// Self-contained blosc1 chunk codec for the zarr-v2 store of
// climate2weather_tpu_torch/data/zarr_store.py (the JAX package's
// data/native/blosc.cc, the same code and C ABI).
//
// Externally-written zarr stores default to the blosc compressor
// (zarr-python's Blosc(cname='lz4', clevel=5, shuffle=SHUFFLE)).  This
// implements the blosc1 container format and an LZ4 block codec from their
// public specifications — no c-blosc or liblz4 dependency:
//
//   chunk := 16-byte header | [int32 block offsets] | blocks
//   header: [0] format version   [1] codec format version
//           [2] flags: 0x1 byte-shuffle, 0x2 pure-memcpy, 0x4 bit-shuffle,
//               bits 5-7 codec id (0 blosclz, 1 lz4/lz4hc, 3 zlib, 4 zstd)
//           [3] typesize
//           [4:8] nbytes  [8:12] blocksize  [12:16] cbytes   (uint32 LE)
//   block := nstreams x ([int32 csize] | stream-bytes); a stream whose
//           csize equals its uncompressed size is stored raw.  Blocks are
//           SPLIT into `typesize` per-byte-plane streams when the codec is
//           blosclz/lz4, typesize <= 16 and blocksize/typesize >= 128
//           (c-blosc's forward-compatible split policy); one stream
//           otherwise.  Byte-shuffle is applied per block before split.
//
// The decoder first applies the inferred split policy and, if the stream
// walk is inconsistent (overrun / size mismatch), retries with the
// opposite interpretation — robust to split-policy drift across c-blosc
// versions.  Supported: lz4 + memcpy chunks, with or without byte-shuffle.
// Unsupported (clear error): blosclz/zlib/zstd codecs, bit-shuffle.  The
// encoder is single-threaded and greedy with no uninitialised state: the
// same input gives the same bytes.
//
// It also decodes LZF (liblzf's format, the chunks of h5py's lzf filter,
// id 32000, that climate2weather_tpu_torch/io/hdf5.py reads): a control
// byte below 32 starts a run of that many plus one literal bytes; above, its
// top three bits are a match's length less two (7: add the next byte), its
// low five the high bits of the distance less one, the next byte the rest.
//
// C ABI, consumed via ctypes (climate2weather_tpu_torch/data/native_blosc.py),
// which builds it at first use with the host C++ compiler:
//   c++ -O3 -std=c++17 -shared -fPIC blosc.cc -o libc2wblosc-<hash>.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kHeaderSize = 16;
constexpr uint8_t kFlagShuffle = 0x1;
constexpr uint8_t kFlagMemcpy = 0x2;
constexpr uint8_t kFlagBitShuffle = 0x4;
constexpr int kCodecLz4 = 1;
constexpr int kMinBufferSize = 128;  // c-blosc BLOSC_MIN_BUFFERSIZE
constexpr int kMaxSplitTypesize = 16;

// error codes (negative returns)
constexpr int64_t kErrTruncated = -1;
constexpr int64_t kErrCapacity = -2;
constexpr int64_t kErrUnsupportedCodec = -3;
constexpr int64_t kErrBitShuffle = -4;
constexpr int64_t kErrCorrupt = -5;
constexpr int64_t kErrTooLarge = -6;  // blosc1 headers are uint32-limited

inline uint32_t load_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline void store_u32(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

// ---------------------------------------------------------------------------
// LZ4 block format (github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md)
// ---------------------------------------------------------------------------

// Safe decode of one LZ4 block: consumes exactly `srclen` bytes, writes at
// most `dstcap`.  Returns bytes written, or negative on malformed input.
int64_t lz4_decompress(const uint8_t* src, int64_t srclen, uint8_t* dst,
                       int64_t dstcap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + srclen;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dstcap;
  while (ip < iend) {
    const uint8_t token = *ip++;
    // literals
    int64_t litlen = token >> 4;
    if (litlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return kErrCorrupt;
        b = *ip++;
        litlen += b;
      } while (b == 255);
    }
    if (ip + litlen > iend || op + litlen > oend) return kErrCorrupt;
    std::memcpy(op, ip, (size_t)litlen);
    ip += litlen;
    op += litlen;
    if (ip == iend) break;  // last sequence: literals only
    // match
    if (ip + 2 > iend) return kErrCorrupt;
    const int64_t offset = (int64_t)ip[0] | ((int64_t)ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return kErrCorrupt;
    int64_t matchlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return kErrCorrupt;
        b = *ip++;
        matchlen += b;
      } while (b == 255);
    }
    if (op + matchlen > oend) return kErrCorrupt;
    const uint8_t* mp = op - offset;
    for (int64_t i = 0; i < matchlen; ++i) op[i] = mp[i];  // overlap-safe
    op += matchlen;
  }
  return op - dst;
}

// Greedy LZ4 block compressor (hash table over 4-byte sequences).  Emits a
// valid stream obeying the end-of-block rules: last 5 bytes are literals,
// last match starts >= 12 bytes before the end.  Returns bytes written or
// kErrCapacity if `dst` cannot hold the worst case.
int64_t lz4_compress(const uint8_t* src, int64_t srclen, uint8_t* dst,
                     int64_t dstcap) {
  // worst case: srclen + srclen/255 + 16
  if (dstcap < srclen + srclen / 255 + 16) return kErrCapacity;
  constexpr int kHashLog = 13;
  int32_t table[1 << kHashLog];
  std::memset(table, -1, sizeof(table));
  auto hash = [](uint32_t v) -> uint32_t {
    return (v * 2654435761u) >> (32 - kHashLog);
  };
  auto read32 = [](const uint8_t* p) -> uint32_t {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
  };
  uint8_t* op = dst;
  int64_t anchor = 0;  // start of pending literals
  const int64_t mflimit = srclen - 12;  // last match must start before this
  int64_t i = 0;
  while (i <= mflimit) {
    const uint32_t h = hash(read32(src + i));
    const int64_t cand = table[h];
    table[h] = (int32_t)i;
    if (cand >= 0 && i - cand <= 65535 && read32(src + cand) == read32(src + i)) {
      // extend match (stop 5 bytes before the end: end-of-block rule)
      int64_t mlen = 4;
      const int64_t maxlen = srclen - 5 - i;
      while (mlen < maxlen && src[cand + mlen] == src[i + mlen]) ++mlen;
      const int64_t litlen = i - anchor;
      // token + extended lengths
      uint8_t* tok = op++;
      if (litlen >= 15) {
        *tok = 0xF0;
        int64_t rest = litlen - 15;
        while (rest >= 255) {
          *op++ = 255;
          rest -= 255;
        }
        *op++ = (uint8_t)rest;
      } else {
        *tok = (uint8_t)(litlen << 4);
      }
      std::memcpy(op, src + anchor, (size_t)litlen);
      op += litlen;
      const int64_t offset = i - cand;
      *op++ = (uint8_t)offset;
      *op++ = (uint8_t)(offset >> 8);
      const int64_t mcode = mlen - 4;
      if (mcode >= 15) {
        *tok |= 0x0F;
        int64_t rest = mcode - 15;
        while (rest >= 255) {
          *op++ = 255;
          rest -= 255;
        }
        *op++ = (uint8_t)rest;
      } else {
        *tok |= (uint8_t)mcode;
      }
      i += mlen;
      anchor = i;
    } else {
      ++i;
    }
  }
  // trailing literals
  const int64_t litlen = srclen - anchor;
  uint8_t* tok = op++;
  if (litlen >= 15) {
    *tok = 0xF0;
    int64_t rest = litlen - 15;
    while (rest >= 255) {
      *op++ = 255;
      rest -= 255;
    }
    *op++ = (uint8_t)rest;
  } else {
    *tok = (uint8_t)(litlen << 4);
  }
  std::memcpy(op, src + anchor, (size_t)litlen);
  op += litlen;
  return op - dst;
}

// ---------------------------------------------------------------------------
// byte shuffle
// ---------------------------------------------------------------------------

void shuffle(const uint8_t* src, uint8_t* dst, int64_t nbytes,
             int64_t typesize) {
  const int64_t nel = nbytes / typesize;
  for (int64_t t = 0; t < typesize; ++t) {
    uint8_t* d = dst + t * nel;
    const uint8_t* s = src + t;
    for (int64_t j = 0; j < nel; ++j) d[j] = s[j * typesize];
  }
}

void unshuffle(const uint8_t* src, uint8_t* dst, int64_t nbytes,
               int64_t typesize) {
  const int64_t nel = nbytes / typesize;
  for (int64_t t = 0; t < typesize; ++t) {
    const uint8_t* s = src + t * nel;
    uint8_t* d = dst + t;
    for (int64_t j = 0; j < nel; ++j) d[j * typesize] = s[j];
  }
}

// c-blosc forward-compatible split policy (blosc.c split_block): split
// lz4/blosclz blocks into per-byte-plane streams for small typesizes.
// The leftover (partial last) block is NEVER split (blosc_d's
// !leftoverblock condition) — callers must also pass bsize == blocksize.
bool split_policy(int codec, int64_t typesize, int64_t blocksize) {
  return (codec == 0 || codec == kCodecLz4) && typesize > 1 &&
         typesize <= kMaxSplitTypesize && blocksize % typesize == 0 &&
         blocksize / typesize >= kMinBufferSize;
}

// Walk one block's streams.  Returns bytes consumed from `src` on success
// (writing exactly `bsize` bytes to `dst`), negative on inconsistency.
int64_t decode_block(const uint8_t* src, int64_t avail, uint8_t* dst,
                     int64_t bsize, int64_t typesize, bool do_split) {
  const int64_t nstreams = do_split ? typesize : 1;
  if (do_split && bsize % typesize != 0) return kErrCorrupt;
  const int64_t neblock = do_split ? bsize / typesize : bsize;
  const uint8_t* ip = src;
  for (int64_t s = 0; s < nstreams; ++s) {
    if (ip + 4 > src + avail) return kErrTruncated;
    const int64_t csize = (int64_t)(int32_t)load_u32(ip);
    ip += 4;
    if (csize < 0 || ip + csize > src + avail) return kErrTruncated;
    if (csize == neblock) {
      std::memcpy(dst + s * neblock, ip, (size_t)neblock);
    } else {
      const int64_t n = lz4_decompress(ip, csize, dst + s * neblock, neblock);
      if (n != neblock) return kErrCorrupt;
    }
    ip += csize;
  }
  return ip - src;
}

}  // namespace

extern "C" {

int64_t c2w_blosc_abi_version() { return 1; }

// Parse the header; return the uncompressed size or a negative error.
int64_t c2w_blosc_nbytes(const uint8_t* src, int64_t srclen) {
  if (srclen < kHeaderSize) return kErrTruncated;
  return (int64_t)load_u32(src + 4);
}

// Decompress a full blosc1 chunk into dst.  Returns nbytes written or a
// negative error code.
int64_t c2w_blosc_decompress(const uint8_t* src, int64_t srclen, uint8_t* dst,
                             int64_t dstcap) {
  if (srclen < kHeaderSize) return kErrTruncated;
  const uint8_t flags = src[2];
  const int64_t typesize = src[3] == 0 ? 256 : src[3];
  const int64_t nbytes = (int64_t)load_u32(src + 4);
  const int64_t blocksize = (int64_t)load_u32(src + 8);
  const int64_t cbytes = (int64_t)load_u32(src + 12);
  if (nbytes > dstcap) return kErrCapacity;
  if (cbytes > srclen) return kErrTruncated;
  if (nbytes == 0) return 0;
  if (flags & kFlagBitShuffle) return kErrBitShuffle;
  if (flags & kFlagMemcpy) {
    if (kHeaderSize + nbytes > srclen) return kErrTruncated;
    std::memcpy(dst, src + kHeaderSize, (size_t)nbytes);
    return nbytes;  // memcpy chunks are never shuffled (c-blosc stores raw)
  }
  const int codec = flags >> 5;
  if (codec != kCodecLz4) return kErrUnsupportedCodec;
  if (blocksize <= 0) return kErrCorrupt;

  const int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  if (kHeaderSize + 4 * nblocks > srclen) return kErrTruncated;
  const bool shuffled = (flags & kFlagShuffle) != 0;
  std::vector<uint8_t> tmp(shuffled ? (size_t)blocksize : 0);

  const bool preferred = split_policy(codec, typesize, blocksize);
  for (int attempt = 0; attempt < 2; ++attempt) {
    const bool do_split = attempt == 0 ? preferred : !preferred;
    bool ok = true;
    for (int64_t b = 0; b < nblocks && ok; ++b) {
      const int64_t off = (int64_t)load_u32(src + kHeaderSize + 4 * b);
      if (off < kHeaderSize || off >= srclen) {
        ok = false;
        break;
      }
      const int64_t bsize =
          (b == nblocks - 1) ? nbytes - b * blocksize : blocksize;
      uint8_t* obuf = shuffled ? tmp.data() : dst + b * blocksize;
      const int64_t used = decode_block(src + off, srclen - off, obuf, bsize,
                                        typesize,
                                        do_split && bsize == blocksize);
      if (used < 0) {
        ok = false;
        break;
      }
      if (shuffled) {
        if (bsize % typesize == 0) {
          unshuffle(tmp.data(), dst + b * blocksize, bsize, typesize);
        } else {  // c-blosc leaves non-aligned leftovers unshuffled
          std::memcpy(dst + b * blocksize, tmp.data(), (size_t)bsize);
        }
      }
    }
    if (ok) return nbytes;
  }
  return kErrCorrupt;
}

// Compress src into a blosc1 chunk (lz4 codec, optional byte-shuffle).
// blocksize 0 selects 32 KiB (typesize-aligned).  Falls back to a memcpy
// chunk when compression does not pay.  Returns cbytes or negative error.
int64_t c2w_blosc_compress(const uint8_t* src, int64_t nbytes,
                           int64_t typesize, int32_t do_shuffle,
                           int64_t blocksize, uint8_t* dst, int64_t dstcap) {
  if (typesize < 1 || typesize > 255) return kErrCorrupt;
  // c-blosc rejects nbytes > BLOSC_MAX_BUFFERSIZE (INT32_MAX - overhead);
  // beyond that the uint32 header fields would silently wrap
  if (nbytes < 0 || nbytes > 0x7FFFFFF0LL) return kErrTooLarge;
  if (dstcap < kHeaderSize + nbytes + nbytes / 16 + 64) return kErrCapacity;
  if (blocksize <= 0) blocksize = 32 * 1024;
  if (blocksize > nbytes) blocksize = nbytes;
  if (blocksize % typesize != 0)
    blocksize -= blocksize % typesize;  // keep blocks element-aligned
  if (blocksize <= 0) blocksize = nbytes;

  dst[0] = 2;  // blosc1 format version
  dst[1] = 1;  // lz4 codec format version
  dst[3] = (uint8_t)typesize;
  store_u32(dst + 4, (uint32_t)nbytes);
  store_u32(dst + 8, (uint32_t)blocksize);
  if (nbytes == 0) {
    dst[2] = (uint8_t)(kCodecLz4 << 5);
    store_u32(dst + 12, kHeaderSize);
    return kHeaderSize;
  }

  const bool shuffled = do_shuffle && typesize > 1 && nbytes % typesize == 0;
  dst[2] = (uint8_t)((shuffled ? kFlagShuffle : 0) | (kCodecLz4 << 5));

  const int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  const bool do_split = split_policy(kCodecLz4, typesize, blocksize);
  uint8_t* const offsets = dst + kHeaderSize;
  uint8_t* op = offsets + 4 * nblocks;
  std::vector<uint8_t> sbuf((size_t)blocksize);
  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t bsize = (b == nblocks - 1) ? nbytes - b * blocksize : blocksize;
    const uint8_t* bin = src + b * blocksize;
    if (shuffled && bsize % typesize == 0) {
      shuffle(bin, sbuf.data(), bsize, typesize);
      bin = sbuf.data();
    }
    store_u32(offsets + 4 * b, (uint32_t)(op - dst));
    const int64_t nstreams = (do_split && bsize == blocksize) ? typesize : 1;
    const int64_t neblock = bsize / nstreams;
    for (int64_t s = 0; s < nstreams; ++s) {
      const int64_t cap = dstcap - (op - dst) - 4;
      if (cap < neblock) return kErrCapacity;
      int64_t csize =
          lz4_compress(bin + s * neblock, neblock, op + 4, cap);
      if (csize < 0 || csize >= neblock) {  // stream did not compress: raw
        std::memcpy(op + 4, bin + s * neblock, (size_t)neblock);
        csize = neblock;
      }
      store_u32(op, (uint32_t)csize);
      op += 4 + csize;
    }
  }
  int64_t cbytes = op - dst;
  if (cbytes >= kHeaderSize + nbytes) {  // compression lost: memcpy chunk
    dst[2] = kFlagMemcpy | (uint8_t)(kCodecLz4 << 5);
    std::memcpy(dst + kHeaderSize, src, (size_t)nbytes);
    cbytes = kHeaderSize + nbytes;
  }
  store_u32(dst + 12, (uint32_t)cbytes);
  return cbytes;
}

// Decode one LZF stream into dst.  Returns bytes written or a negative
// error code (-1 truncated input, -2 output capacity, -5 a match reaching
// before the output's start).
int64_t c2w_lzf_decompress(const uint8_t* src, int64_t srclen, uint8_t* dst,
                           int64_t dstcap) {
  const uint8_t* ip = src;
  const uint8_t* const in_end = src + srclen;
  int64_t op = 0;
  while (ip < in_end) {
    uint32_t ctrl = *ip++;
    if (ctrl < 32) {  // a literal run of ctrl + 1 bytes
      const int64_t n = (int64_t)ctrl + 1;
      if (ip + n > in_end) return kErrTruncated;
      if (op + n > dstcap) return kErrCapacity;
      std::memcpy(dst + op, ip, (size_t)n);
      ip += n;
      op += n;
      continue;
    }
    int64_t len = ctrl >> 5;
    if (len == 7) {
      if (ip >= in_end) return kErrTruncated;
      len += *ip++;
    }
    if (ip >= in_end) return kErrTruncated;
    const int64_t dist = (int64_t)((ctrl & 0x1f) << 8) + *ip++ + 1;
    len += 2;
    if (dist > op) return kErrCorrupt;
    if (op + len > dstcap) return kErrCapacity;
    for (int64_t i = 0; i < len; ++i, ++op) dst[op] = dst[op - dist];  // may overlap
  }
  return op;
}

}  // extern "C"
