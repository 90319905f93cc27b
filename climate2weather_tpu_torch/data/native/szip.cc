// szip decoder: CCSDS 121.0-B adaptive Rice coding as HDF5 frames it (the
// szip filter, id 4, through libaec's SZ compatibility layer), for the
// chunks climate2weather_tpu_torch/io/hdf5.py reads.  Built into one
// library with blosc.cc (climate2weather_tpu_torch/data/native_blosc.py).
//
// A filtered chunk is a 4-byte little-endian decoded size, then one AEC
// stream.  The filter's client values give the options mask (bit 4: samples
// big-endian; bit 5: the unit-delay predictor), the pixels per block, the
// bits per pixel and the pixels per scanline:
//
//   - 32- and 64-bit pixels are coded as 8-bit samples, the chunk's bytes
//     interleaved into planes (every pixel's byte 0, then byte 1, ...);
//     other pixels are samples of their own width, in 1, 2 or 4 bytes;
//   - the samples are cut into scanlines of pixels-per-scanline samples,
//     each padded to a whole number of blocks; one scanline is one
//     reference sample interval (RSI) of ceil(scanline / block) blocks.
//     Where no padding is needed the last RSI holds only the blocks its
//     samples fill.
//
// Each block starts with an option ID (3 bits for samples of up to 8 bits,
// 4 up to 16, 5 above): 0 a low-entropy block (a further bit: 0 a run of
// zero blocks, its length a fundamental sequence; 1 the second extension,
// pairs coded as one fundamental sequence), all ones an uncompressed block,
// k + 1 a split-sample block (fundamental sequences of the high parts, then
// the k low bits of each sample).  With the predictor, the first block of
// an RSI carries its reference sample, raw, after the ID (after the
// low-entropy bit); the other samples are mapped prediction errors,
// undone against the previous sample.  Bits are read most significant
// first; the stream ends at the byte holding the last block's last bit.
//
// Every read is checked against the input's length and every write against
// the output's size: a truncated or corrupt stream returns an error code.
//
// C ABI (ctypes):
//   int64_t c2w_szip_decompress(src, srclen, dst, dstcap, options_mask,
//                               pixels_per_block, bits_per_pixel,
//                               pixels_per_scanline)
// returns the decoded size (the chunk's header's), or a negative error.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kErrTruncated = -1;
constexpr int64_t kErrCapacity = -2;
constexpr int64_t kErrCorrupt = -5;
constexpr int64_t kErrParameters = -7;

constexpr int kOptMsb = 16;  // SZ_MSB_OPTION_MASK
constexpr int kOptNn = 32;   // SZ_NN_OPTION_MASK
constexpr int kZeroBlockRos = 5;  // "the remainder of the segment"
constexpr int kSegmentBlocks = 64;
constexpr int kMaxRsi = 4096;  // libaec's bound on the blocks of an RSI

class BitReader {
 public:
  BitReader(const uint8_t* p, int64_t n) : p_(p), n_(n) {}

  // Fill the accumulator with whole bytes while they fit; false where the
  // input is spent before `need` bits are held. Eight bytes are loaded at
  // once where eight are left: the bits past the whole bytes taken are the
  // stream's next ones, so the next fill ORs the same bits there.
  bool fill(int need) {
    if (pos_ + 8 <= n_) {
      uint64_t v;
      std::memcpy(&v, p_ + pos_, 8);
      acc_ |= __builtin_bswap64(v) >> nbits_;
      const int64_t take = (63 - nbits_) >> 3;
      pos_ += take;
      nbits_ += 8 * take;
      return nbits_ >= need;
    }
    while (nbits_ <= 56 && pos_ < n_) {
      acc_ |= (uint64_t)p_[pos_++] << (56 - nbits_);
      nbits_ += 8;
    }
    return nbits_ >= need;
  }

  // `n` bits (0..32), most significant first.
  bool get(int64_t n, uint32_t* out) {
    if (n == 0) {
      *out = 0;
      return true;
    }
    if (nbits_ < n && !fill(n)) return false;
    *out = (uint32_t)(acc_ >> (64 - n));
    acc_ <<= n;
    nbits_ -= n;
    return true;
  }

  // A fundamental sequence: the count of zeros before a one, at most
  // `limit` (a longer run is corrupt).
  bool fs(uint32_t limit, uint32_t* out) {
    uint32_t zeros = 0;
    for (;;) {
      if (nbits_ == 0 && !fill(1)) return false;
      if (acc_ != 0) {
        const int lead = __builtin_clzll(acc_);
        if (lead < nbits_) {
          zeros += (uint32_t)lead;
          if (zeros > limit) return false;
          acc_ = lead == 63 ? 0 : acc_ << (lead + 1);
          nbits_ -= lead + 1;
          *out = zeros;
          return true;
        }
      }
      zeros += (uint32_t)nbits_;  // every held bit is a zero
      if (zeros > limit) return false;
      acc_ = 0;
      nbits_ = 0;
    }
  }

  // Bits of the input not consumed.
  int64_t left() const { return (n_ - pos_) * 8 + nbits_; }

 private:
  const uint8_t* p_;
  int64_t n_;
  int64_t pos_ = 0;
  uint64_t acc_ = 0;
  int64_t nbits_ = 0;  // not int: the decoder's uint32_t stores may alias an int, not an int64_t
};

// The second extension's pairs: code m -> (beta, first code of that beta).
struct SecondExtension {
  uint8_t beta[91];
  uint8_t first[91];
  SecondExtension() {
    int m = 0;
    for (int b = 0; b < 13; ++b) {
      const int first_m = m;
      for (int j = 0; j <= b; ++j, ++m) {
        beta[m] = (uint8_t)b;
        first[m] = (uint8_t)first_m;
      }
    }
  }
};
const SecondExtension kSecondExtension;

// Decode the RSIs of `nsamples` coded samples (bps bits each) into
// `out` (mapped values undone where `predict`), keeping `keep` samples of
// each RSI of `rsi_samples` (the rest is scanline padding).  Returns the
// samples written or an error.
int64_t aec_decode(BitReader* br, int bps, int block, int rsi, bool predict, int64_t total_blocks,
                   int64_t keep, std::vector<uint32_t>* out) {
  const int id_len = bps > 16 ? 5 : bps > 8 ? 4 : 3;
  const uint32_t max_id = (1u << id_len) - 1;
  const uint32_t xmax = bps == 32 ? 0xFFFFFFFFu : (1u << bps) - 1;  // a high part past it is corrupt
  const int64_t rsi_samples = (int64_t)rsi * block;
  std::vector<uint32_t> buf((size_t)rsi_samples);
  int64_t done = 0;
  while (done < total_blocks) {
    const int blocks = (int)std::min<int64_t>(rsi, total_blocks - done);
    int64_t n = 0;  // samples held in buf
    int b = 0;
    while (b < blocks) {
      const int ref = predict && b == 0 ? 1 : 0;
      uint32_t id, v;
      if (!br->get(id_len, &id)) return kErrTruncated;
      if (id == 0) {
        uint32_t sub;
        if (!br->get(1, &sub)) return kErrTruncated;
        if (ref) {
          if (!br->get(bps, &v)) return kErrTruncated;
          buf[n++] = v;
        }
        if (sub == 0) {  // zero blocks
          uint32_t run;
          if (!br->fs(kSegmentBlocks + 1, &run)) return kErrCorrupt;
          int64_t zero_blocks = (int64_t)run + 1;
          if (zero_blocks == kZeroBlockRos) {
            zero_blocks = std::min<int64_t>(rsi - b, kSegmentBlocks - b % kSegmentBlocks);
          } else if (zero_blocks > kZeroBlockRos) {
            zero_blocks -= 1;
          }
          if (b + zero_blocks > rsi) return kErrCorrupt;
          const int64_t zeros = zero_blocks * block - ref;
          if (n + zeros > rsi_samples) return kErrCorrupt;
          std::fill(buf.begin() + n, buf.begin() + n + zeros, 0u);
          n += zeros;
          b += (int)zero_blocks;
          continue;
        }
        for (int i = ref; i < block;) {  // the second extension
          uint32_t m;
          if (!br->fs(90, &m)) return kErrCorrupt;
          const uint32_t d1 = m - kSecondExtension.first[m];
          if ((i & 1) == 0) {
            buf[n++] = kSecondExtension.beta[m] - d1;
            ++i;
          }
          buf[n++] = d1;
          ++i;
        }
      } else if (id == max_id) {  // uncompressed
        for (int i = 0; i < block; ++i) {
          if (!br->get(bps, &v)) return kErrTruncated;
          buf[n++] = v;
        }
      } else {  // split samples, k low bits
        const int k = (int)id - 1;
        if (ref) {
          if (!br->get(bps, &v)) return kErrTruncated;
          buf[n++] = v;
        }
        const int64_t first = n;
        for (int i = ref; i < block; ++i) {
          uint32_t hi;
          if (!br->fs(xmax >> k, &hi)) return kErrCorrupt;
          buf[n++] = hi << k;
        }
        if (k) {
          for (int64_t i = first; i < n; ++i) {
            if (!br->get(k, &v)) return kErrTruncated;
            buf[i] |= v;
          }
        }
      }
      ++b;
    }
    done += b;
    if (predict && n > 0) {  // undo the unit-delay prediction and its mapping, without branches
      uint32_t last = buf[0];
      const uint32_t half = xmax / 2 + 1;
      for (int64_t i = 1; i < n; ++i) {
        const uint32_t d = buf[i];
        const uint32_t upper = (0u - (uint32_t)(last >= half)) & xmax;
        const uint32_t theta = upper ^ last;  // min(last, xmax - last)
        const uint64_t half_d = ((uint64_t)d >> 1) + (d & 1);
        const uint32_t sign = 0u - (d & 1);  // an odd d is a step down
        const uint32_t near = last + (((uint32_t)half_d ^ sign) - sign);
        last = half_d <= theta ? near : upper ^ d;
        buf[i] = last;
      }
    }
    const int64_t take = std::min<int64_t>(n, keep);
    out->insert(out->end(), buf.begin(), buf.begin() + take);
  }
  return (int64_t)out->size();
}

}  // namespace

extern "C" {

int64_t c2w_szip_decompress(const uint8_t* src, int64_t srclen, uint8_t* dst, int64_t dstcap,
                            int32_t options_mask, int32_t pixels_per_block, int32_t bits_per_pixel,
                            int32_t pixels_per_scanline) {
  if (srclen < 4) return kErrTruncated;
  const int64_t nbytes = (int64_t)src[0] | ((int64_t)src[1] << 8) | ((int64_t)src[2] << 16) |
                         ((int64_t)src[3] << 24);
  if (nbytes > dstcap) return kErrCapacity;
  const int ppb = pixels_per_block, bpp = bits_per_pixel, pps = pixels_per_scanline;
  if (ppb < 2 || ppb > 32 || ppb % 2 || bpp < 1 || bpp > 64 || (bpp > 32 && bpp != 64) || pps < 1 ||
      (pps + ppb - 1) / ppb > kMaxRsi)
    return kErrParameters;
  const bool interleave = bpp == 32 || bpp == 64;
  const int bps = interleave ? 8 : bpp;
  const int psize = bps > 16 ? 4 : bps > 8 ? 2 : 1;
  if (nbytes % psize || (interleave && nbytes % (bpp / 8))) return kErrParameters;
  const int64_t nsamples = nbytes / psize;
  const int rsi = (pps + ppb - 1) / ppb;
  // blocks in the stream: whole RSIs where scanlines are padded, else only
  // those the samples fill
  const int64_t lines = (nsamples + pps - 1) / pps;
  const int64_t total_blocks = pps % ppb ? lines * rsi : (nsamples + ppb - 1) / ppb;
  BitReader br(src + 4, srclen - 4);
  std::vector<uint32_t> samples;
  samples.reserve((size_t)(lines * pps));
  const int64_t got = aec_decode(&br, bps, ppb, rsi, (options_mask & kOptNn) != 0, total_blocks, pps,
                                 &samples);
  if (got < 0) return got;
  if (got < nsamples) return kErrTruncated;
  if (br.left() >= 8) return kErrCorrupt;  // the stream must end at its last block
  if (interleave) {  // plane j holds byte j of every pixel
    const int w = bpp / 8;
    const int64_t npix = nbytes / w;
    for (int j = 0; j < w; ++j)
      for (int64_t i = 0; i < npix; ++i) dst[i * w + j] = (uint8_t)samples[(size_t)(j * npix + i)];
    return nbytes;
  }
  const bool msb = (options_mask & kOptMsb) != 0;
  for (int64_t i = 0; i < nsamples; ++i) {
    const uint32_t s = samples[(size_t)i];
    uint8_t* o = dst + i * psize;
    for (int j = 0; j < psize; ++j) o[msb ? psize - 1 - j : j] = (uint8_t)(s >> (8 * j));
  }
  return nbytes;
}

}  // extern "C"
