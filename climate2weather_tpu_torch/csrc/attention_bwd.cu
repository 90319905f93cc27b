// Fused single-head self-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel climate2weather_tpu/ops/attention.py
// `_attn_bwd_kernel` (launched by `_call_bwd`, reached through the custom
// VJP `_bwd`). Same arithmetic, fp32 inside:
//
//     P  = softmax((q s)(k s)^T),  s = C^-1/4    (recomputed, not saved)
//     dV = P^T dO
//     dP = dO V^T
//     dS = P o (dP - D),  D = rowsum(dP o P)
//     dQ = dS K s^2,   dK = dS^T Q s^2           (K, Q unscaled)
//
// with the outputs cast to the input type (fp32 or bf16). D is the Pallas
// body's rowsum(dP o P), not FlashAttention's rowsum(dO o O): the autograd
// Function saves q, k and v, not the output.
//
// What bounds it: the function reads q, k, v and dO once and writes dQ, dK
// and dV once, 7 B T C bf16 values: 14.7 MB at the 72.1M UNet's level 4 in
// training ([32, 64, 512]), 4.4 us at 3.35 TB/s, and 58.7 MB at
// [32, 256, 512] (sda_unet_large's level 4 at 256 x 256, tiny_unet's route
// at C = 32), 17.5 us. Its five products (10 B T^2 C operations: 0.67 and
// 10.7 GFLOP) take 0.7 and 10.9 us at the bf16 tensor-core peak, so bytes
// bound it at both shapes.
//
// Two routes, by dtype.
//
// bf16: the tensor cores (mma.sync.m16n8k16, bf16 operands, fp32
//   accumulators), no T x T buffer in device memory, no atomics: the same
//   inputs give the same bits on every call. A block owns an output slice of
//   CB channels and forms the 64 x 64 tiles of S and dP that it needs over
//   all of C itself:
//   - S = q k^T and dP = dO V^T: the raw bf16 operands, whose products are
//     exact in fp32, streamed in 64-channel chunks by 16-byte cp.async
//     through a ring of stages (the next chunks land while one is
//     multiplied), rows padded so that ldmatrix reads them without bank
//     conflicts. Each chunk sums into fresh accumulators (64 exact products
//     in one tensor-core accumulation), added to the running fp32 sums.
//     s^2 is applied to the fp32 scores, as the forward's T > 64 route does.
//   - P and dS (fp32) go to shared memory as three bf16 terms each, hi =
//     bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which hold every
//     fp32 value exactly; the products P^T dO, dS^T Q and dS K sum the three
//     terms of 16 keys or queries into fresh accumulators (small terms
//     first), added to the running fp32 sums: 48 exact products at most in
//     one tensor-core accumulation. The slice's operand (64 rows x CB
//     channels of dO, Q or K) comes by cp.async beside the chunks, and the
//     outputs leave through shared memory as 16-byte rows.
//   T <= 64 (the 72.1M net; sda_unet_large's level 5 at C = 768): one
//   kernel of 8 warps per (batch element, 128-channel slice): S and dP over
//   all of C, the softmax and D exact in the block (each row's max, sum and
//   rowsum(dP o exp(S - m)) joined over its warps through shared memory),
//   then dV, dK and dQ of the slice. At [32, 64, 512], 128 blocks.
//   T > 64: three kernels.
//   1. statistics, 8 warps per (batch element, 64 query rows): the key
//      tiles walked with the online softmax: the row max m, the sum l and
//      D = rowsum(dP o exp(S - m)) / l, D's sum rescaled by exp(m_old -
//      m_new) as m grows, like l; m, l and D go to a [3, B, T] fp32 buffer.
//   2. dK and dV, 16 warps per (batch element, 64 keys, 256-channel slice):
//      the query tiles walked, S^T and dP^T formed with the keys as rows,
//      P^T and dS^T from each query's statistics, dK and dV of the keys and
//      slice kept in registers (64 fp32 a thread).
//   3. dQ, 16 warps per (batch element, 64 query rows, 256-channel slice):
//      the key tiles walked, dQ kept in registers.
//   Where the rest goes: forming S and dP over all of C in every block. At
//   [32, 256, 512] the statistics and the two slices of each gradient kernel
//   form them five times over, so L2 sends the SMs about 0.76 GB (13x the
//   function's bytes), behind which the three output products (each taken
//   three times over for the terms) are the smaller part. At [32, 64, 512]
//   the four slices read q, k, v and dO four times over (34 MB). Wider
//   slices need more accumulator registers than a thread has: 16 warps are
//   what let the gradient kernels take 256 channels (8-warp blocks of 128
//   channels were slower there). Summing the slices' partial S and dP across
//   a thread-block cluster instead (each block over its own channels, the
//   sums through distributed shared memory) was slower still: that memory
//   carried the exchange more slowly than L2 carries the recomputation.
//   The launcher needs q, k, v, dO and the outputs aligned to 16 bytes and
//   row strides that are multiples of 8 elements (16-byte copies); the
//   UNet's [B, T, 3C] thirds are.
//
// fp32 (the tests' and the checks' reference route; no path of the port runs
//   it): the CUDA-core body, two kernels split where the reduction over C
//   ends, with an fp32 [B, T, T] scratch for P and one for dS between them:
//   A. one block per (batch element, QT query rows) walks the keys in tiles
//      of KT, streaming q and k through shared memory in CK-channel chunks:
//      pass 1 forms the scores, keeps each row's running max and sum and
//      parks the scores in the P scratch; pass 2 turns them into P, forms
//      dP = dO V^T the same way and accumulates rowsum(dP o P); pass 3
//      writes dS.
//   B. one block per (batch element, RT rows, CB channels) walks the other T
//      axis in tiles of JT and forms the RT x CB slices of dV, dQ and dK.
//
// T runs up to T_MAX on both routes (the fp32 scratch is 2 B T^2 fp32).
// The shared-memory opt-ins are asked once per card.
//
// Interface: a plain C launcher, loaded with ctypes. q, k and v share their
// strides (batch, row; channels contiguous), so they may be the three thirds
// of one [B, T, 3C] projection. dO, dQ, dK and dV are contiguous [B, T, C];
// the scratch the route needs (c2w_attention_bwd_scratch_bytes) is given by
// the caller.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int T_MAX = 8192;  // tokens
constexpr int MAX_DEVICES = 64;

// Let `kernel` use `bytes` of dynamic shared memory on the current card,
// once per card: `opted` is the kernel's own record of what each card was
// given.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, int (&opted)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (opted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) opted[dev] = bytes;
  return err;
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int TILE = 64;    // query rows and keys of a score tile
constexpr int CK = 64;      // channels per chunk of the S and dP products
constexpr int LD = CK + 8;  // row stride (bf16) of chunk tiles and of the P, dS terms: 144 bytes
constexpr int TERMS = 3;    // bf16 terms of P and dS

constexpr int CHUNK = TILE * LD;  // elements of a chunk tile
constexpr int STAGE = 4 * CHUNK;  // a stage: the chunks of x1, y1, x2, y2
constexpr int TERM = TILE * LD;   // elements of a term tile

// A block of W warps in a 4 x WC grid: warp (wr, wc) holds 16 rows x NC
// columns of a 64 x 64 score tile, and 16 rows x 64 channels of the block's
// output slice of CB = 64 WC channels. Its ring has S stages: S - 1 chunks
// land while one is multiplied.
template <int W, int S>
struct Geo {
  static constexpr int THREADS = 32 * W;
  static constexpr int STAGES = S;
  static constexpr int WC = W / 4;
  static constexpr int NC = TILE / WC;  // score columns a warp
  static constexpr int NT = NC / 8;     // its 8-column mma tiles
  static constexpr int CB = 64 * WC;    // output channels a block
  static constexpr int SLD = CB + 8;    // row stride (bf16) of slice tiles: 16 bytes past a multiple of 128
  static constexpr int SLICE = TILE * SLD;
  // the ring, `slices` slice tiles, `terms` term tiles, the row exchange
  static constexpr size_t smem(int slices, int terms) {
    return (STAGES * (size_t)STAGE + (size_t)slices * SLICE + (size_t)terms * TERM) * sizeof(__nv_bfloat16) +
           3 * WC * TILE * sizeof(float);
  }
};
using G8 = Geo<8, 3>;    // T <= 64 and the statistics: 128-channel slices
using G16 = Geo<16, 2>;  // dK, dV and dQ where T > 64: 256-channel slices (two stages fit)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b on one 16 x 8 x 16 bf16 tile, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// A thread's place in the tiles: warp (wr, wc); g, t4 the mma fragment's
// row and column pair; (lrow, lcol) and (srow, scol) the ldmatrix row
// addresses whose four 8 x 8 matrices are an A fragment (or a transposed B
// pair) and a B pair (or a transposed A fragment).
struct Lane {
  int tid, g, t4, wr, wc, lrow, lcol, srow, scol;
};
__device__ __forceinline__ Lane lane_of(int tid) {
  const int warp = tid / 32, lane = tid % 32;
  return {tid, lane / 4, lane % 4, warp % 4, warp / 4, (lane & 7) + 8 * ((lane >> 3) & 1),
          8 * (lane >> 4), (lane & 7) + 8 * (lane >> 4), 8 * ((lane >> 3) & 1)};
}
// the thread's score-tile rows (h = 0, 1) and columns (nt, e)
__device__ __forceinline__ int row_of(const Lane& ln, int h) { return 16 * ln.wr + ln.g + 8 * h; }
template <class G>
__device__ __forceinline__ int col_of(const Lane& ln, int nt, int e) {
  return G::NC * ln.wc + 8 * nt + 2 * ln.t4 + e;
}

// 64 rows of a [seq][ch] bf16 operand: rows r0.. of the batch element at base
struct Rows {
  const __nv_bfloat16* base;
  long long stride;  // elements between rows
  int r0;
};

// WIDTH channels from c0 of the 64 rows of t into dst (row stride ld); rows
// past seq and channels past ch read zero
template <class G, int WIDTH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld, const Rows& t, int seq, int ch,
                                          int c0, int tid) {
  constexpr int PER_ROW = WIDTH / 8;
  static_assert(TILE * PER_ROW % G::THREADS == 0, "whole pieces a thread");
#pragma unroll
  for (int i = 0; i < TILE * PER_ROW / G::THREADS; ++i) {
    const int piece = tid + G::THREADS * i;
    const int r = piece / PER_ROW, c = c0 + (piece % PER_ROW) * 8;
    const bool in = t.r0 + r < seq && c < ch;
    cp_async16(dst + r * ld + c - c0, in ? t.base + (t.r0 + r) * t.stride + c : t.base, in);
  }
}

template <class G>
__device__ __forceinline__ void load_slice(__nv_bfloat16* dst, const Rows& t, int seq, int ch, int c0, int tid) {
  load_tile<G, G::CB>(dst, G::SLD, t, seq, ch, c0, tid);
}

// The first G::STAGES - 1 chunks of a tile pair into their stages (the ring is
// free); one copy group a stage, empty past the last chunk, so that every
// wait counts the same groups.
template <class G>
__device__ __forceinline__ void prefetch(__nv_bfloat16* ring, const Rows& x1, const Rows& y1, const Rows& x2,
                                         const Rows& y2, int seq, int ch, int tid) {
#pragma unroll
  for (int c = 0; c < G::STAGES - 1; ++c) {
    if (c * CK < ch) {
      __nv_bfloat16* st = ring + c * STAGE;
      load_tile<G, CK>(st, LD, x1, seq, ch, c * CK, tid);
      load_tile<G, CK>(st + CHUNK, LD, y1, seq, ch, c * CK, tid);
      load_tile<G, CK>(st + 2 * CHUNK, LD, x2, seq, ch, c * CK, tid);
      load_tile<G, CK>(st + 3 * CHUNK, LD, y2, seq, ch, c * CK, tid);
    }
    cp_async_commit();
  }
}

// acc += x y^T over one 16-channel step of a stage: warp (wr, wc)'s 16 x NC tile
template <class G>
__device__ __forceinline__ void chunk_step(float (&acc)[G::NT][4], const __nv_bfloat16* xs,
                                           const __nv_bfloat16* ys, int kk, const Lane& ln) {
  unsigned a[4];
  ldmatrix_x4(a, xs + (16 * ln.wr + ln.lrow) * LD + 16 * kk + ln.lcol);
#pragma unroll
  for (int p = 0; p < G::NT / 2; ++p) {
    unsigned b[4];
    ldmatrix_x4(b, ys + (G::NC * ln.wc + 16 * p + ln.srow) * LD + 16 * kk + ln.scol);
    mma(acc[2 * p], a, b[0], b[1]);
    mma(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// s = x1 y1^T and dp = x2 y2^T, 64 x 64 in fp32 over all channels; the
// caller has prefetched the first chunks. s[nt][2 h + e] is row row_of(h),
// column col_of(nt, e). Each 64-channel chunk sums into fresh accumulators
// (64 exact products), added to the running fp32 sums; channels past ch
// are zeros. Every copy has landed and the ring is free when it returns.
template <class G>
__device__ __forceinline__ void tile_products(float (&s)[G::NT][4], float (&dp)[G::NT][4], __nv_bfloat16* ring,
                                              const Rows& x1, const Rows& y1, const Rows& x2,
                                              const Rows& y2, int seq, int ch, const Lane& ln) {
  zero(s);
  zero(dp);
  const int nchunks = (ch + CK - 1) / CK;
  for (int c = 0; c < nchunks; ++c) {
    const int next = c + G::STAGES - 1;  // into the stage chunk c - 1 has freed
    if (next < nchunks) {
      __nv_bfloat16* st = ring + (next % G::STAGES) * STAGE;
      load_tile<G, CK>(st, LD, x1, seq, ch, next * CK, ln.tid);
      load_tile<G, CK>(st + CHUNK, LD, y1, seq, ch, next * CK, ln.tid);
      load_tile<G, CK>(st + 2 * CHUNK, LD, x2, seq, ch, next * CK, ln.tid);
      load_tile<G, CK>(st + 3 * CHUNK, LD, y2, seq, ch, next * CK, ln.tid);
    }
    cp_async_commit();
    cp_async_wait<G::STAGES - 1>();
    __syncthreads();
    const __nv_bfloat16* st = ring + (c % G::STAGES) * STAGE;
    float ts[G::NT][4], tdp[G::NT][4];
    zero(ts);
    zero(tdp);
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      chunk_step<G>(ts, st, st + CHUNK, kk, ln);
      chunk_step<G>(tdp, st + 2 * CHUNK, st + 3 * CHUNK, kk, ln);
    }
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] += ts[nt][e];
        dp[nt][e] += tdp[nt][e];
      }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// the three bf16 terms of v0, v1 at row r, columns col, col + 1 of the term
// tiles: hi, mid, lo, which sum to each fp32 value exactly
__device__ __forceinline__ void store_terms(__nv_bfloat16* terms, int r, int col, float v0, float v1) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(terms + t * TERM + r * LD + col) = h;
    const float2 f = __bfloat1622float2(h);
    v0 -= f.x;  // exact: the rest of a rounding to 8 bits
    v1 -= f.y;
  }
}

// the terms of a 64 x 64 tile x (the thread's fragments) into term tiles
template <class G>
__device__ __forceinline__ void store_tile_terms(__nv_bfloat16* terms, const float (&x)[G::NT][4], const Lane& ln) {
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) store_terms(terms, row_of(ln, h), col_of<G>(ln, nt, 0), x[nt][2 * h], x[nt][2 * h + 1]);
}

// acc += A B over 64 k. A: 64 rows x 64 k as TERMS bf16 term tiles, stored
// [row][k], or [k][row] where TRANS; B: a slice tile, [k][SLD]. Warp (wr, wc)
// takes rows 16 wr.. and channels 64 wc..; per 16 k the three terms sum
// into fresh accumulators (the small terms first), added to acc in fp32.
template <bool TRANS, class G>
__device__ __forceinline__ void slice_product(float (&acc)[8][4], const __nv_bfloat16* terms,
                                              const __nv_bfloat16* b, const Lane& ln) {
#pragma unroll
  for (int ks = 0; ks < TILE / 16; ++ks) {
    unsigned a[TERMS][4];
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
      if (TRANS)
        ldmatrix_x4_trans(a[t], terms + t * TERM + (16 * ks + ln.srow) * LD + 16 * ln.wr + ln.scol);
      else
        ldmatrix_x4(a[t], terms + t * TERM + (16 * ln.wr + ln.lrow) * LD + 16 * ks + ln.lcol);
    }
#pragma unroll
    for (int cg = 0; cg < 4; ++cg) {
      unsigned r[4];
      ldmatrix_x4_trans(r, b + (16 * ks + ln.lrow) * G::SLD + 64 * ln.wc + 16 * cg + ln.lcol);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = TERMS - 1; t >= 0; --t) mma(t4, a[t], r[2 * h], r[2 * h + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[2 * cg + h][e] += t4[e];
      }
    }
  }
}

// acc * scale, rounded to bf16, into a staging tile [64][SLD]
template <class G>
__device__ __forceinline__ void stage_out(__nv_bfloat16* out, const float (&acc)[8][4], float scale,
                                          const Lane& ln) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(out + row_of(ln, h) * G::SLD + 64 * ln.wc + 8 * nt + 2 * ln.t4) =
          __floats2bfloat162_rn(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
}

// a staging tile out to rows r0.. and channels c0.. of a contiguous
// [seq][ch] bf16 array, 16 bytes a piece
template <class G>
__device__ __forceinline__ void write_out(__nv_bfloat16* dst, const __nv_bfloat16* out, int r0, int c0,
                                          int seq, int ch, int tid) {
#pragma unroll
  for (int i = 0; i < TILE * G::CB / 8 / G::THREADS; ++i) {
    const int piece = tid + G::THREADS * i;
    const int r = piece / (G::CB / 8), c = (piece % (G::CB / 8)) * 8;
    if (r0 + r < seq && c0 + c < ch)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * ch + c0 + c) =
          *reinterpret_cast<const uint4*>(out + r * G::SLD + c);
  }
}

// The row statistics of a score tile whose keys start at j0: this tile's
// row max (into mx), then sum = rowsum(exp(s - m)) and dot = rowsum(dp o
// exp(s - m)) for the given m, each row's WC warps joined through red
// ([3][WC][TILE]) in warp order. Keys past seq count nothing.
template <class G>
__device__ __forceinline__ void tile_max(float (&mx)[2], const float (&s)[G::NT][4], float* red, int j0, int seq,
                                         const Lane& ln) {
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h] = -CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (j0 + col_of<G>(ln, nt, e) < seq) mx[h] = fmaxf(mx[h], s[nt][2 * h + e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    if (ln.t4 == 0) red[ln.wc * TILE + row_of(ln, h)] = mx[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = red[row_of(ln, h)];
#pragma unroll
    for (int w = 1; w < G::WC; ++w) mx[h] = fmaxf(mx[h], red[w * TILE + row_of(ln, h)]);
  }
}
template <class G>
__device__ __forceinline__ void tile_sums(float (&sum)[2], float (&dot)[2], float (&s)[G::NT][4],
                                          const float (&dp)[G::NT][4], const float (&m)[2], float* red, int j0,
                                          int seq, const Lane& ln) {
  float* red_sum = red + G::WC * TILE;
  float* red_dot = red + 2 * G::WC * TILE;
#pragma unroll
  for (int h = 0; h < 2; ++h) sum[h] = dot[h] = 0.f;
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool key = j0 + col_of<G>(ln, nt, e) < seq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = key ? expf(s[nt][2 * h + e] - m[h]) : 0.f;
        s[nt][2 * h + e] = x;
        sum[h] += x;
        dot[h] += x * dp[nt][2 * h + e];
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] = quad_sum(sum[h]);
    dot[h] = quad_sum(dot[h]);
    if (ln.t4 == 0) {
      red_sum[ln.wc * TILE + row_of(ln, h)] = sum[h];
      red_dot[ln.wc * TILE + row_of(ln, h)] = dot[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] = red_sum[row_of(ln, h)];
    dot[h] = red_dot[row_of(ln, h)];
#pragma unroll
    for (int w = 1; w < G::WC; ++w) {
      sum[h] += red_sum[w * TILE + row_of(ln, h)];
      dot[h] += red_dot[w * TILE + row_of(ln, h)];
    }
  }
}

template <class G>
__device__ __forceinline__ void scale_scores(float (&s)[G::NT][4], float scale2) {
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= scale2;
}

// ---- T <= 64: one kernel -------------------------------------------------

__global__ void __launch_bounds__(G8::THREADS, 1)
attention_bwd_one_tile_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                              __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int seq, int ch, long long stride_b,
                              long long stride_t, float scale2, int slices) {
  using G = G8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [G::STAGES][4][TILE][LD]; then the outputs
  __nv_bfloat16* sl = ring + G::STAGES * STAGE;                       // slices of dO, Q, K: [3][TILE][SLD]
  __nv_bfloat16* terms = sl + 3 * G::SLICE;                        // P, then dS: [2][TERMS][TILE][LD]
  float* red = reinterpret_cast<float*>(terms + 2 * TERMS * TERM);  // max, sum, dot: [3][WC][TILE]
  static_assert(3 * G::SLICE <= G::STAGES * STAGE, "the outputs are staged over the ring");

  const Lane ln = lane_of(threadIdx.x);
  const int slice = blockIdx.x % slices;
  const long long b = blockIdx.x / slices;
  const int cs0 = slice * G::CB;
  const long long dbase = b * seq * (long long)ch;
  const Rows qr{q + b * stride_b, stride_t, 0}, kr{k + b * stride_b, stride_t, 0},
      vr{v + b * stride_b, stride_t, 0}, dr{dout + dbase, ch, 0};

  load_slice<G>(sl, dr, seq, ch, cs0, ln.tid);
  load_slice<G>(sl + G::SLICE, qr, seq, ch, cs0, ln.tid);
  load_slice<G>(sl + 2 * G::SLICE, kr, seq, ch, cs0, ln.tid);
  cp_async_commit();
  prefetch<G>(ring, qr, kr, dr, vr, seq, ch, ln.tid);
  float s[G::NT][4], dp[G::NT][4];
  tile_products<G>(s, dp, ring, qr, kr, dr, vr, seq, ch, ln);

  // ---- the softmax and D, exact: P = exp(S - m) / l, dS = P (dP - D) ------
  scale_scores<G>(s, scale2);
  float m[2], l[2], d[2];
  tile_max<G>(m, s, red, 0, seq, ln);
  tile_sums<G>(l, d, s, dp, m, red, 0, seq, ln);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float dd = d[h] / l[h];  // rowsum(dP o P)
    const bool row = row_of(ln, h) < seq;
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = row ? s[nt][2 * h + e] / l[h] : 0.f;
        s[nt][2 * h + e] = p;
        dp[nt][2 * h + e] = p * (dp[nt][2 * h + e] - dd);
      }
  }
  store_tile_terms<G>(terms, s, ln);
  store_tile_terms<G>(terms + TERMS * TERM, dp, ln);
  __syncthreads();

  // ---- dV = P^T dO, dK = dS^T Q s^2, dQ = dS K s^2 on the slice ----------
  if (64 * ln.wc < ch - cs0) {
    float acc[8][4];
    zero(acc);
    slice_product<true, G>(acc, terms, sl, ln);
    stage_out<G>(ring, acc, 1.f, ln);
    zero(acc);
    slice_product<true, G>(acc, terms + TERMS * TERM, sl + G::SLICE, ln);
    stage_out<G>(ring + G::SLICE, acc, scale2, ln);
    zero(acc);
    slice_product<false, G>(acc, terms + TERMS * TERM, sl + 2 * G::SLICE, ln);
    stage_out<G>(ring + 2 * G::SLICE, acc, scale2, ln);
  }
  __syncthreads();
  write_out<G>(dv + dbase, ring, 0, cs0, seq, ch, ln.tid);
  write_out<G>(dk + dbase, ring + G::SLICE, 0, cs0, seq, ch, ln.tid);
  write_out<G>(dq + dbase, ring + 2 * G::SLICE, 0, cs0, seq, ch, ln.tid);
}

// ---- T > 64: 1. the row statistics m, l, D ------------------------------

__global__ void __launch_bounds__(G8::THREADS, 2)
attention_bwd_stats_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                           float* __restrict__ stats, int seq, int ch, long long stride_b,
                           long long stride_t, float scale2, long long bt) {
  using G = G8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  float* red = reinterpret_cast<float*>(ring + G::STAGES * STAGE);

  const Lane ln = lane_of(threadIdx.x);
  const int tiles = (seq + TILE - 1) / TILE;
  const long long b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * TILE;
  const Rows qr{q + b * stride_b, stride_t, q0}, dr{dout + b * seq * (long long)ch, ch, q0};
  Rows kr{k + b * stride_b, stride_t, 0}, vr{v + b * stride_b, stride_t, 0};

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  prefetch<G>(ring, qr, kr, dr, vr, seq, ch, ln.tid);
  for (int j0 = 0; j0 < seq; j0 += TILE) {
    float s[G::NT][4], dp[G::NT][4];
    tile_products<G>(s, dp, ring, qr, kr, dr, vr, seq, ch, ln);
    if (j0 + TILE < seq) {  // the next key tile's first chunks land meanwhile
      kr.r0 = vr.r0 = j0 + TILE;
      prefetch<G>(ring, qr, kr, dr, vr, seq, ch, ln.tid);
    }
    // the online softmax: l and d = rowsum(dP o exp(S - m)) rescaled by
    // exp(m_old - m_new) as the row max m grows
    scale_scores<G>(s, scale2);
    float mx[2], sum[2], dot[2];
    tile_max<G>(mx, s, red, j0, seq, ln);
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = fmaxf(m[h], mx[h]);
    tile_sums<G>(sum, dot, s, dp, mx, red, j0, seq, ln);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float fix = expf(m[h] - mx[h]);  // 0 on the first tile (m = -inf)
      l[h] = l[h] * fix + sum[h];
      d[h] = d[h] * fix + dot[h];
      m[h] = mx[h];
    }
  }
  if (ln.wc == 0 && ln.t4 == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + row_of(ln, h);
      if (row < seq) {
        const long long o = b * seq + row;
        stats[o] = m[h];
        stats[bt + o] = l[h];
        stats[2 * bt + o] = d[h] / l[h];  // rowsum(dP o P)
      }
    }
}

// ---- T > 64: 2. dK and dV of 64 keys and a channel slice ----------------

template <class G>
__global__ void __launch_bounds__(G::THREADS, 1)
attention_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int seq, int ch, long long stride_b,
                          long long stride_t, float scale2, int slices, long long bt) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // then the outputs
  __nv_bfloat16* sl = ring + G::STAGES * STAGE;                       // slices of Q, dO: [2][TILE][SLD]
  __nv_bfloat16* terms = sl + 2 * G::SLICE;                        // P^T, then dS^T: [2][TERMS][TILE][LD]
  static_assert(2 * G::SLICE <= G::STAGES * STAGE, "the outputs are staged over the ring");

  const Lane ln = lane_of(threadIdx.x);
  int bid = blockIdx.x;
  const int slice = bid % slices;
  bid /= slices;
  const int tiles = (seq + TILE - 1) / TILE;
  const long long b = bid / tiles;
  const int j0 = (bid % tiles) * TILE;
  const int cs0 = slice * G::CB;
  const long long dbase = b * seq * (long long)ch;
  const Rows kr{k + b * stride_b, stride_t, j0}, vr{v + b * stride_b, stride_t, j0};
  Rows qr{q + b * stride_b, stride_t, 0}, dr{dout + dbase, ch, 0};
  const float* st_m = stats + b * seq;
  const float* st_l = st_m + bt;
  const float* st_d = st_m + 2 * bt;
  const bool owns = 64 * ln.wc < ch - cs0;

  load_slice<G>(sl, qr, seq, ch, cs0, ln.tid);
  load_slice<G>(sl + G::SLICE, dr, seq, ch, cs0, ln.tid);
  cp_async_commit();
  prefetch<G>(ring, kr, qr, vr, dr, seq, ch, ln.tid);
  float acc_v[8][4], acc_k[8][4];
  zero(acc_v);
  zero(acc_k);
  for (int i0 = 0; i0 < seq; i0 += TILE) {
    qr.r0 = dr.r0 = i0;
    float s[G::NT][4], dp[G::NT][4];  // S^T and dP^T: keys as rows, queries as columns
    tile_products<G>(s, dp, ring, kr, qr, vr, dr, seq, ch, ln);
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + col_of<G>(ln, nt, e);
        const bool query = i < seq;
        const float mi = query ? __ldg(st_m + i) : 0.f, li = query ? __ldg(st_l + i) : 1.f,
                    di = query ? __ldg(st_d + i) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p = query && j0 + row_of(ln, h) < seq ? expf(s[nt][2 * h + e] * scale2 - mi) / li : 0.f;
          s[nt][2 * h + e] = p;
          dp[nt][2 * h + e] = p * (dp[nt][2 * h + e] - di);
        }
      }
    store_tile_terms<G>(terms, s, ln);
    store_tile_terms<G>(terms + TERMS * TERM, dp, ln);
    __syncthreads();
    const bool more = i0 + TILE < seq;
    if (more) {  // the next query tile's first chunks land during the products
      qr.r0 = dr.r0 = i0 + TILE;
      prefetch<G>(ring, kr, qr, vr, dr, seq, ch, ln.tid);
    }
    if (owns) {
      slice_product<false, G>(acc_v, terms, sl + G::SLICE, ln);         // dV += P^T dO
      slice_product<false, G>(acc_k, terms + TERMS * TERM, sl, ln);      // dK += dS^T Q
    }
    __syncthreads();  // the slices and terms are rewritten next
    if (more) {
      load_slice<G>(sl, qr, seq, ch, cs0, ln.tid);
      load_slice<G>(sl + G::SLICE, dr, seq, ch, cs0, ln.tid);
      cp_async_commit();
    }
  }
  if (owns) {
    stage_out<G>(ring, acc_v, 1.f, ln);
    stage_out<G>(ring + G::SLICE, acc_k, scale2, ln);
  }
  __syncthreads();
  write_out<G>(dv + dbase, ring, j0, cs0, seq, ch, ln.tid);
  write_out<G>(dk + dbase, ring + G::SLICE, j0, cs0, seq, ch, ln.tid);
}

// ---- T > 64: 3. dQ of 64 query rows and a channel slice -----------------

template <class G>
__global__ void __launch_bounds__(G::THREADS, 1)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int seq, int ch,
                        long long stride_b, long long stride_t, float scale2, int slices, long long bt) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // then the output
  __nv_bfloat16* sl = ring + G::STAGES * STAGE;                       // slice of K: [TILE][SLD]
  __nv_bfloat16* terms = sl + G::SLICE;                            // dS: [TERMS][TILE][LD]

  const Lane ln = lane_of(threadIdx.x);
  int bid = blockIdx.x;
  const int slice = bid % slices;
  bid /= slices;
  const int tiles = (seq + TILE - 1) / TILE;
  const long long b = bid / tiles;
  const int i0 = (bid % tiles) * TILE;
  const int cs0 = slice * G::CB;
  const long long dbase = b * seq * (long long)ch;
  const Rows qr{q + b * stride_b, stride_t, i0}, dr{dout + dbase, ch, i0};
  Rows kr{k + b * stride_b, stride_t, 0}, vr{v + b * stride_b, stride_t, 0};
  const bool owns = 64 * ln.wc < ch - cs0;

  float m[2], l[2], d[2];
  bool row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + row_of(ln, h);
    row[h] = i < seq;
    const long long o = b * seq + (row[h] ? i : 0);
    m[h] = __ldg(stats + o);
    l[h] = __ldg(stats + bt + o);
    d[h] = __ldg(stats + 2 * bt + o);
  }

  load_slice<G>(sl, kr, seq, ch, cs0, ln.tid);
  cp_async_commit();
  prefetch<G>(ring, qr, kr, dr, vr, seq, ch, ln.tid);
  float acc[8][4];
  zero(acc);
  for (int j0 = 0; j0 < seq; j0 += TILE) {
    kr.r0 = vr.r0 = j0;
    float s[G::NT][4], dp[G::NT][4];
    tile_products<G>(s, dp, ring, qr, kr, dr, vr, seq, ch, ln);
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool key = j0 + col_of<G>(ln, nt, e) < seq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p = row[h] && key ? expf(s[nt][2 * h + e] * scale2 - m[h]) / l[h] : 0.f;
          dp[nt][2 * h + e] = p * (dp[nt][2 * h + e] - d[h]);
        }
      }
    store_tile_terms<G>(terms, dp, ln);
    __syncthreads();
    const bool more = j0 + TILE < seq;
    if (more) {  // the next key tile's first chunks land during the product
      kr.r0 = vr.r0 = j0 + TILE;
      prefetch<G>(ring, qr, kr, dr, vr, seq, ch, ln.tid);
    }
    if (owns) slice_product<false, G>(acc, terms, sl, ln);  // dQ += dS K
    __syncthreads();  // the slice and terms are rewritten next
    if (more) {
      load_slice<G>(sl, kr, seq, ch, cs0, ln.tid);
      cp_async_commit();
    }
  }
  if (owns) stage_out<G>(ring, acc, scale2, ln);
  __syncthreads();
  write_out<G>(dq + dbase, ring, i0, cs0, seq, ch, ln.tid);
}

template <class G>
cudaError_t launch_grads(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         const __nv_bfloat16* dout, const float* stats, __nv_bfloat16* dq, __nv_bfloat16* dk,
                         __nv_bfloat16* dv, long long batch, int seq, int ch, long long stride_b,
                         long long stride_t, float scale2, cudaStream_t stream) {
  const int slices = (ch + G::CB - 1) / G::CB;
  const long long blocks = batch * ((seq + TILE - 1) / TILE) * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem_dkdv = G::smem(2, 2 * TERMS), smem_dq = G::smem(1, TERMS);
  static int opted_dkdv[MAX_DEVICES], opted_dq[MAX_DEVICES];
  cudaError_t err = opt_in(attention_bwd_dkdv_kernel<G>, (int)smem_dkdv, opted_dkdv);
  if (err == cudaSuccess) err = opt_in(attention_bwd_dq_kernel<G>, (int)smem_dq, opted_dq);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<G><<<(unsigned)blocks, G::THREADS, smem_dkdv, stream>>>(
      q, k, v, dout, stats, dk, dv, seq, ch, stride_b, stride_t, scale2, slices, batch * seq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<G><<<(unsigned)blocks, G::THREADS, smem_dq, stream>>>(
      q, k, v, dout, stats, dq, seq, ch, stride_b, stride_t, scale2, slices, batch * seq);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                   void* dv, float* stats, long long batch, int seq, int ch, long long stride_b,
                   long long stride_t, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  // C^-1/4 rounded once from double, as the plain version rounds a Python
  // float; s^2 likewise
  const double sd = std::pow((double)ch, -0.25);
  const float scale2 = (float)(sd * sd);
  const long long tiles = (seq + TILE - 1) / TILE;
  const bf *qp = static_cast<const bf*>(q), *kp = static_cast<const bf*>(k), *vp = static_cast<const bf*>(v),
           *dop = static_cast<const bf*>(dout);
  bf *dqp = static_cast<bf*>(dq), *dkp = static_cast<bf*>(dk), *dvp = static_cast<bf*>(dv);
  cudaError_t err;
  if (seq <= TILE) {
    const int slices = (ch + G8::CB - 1) / G8::CB;
    if (batch * slices > 0x7fffffffLL) return cudaErrorInvalidValue;
    constexpr size_t smem = G8::smem(3, 2 * TERMS);
    static int opted[MAX_DEVICES];
    err = opt_in(attention_bwd_one_tile_kernel, (int)smem, opted);
    if (err != cudaSuccess) return err;
    attention_bwd_one_tile_kernel<<<(unsigned)(batch * slices), G8::THREADS, smem, stream>>>(
        qp, kp, vp, dop, dqp, dkp, dvp, seq, ch, stride_b, stride_t, scale2, slices);
    return cudaGetLastError();
  }
  if (batch * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem_stats = G8::smem(0, 0);
  static int opted_stats[MAX_DEVICES];
  err = opt_in(attention_bwd_stats_kernel, (int)smem_stats, opted_stats);
  if (err != cudaSuccess) return err;
  attention_bwd_stats_kernel<<<(unsigned)(batch * tiles), G8::THREADS, smem_stats, stream>>>(
      qp, kp, vp, dop, stats, seq, ch, stride_b, stride_t, scale2, batch * seq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_grads<G16>(qp, kp, vp, dop, stats, dqp, dkp, dvp, batch, seq, ch, stride_b, stride_t, scale2,
                           stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int QT = 16;        // query rows per block of kernel A
constexpr int KT = 64;        // keys per tile of kernel A
constexpr int CK = 64;        // channels per shared-memory chunk in kernel A
constexpr int RT = 64;        // output rows per block of kernel B
constexpr int JT = 64;        // rows of the summed axis per tile of kernel B
constexpr int CB = 32;        // channels per block of kernel B
constexpr int THREADS = 256;  // 8 warps
constexpr int ACC = (QT * KT) / THREADS;   // tile entries per thread (A)
constexpr int ROWS = RT / (THREADS / CB);  // output rows per thread (B)

// acc[m] = sum_c x[q0 + r][c] y[j0 + j][c] (both times `scale`) for the QT x KT
// entries idx = tid + m * THREADS (r = idx / KT, j = idx % KT), streaming
// CK-channel chunks of x and y through shared memory; rows past seq are zero.
__device__ __forceinline__ void tile_products(float* acc, float* xs, float* ys, const float* x,
                                              long long x_stride, const float* y, long long y_stride,
                                              int q0, int j0, int seq, int ch, float scale, int tid) {
#pragma unroll
  for (int m = 0; m < ACC; ++m) acc[m] = 0.f;
  for (int c0 = 0; c0 < ch; c0 += CK) {
    const int cw = min(CK, ch - c0);
    for (int i = tid; i < QT * CK; i += THREADS) {
      const int r = i / CK, c = i % CK;
      const int row = q0 + r;
      xs[i] = (row < seq && c < cw) ? x[row * x_stride + c0 + c] * scale : 0.f;
    }
    for (int i = tid; i < KT * CK; i += THREADS) {
      const int j = i / CK, c = i % CK;
      const int row = j0 + j;
      ys[j * (CK + 1) + c] = (row < seq && c < cw) ? y[row * y_stride + c0 + c] * scale : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < ACC; ++m) {
      const int idx = tid + m * THREADS;
      const float* xr = xs + (idx / KT) * CK;
      const float* yj = ys + (idx % KT) * (CK + 1);
      float s = acc[m];
      for (int c = 0; c < cw; ++c) s = fmaf(xr[c], yj[c], s);
      acc[m] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
attention_bwd_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            float* __restrict__ p_out, float* __restrict__ ds_out,
                            int seq, int ch, long long stride_b, long long stride_t,
                            float scale) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [QT][CK]: q, then dO chunks
  float* ys = xs + QT * CK;         // [KT][CK + 1]: k, then v chunks
  float* tile = ys + KT * (CK + 1); // [QT][KT]: scores, then dP
  float* row_max = tile + QT * KT;  // [QT]
  float* row_sum = row_max + QT;    // [QT]
  float* row_dot = row_sum + QT;    // [QT] rowsum(dP o P)

  const int tiles = (seq + QT - 1) / QT;
  const long long b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * QT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long dstride_b = (long long)seq * ch;
  const float* qb = q + b * stride_b;
  const float* kb = k + b * stride_b;
  const float* vb = v + b * stride_b;
  const float* dob = dout + b * dstride_b;
  if (tid < QT) {
    row_max[tid] = -CUDART_INF_F;
    row_sum[tid] = 0.f;
    row_dot[tid] = 0.f;
  }
  float acc[ACC];

  // ---- pass 1: scores into the P scratch; running row max and sum --------
  for (int j0 = 0; j0 < seq; j0 += KT) {
    const int kw = min(KT, seq - j0);
    tile_products(acc, xs, ys, qb, stride_t, kb, stride_t, q0, j0, seq, ch, scale, tid);
#pragma unroll
    for (int m = 0; m < ACC; ++m) tile[tid + m * THREADS] = acc[m];
    __syncthreads();
    for (int r = warp; r < QT; r += THREADS / 32) {
      const int row = q0 + r;
      if (row >= seq) continue;
      const float* s = tile + r * KT;
      float* dst = p_out + (b * seq + row) * (long long)seq + j0;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < kw; j += 32) {
        mx = fmaxf(mx, s[j]);
        dst[j] = s[j];
      }
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(row_max[r], mx);
      float sum = 0.f;
      for (int j = lane; j < kw; j += 32) sum += expf(s[j] - m_new);
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        row_sum[r] = row_sum[r] * expf(row_max[r] - m_new) + sum;
        row_max[r] = m_new;
      }
    }
    __syncthreads();
  }

  // ---- pass 2: P = exp(S - m) / l into the scratch, dP into the dS
  //      scratch, and rowsum(dP o P) ------------------------------------------
  for (int j0 = 0; j0 < seq; j0 += KT) {
    const int kw = min(KT, seq - j0);
    tile_products(acc, xs, ys, dob, (long long)ch, vb, stride_t, q0, j0, seq, ch, 1.f, tid);
#pragma unroll
    for (int m = 0; m < ACC; ++m) tile[tid + m * THREADS] = acc[m];
    __syncthreads();
    for (int r = warp; r < QT; r += THREADS / 32) {
      const int row = q0 + r;
      if (row >= seq) continue;
      const long long base = (b * seq + row) * (long long)seq + j0;
      const float* dp = tile + r * KT;
      const float mx = row_max[r], l = row_sum[r];
      float dot = 0.f;
      for (int j = lane; j < kw; j += 32) {
        const float p = expf(p_out[base + j] - mx) / l;
        p_out[base + j] = p;
        ds_out[base + j] = dp[j];
        dot = fmaf(dp[j], p, dot);
      }
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) row_dot[r] += dot;
    }
    __syncthreads();
  }

  // ---- pass 3: dS = P (dP - rowsum(dP o P)) -------------------------------
  for (int r = warp; r < QT; r += THREADS / 32) {
    const int row = q0 + r;
    if (row >= seq) continue;
    const long long base = (b * seq + row) * (long long)seq;
    const float dot = row_dot[r];
    for (int j = lane; j < seq; j += 32) ds_out[base + j] = p_out[base + j] * (ds_out[base + j] - dot);
  }
}

__global__ void __launch_bounds__(THREADS)
attention_bwd_grads_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ dout, const float* __restrict__ p_in,
                           const float* __restrict__ ds_in, float* __restrict__ dq,
                           float* __restrict__ dk, float* __restrict__ dv, int seq, int ch,
                           long long stride_b, long long stride_t, float scale2) {
  extern __shared__ float smem[];
  float* ds_rj = smem;                 // [RT][JT + 1]: dS[r, j]
  float* ds_jr = ds_rj + RT * (JT + 1);  // [JT][RT + 1]: dS[j, r]
  float* p_jr = ds_jr + JT * (RT + 1);   // [JT][RT + 1]: P[j, r]
  float* dos = p_jr + JT * (RT + 1);     // [JT][CB]: dO[j, c]
  float* ks = dos + JT * CB;             // [JT][CB]: K[j, c]
  float* qs = ks + JT * CB;              // [JT][CB]: Q[j, c]

  const int row_tiles = (seq + RT - 1) / RT;
  const int chunks = (ch + CB - 1) / CB;
  const long long b = blockIdx.x / ((long long)row_tiles * chunks);
  const int rest = (int)(blockIdx.x % ((long long)row_tiles * chunks));
  const int r0 = (rest / chunks) * RT;
  const int c0 = (rest % chunks) * CB;
  const int cw = min(CB, ch - c0);
  const int tid = threadIdx.x;
  const long long pbase = b * seq * (long long)seq;
  const long long dbase = b * seq * (long long)ch;

  // thread -> channel c = tid % CB, rows r = tid / CB + g * (THREADS / CB)
  const int c = tid % CB;
  const int rr = tid / CB;
  constexpr int RSTEP = THREADS / CB;
  float aq[ROWS], ak[ROWS], av[ROWS];
#pragma unroll
  for (int g = 0; g < ROWS; ++g) aq[g] = ak[g] = av[g] = 0.f;

  for (int j0 = 0; j0 < seq; j0 += JT) {
    for (int i = tid; i < RT * JT; i += THREADS) {
      const int a = i / JT, e = i % JT;  // ds_rj[a][e] = dS[r0 + a, j0 + e]
      const bool in_re = r0 + a < seq && j0 + e < seq;
      ds_rj[a * (JT + 1) + e] = in_re ? ds_in[pbase + (long long)(r0 + a) * seq + j0 + e] : 0.f;
      const int j = i / RT, r = i % RT;  // [j][r] tiles: dS[j0 + j, r0 + r], P[j0 + j, r0 + r]
      const bool in_jr = j0 + j < seq && r0 + r < seq;
      const long long o = pbase + (long long)(j0 + j) * seq + r0 + r;
      ds_jr[j * (RT + 1) + r] = in_jr ? ds_in[o] : 0.f;
      p_jr[j * (RT + 1) + r] = in_jr ? p_in[o] : 0.f;
    }
    for (int i = tid; i < JT * CB; i += THREADS) {
      const int j = i / CB, cc = i % CB;
      const bool in = j0 + j < seq && cc < cw;
      const long long row = j0 + j;
      dos[i] = in ? dout[dbase + row * ch + c0 + cc] : 0.f;
      ks[i] = in ? k[b * stride_b + row * stride_t + c0 + cc] : 0.f;
      qs[i] = in ? q[b * stride_b + row * stride_t + c0 + cc] : 0.f;
    }
    __syncthreads();
    const int jw = min(JT, seq - j0);
    for (int j = 0; j < jw; ++j) {
      const float kj = ks[j * CB + c], qj = qs[j * CB + c], doj = dos[j * CB + c];
#pragma unroll
      for (int g = 0; g < ROWS; ++g) {
        const int r = rr + g * RSTEP;
        aq[g] = fmaf(ds_rj[r * (JT + 1) + j], kj, aq[g]);  // dQ[r] += dS[r, j] K[j]
        ak[g] = fmaf(ds_jr[j * (RT + 1) + r], qj, ak[g]);  // dK[r] += dS[j, r] Q[j]
        av[g] = fmaf(p_jr[j * (RT + 1) + r], doj, av[g]);  // dV[r] += P[j, r] dO[j]
      }
    }
    __syncthreads();
  }
  if (c < cw) {
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      const int r = r0 + rr + g * RSTEP;
      if (r < seq) {
        const long long o = dbase + (long long)r * ch + c0 + c;
        dq[o] = aq[g] * scale2;
        dk[o] = ak[g] * scale2;
        dv[o] = av[g];
      }
    }
  }
}

constexpr size_t SMEM_A = sizeof(float) * (QT * CK + KT * (CK + 1) + QT * KT + 3 * QT);
constexpr size_t SMEM_B = sizeof(float) * (RT * (JT + 1) + 2 * JT * (RT + 1) + 3 * JT * CB);

cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                   void* dv, float* scratch, long long batch, int seq, int ch, long long stride_b,
                   long long stride_t, cudaStream_t stream) {
  // C^-1/4 rounded once from double, as the forward kernel and the plain
  // version round a Python float; s^2 likewise
  const double s = std::pow((double)ch, -0.25);
  float* p_scratch = scratch;
  float* ds_scratch = scratch + batch * seq * (long long)seq;
  const int tiles = (seq + QT - 1) / QT;
  attention_bwd_scores_kernel<<<(unsigned)(batch * tiles), THREADS, SMEM_A, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), p_scratch, ds_scratch, seq, ch, stride_b, stride_t, (float)s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static int opted[MAX_DEVICES];
  err = opt_in(attention_bwd_grads_kernel, (int)SMEM_B, opted);
  if (err != cudaSuccess) return err;
  const long long blocks = batch * ((seq + RT - 1) / RT) * ((ch + CB - 1) / CB);
  attention_bwd_grads_kernel<<<(unsigned)blocks, THREADS, SMEM_B, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(dout),
      p_scratch, ds_scratch, static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
      seq, ch, stride_b, stride_t, (float)(s * s));
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" int c2w_attention_bwd_max_seq() { return T_MAX; }

// Shared memory does not depend on C; the grid bounds it far above any use.
extern "C" int c2w_attention_bwd_max_ch() { return 1 << 20; }

// Bytes of fp32 scratch the route needs: the fp32 route's P and dS
// ([2, B, T, T]); the bf16 route's row statistics m, l, D ([3, B, T]) where
// T > 64, else none.
extern "C" long long c2w_attention_bwd_scratch_bytes(long long batch, int seq, int dtype) {
  if (dtype == 0) return 2 * batch * (long long)seq * seq * (long long)sizeof(float);
  return seq > tc::TILE ? 3 * batch * (long long)seq * (long long)sizeof(float) : 0;
}

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). scratch:
// c2w_attention_bwd_scratch_bytes of fp32 (may be null where that is 0).
// Returns a cudaError_t (0 on success).
extern "C" int c2w_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 void* dq, void* dk, void* dv, void* scratch, long long batch, int seq,
                                 int ch, long long stride_b, long long stride_t, int dtype, void* stream) {
  if (seq < 1 || seq > T_MAX || ch < 1 || ch > c2w_attention_bwd_max_ch() || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (c2w_attention_bwd_scratch_bytes(batch, seq, dtype) > 0 && sc == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)f32::launch(q, k, v, dout, dq, dk, dv, sc, batch, seq, ch, stride_b, stride_t, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // 16-byte copies of every operand and output row
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                         reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                         reinterpret_cast<uintptr_t>(dv);
  if (ptrs % 16 || ch % 8 || stride_t % 8 || stride_b % 8) return (int)cudaErrorInvalidValue;
  return (int)tc::launch(q, k, v, dout, dq, dk, dv, sc, batch, seq, ch, stride_b, stride_t, st);
}
