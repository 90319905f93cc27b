// Fused single-head self-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel climate2weather_tpu/ops/attention.py
// `_attn_fwd_kernel` (launched by `_call_fwd`). Same function:
//
//     out = softmax((q * s)(k * s)^T) v,   s = C^-1/4,
//
// with an fp32 softmax, the products accumulated in fp32, and the result
// cast to the input type (bf16 or fp32).
//
// What bounds it here: it must read q, k and v once and write o once. On the
// UNet's level-4 attention in sampling (B = 96 windows, T = 64 tokens,
// C = 512 channels, bf16) that is 25.2 MB, about 7.5 us at 3.35 TB/s, for
// 0.8 GFLOP (32 FLOP per byte); at [32, 256, 512] (sda_unet_large's level 4
// at 256 x 256, or a training microbatch there) 33.6 MB, about 10 us, for
// 4.3 GFLOP (128 FLOP per byte). Both lie far below the card's ridge of
// ~295 bf16 FLOP per byte, so the bound is memory, and mma.sync tiles on the
// tensor cores are enough to come near it. The T <= 64 route below gives
// that up to equal the plain version: its 0.8 GFLOP of fp32 fmas on the CUDA
// cores (67 TFLOP/s) take at least 12 us.
//
// Three routes, chosen by dtype and T in the launcher:
//
// bf16, T <= 64 (the 72.1M net's level 4: sampling, predict and training):
//   the plain version's own fp32 arithmetic on the CUDA cores, so that its
//   bf16 outputs equal the plain version's. The whole-forward check of the
//   72.1M net (chip_smoke.py phase 3) allows no other: one attention output
//   moved one ulp already takes that forward's max difference to the
//   check's limit on most seeds, and either product summed in another order
//   (in float64, or on the tensor cores, which moved ~1,300 of its 18.9
//   million attention outputs) takes its mean difference to 92-100 % of the
//   limit and its max across it on some seeds. So each logit is one fmaf
//   chain over the channels of the fp32 products (q s)(k s), the row max
//   and sum are one warp's butterflies, P is normalized before P V, and each
//   output is one fmaf chain over the keys, as the plain version's cuBLAS
//   calls and reductions do. One block of (QR / RA) x 16 threads per (batch
//   element, QR query rows) holds the chunk's q s and k s transposed in
//   shared memory, so that each thread's register tile (RA rows by 4 keys,
//   then by 4 channels) takes its operands in two vector loads per 4 RA
//   fmas; the next chunk is read into registers while the current one is
//   used, and the output goes out from registers. Shared-memory loads bound
//   it, and a larger tile would need fewer threads than the SMs want: as
//   each logit is one chain, a block has no more parallel work than its
//   QR x 64 logits. QR = 32, RA = 4 where that grid gives every SM a block,
//   else QR = 16, RA = 2.
//
// bf16, T > 64 (tiny_unet at 32 x 32, sda_unet_large at 256 x 256):
//   tensor cores. One block of 8 warps per (batch element, QT = 64 query
//   rows, CB = 256 output channels). C above 256 is split over blocks, each
//   recomputing the scores (C = 512: two blocks; sda_unet_large's C = 768:
//   three), so the [64 x C] fp32 output accumulator lives in registers and
//   never in shared memory: each warp owns 32 channels of the block's slice
//   for all 64 rows (16 mma accumulators, 64 floats a thread). Keys come in
//   tiles of KT = 64. For each tile:
//   - S = q k^T on bf16 mma.sync.m16n8k16 with fp32 accumulators: the raw
//     bf16 q and k, whose products are exact in fp32, in CK = 64-channel
//     chunks; the 4 x 2 warps each own a 16 x 32 tile of S. q and k chunks
//     come through cp.async into two stages (the next chunk lands while the
//     current one is multiplied), and the V tile of the slice is copied
//     alongside; rows are padded to 144 (528) bytes so that ldmatrix reads
//     them without bank conflicts. Ragged T and C are zero-filled by the
//     copies (src-size 0) and masked in the softmax. q is read again from
//     L2 for each key tile; the next tile's first chunk is copied while the
//     current tile's P V runs.
//   - s^2 = C^-1/2 is applied to the fp32 scores, which go to shared memory
//     (over the finished stage). Four threads a row (16 keys each, reduced
//     with two quad shuffles) keep the row's running max m and sum l
//     (online softmax: the accumulators are rescaled by exp(m_old - m_new)
//     before the tile's P V).
//   - P V on the same mma, with P split into three bf16 terms, hi = bf16(p),
//     mid = bf16(p - hi), lo = bf16(p - hi - mid): the three hold every fp32
//     p exactly, and V is exact in bf16. The terms are written once per tile
//     to shared memory, where every warp reads them as A fragments for its
//     channel slice.
//   - Summation split: each mma sums into fresh zero accumulators (one
//     k-step of 16 channels in S; the three terms of 16 keys in P V), which
//     are then added to the running fp32 sums, so the tensor core's own
//     accumulation spans at most 48 exact products.
//   The output is acc / l (one reciprocal a row), rounded to bf16 and
//   written through the V tile's buffer as 16-byte rows. 99 KB of shared
//   memory and at most 128 registers a thread keep two blocks on an SM.
//   Tensor-core sums round otherwise than the plain version's sequential
//   fp32 fmas, so a bf16 output now and then lands one ulp from the plain
//   one.
//
// Both bf16 routes copy 16-byte rows: the launcher needs q, k, v and o
// aligned to 16 bytes and row strides that are multiples of 8 elements; the
// UNet's [B, T, 3C] thirds are.
//
// fp32 (the tests' and the checks' reference route; no path of the port runs
//   it): the CUDA-core kernel, exact fp32 fmas from shared memory. One block
//   per (batch element, QT in {64, 32, 16} query rows) keeps an fp32
//   accumulator [QT][C] in shared memory and streams keys in tiles of 64 with
//   the same online softmax; q and k are scaled by s on the way in. Each of
//   16 x 16 threads holds a register tile (QT/16 rows x 4 keys or channels).
//   QT is the largest whose accumulator fits and whose grid still gives
//   every SM a block. Its accumulator bounds C for every route: the launcher
//   takes C up to c2w_attention_fwd_max_ch() (3,232).
//
// T has no limit below the grid's.
//
// Interface: a plain C launcher, loaded with ctypes. q, k and v share their
// strides (batch, row; channels contiguous), so they may be the three thirds
// of one [B, T, 3C] projection. o is a contiguous [B, T, C].

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int T_MAX = 1 << 20;   // tokens: bounded by the grid only
constexpr int SMEM_MAX = 232448;  // bytes a block may use (227 KB)
constexpr int MAX_DEVICES = 64;

// The current card's SM count, asked once per card.
cudaError_t sm_count(int* sms) {
  static int counts[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!counts[dev]) err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  *sms = counts[dev];
  return err;
}

// Let `kernel` use `bytes` of dynamic shared memory on card `dev` (and, with
// `carveout`, prefer shared memory to L1), once per card and size: `opted`
// is the kernel's own record of what each card was given.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, int dev, int (&opted)[MAX_DEVICES],
                   bool carveout = false) {
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (opted[dev] >= bytes) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && carveout)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) opted[dev] = bytes;
  return err;
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

namespace tc {


constexpr int QT = 64;         // query rows per block
constexpr int KT = 64;         // keys per tile
constexpr int CK = 64;         // channels per q/k chunk
constexpr int CB = 256;        // output channels per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int WC = CB / WARPS;  // output channels per warp (32)
constexpr int LD = CK + 8;      // row stride of q, k and P tiles (bf16): 144 bytes
constexpr int VLD = CB + 8;     // row stride of the V tile (bf16): 528 bytes
constexpr int SLD = KT + 4;     // row stride of the fp32 scores
constexpr int TERMS = 3;        // bf16 terms of P

constexpr size_t QK_BYTES = 2 * 2 * QT * LD * sizeof(__nv_bfloat16);  // 2 stages of q, k
constexpr size_t V_BYTES = KT * VLD * sizeof(__nv_bfloat16);
constexpr size_t P_BYTES = TERMS * QT * LD * sizeof(__nv_bfloat16);
constexpr size_t SMEM = QK_BYTES + V_BYTES + P_BYTES + 3 * QT * sizeof(float);
static_assert(QT * SLD * sizeof(float) <= 2 * QT * LD * sizeof(__nv_bfloat16),
              "the scores must fit the first stage they overwrite");

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


// Copy the q rows of the block and the k rows of the key tile, channels
// [c0, c0 + CK), into one stage; rows and channels past the ends read zero.
__device__ __forceinline__ void load_qk(__nv_bfloat16* stage, const __nv_bfloat16* qb,
                                        const __nv_bfloat16* kb, int q0, int j0, int seq,
                                        int ch, int c0, long long stride_t, int tid) {
  __nv_bfloat16* qs = stage;
  __nv_bfloat16* ks = stage + QT * LD;
#pragma unroll
  for (int i = 0; i < QT * CK / 8 / THREADS; ++i) {
    const int piece = tid + THREADS * i;
    const int r = piece / (CK / 8), c = c0 + (piece % (CK / 8)) * 8;
    const bool qin = q0 + r < seq && c < ch, kin = j0 + r < seq && c < ch;
    cp_async16(qs + r * LD + c - c0, qin ? qb + (q0 + r) * stride_t + c : qb, qin);
    cp_async16(ks + r * LD + c - c0, kin ? kb + (j0 + r) * stride_t + c : kb, kin);
  }
}

// Two blocks an SM: at most 128 registers a thread.
__global__ void __launch_bounds__(THREADS, 2)
attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          int seq, int ch, long long stride_b, long long stride_t, float scale2,
                          int slices) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* qk = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [2 stages][q, k][QT][LD]
  float* sc = reinterpret_cast<float*>(smem_tc);                    // [QT][SLD], over stage 0
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(smem_tc + QK_BYTES);           // [KT][VLD]
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(smem_tc + QK_BYTES + V_BYTES);  // [TERMS][QT][LD]
  float* row_max = reinterpret_cast<float*>(smem_tc + QK_BYTES + V_BYTES + P_BYTES);   // [QT]
  float* row_sum = row_max + QT;
  float* row_fix = row_sum + QT;  // exp(m_old - m_new) of this tile

  int bid = blockIdx.x;
  const int slice = bid % slices;
  bid /= slices;
  const int tiles = (seq + QT - 1) / QT;
  const long long b = bid / tiles;
  const int q0 = (bid % tiles) * QT;
  const int cs0 = slice * CB, cw = min(CB, ch - cs0);  // this block's output channels
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row and column pair
  // ldmatrix row addresses: lanes 0-7, 8-15, 16-23, 24-31 give the rows of
  // the four 8 x 8 matrices
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  const int srow_b = (lane & 7) + 8 * (lane >> 4), scol_b = 8 * ((lane >> 3) & 1);
  const int nchunks = (ch + CK - 1) / CK;
  const __nv_bfloat16* qb = q + b * stride_b;
  const __nv_bfloat16* kb = k + b * stride_b;
  const __nv_bfloat16* vb = v + b * stride_b;

  // S tiles: warp (wr, wc) owns rows 16 wr.., keys 32 wc..
  const int wr = warp % 4, wc = warp / 4;
  // P V: warp owns channels [nb, nb + WC) of the slice
  const int nb = warp * WC;
  const bool owns = nb < cw;

  if (tid < QT) {
    row_max[tid] = -CUDART_INF_F;
    row_sum[tid] = 0.f;
  }
  float acc[4][WC / 8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < WC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load_qk(qk, qb, kb, q0, 0, seq, ch, 0, stride_t, tid);
  cp_async_commit();
  for (int j0 = 0; j0 < seq; j0 += KT) {
    const int kw = min(KT, seq - j0);

    // ---- the V tile of this slice, copied while the scores are formed ----
#pragma unroll
    for (int i = 0; i < KT * CB / 8 / THREADS; ++i) {
      const int piece = tid + THREADS * i;
      const int r = piece / (CB / 8), c = (piece % (CB / 8)) * 8;
      const bool in = r < kw && c < cw;
      cp_async16(vt + r * VLD + c, in ? vb + (j0 + r) * stride_t + cs0 + c : vb, in);
    }
    cp_async_commit();

    // ---- S = q k^T over channel chunks, two stages -----------------------
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      // commit order: chunk 0, V, chunk 1, chunk 2, ...
      if (c + 1 < nchunks) {
        load_qk(qk + ((c + 1) & 1) * 2 * QT * LD, qb, kb, q0, j0, seq, ch, (c + 1) * CK, stride_t, tid);
        cp_async_commit();
        if (c == 0) cp_async_wait<2>(); else cp_async_wait<1>();
      } else {
        if (c == 0) cp_async_wait<1>(); else cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* qs = qk + (c & 1) * 2 * QT * LD;
      const __nv_bfloat16* ks = qs + QT * LD;
      const int csteps = (min(CK, ch - c * CK) + 15) / 16;
      for (int kk = 0; kk < csteps; ++kk) {
        unsigned a[4], b0[4], b1[4];
        ldmatrix_x4(a, qs + (16 * wr + lrow) * LD + 16 * kk + lcol);
        ldmatrix_x4(b0, ks + (32 * wc + srow_b) * LD + 16 * kk + scol_b);
        ldmatrix_x4(b1, ks + (32 * wc + 16 + srow_b) * LD + 16 * kk + scol_b);
        // each k-step sums into fresh accumulators, added to the scores in
        // fp32: the tensor core's own accumulation then spans 16 products
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned* bk = nt < 2 ? b0 : b1;
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma(t, a, bk[2 * (nt % 2)], bk[2 * (nt % 2) + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += t[e];
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();  // the V tile

    // ---- scaled scores to shared memory, over stage 0 ---------------------
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = 16 * wr + g, key = 32 * wc + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(sc + r * SLD + key) = make_float2(s[nt][0] * scale2, s[nt][1] * scale2);
      *reinterpret_cast<float2*>(sc + (r + 8) * SLD + key) =
          make_float2(s[nt][2] * scale2, s[nt][3] * scale2);
    }
    __syncthreads();

    // ---- online softmax, four threads a row; P as three bf16 terms -------
    // thread tid takes row tid / 4 and its keys [16 (tid % 4), + 16): the
    // rows' chains run side by side, reduced over the quad with two shuffles
    {
      static_assert(QT * 4 == THREADS && KT == 4 * 16, "four threads of 16 keys a row");
      const int r = tid / 4, k0 = 16 * (tid % 4);
      const float* row = sc + r * SLD + k0;
      float x[16];
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        const float4 f = *reinterpret_cast<const float4*>(row + i);
        x[i] = f.x;
        x[i + 1] = f.y;
        x[i + 2] = f.z;
        x[i + 3] = f.w;
      }
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 16; ++i) mx = k0 + i < kw ? fmaxf(mx, x[i]) : mx;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_max[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        x[i] = k0 + i < kw ? expf(x[i] - m_new) : 0.f;
        sum += x[i];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
      for (int i = 0; i < 16; i += 8) {
        __align__(16) __nv_bfloat16 term[TERMS][8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float pv = x[i + e];
          const __nv_bfloat16 hi = __float2bfloat16(pv);
          const float rest = pv - __bfloat162float(hi);
          const __nv_bfloat16 mid = __float2bfloat16(rest);
          term[0][e] = hi;
          term[1][e] = mid;
          if (TERMS > 2) term[2][e] = __float2bfloat16(rest - __bfloat162float(mid));
        }
#pragma unroll
        for (int t = 0; t < TERMS; ++t)
          *reinterpret_cast<uint4*>(pt + t * QT * LD + r * LD + k0 + i) =
              *reinterpret_cast<const uint4*>(term[t]);
      }
      if (tid % 4 == 0) {
        const float fix = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
        row_fix[r] = fix;
        row_sum[r] = row_sum[r] * fix + sum;
        row_max[r] = m_new;
      }
    }
    __syncthreads();

    // the next tile's first chunk lands in stage 0 while P V runs
    if (j0 + KT < seq) {
      load_qk(qk, qb, kb, q0, j0 + KT, seq, ch, 0, stride_t, tid);
      cp_async_commit();
    }

    // ---- acc = acc * fix + P V on this warp's channels ---------------------
    if (owns) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float f0 = row_fix[16 * mt + g], f1 = row_fix[16 * mt + g + 8];
#pragma unroll
        for (int nt = 0; nt < WC / 8; ++nt) {
          acc[mt][nt][0] *= f0;
          acc[mt][nt][1] *= f0;
          acc[mt][nt][2] *= f1;
          acc[mt][nt][3] *= f1;
        }
      }
      const int ksteps = (kw + 15) / 16;
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned bv[WC / 8][2];
#pragma unroll
        for (int cg = 0; cg < WC / 16; ++cg) {
          unsigned r[4];
          ldmatrix_x4_trans(r, vt + (16 * ks + lrow) * VLD + nb + 16 * cg + lcol);
          bv[2 * cg][0] = r[0];
          bv[2 * cg][1] = r[1];
          bv[2 * cg + 1][0] = r[2];
          bv[2 * cg + 1][1] = r[3];
        }
        // per 16 keys, the three terms go into fresh accumulators (the
        // small terms first), which are added to acc in fp32
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          unsigned a[TERMS][4];
#pragma unroll
          for (int term = 0; term < TERMS; ++term)
            ldmatrix_x4(a[term], pt + term * QT * LD + (16 * mt + lrow) * LD + 16 * ks + lcol);
#pragma unroll
          for (int nt = 0; nt < WC / 8; ++nt) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int term = TERMS - 1; term >= 0; --term) mma(t, a[term], bv[nt][0], bv[nt][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[e];
          }
        }
      }
    }
    __syncthreads();  // V, P and the row statistics are rewritten by the next tile
  }

  // ---- out = acc / l, rounded to bf16, through the V tile's buffer --------
  // (the key loop's last barrier freed it): 16-byte rows out to o
  if (owns) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        const float inv_l = 1.f / row_sum[r];  // one division a row
#pragma unroll
        for (int nt = 0; nt < WC / 8; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(vt + r * VLD + nb + 8 * nt + 2 * t4) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h] * inv_l, acc[mt][nt][2 * h + 1] * inv_l);
      }
  }
  __syncthreads();
  __nv_bfloat16* ob = o + b * (long long)seq * ch + cs0;
#pragma unroll
  for (int i = 0; i < QT * CB / 8 / THREADS; ++i) {
    const int piece = tid + THREADS * i;
    const int r = piece / (CB / 8), c = (piece % (CB / 8)) * 8;
    if (q0 + r < seq && c < cw)
      *reinterpret_cast<uint4*>(ob + (long long)(q0 + r) * ch + c) =
          *reinterpret_cast<const uint4*>(vt + r * VLD + c);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o, long long batch, int seq,
                   int ch, long long stride_b, long long stride_t, cudaStream_t stream) {
  // s = C^-1/4 rounded once from double, as the reference rounds a Python
  // float; the scores take s^2
  const float scale = (float)std::pow((double)ch, -0.25);
  const int slices = (ch + CB - 1) / CB;
  const long long blocks = batch * ((seq + QT - 1) / QT) * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  static int opted[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = opt_in(attention_fwd_bf16_kernel, (int)SMEM, dev, opted, true);
  if (err != cudaSuccess) return err;
  attention_fwd_bf16_kernel<<<(unsigned)blocks, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq, ch, stride_b,
      stride_t, scale * scale, slices);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16 route where every key fits one tile (T <= 64): the plain version's
// fp32 arithmetic on the CUDA cores
// ---------------------------------------------------------------------------

namespace chain {

constexpr int KT = 64;        // keys: all of them
constexpr int CK = 64;        // channels per shared-memory chunk
constexpr int KLD = KT + 4;   // row stride (floats) of kT[c][j] and of the V chunk [j][c]

template <int QR>
struct Layout {
  static constexpr int QLD = QR + 4;  // row stride of qT[c][r] and pT[j][r]
  static constexpr int SLD = KT + 1;  // row stride of the scores
  // q s chunk [CK][QLD], k s chunk [CK][KLD] (then V), scores [QR][SLD], P [KT][QLD]
  static constexpr size_t BYTES = sizeof(float) * (CK * QLD + CK * KLD + QR * SLD + KT * QLD);
};

// N consecutive floats of shared memory, in one load
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  static_assert(N == 2 || N == 4, "two or four floats");
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  }
}

__device__ __forceinline__ void unpack8(float (&f)[8], uint4 u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p, bool in) {
  return in ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

// One block per (batch element, QR query rows). Each sum runs in the plain
// version's order: the logits as one fmaf chain over the channels of the
// fp32 products (q s)(k s), the row sum as one warp's butterfly, P V as one
// fmaf chain over the keys.
template <int QR, int RA>
__global__ void __launch_bounds__(QR / RA * 16)
attention_fwd_chain_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int seq, int ch, long long stride_b, long long stride_t, float scale) {
  // (QR / RA) x 16 threads: ty takes RA rows, tx 4 keys (then 4 channels)
  constexpr int THREADS = QR / RA * 16;
  constexpr int QLD = Layout<QR>::QLD, SLD = Layout<QR>::SLD;
  constexpr int QPIECES = QR * CK / 8, KPIECES = KT * CK / 8;  // 16-byte pieces of a chunk
  constexpr int QP = (QPIECES + THREADS - 1) / THREADS, KP = KPIECES / THREADS;
  extern __shared__ __align__(16) float smem_chain[];
  float* qT = smem_chain;    // [CK][QLD] q s of the chunk, transposed
  float* kT = qT + CK * QLD;  // [CK][KLD] k s of the chunk, transposed; then V [KT][KLD]
  float* sc = kT + CK * KLD;  // [QR][SLD] scores
  float* pT = sc + QR * SLD;  // [KT][QLD] P, transposed

  const int tiles = (seq + QR - 1) / QR;
  const long long b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * QR;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, warp = tid / 32, lane = tid % 32;
  const int nchunks = (ch + CK - 1) / CK;
  const __nv_bfloat16* qb = q + b * stride_b;
  const __nv_bfloat16* kb = k + b * stride_b;
  const __nv_bfloat16* vb = v + b * stride_b;

  // ---- logits: each a chain of fmaf over the channels, chunk by chunk ----
  // The next chunk is read into registers while the current one is used;
  // pieces go row-fastest so that the transposed stores miss no bank.
  uint4 qreg[QP], kreg[KP];
  auto fetch_qk = [&](int c0) {
#pragma unroll
    for (int i = 0; i < QP; ++i) {
      const int piece = tid + THREADS * i, r = piece % QR, c = c0 + piece / QR * 8;
      qreg[i] = load16(qb + (q0 + r) * stride_t + c, piece < QPIECES && q0 + r < seq && c < ch);
    }
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      const int piece = tid + THREADS * i, j = piece % KT, c = c0 + piece / KT * 8;
      kreg[i] = load16(kb + j * stride_t + c, j < seq && c < ch);
    }
  };
  float s[RA][4];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int n = 0; n < 4; ++n) s[a][n] = 0.f;
  fetch_qk(0);
  for (int chunk = 0; chunk < nchunks; ++chunk) {
#pragma unroll
    for (int i = 0; i < QP; ++i) {
      const int piece = tid + THREADS * i, r = piece % QR, c = piece / QR * 8;
      float f[8];
      unpack8(f, qreg[i]);
      if (piece < QPIECES)
#pragma unroll
        for (int e = 0; e < 8; ++e) qT[(c + e) * QLD + r] = f[e] * scale;
    }
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      const int piece = tid + THREADS * i, j = piece % KT, c = piece / KT * 8;
      float f[8];
      unpack8(f, kreg[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) kT[(c + e) * KLD + j] = f[e] * scale;
    }
    __syncthreads();
    if (chunk + 1 < nchunks) fetch_qk((chunk + 1) * CK);
    const int cw = min(CK, ch - chunk * CK);  // a multiple of 8
    for (int c0 = 0; c0 < cw; c0 += 8) {
#pragma unroll
      for (int c = c0; c < c0 + 8; ++c) {  // 8 steps: their loads go out ahead
        float qv[RA], kv[4];
        lds(qv, qT + c * QLD + ty * RA);
        lds(kv, kT + c * KLD + tx * 4);
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int n = 0; n < 4; ++n) s[a][n] = fmaf(qv[a], kv[n], s[a][n]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int n = 0; n < 4; ++n) sc[(ty * RA + a) * SLD + tx * 4 + n] = s[a][n];

  // the first V chunk is read while the softmax runs: 8 pieces a key row
  uint4 vreg[KP];
  auto fetch_v = [&](int c0) {
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      const int piece = tid + THREADS * i, j = piece / (CK / 8), c = c0 + piece % (CK / 8) * 8;
      vreg[i] = load16(vb + j * stride_t + c, j < seq && c < ch);
    }
  };
  fetch_v(0);
  __syncthreads();

  // ---- softmax, one warp a row: P = exp(x - max) / sum, normalized --------
  for (int r = warp; r < QR; r += THREADS / 32) {
    const float* row = sc + r * SLD;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < seq; j += 32) mx = fmaxf(mx, row[j]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float e[2], sum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      e[i] = j < seq ? expf(row[j] - mx) : 0.f;
      sum += e[i];
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      pT[j * QLD + r] = j < seq ? e[i] / sum : 0.f;
    }
  }

  // ---- P V: each output a chain of fmaf over the keys, chunk by chunk -----
  float* vs = kT;
  __nv_bfloat16* ob = o + b * (long long)seq * ch;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      const int piece = tid + THREADS * i, j = piece / (CK / 8), c = piece % (CK / 8) * 8;
      float f[8];
      unpack8(f, vreg[i]);
      *reinterpret_cast<float4*>(vs + j * KLD + c) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(vs + j * KLD + c + 4) = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();  // (the first time, also the softmax's P)
    if (chunk + 1 < nchunks) fetch_v((chunk + 1) * CK);
    float acc[RA][4];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[a][n] = 0.f;
    // keys in steps of 8: P and V are zero past seq, where fmaf(0, 0, acc)
    // leaves acc as it is
    for (int j0 = 0; j0 < seq; j0 += 8) {
#pragma unroll
      for (int j = j0; j < j0 + 8; ++j) {
        float p[RA], vv[4];
        lds(p, pT + j * QLD + ty * RA);
        lds(vv, vs + j * KLD + tx * 4);
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[a][n] = fmaf(p[a], vv[n], acc[a][n]);
      }
    }
    const int c = chunk * CK + tx * 4;
    if (c < ch)
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int row = q0 + ty * RA + a;
        if (row < seq) {
          __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(acc[a][0], acc[a][1]),
                                    __floats2bfloat162_rn(acc[a][2], acc[a][3])};
          *reinterpret_cast<uint2*>(ob + (long long)row * ch + c) = *reinterpret_cast<const uint2*>(pair);
        }
      }
    __syncthreads();
  }
}

template <int QR, int RA>
cudaError_t launch_qr(const void* q, const void* k, const void* v, void* o, long long batch,
                      int seq, int ch, long long stride_b, long long stride_t, int dev,
                      cudaStream_t stream) {
  constexpr size_t smem = Layout<QR>::BYTES;
  static int opted[MAX_DEVICES];
  const cudaError_t err = opt_in(attention_fwd_chain_kernel<QR, RA>, (int)smem, dev, opted);
  if (err != cudaSuccess) return err;
  // C^-1/4 rounded once from double, as the reference rounds a Python float
  const float scale = (float)std::pow((double)ch, -0.25);
  const long long blocks = batch * ((seq + QR - 1) / QR);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_fwd_chain_kernel<QR, RA><<<(unsigned)blocks, QR / RA * 16, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq, ch, stride_b,
      stride_t, scale);
  return cudaGetLastError();
}

// 32 query rows a block in tiles of 4 rows (128 threads) where that grid
// gives every SM a block (sampling's 96 windows of 64 tokens: 192 blocks),
// else 16 rows in tiles of 2 (128 threads; a training microbatch of 32:
// 128 blocks). Both are phase 2's timed rows.
cudaError_t launch(const void* q, const void* k, const void* v, void* o, long long batch, int seq,
                   int ch, long long stride_b, long long stride_t, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (batch * ((seq + 31) / 32) >= sms)
    return launch_qr<32, 4>(q, k, v, o, batch, seq, ch, stride_b, stride_t, dev, stream);
  return launch_qr<16, 2>(q, k, v, o, batch, seq, ch, stride_b, stride_t, dev, stream);
}

}  // namespace chain

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int KT = 64;        // keys per tile
constexpr int CK = 64;        // channels per shared-memory chunk
constexpr int THREADS = 256;  // a 16 x 16 grid: rows (ty) by keys or channels (tx)

size_t smem_bytes(int qt, int ch) {
  // output accumulator [qt][ch], q chunk [qt][CK + 1], K or V chunk
  // [KT][CK + 1], scores [qt][KT + 1], and per-row max, sum and rescale
  return sizeof(float) *
         ((size_t)qt * ch + qt * (CK + 1) + KT * (CK + 1) + qt * (KT + 1) + 3 * qt);
}

template <int QT>
__global__ void __launch_bounds__(THREADS)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int seq, int ch,
                         long long stride_b, long long stride_t, float scale) {
  constexpr int RA = QT / 16;        // rows of a thread's register tile
  extern __shared__ float smem[];
  float* acc = smem;                 // [QT][ch] output accumulator
  float* qs = acc + QT * ch;         // [QT][CK + 1] scaled q chunk
  float* kv = qs + QT * (CK + 1);    // [KT][CK + 1] K, then V chunk
  float* sc = kv + KT * (CK + 1);    // [QT][KT + 1] scores, then P
  float* row_max = sc + QT * (KT + 1);  // [QT]
  float* row_sum = row_max + QT;     // [QT]
  float* row_fix = row_sum + QT;     // [QT] exp(m_old - m_new) of this tile

  const int tiles = (seq + QT - 1) / QT;
  const long long b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * QT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const bool one_tile = seq <= KT;   // P is normalized before P V, l = 1
  const float* qb = q + b * stride_b;
  const float* kb = k + b * stride_b;
  const float* vb = v + b * stride_b;

  for (int i = tid; i < QT * ch; i += THREADS) acc[i] = 0.f;
  if (tid < QT) {
    row_max[tid] = -CUDART_INF_F;
    row_sum[tid] = 0.f;
  }

  const int warp = tid / 32, lane = tid % 32;
  for (int j0 = 0; j0 < seq; j0 += KT) {
    const int kw = min(KT, seq - j0);

    // ---- scores of this key tile: S = (q s)(k s)^T over channel chunks --
    float s[RA][4];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int c0 = 0; c0 < ch; c0 += CK) {
      const int cw = min(CK, ch - c0);
      for (int i = tid; i < QT * CK; i += THREADS) {
        const int r = i / CK, c = i % CK;
        const int row = q0 + r;
        qs[r * (CK + 1) + c] = (row < seq && c < cw) ? qb[row * stride_t + c0 + c] * scale : 0.f;
      }
      for (int i = tid; i < KT * CK; i += THREADS) {
        const int j = i / CK, c = i % CK;
        kv[j * (CK + 1) + c] = (j < kw && c < cw) ? kb[(j0 + j) * stride_t + c0 + c] * scale : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < cw; ++c) {
        float qv[RA], kk[4];
#pragma unroll
        for (int a = 0; a < RA; ++a) qv[a] = qs[(ty + 16 * a) * (CK + 1) + c];
#pragma unroll
        for (int n = 0; n < 4; ++n) kk[n] = kv[(tx + 16 * n) * (CK + 1) + c];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int n = 0; n < 4; ++n) s[a][n] = fmaf(qv[a], kk[n], s[a][n]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int n = 0; n < 4; ++n) sc[(ty + 16 * a) * (KT + 1) + tx + 16 * n] = s[a][n];
    __syncthreads();

    // ---- online softmax, one warp per row -----------------------------
    for (int r = warp; r < QT; r += THREADS / 32) {
      float* row = sc + r * (KT + 1);
      float mx = -CUDART_INF_F;
      for (int j = lane; j < kw; j += 32) mx = fmaxf(mx, row[j]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_max[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < KT; j += 32) {
        const float e = j < kw ? expf(row[j] - m_new) : 0.f;
        row[j] = e;
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (one_tile)
        for (int j = lane; j < kw; j += 32) row[j] = row[j] / sum;
      if (lane == 0) {
        const float fix = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
        row_fix[r] = fix;
        row_sum[r] = one_tile ? 1.f : row_sum[r] * fix + sum;
        row_max[r] = m_new;
      }
    }
    __syncthreads();

    // ---- acc = acc * fix + P V over channel chunks ----------------------
    for (int c0 = 0; c0 < ch; c0 += CK) {
      const int cw = min(CK, ch - c0);
      for (int i = tid; i < KT * CK; i += THREADS) {
        const int j = i / CK, c = i % CK;
        kv[j * (CK + 1) + c] = (j < kw && c < cw) ? vb[(j0 + j) * stride_t + c0 + c] : 0.f;
      }
      __syncthreads();
      float pv[RA][4];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int n = 0; n < 4; ++n) pv[a][n] = 0.f;
      for (int j = 0; j < kw; ++j) {
        float p[RA], vv[4];
#pragma unroll
        for (int a = 0; a < RA; ++a) p[a] = sc[(ty + 16 * a) * (KT + 1) + j];
#pragma unroll
        for (int n = 0; n < 4; ++n) vv[n] = kv[j * (CK + 1) + tx + 16 * n];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int n = 0; n < 4; ++n) pv[a][n] = fmaf(p[a], vv[n], pv[a][n]);
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = tx + 16 * n;
          if (c < cw) {
            float* dst = acc + r * ch + c0 + c;
            *dst = fmaf(*dst, row_fix[r], pv[a][n]);
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- out = acc / l ------------------------------------------------------
  float* ob = o + b * (long long)seq * ch;
  for (int i = tid; i < QT * ch; i += THREADS) {
    const int r = i / ch, c = i % ch;
    const int row = q0 + r;
    if (row < seq) ob[(long long)row * ch + c] = acc[i] / row_sum[r];
  }
}

// Query rows per block: the largest of 64, 32, 16 whose accumulator fits
// and whose grid still gives every SM a block.
int pick_qt(long long batch, int seq, int ch, int sms) {
  for (int qt = 64; qt > 16; qt /= 2)
    if (smem_bytes(qt, ch) <= (size_t)SMEM_MAX && batch * ((seq + qt - 1) / qt) >= sms) return qt;
  return 16;
}

template <int QT>
cudaError_t launch_qt(const void* q, const void* k, const void* v, void* o, long long batch,
                      int seq, int ch, long long stride_b, long long stride_t, cudaStream_t stream) {
  const size_t smem = smem_bytes(QT, ch);
  static int opted[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = opt_in(attention_fwd_f32_kernel<QT>, (int)smem, dev, opted);
  if (err != cudaSuccess) return err;
  // C^-1/4 rounded once from double, as the reference rounds a Python float
  const float scale = (float)std::pow((double)ch, -0.25);
  const long long blocks = batch * ((seq + QT - 1) / QT);
  attention_fwd_f32_kernel<QT><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), seq, ch, stride_b, stride_t, scale);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o, long long batch, int seq,
                   int ch, long long stride_b, long long stride_t, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  switch (pick_qt(batch, seq, ch, sms)) {
    case 64: return launch_qt<64>(q, k, v, o, batch, seq, ch, stride_b, stride_t, stream);
    case 32: return launch_qt<32>(q, k, v, o, batch, seq, ch, stride_b, stride_t, stream);
    default: return launch_qt<16>(q, k, v, o, batch, seq, ch, stride_b, stride_t, stream);
  }
}

}  // namespace f32

}  // namespace

extern "C" int c2w_attention_fwd_max_seq() { return T_MAX; }

// The most channels the fp32 route's shared memory holds; the launcher takes
// no more in either dtype.
extern "C" int c2w_attention_fwd_max_ch() {
  int c = 8;
  while (f32::smem_bytes(16, c + 8) <= (size_t)SMEM_MAX) c += 8;
  return c;
}

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (T <= 64: the chain kernel on
// the CUDA cores; longer T: tensor cores). Returns a cudaError_t (0 on success).
extern "C" int c2w_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 long long batch, int seq, int ch, long long stride_b,
                                 long long stride_t, int dtype, void* stream) {
  if (seq < 1 || seq > T_MAX || ch < 1 || ch % 8 || batch < 1 || ch > c2w_attention_fwd_max_ch())
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)f32::launch(q, k, v, o, batch, seq, ch, stride_b, stride_t, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // both bf16 kernels copy 16-byte rows
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (ptrs % 16 || stride_t % 8 || stride_b % 8) return (int)cudaErrorInvalidValue;
  if (seq <= chain::KT) return (int)chain::launch(q, k, v, o, batch, seq, ch, stride_b, stride_t, s);
  return (int)tc::launch(q, k, v, o, batch, seq, ch, stride_b, stride_t, s);
}
