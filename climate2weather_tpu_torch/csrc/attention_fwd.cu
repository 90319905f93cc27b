// Fused single-head self-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel climate2weather_tpu/ops/attention.py
// `_attn_fwd_kernel` (launched by `_call_fwd`). Same arithmetic:
//
//     out = softmax((q * s)(k * s)^T) v,   s = C^-1/4,
//
// with q and k scaled in fp32 before the product, QK^T accumulated in fp32,
// an fp32 softmax, PV accumulated in fp32, and the result cast to the input
// type (fp32 or bf16).
//
// What bounds it here: on the UNet's level-4 attention (B = 96 windows,
// T = 64 tokens, C = 512 channels, bf16) it reads q, k, v once (18.9 MB) and
// writes o once (6.3 MB): about 7.5 us at 3.35 TB/s. Its 0.8 GFLOP would take
// about 0.8 us on the tensor cores, so the bound is memory. At T = 256 and
// beyond the T^2 C products grow faster than the bytes, and on the CUDA
// cores the products are what bound it.
//
// Design: the Pallas body holds the whole [T, C] tile in VMEM; a Hopper block
// cannot at long T. One block per (batch element, tile of QT query rows)
// keeps an fp32 output accumulator [QT][C] in shared memory and streams the
// keys in tiles of KT = 64: for each tile it forms the QT x KT scores over
// channel chunks of CK (q and K chunks through shared memory, scaled in
// fp32 on the way in), updates each row's running max m and sum l (online
// softmax: the old accumulator and sum are rescaled by exp(m_old - m_new)),
// and adds P V, streaming V through the same buffer. The output is the
// accumulator over l. Where all keys fit one tile (T <= 64, the UNet's
// level 4) P is normalized before P V, as the Pallas body does, and l is 1.
// Shared memory grows with QT C, not with T, so there is no token limit
// below the grid's.
//
// The products run on the CUDA cores in fp32 from shared memory, and the
// shared-memory loads bound them: the 16 x 16 threads of a block each hold a
// register tile of QT / 16 rows x 4 keys (or 4 channels in P V), so a
// QT = 64 block does 16 fmas per 8 loads. K and V are read once per query
// tile. The launcher takes the largest QT in {64, 32, 16} whose accumulator
// fits and that still gives every SM a block (B ceil(T / QT) >= SMs): few
// query tiles read K and V few times and reuse more registers, and an SM
// left without a block idles. wgmma and TMA are later work.
//
// Interface: a plain C launcher, loaded with ctypes. q, k and v share their
// strides (batch, row; channels contiguous), so they may be the three thirds
// of one [B, T, 3C] projection. o is a contiguous [B, T, C].

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int KT = 64;        // keys per tile
constexpr int CK = 64;        // channels per shared-memory chunk
constexpr int THREADS = 256;  // a 16 x 16 grid: rows (ty) by keys or channels (tx)
constexpr int T_MAX = 1 << 20;                 // tokens: bounded by the grid only
constexpr int SMEM_MAX = 232448;               // bytes a block may use (227 KB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int qt, int ch) {
  // output accumulator [qt][ch], q chunk [qt][CK + 1], K or V chunk
  // [KT][CK + 1], scores [qt][KT + 1], and per-row max, sum and rescale
  return sizeof(float) *
         ((size_t)qt * ch + qt * (CK + 1) + KT * (CK + 1) + qt * (KT + 1) + 3 * qt);
}

template <typename T, int QT>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int seq,
                     int ch, long long stride_b, long long stride_t,
                     float scale) {
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
  const T* qb = q + b * stride_b;
  const T* kb = k + b * stride_b;
  const T* vb = v + b * stride_b;

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
        qs[r * (CK + 1) + c] =
            (row < seq && c < cw) ? to_f32(qb[row * stride_t + c0 + c]) * scale : 0.f;
      }
      for (int i = tid; i < KT * CK; i += THREADS) {
        const int j = i / CK, c = i % CK;
        kv[j * (CK + 1) + c] =
            (j < kw && c < cw) ? to_f32(kb[(j0 + j) * stride_t + c0 + c]) * scale : 0.f;
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
        kv[j * (CK + 1) + c] = (j < kw && c < cw) ? to_f32(vb[(j0 + j) * stride_t + c0 + c]) : 0.f;
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
  T* ob = o + b * (long long)seq * ch;
  for (int i = tid; i < QT * ch; i += THREADS) {
    const int r = i / ch, c = i % ch;
    const int row = q0 + r;
    if (row < seq) ob[(long long)row * ch + c] = from_f32<T>(acc[i] / row_sum[r]);
  }
}

// Query rows per block: the largest of 64, 32, 16 whose accumulator fits
// and whose grid still gives every SM a block.
int pick_qt(long long batch, int seq, int ch, int sms) {
  for (int qt = 64; qt > 16; qt /= 2)
    if (smem_bytes(qt, ch) <= (size_t)SMEM_MAX && batch * ((seq + qt - 1) / qt) >= sms) return qt;
  return 16;
}

template <typename T, int QT>
cudaError_t launch_qt(const void* q, const void* k, const void* v, void* o,
                      long long batch, int seq, int ch, long long stride_b,
                      long long stride_t, cudaStream_t stream) {
  const size_t smem = smem_bytes(QT, ch);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // C^-1/4 rounded once from double, as the reference rounds a Python float
  const float scale = (float)std::pow((double)ch, -0.25);
  const long long blocks = batch * ((seq + QT - 1) / QT);
  attention_fwd_kernel<T, QT><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, ch, stride_b, stride_t, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long batch, int seq, int ch, long long stride_b,
                   long long stride_t, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  switch (pick_qt(batch, seq, ch, sms)) {
    case 64: return launch_qt<T, 64>(q, k, v, o, batch, seq, ch, stride_b, stride_t, stream);
    case 32: return launch_qt<T, 32>(q, k, v, o, batch, seq, ch, stride_b, stride_t, stream);
    default: return launch_qt<T, 16>(q, k, v, o, batch, seq, ch, stride_b, stride_t, stream);
  }
}

}  // namespace

extern "C" int c2w_attention_fwd_max_seq() { return T_MAX; }

// The most channels a block's shared memory holds.
extern "C" int c2w_attention_fwd_max_ch() {
  int c = 8;
  while (smem_bytes(16, c + 8) <= (size_t)SMEM_MAX) c += 8;
  return c;
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int c2w_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, long long batch, int seq, int ch,
                                 long long stride_b, long long stride_t,
                                 int dtype, void* stream) {
  if (seq < 1 || seq > T_MAX || ch < 1 || batch < 1 || smem_bytes(16, ch) > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, o, batch, seq, ch, stride_b, stride_t, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(q, k, v, o, batch, seq, ch, stride_b, stride_t, s);
  return (int)cudaErrorInvalidValue;
}
