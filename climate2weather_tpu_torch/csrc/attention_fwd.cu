// Fused single-head self-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel climate2weather_tpu/ops/attention.py
// `_attn_fwd_kernel` (launched by `_call_fwd`). Same arithmetic:
//
//     out = softmax((q * s)(k * s)^T) v,   s = C^-1/4,
//
// with q and k scaled in fp32 before the product, QK^T accumulated in fp32,
// a row-max-subtracted fp32 softmax, PV accumulated in fp32, and the result
// cast to the input type (fp32 or bf16).
//
// What bounds it here: on the UNet's level-4 attention (B = 96 windows,
// T = 64 tokens, C = 512 channels, bf16) it reads q, k, v once (18.9 MB) and
// writes o once (6.3 MB): about 7.5 us at 3.35 TB/s. Its 0.8 GFLOP would take
// about 0.8 us on the tensor cores, so the bound is memory.
//
// Design: one block per (batch element, tile of QT query rows), so B = 96
// gives 384 blocks over the 132 SMs. The block streams its q tile and all of
// K through shared memory in chunks of CK channels (converted to fp32 and
// scaled on the way in), keeps the QT x T score tile in shared memory, runs
// the softmax there with one warp per row, then streams V through the same
// buffer to form the output tile. K and V are read once per query tile
// (4 times per batch element at T = 64), mostly from L2. The products run on
// the CUDA cores in fp32; wgmma and TMA are later work.
//
// Interface: a plain C launcher, loaded with ctypes. q, k and v share their
// strides (batch, row; channels contiguous), so they may be the three thirds
// of one [B, T, 3C] projection. o is a contiguous [B, T, C].

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int QT = 16;        // query rows per block
constexpr int CK = 64;        // channels per shared-memory chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int T_MAX = 128;    // keys per block: bounds shared memory (45 KB)
constexpr int ACC = (QT * T_MAX) / THREADS;  // score entries per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int seq,
                     int ch, long long stride_b, long long stride_t,
                     float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [QT][CK]
  float* kv = qs + QT * CK;            // [seq][CK + 1], K then V chunks
  float* sc = kv + seq * (CK + 1);     // [QT][seq] scores, then P

  const int tiles = (seq + QT - 1) / QT;
  const long long b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * QT;
  const int tid = threadIdx.x;
  const T* qb = q + b * stride_b;
  const T* kb = k + b * stride_b;
  const T* vb = v + b * stride_b;

  // ---- scores: S = (q s)(k s)^T over channel chunks ----------------------
  float acc[ACC];
#pragma unroll
  for (int m = 0; m < ACC; ++m) acc[m] = 0.f;
  const int n_scores = QT * seq;

  for (int c0 = 0; c0 < ch; c0 += CK) {
    const int cw = min(CK, ch - c0);
    for (int i = tid; i < QT * CK; i += THREADS) {
      const int r = i / CK, c = i % CK;
      const int row = q0 + r;
      qs[i] = (row < seq && c < cw) ? to_f32(qb[row * stride_t + c0 + c]) * scale : 0.f;
    }
    for (int i = tid; i < seq * CK; i += THREADS) {
      const int j = i / CK, c = i % CK;
      kv[j * (CK + 1) + c] = (c < cw) ? to_f32(kb[j * stride_t + c0 + c]) * scale : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < ACC; ++m) {
      const int idx = tid + m * THREADS;
      if (idx < n_scores) {
        const int r = idx / seq, j = idx % seq;
        const float* qr = qs + r * CK;
        const float* kj = kv + j * (CK + 1);
        float s = acc[m];
        for (int c = 0; c < cw; ++c) s = fmaf(qr[c], kj[c], s);
        acc[m] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < ACC; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < n_scores) sc[idx] = acc[m];
  }
  __syncthreads();

  // ---- softmax over keys, one warp per row -------------------------------
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < QT; r += THREADS / 32) {
    float* row = sc + r * seq;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < seq; j += 32) mx = fmaxf(mx, row[j]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < seq; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  // ---- output: O = P V over channel chunks -------------------------------
  T* ob = o + b * (long long)seq * ch;
  for (int c0 = 0; c0 < ch; c0 += CK) {
    const int cw = min(CK, ch - c0);
    for (int i = tid; i < seq * CK; i += THREADS) {
      const int j = i / CK, c = i % CK;
      kv[j * (CK + 1) + c] = (c < cw) ? to_f32(vb[j * stride_t + c0 + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < QT * CK; i += THREADS) {
      const int r = i / CK, c = i % CK;
      const int row = q0 + r;
      if (row < seq && c < cw) {
        const float* p = sc + r * seq;
        float s = 0.f;
        for (int j = 0; j < seq; ++j) s = fmaf(p[j], kv[j * (CK + 1) + c], s);
        ob[(long long)row * ch + c0 + c] = from_f32<T>(s);
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long batch, int seq, int ch, long long stride_b,
                   long long stride_t, cudaStream_t stream) {
  const int tiles = (seq + QT - 1) / QT;
  const size_t smem = sizeof(float) * (QT * CK + seq * (CK + 1) + QT * seq);
  // C^-1/4 rounded once from double, as the reference rounds a Python float
  const float scale = (float)std::pow((double)ch, -0.25);
  attention_fwd_kernel<T><<<(unsigned)(batch * tiles), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, ch, stride_b, stride_t, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int c2w_attention_fwd_max_seq() { return T_MAX; }

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int c2w_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, long long batch, int seq, int ch,
                                 long long stride_b, long long stride_t,
                                 int dtype, void* stream) {
  if (seq < 1 || seq > T_MAX || ch < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, o, batch, seq, ch, stride_b, stride_t, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(q, k, v, o, batch, seq, ch, stride_b, stride_t, s);
  return (int)cudaErrorInvalidValue;
}
