// Fused single-head self-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel climate2weather_tpu/ops/attention.py
// `_attn_bwd_kernel` (launched by `_call_bwd`, reached through the custom
// VJP `_bwd`). Same arithmetic, all in fp32 inside:
//
//     P  = softmax((q s)(k s)^T),  s = C^-1/4    (recomputed, not saved)
//     dV = P^T dO
//     dP = dO V^T
//     dS = P o (dP - rowsum(dP o P))
//     dQ = dS K s^2,   dK = dS^T Q s^2           (K, Q unscaled)
//
// with the outputs cast to the input type (fp32 or bf16).
//
// What bounds it here: on the UNet's level-4 attention during training
// (B = 32 microbatch, T = 64 tokens, C = 512 channels, bf16) it must read
// q, k, v and dO once (8.4 MB), write dQ, dK and dV once (6.3 MB) and pass
// P and dS through an fp32 scratch (1 MB each way): about 4.4 us at
// 3.35 TB/s. Its 0.67 GFLOP would take under 1 us on the tensor cores, so
// the bound is memory.
//
// Design: the Pallas body holds the whole [T, C] tile of four operands in
// VMEM, 128 KB each at C = 512 in fp32; a Hopper block cannot. The work is
// split in two kernels at the point where the reduction over C ends:
//
//   A. one block per (batch element, QT query rows). It streams q, k through
//      shared memory in CK-channel chunks to form the QT x T scores, takes
//      the softmax, then streams dO and V the same way to form dP, and
//      writes P and dS for its rows to an fp32 [B, T, T] scratch.
//   B. one block per (batch element, CB channels). It loads P and dS of its
//      batch element into shared memory and the CB-channel slices of dO, K
//      and Q, and forms the CB-channel slices of dV, dQ and dK.
//
// At B = 32 that is 128 blocks for A and 512 for B. The products run on the
// CUDA cores in fp32, as in the forward kernel; wgmma and TMA are later
// work.
//
// Interface: a plain C launcher, loaded with ctypes. q, k and v share their
// strides (batch, row; channels contiguous), so they may be the three thirds
// of one [B, T, 3C] projection. dO, dQ, dK and dV are contiguous [B, T, C];
// the scratch is two contiguous fp32 [B, T, T] arrays given by the caller.

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int QT = 16;        // query rows per block of kernel A
constexpr int CK = 64;        // channels per shared-memory chunk in kernel A
constexpr int CB = 32;        // channels per block of kernel B
constexpr int THREADS = 256;  // 8 warps
constexpr int T_MAX = 128;    // tokens: bounds shared memory (B: 178 KB)
constexpr int ACC = (QT * T_MAX) / THREADS;   // score entries per thread (A)
constexpr int ROWS = T_MAX / (THREADS / CB);  // output rows per thread (B)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc[m] += sum_c a[r][c] * b[j][c] over one chunk, for the QT x seq entries
// idx = tid + m * THREADS (r = idx / seq, j = idx % seq).
__device__ __forceinline__ void tile_products(float* acc, const float* a, const float* b,
                                              int seq, int cw, int tid) {
#pragma unroll
  for (int m = 0; m < ACC; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < QT * seq) {
      const int r = idx / seq, j = idx % seq;
      const float* ar = a + r * CK;
      const float* bj = b + j * (CK + 1);
      float s = acc[m];
      for (int c = 0; c < cw; ++c) s = fmaf(ar[c], bj[c], s);
      acc[m] = s;
    }
  }
}

// Loads rows q0..q0+QT of x (row stride stride_t) and all seq rows of y,
// channels c0..c0+cw, into shared memory as fp32 times `scale`; rows past
// seq and channels past cw are zero.
template <typename T>
__device__ __forceinline__ void load_chunk(float* xs, float* ys, const T* x, long long x_stride,
                                           const T* y, long long y_stride, int q0, int seq,
                                           int c0, int cw, float scale, int tid) {
  for (int i = tid; i < QT * CK; i += THREADS) {
    const int r = i / CK, c = i % CK;
    const int row = q0 + r;
    xs[i] = (row < seq && c < cw) ? to_f32(x[row * x_stride + c0 + c]) * scale : 0.f;
  }
  for (int i = tid; i < seq * CK; i += THREADS) {
    const int j = i / CK, c = i % CK;
    ys[j * (CK + 1) + c] = (c < cw) ? to_f32(y[j * y_stride + c0 + c]) * scale : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_bwd_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            float* __restrict__ p_out, float* __restrict__ ds_out,
                            int seq, int ch, long long stride_b, long long stride_t,
                            float scale) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [QT][CK]: q, then dO chunks
  float* ys = xs + QT * CK;         // [seq][CK + 1]: k, then v chunks
  float* pt = ys + seq * (CK + 1);  // [QT][seq]: scores, then P
  float* dp = pt + QT * seq;        // [QT][seq]: dP

  const int tiles = (seq + QT - 1) / QT;
  const long long b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * QT;
  const int tid = threadIdx.x;
  const long long dstride_b = (long long)seq * ch;

  // ---- S = (q s)(k s)^T --------------------------------------------------
  float acc[ACC];
#pragma unroll
  for (int m = 0; m < ACC; ++m) acc[m] = 0.f;
  for (int c0 = 0; c0 < ch; c0 += CK) {
    const int cw = min(CK, ch - c0);
    load_chunk(xs, ys, q + b * stride_b, stride_t, k + b * stride_b, stride_t, q0, seq, c0, cw,
               scale, tid);
    __syncthreads();
    tile_products(acc, xs, ys, seq, cw, tid);
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < ACC; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < QT * seq) pt[idx] = acc[m];
  }

  // ---- dP = dO V^T -------------------------------------------------------
#pragma unroll
  for (int m = 0; m < ACC; ++m) acc[m] = 0.f;
  for (int c0 = 0; c0 < ch; c0 += CK) {
    const int cw = min(CK, ch - c0);
    load_chunk(xs, ys, dout + b * dstride_b, (long long)ch, v + b * stride_b, stride_t, q0, seq,
               c0, cw, 1.f, tid);
    __syncthreads();
    tile_products(acc, xs, ys, seq, cw, tid);
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < ACC; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < QT * seq) dp[idx] = acc[m];
  }
  __syncthreads();

  // ---- softmax, then dS = P (dP - rowsum(dP P)); one warp per row --------
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < QT; r += THREADS / 32) {
    const int row = q0 + r;
    if (row >= seq) continue;
    float* prow = pt + r * seq;
    const float* dprow = dp + r * seq;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < seq; j += 32) mx = fmaxf(mx, prow[j]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    float dot = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float p = prow[j] / sum;
      prow[j] = p;
      dot = fmaf(dprow[j], p, dot);
    }
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const long long base = (b * seq + row) * (long long)seq;
    for (int j = lane; j < seq; j += 32) {
      const float p = prow[j];
      p_out[base + j] = p;
      ds_out[base + j] = p * (dprow[j] - dot);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_bwd_grads_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ dout, const float* __restrict__ p_in,
                           const float* __restrict__ ds_in, T* __restrict__ dq,
                           T* __restrict__ dk, T* __restrict__ dv, int seq, int ch,
                           long long stride_b, long long stride_t, float scale2) {
  extern __shared__ float smem[];
  const int pitch = seq + 1;
  float* ps = smem;                // [seq][seq + 1]: P
  float* dss = ps + seq * pitch;   // [seq][seq + 1]: dS
  float* dos = dss + seq * pitch;  // [seq][CB]: dO slice
  float* ks = dos + seq * CB;      // [seq][CB]: K slice
  float* qs = ks + seq * CB;       // [seq][CB]: Q slice

  const int chunks = (ch + CB - 1) / CB;
  const long long b = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * CB;
  const int cw = min(CB, ch - c0);
  const int tid = threadIdx.x;
  const long long pbase = b * seq * (long long)seq;
  const long long dbase = b * seq * (long long)ch;

  for (int i = tid; i < seq * seq; i += THREADS) {
    const int r = i / seq, j = i % seq;
    ps[r * pitch + j] = p_in[pbase + i];
    dss[r * pitch + j] = ds_in[pbase + i];
  }
  for (int i = tid; i < seq * CB; i += THREADS) {
    const int j = i / CB, c = i % CB;
    const bool in = c < cw;
    dos[i] = in ? to_f32(dout[dbase + (long long)j * ch + c0 + c]) : 0.f;
    ks[i] = in ? to_f32(k[b * stride_b + j * stride_t + c0 + c]) : 0.f;
    qs[i] = in ? to_f32(q[b * stride_b + j * stride_t + c0 + c]) : 0.f;
  }
  __syncthreads();

  // thread -> channel c = tid % CB, rows r = tid / CB + g * (THREADS / CB)
  const int c = tid % CB;
  const int r0 = tid / CB;
  constexpr int RSTEP = THREADS / CB;
  float aq[ROWS], ak[ROWS], av[ROWS];
#pragma unroll
  for (int g = 0; g < ROWS; ++g) aq[g] = ak[g] = av[g] = 0.f;
  for (int j = 0; j < seq; ++j) {
    const float kj = ks[j * CB + c], qj = qs[j * CB + c], doj = dos[j * CB + c];
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      const int r = r0 + g * RSTEP;
      if (r < seq) {
        aq[g] = fmaf(dss[r * pitch + j], kj, aq[g]);   // dQ[r] += dS[r, j] K[j]
        ak[g] = fmaf(dss[j * pitch + r], qj, ak[g]);   // dK[r] += dS[j, r] Q[j]
        av[g] = fmaf(ps[j * pitch + r], doj, av[g]);   // dV[r] += P[j, r] dO[j]
      }
    }
  }
  if (c < cw) {
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      const int r = r0 + g * RSTEP;
      if (r < seq) {
        const long long o = dbase + (long long)r * ch + c0 + c;
        dq[o] = from_f32<T>(aq[g] * scale2);
        dk[o] = from_f32<T>(ak[g] * scale2);
        dv[o] = from_f32<T>(av[g]);
      }
    }
  }
}

size_t smem_a(int seq) { return sizeof(float) * (QT * CK + seq * (CK + 1) + 2 * QT * seq); }
size_t smem_b(int seq) { return sizeof(float) * (2 * seq * (seq + 1) + 3 * seq * CB); }

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, float* p_scratch, float* ds_scratch, long long batch,
                   int seq, int ch, long long stride_b, long long stride_t, cudaStream_t stream) {
  // C^-1/4 rounded once from double, as the forward kernel and the plain
  // version round a Python float; s^2 likewise
  const double s = std::pow((double)ch, -0.25);
  const size_t sa = smem_a(seq), sb = smem_b(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_scores_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_grads_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb);
  if (err != cudaSuccess) return err;
  const int tiles = (seq + QT - 1) / QT;
  attention_bwd_scores_kernel<T><<<(unsigned)(batch * tiles), THREADS, sa, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), p_scratch, ds_scratch, seq, ch, stride_b, stride_t,
      (float)s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = (ch + CB - 1) / CB;
  attention_bwd_grads_kernel<T><<<(unsigned)(batch * chunks), THREADS, sb, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(dout),
      p_scratch, ds_scratch, static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), seq,
      ch, stride_b, stride_t, (float)(s * s));
  return cudaGetLastError();
}

}  // namespace

extern "C" int c2w_attention_bwd_max_seq() { return T_MAX; }

// dtype: 0 = float32, 1 = bfloat16. p_scratch and ds_scratch: fp32
// [batch, seq, seq] each. Returns a cudaError_t (0 on success).
extern "C" int c2w_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 void* dq, void* dk, void* dv, void* p_scratch,
                                 void* ds_scratch, long long batch, int seq, int ch,
                                 long long stride_b, long long stride_t, int dtype,
                                 void* stream) {
  if (seq < 1 || seq > T_MAX || ch < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(p_scratch);
  float* dss = static_cast<float*>(ds_scratch);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, dout, dq, dk, dv, ps, dss, batch, seq, ch, stride_b,
                              stride_t, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, ps, dss, batch, seq, ch,
                                      stride_b, stride_t, st);
  return (int)cudaErrorInvalidValue;
}
