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
// q, k, v and dO once (8.4 MB) and write dQ, dK and dV once (6.3 MB): about
// 4.4 us at 3.35 TB/s. Its 0.67 GFLOP would take under 1 us on the tensor
// cores, so the bound is memory. On the CUDA cores the products bound it.
//
// Design: the Pallas body holds the whole [T, C] tile of four operands in
// VMEM, 128 KB each at C = 512 in fp32; a Hopper block cannot. The work is
// split in two kernels at the point where the reduction over C ends, with
// an fp32 [B, T, T] scratch for P and one for dS between them (the only
// term in T^2):
//
//   A. one block per (batch element, QT query rows). It walks the keys in
//      tiles of KT, streaming q and k through shared memory in CK-channel
//      chunks: pass 1 forms the scores, keeps each row's running max and
//      sum (online softmax) and parks the scores in the P scratch; pass 2
//      turns them into P, forms dP = dO V^T the same way, and accumulates
//      rowsum(dP o P); pass 3 writes dS. Its shared memory does not grow
//      with T (22 KB).
//   B. one block per (batch element, RT rows, CB channels). It walks the
//      other T axis in tiles of JT, loading the RT x JT and JT x RT tiles of
//      P and dS it needs and the JT x CB slices of dO, K and Q, and forms
//      the RT x CB slices of dV, dQ and dK in registers. Its shared memory
//      does not grow with T either (75 KB).
//
// T is bounded by the scratch the caller allocates (2 B T^2 fp32), not by
// shared memory; the launcher takes T up to T_MAX. The products run on the
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
constexpr int KT = 64;        // keys per tile of kernel A
constexpr int CK = 64;        // channels per shared-memory chunk in kernel A
constexpr int RT = 64;        // output rows per block of kernel B
constexpr int JT = 64;        // rows of the summed axis per tile of kernel B
constexpr int CB = 32;        // channels per block of kernel B
constexpr int THREADS = 256;  // 8 warps
constexpr int T_MAX = 8192;   // tokens (the scratch is 2 B T^2 fp32)
constexpr int ACC = (QT * KT) / THREADS;       // tile entries per thread (A)
constexpr int ROWS = RT / (THREADS / CB);      // output rows per thread (B)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc[m] = sum_c x[q0 + r][c] y[j0 + j][c] (both times `scale`) for the QT x KT
// entries idx = tid + m * THREADS (r = idx / KT, j = idx % KT), streaming
// CK-channel chunks of x and y through shared memory; rows past seq are zero.
template <typename T>
__device__ __forceinline__ void tile_products(float* acc, float* xs, float* ys, const T* x,
                                              long long x_stride, const T* y, long long y_stride,
                                              int q0, int j0, int seq, int ch, float scale,
                                              int tid) {
#pragma unroll
  for (int m = 0; m < ACC; ++m) acc[m] = 0.f;
  for (int c0 = 0; c0 < ch; c0 += CK) {
    const int cw = min(CK, ch - c0);
    for (int i = tid; i < QT * CK; i += THREADS) {
      const int r = i / CK, c = i % CK;
      const int row = q0 + r;
      xs[i] = (row < seq && c < cw) ? to_f32(x[row * x_stride + c0 + c]) * scale : 0.f;
    }
    for (int i = tid; i < KT * CK; i += THREADS) {
      const int j = i / CK, c = i % CK;
      const int row = j0 + j;
      ys[j * (CK + 1) + c] = (row < seq && c < cw) ? to_f32(y[row * y_stride + c0 + c]) * scale : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_bwd_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
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
  const T* qb = q + b * stride_b;
  const T* kb = k + b * stride_b;
  const T* vb = v + b * stride_b;
  const T* dob = dout + b * dstride_b;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_bwd_grads_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ dout, const float* __restrict__ p_in,
                           const float* __restrict__ ds_in, T* __restrict__ dq,
                           T* __restrict__ dk, T* __restrict__ dv, int seq, int ch,
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
      dos[i] = in ? to_f32(dout[dbase + row * ch + c0 + cc]) : 0.f;
      ks[i] = in ? to_f32(k[b * stride_b + row * stride_t + c0 + cc]) : 0.f;
      qs[i] = in ? to_f32(q[b * stride_b + row * stride_t + c0 + cc]) : 0.f;
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
        dq[o] = from_f32<T>(aq[g] * scale2);
        dk[o] = from_f32<T>(ak[g] * scale2);
        dv[o] = from_f32<T>(av[g]);
      }
    }
  }
}

size_t smem_a() { return sizeof(float) * (QT * CK + KT * (CK + 1) + QT * KT + 3 * QT); }
size_t smem_b() { return sizeof(float) * (RT * (JT + 1) + 2 * JT * (RT + 1) + 3 * JT * CB); }

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, float* p_scratch, float* ds_scratch, long long batch,
                   int seq, int ch, long long stride_b, long long stride_t, cudaStream_t stream) {
  // C^-1/4 rounded once from double, as the forward kernel and the plain
  // version round a Python float; s^2 likewise
  const double s = std::pow((double)ch, -0.25);
  const int tiles = (seq + QT - 1) / QT;
  attention_bwd_scores_kernel<T><<<(unsigned)(batch * tiles), THREADS, smem_a(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), p_scratch, ds_scratch, seq, ch, stride_b, stride_t,
      (float)s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_grads_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b());
  if (err != cudaSuccess) return err;
  const long long blocks = batch * ((seq + RT - 1) / RT) * ((ch + CB - 1) / CB);
  attention_bwd_grads_kernel<T><<<(unsigned)blocks, THREADS, smem_b(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(dout),
      p_scratch, ds_scratch, static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), seq,
      ch, stride_b, stride_t, (float)(s * s));
  return cudaGetLastError();
}

}  // namespace

extern "C" int c2w_attention_bwd_max_seq() { return T_MAX; }

// Shared memory does not depend on C; the grid bounds it far above any use.
extern "C" int c2w_attention_bwd_max_ch() { return 1 << 20; }

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
