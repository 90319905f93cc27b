// Fused channel norm, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's `channel_norm`
// (climate2weather_tpu/models/unet.py) is plain jnp, and XLA fuses the add
// of the block's projection, the statistics and the epilogue into one pass
// on the TPU. The port ran it as seven PyTorch passes (the broadcast add, a
// cast to fp32, a mean, a variance, a broadcast subtract and multiply, a cast
// back), four of them on TensorIterator's non-vectorised path. Same function:
//
//     h = round(x + shift)                      (shift optional, [B, C])
//     y = (h - mean(h)) * rsqrt(var(h, ddof) + eps)
//
// over the channel axis of each row, the add rounded to x's type as
// `x + proj` rounds it, mean and variance in fp32, y in x's type (bf16 or
// fp32). The backward gives, for the upstream dy,
//
//     dh = rstd * (dy - mean(dy) - xhat * sum(dy * xhat) / (C - ddof))
//
// with xhat = (h - mean) * rstd recomputed from x, shift and the saved fp32
// mean and rstd of each row.
//
// What bounds it: bytes. The UNet hands its activations over channels-last,
// so a row is C contiguous values (C = 128 to 768), and the op reads x once
// and writes y once (the backward reads dy and x and writes dh), at 1 to 3
// flops a byte, far below the card's ~295 bf16 flops a byte. One sampling
// forward of the 72.1M net at 480 windows normalises 9.22e9 values: 36.9 GB
// read and written in bf16, 11.0 ms at 3.35 TB/s.
//
// What the design does about it:
// - One pass over the data. A group of G lanes owns one row (G a power of
//   two up to 32 dividing the row's 16-byte vectors, so that each lane holds
//   V <= 8 of them: C = 128 bf16 is 16 lanes of one vector, C = 256 a warp
//   of one, C = 384 16 lanes of three, C = 768 a warp of three). Every load
//   and store is 16 bytes, neighbouring lanes on neighbouring addresses, so
//   a group's access is one run of contiguous sectors. The row stays in
//   registers between the load and the store.
// - Exact two-pass statistics on those registers: the mean, then the
//   centred sum of squares, each summed in fp32 over the lane's values and
//   reduced across the group with xor shuffles. No value is read twice from
//   memory, and no floating-point atomic is used, so a rerun gives the same
//   bits.
// - The shift row (the block's projection, C values per batch element) is
//   read once per row through the read-only path, where the rows of one
//   batch element, all neighbours, find it cached.
// - Blocks of 256 threads walk the rows in a grid-stride loop, a group one
//   row a step, as many blocks as the card holds at once (the kernel's
//   occupancy, asked once per card), so no wave runs part-empty. Loading two
//   or four rows a group before the first reduction took more registers and
//   so fewer warps an SM, and ran 25-40 % slower at level 0. The loop runs
//   the same count on every lane of a warp, so the shuffles take the full
//   mask; a lane past the last row computes on zeros and stores nothing.
// - The forward writes the fp32 mean and rstd of each row only when asked
//   (for the backward, 8 bytes a row); sampling asks for none.
// Rows whose C is not a multiple of a vector, or whose pointers are not
// 16-byte aligned, take a scalar route: one warp a row, striding over the
// channels, reading the row three times (mostly from L1). No path of the
// port's configurations takes it.
//
// Interface: plain C launchers, loaded with ctypes. x, y, dy and dh are
// [rows, C] with rows dense (the caller's channel axis innermost); shift is
// [B, C] contiguous with row r taking shift row r / rows_per_batch. The
// launchers launch on the given stream, allocate nothing and return
// cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int V_MAX = 8;  // 16-byte vectors a lane holds on the vector route
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

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// Values of T in 16 bytes
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// The four 32-bit words of a 16-byte vector as floats (a bf16 word holds two
// values, the first in its low half) and back.
__device__ __forceinline__ void unpack_word(unsigned w, float* out, __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack_word(unsigned w, float* out, float) { out[0] = __uint_as_float(w); }
__device__ __forceinline__ unsigned pack_word(const float* in, __nv_bfloat16) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(in[0])) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(in[1])) << 16);
}
__device__ __forceinline__ unsigned pack_word(const float* in, float) { return __float_as_uint(in[0]); }

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  constexpr int W = Vec<T>::N / 4;  // values a word
  unpack_word(raw.x, out, T());
  unpack_word(raw.y, out + W, T());
  unpack_word(raw.z, out + 2 * W, T());
  unpack_word(raw.w, out + 3 * W, T());
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* in) {
  constexpr int W = Vec<T>::N / 4;
  return make_uint4(pack_word(in, T()), pack_word(in + W, T()), pack_word(in + 2 * W, T()),
                    pack_word(in + 3 * W, T()));
}

// Sum over the G lanes of a group (G a power of two; groups aligned in the
// warp, so xor offsets below G stay inside the group).
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) { return group_sum(v, 32); }

// The batch element of row `row`: 32-bit division where both fit.
__device__ __forceinline__ long long batch_of(long long row, long long rows_per_batch) {
  if (row <= 0xffffffffLL && rows_per_batch <= 0xffffffffLL)
    return (long long)((unsigned)row / (unsigned)rows_per_batch);
  return row / rows_per_batch;
}

// The row h = round(x + shift) of one group into registers: lane `sub` of the
// group holds the vectors sub, sub + G, ..., sub + (V - 1) G of the row.
template <typename T, int V>
__device__ __forceinline__ void load_row(float* h, const T* __restrict__ x, const T* __restrict__ shift,
                                         long long row, long long rows_per_batch, int ch, int sub, int g) {
  constexpr int N = Vec<T>::N;
  const uint4* src = reinterpret_cast<const uint4*>(x + row * ch);
#pragma unroll
  for (int v = 0; v < V; ++v) unpack<T>(src[sub + v * g], h + v * N);
  if (shift != nullptr) {
    const uint4* s = reinterpret_cast<const uint4*>(shift + batch_of(row, rows_per_batch) * ch);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float sv[N];
      unpack<T>(__ldg(s + sub + v * g), sv);
#pragma unroll
      for (int i = 0; i < N; ++i) h[v * N + i] = to_float(from_float<T>(h[v * N + i] + sv[i]));
    }
  }
}

// ---------------------------------------------------------------------------
// vector route: G lanes a row, V 16-byte vectors a lane, the row in registers
// ---------------------------------------------------------------------------

// A warp takes 32 / G consecutive rows a step, one a group; the warps stride
// over the rows. The step count is the same on every lane of a warp.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
channel_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ shift, long long rows_per_batch,
                        T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
                        long long rows, int ch, int g, float dof, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);
  const int per_warp = 32 / g;
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * (THREADS / 32) * per_warp;
  for (long long r0 = warp * per_warp; r0 < rows; r0 += step) {
    const long long row = r0 + lane / g;
    const bool live = row < rows;
    float h[V * N];
    if (live) {
      load_row<T, V>(h, x, shift, row, rows_per_batch, ch, sub, g);
    } else {
#pragma unroll
      for (int i = 0; i < V * N; ++i) h[i] = 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V * N; ++i) s += h[i];
    const float mean = group_sum(s, g) / (float)ch;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V * N; ++i) {
      const float d = h[i] - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(group_sum(q, g) / dof + eps);
    if (!live) continue;
    uint4* dst = reinterpret_cast<uint4*>(y + row * ch);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i) o[i] = (h[v * N + i] - mean) * rstd;
      dst[sub + v * g] = pack<T>(o);
    }
    if (mean_out != nullptr && sub == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
channel_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ shift,
                        long long rows_per_batch, const float* __restrict__ mean_in,
                        const float* __restrict__ rstd_in, T* __restrict__ dh, long long rows, int ch, int g,
                        float dof) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);
  const int per_warp = 32 / g;
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * (THREADS / 32) * per_warp;
  for (long long r0 = warp * per_warp; r0 < rows; r0 += step) {
    const long long row = r0 + lane / g;
    const bool live = row < rows;
    float xh[V * N], d[V * N];
    float mean = 0.f, rstd = 0.f;
    if (live) {
      load_row<T, V>(xh, x, shift, row, rows_per_batch, ch, sub, g);
      const uint4* src = reinterpret_cast<const uint4*>(dy + row * ch);
#pragma unroll
      for (int v = 0; v < V; ++v) unpack<T>(src[sub + v * g], d + v * N);
      mean = mean_in[row];
      rstd = rstd_in[row];
    } else {
#pragma unroll
      for (int i = 0; i < V * N; ++i) xh[i] = d[i] = 0.f;
    }
    float sd = 0.f, sdx = 0.f;
#pragma unroll
    for (int i = 0; i < V * N; ++i) {
      xh[i] = (xh[i] - mean) * rstd;
      sd += d[i];
      sdx += d[i] * xh[i];
    }
    const float mean_d = group_sum(sd, g) / (float)ch;
    const float proj = group_sum(sdx, g) / dof;
    if (!live) continue;
    uint4* dst = reinterpret_cast<uint4*>(dh + row * ch);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i) o[i] = rstd * (d[v * N + i] - mean_d - xh[v * N + i] * proj);
      dst[sub + v * g] = pack<T>(o);
    }
  }
}

// ---------------------------------------------------------------------------
// scalar route: one warp a row, any C and alignment
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float h_at(const T* __restrict__ xr, const T* __restrict__ sr, int c) {
  const float v = to_float(xr[c]);
  return sr == nullptr ? v : to_float(from_float<T>(v + to_float(sr[c])));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
channel_norm_fwd_scalar_kernel(const T* __restrict__ x, const T* __restrict__ shift, long long rows_per_batch,
                               T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
                               long long rows, int ch, float dof, float eps) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * (THREADS / 32);
  for (long long row = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32; row < rows; row += stride) {
    const T* xr = x + row * ch;
    const T* sr = shift == nullptr ? nullptr : shift + batch_of(row, rows_per_batch) * ch;
    float s = 0.f;
    for (int c = lane; c < ch; c += 32) s += h_at(xr, sr, c);
    const float mean = warp_sum(s) / (float)ch;
    float q = 0.f;
    for (int c = lane; c < ch; c += 32) {
      const float d = h_at(xr, sr, c) - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / dof + eps);
    for (int c = lane; c < ch; c += 32) y[row * ch + c] = from_float<T>((h_at(xr, sr, c) - mean) * rstd);
    if (mean_out != nullptr && lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
channel_norm_bwd_scalar_kernel(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ shift,
                               long long rows_per_batch, const float* __restrict__ mean_in,
                               const float* __restrict__ rstd_in, T* __restrict__ dh, long long rows, int ch,
                               float dof) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * (THREADS / 32);
  for (long long row = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32; row < rows; row += stride) {
    const T* xr = x + row * ch;
    const T* dr = dy + row * ch;
    const T* sr = shift == nullptr ? nullptr : shift + batch_of(row, rows_per_batch) * ch;
    const float mean = mean_in[row], rstd = rstd_in[row];
    float sd = 0.f, sdx = 0.f;
    for (int c = lane; c < ch; c += 32) {
      const float d = to_float(dr[c]);
      sd += d;
      sdx += d * ((h_at(xr, sr, c) - mean) * rstd);
    }
    const float mean_d = warp_sum(sd) / (float)ch;
    const float proj = warp_sum(sdx) / dof;
    for (int c = lane; c < ch; c += 32) {
      const float xhat = (h_at(xr, sr, c) - mean) * rstd;
      dh[row * ch + c] = from_float<T>(rstd * (to_float(dr[c]) - mean_d - xhat * proj));
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The vector route's lanes a row (G) and vectors a lane (V) for C channels of
// T, or V = 0 where the row does not split into 16-byte vectors that way.
template <typename T>
void vector_split(int ch, int* g, int* v) {
  constexpr int N = Vec<T>::N;
  *g = 0;
  *v = 0;
  if (ch % N) return;
  const int nvec = ch / N;
  for (int gg = 32; gg >= 1; gg >>= 1) {
    if (nvec % gg == 0 && nvec / gg <= V_MAX) {
      *g = gg;
      *v = nvec / gg;
      return;
    }
  }
}

// Launch `Kernel` with blocks enough for `rows` at `rows_per_block` a block
// and step, but no more than the card holds at once (asked once per card):
// the grid-stride loop takes the rest, and no wave of blocks runs part-empty.
template <auto Kernel, typename... Args>
cudaError_t launch(long long rows, int rows_per_block, cudaStream_t stream, Args... args) {
  static int resident[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int sms = 0, per_sm = 0;
    err = sm_count(&sms);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (rows + rows_per_block - 1) / rows_per_block;
  const int blocks = (int)(want < resident[dev] ? want : resident[dev]);
  Kernel<<<blocks, THREADS, 0, stream>>>(args...);
  return cudaGetLastError();
}

#define C2W_FOR_V(MACRO)                   \
  switch (v) {                             \
    case 1: return MACRO(1);               \
    case 2: return MACRO(2);               \
    case 3: return MACRO(3);               \
    case 4: return MACRO(4);               \
    case 5: return MACRO(5);               \
    case 6: return MACRO(6);               \
    case 7: return MACRO(7);               \
    case 8: return MACRO(8);               \
    default: return cudaErrorInvalidValue; \
  }

template <typename T>
cudaError_t launch_fwd(const T* x, const T* shift, long long rows_per_batch, T* y, float* mean, float* rstd,
                       long long rows, int ch, float dof, float eps, cudaStream_t stream) {
  int g = 0, v = 0;
  vector_split<T>(ch, &g, &v);
  if (!aligned16(x) || !aligned16(y) || (shift != nullptr && !aligned16(shift))) v = 0;
  if (v == 0)
    return launch<channel_norm_fwd_scalar_kernel<T>>(rows, THREADS / 32, stream, x, shift, rows_per_batch, y,
                                                     mean, rstd, rows, ch, dof, eps);
#define C2W_FWD(V)                                                                                   \
  launch<channel_norm_fwd_kernel<T, V>>(rows, THREADS / g, stream, x, shift, rows_per_batch, y, mean, rstd, \
                                        rows, ch, g, dof, eps)
  C2W_FOR_V(C2W_FWD)
#undef C2W_FWD
}

template <typename T>
cudaError_t launch_bwd(const T* dy, const T* x, const T* shift, long long rows_per_batch, const float* mean,
                       const float* rstd, T* dh, long long rows, int ch, float dof, cudaStream_t stream) {
  int g = 0, v = 0;
  vector_split<T>(ch, &g, &v);
  if (!aligned16(dy) || !aligned16(x) || !aligned16(dh) || (shift != nullptr && !aligned16(shift))) v = 0;
  if (v == 0)
    return launch<channel_norm_bwd_scalar_kernel<T>>(rows, THREADS / 32, stream, dy, x, shift, rows_per_batch,
                                                     mean, rstd, dh, rows, ch, dof);
#define C2W_BWD(V)                                                                                   \
  launch<channel_norm_bwd_kernel<T, V>>(rows, THREADS / g, stream, dy, x, shift, rows_per_batch, mean, rstd, \
                                        dh, rows, ch, g, dof)
  C2W_FOR_V(C2W_BWD)
#undef C2W_BWD
}

#undef C2W_FOR_V

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. shift may be null (no add); mean and rstd
// may both be null (statistics not kept). Returns a cudaError_t (0 on
// success).
extern "C" int c2w_channel_norm_fwd(const void* x, const void* shift, long long rows_per_batch, void* y,
                                    void* mean, void* rstd, long long rows, int ch, int ddof, float eps, int dtype,
                                    void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (rows < 0 || ch < 1 || ddof < 0 || (shift != nullptr && rows_per_batch < 1) ||
      ((mean == nullptr) != (rstd == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  const float dof = (float)(ch - ddof);
  if (dtype == 0)
    return (int)launch_fwd(static_cast<const float*>(x), static_cast<const float*>(shift), rows_per_batch,
                           static_cast<float*>(y), m, r, rows, ch, dof, eps, s);
  if (dtype == 1)
    return (int)launch_fwd(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(shift),
                           rows_per_batch, static_cast<__nv_bfloat16*>(y), m, r, rows, ch, dof, eps, s);
  return (int)cudaErrorInvalidValue;
}

// dh (x's type, x's layout) of the forward at x (+ shift) for the upstream dy,
// from the forward's saved fp32 mean and rstd of each row.
extern "C" int c2w_channel_norm_bwd(const void* dy, const void* x, const void* shift, long long rows_per_batch,
                                    const void* mean, const void* rstd, void* dh, long long rows, int ch, int ddof,
                                    int dtype, void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (rows < 0 || ch < 1 || ddof < 0 || (shift != nullptr && rows_per_batch < 1) || mean == nullptr ||
      rstd == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float dof = (float)(ch - ddof);
  if (dtype == 0)
    return (int)launch_bwd(static_cast<const float*>(dy), static_cast<const float*>(x),
                           static_cast<const float*>(shift), rows_per_batch, m, r, static_cast<float*>(dh), rows,
                           ch, dof, s);
  if (dtype == 1)
    return (int)launch_bwd(static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(shift), rows_per_batch, m, r,
                           static_cast<__nv_bfloat16*>(dh), rows, ch, dof, s);
  return (int)cudaErrorInvalidValue;
}
