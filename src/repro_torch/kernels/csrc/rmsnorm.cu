// RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel in src/repro/kernels/rmsnorm.py:
//   rmsnorm_pallas (_rmsnorm_kernel) -> rmsnorm_rows
//
// Contract (the plain torch version, kernels.ref.rmsnorm_ref): every row
// is upcast to float32, its mean square taken in float32, and
// (x * rsqrt(var + eps)) * scale rounded once to x's type.  The mean is
// the float32 sum of squares divided by D (IEEE division, as torch's
// mean); the sum runs in another order than torch's and rsqrtf is within
// 2 ulp, so float32 outputs agree to a few ulp and bf16 outputs to one
// bf16 ulp.  `scale` may be float32 or bf16 whatever x is.  Rows are not
// padded: the TPU kernel pads only to fill its (block_rows, D) tile.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes.  One read of x and
// one write of y; at the Mamba2 prefill's (4, 512, 768) bf16 that is
// 6.3 MB, about 1.9 us at the memory rate; at decode (4 rows) the launch
// latency bounds it instead.
//
// Design.  One warp per row (D is 512 to 5120 on the served models: 768,
// 1536 and 3072 on the dense ones, 2048 on Qwen3-30B-A3B, 5120 on
// DeepSeek-V2 with MLA's q_norm at 1536 and kv_norm at 512; in bf16 that
// is 2 to 20 16-byte vectors per lane, in float32 twice as many; every
// one of these widths is held against the plain version on the card by
// chip_smoke.py), eight rows per block, no
// shared memory and no barrier: each lane sums the squares of its
// vectors, the warp reduces with shuffles, and every lane then re-reads
// its vectors (from L1) to scale and store them.  Rows whose start is
// 16-byte aligned and whose width is a multiple of the vector are read
// and written with 16-byte accesses; others take a scalar loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes as floats, and back
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&f)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = __halves2bfloat162(__float2bfloat16_rn(f[2 * j]),
                                __float2bfloat16_rn(f[2 * j + 1]));
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// grid: ceil(rows / 8) blocks of 256 threads; warp w of block b owns row
// b * 8 + w
template <typename T, typename S, bool kVector>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows(const T* __restrict__ x, const S* __restrict__ scale,
             T* __restrict__ y, int64_t rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  if (kVector) {
    for (int i = lane * N; i < d; i += 32 * N) {
      float f[N];
      Vec<T>::load(xr + i, f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(__fdiv_rn(ss, static_cast<float>(d)) + eps);

  if (kVector) {
    for (int i = lane * N; i < d; i += 32 * N) {
      float f[N];
      Vec<T>::load(xr + i, f);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = (f[j] * r) * to_f32(scale[i + j]);
      Vec<T>::store(yr + i, f);
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(scale[i]));
    }
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* y, int64_t rows,
                   int d, float eps, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kRowsPerBlock - 1) /
                                        kRowsPerBlock));
  const bool vec = d % Vec<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const S* st = static_cast<const S*>(scale);
  T* yt = static_cast<T*>(y);
  if (vec) {
    rmsnorm_rows<T, S, true><<<grid, kThreads, 0, stream>>>(xt, st, yt, rows,
                                                            d, eps);
  } else {
    rmsnorm_rows<T, S, false><<<grid, kThreads, 0, stream>>>(xt, st, yt,
                                                             rows, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x and y: (rows, d) contiguous, x_bf16 selects bf16 (else float32);
// scale: (d,), scale_bf16 likewise.  Returns the launch's cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              long long rows, int d, int x_bf16,
                              int scale_bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return 0;
  if (x_bf16) {
    return scale_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d,
                                                      eps, s)
               : launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps, s);
  }
  return scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, y, rows, d, eps, s)
                    : launch<float, float>(x, scale, y, rows, d, eps, s);
}
