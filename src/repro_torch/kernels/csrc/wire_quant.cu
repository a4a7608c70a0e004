// Packed int8 cut wire: per-row absmax quantize and its dequantize.
//
// Replaces the TPU kernels in src/repro/kernels/wire_quant.py:
//   wire_quant_pallas   (_quant_kernel)   -> quant_rows
//   wire_dequant_pallas (_dequant_kernel) -> dequant_rows
//
// Contract (bitwise equal to the plain torch version and to the
// reference's oracle):
//   scale = max(absmax(row) * f32(1/127), f32(1e-12))
//   q     = int8(clip(round_half_even(x / scale), -127, 127))
//   deq   = (float(q) * scale) rounded to the output type
// The division is IEEE (__fdiv_rn; this file must not be built with
// --use_fast_math), rounding is rintf (half to even, never roundf), and
// bf16 goes through __bfloat162float / __float2bfloat16_rn.  Inputs are
// taken to be finite: a NaN in a row does not propagate into its scale.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes.  On the serving path
// the logits row (4, 1, 200064) bf16 moves 1.6 MB in and 0.8 MB out,
// about 0.7 us at the memory rate; the cut activation (4, 1, 3072) moves
// 37 KB and is bound by launch latency instead.
//
// Design.  The TPU kernel holds a whole block of rows in VMEM; here a
// batch of four 200,064-wide rows would leave one block per row on four
// SMs, each reading 400 KB twice through one load per thread in flight
// (measured 45 us).  So a row is spread over a thread-block cluster of up
// to 8 blocks, one per 8K elements (a row that fits one block is
// launched without a cluster): each block reduces its slice's absmax,
// the cluster combines the partial maxima through distributed shared
// memory (no partial value goes to device memory and no second launch),
// every block derives the same scale, and each quantizes its own slice,
// re-read mostly from L2.  Rows whose start is 16-byte aligned
// and whose width is a multiple of the vector are read with 16-byte loads
// and written with 8- or 4-byte stores; others take a scalar loop.
// Dequantize is an elementwise grid over (columns, rows) with no integer
// division.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;          // portable cluster size
constexpr int64_t kSliceTarget = 8192;  // elements per block of a row

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

// 16 bytes of input as floats; the matching packed int8 store
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Store = uint32_t;
  __device__ __forceinline__ static void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Store = uint2;
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
};

__device__ __forceinline__ int8_t quant_one(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// grid: rows * cluster blocks, cluster (cluster, 1, 1); block `rank` of a
// row's cluster owns elements [rank * slice, (rank + 1) * slice).  A row
// that fits one block (kCluster false) is launched without a cluster.
template <typename T, bool kVector, bool kCluster>
__global__ void __launch_bounds__(kThreads)
quant_rows(const T* __restrict__ x, int8_t* __restrict__ q,
           float* __restrict__ scale, int64_t k, int64_t slice, float inv127,
           float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float warp_max[kThreads / 32];
  __shared__ float block_max;

  const unsigned rank = kCluster ? cg::this_cluster().block_rank() : 0;
  const unsigned n_blocks = kCluster ? cg::this_cluster().num_blocks() : 1;
  const int64_t row = blockIdx.x / n_blocks;
  const int64_t lo = rank * slice;
  const int64_t hi = lo + slice < k ? lo + slice : k;
  const T* xr = x + row * k;
  int8_t* qr = q + row * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float amax = 0.f;
  if (kVector) {        // slice and row start are multiples of N elements
#pragma unroll 4
    for (int64_t i = lo + threadIdx.x * N; i < hi; i += kThreads * N) {
      float f[N];
      Vec<T>::load(xr + i, f);
#pragma unroll
      for (int j = 0; j < N; ++j) amax = fmaxf(amax, fabsf(f[j]));
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      amax = fmaxf(amax, fabsf(to_f32(xr[i])));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    block_max = m;
  }
  float m;
  if (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();     // every block's partial max is visible cluster-wide
    m = 0.f;
    for (unsigned r = 0; r < n_blocks; ++r) {
      m = fmaxf(m, *cluster.map_shared_rank(&block_max, r));
    }
    cluster.sync();     // no block exits while a peer still reads it
  } else {
    __syncthreads();
    m = block_max;
  }
  const float s = fmaxf(__fmul_rn(m, inv127), eps);
  if (rank == 0 && threadIdx.x == 0) scale[row] = s;

  if (kVector) {
    using Store = typename Vec<T>::Store;
#pragma unroll 4
    for (int64_t i = lo + threadIdx.x * N; i < hi; i += kThreads * N) {
      float f[N];
      Vec<T>::load(xr + i, f);
      union {
        int8_t b[N];
        Store v;
      } out;
#pragma unroll
      for (int j = 0; j < N; ++j) out.b[j] = quant_one(f[j], s);
      *reinterpret_cast<Store*>(qr + i) = out.v;
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      qr[i] = quant_one(to_f32(xr[i]), s);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
dequant_rows(const int8_t* __restrict__ q, const float* __restrict__ scale,
             OutT* __restrict__ out, int64_t rows, int64_t k) {
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const float s = scale[row];
    const int8_t* qr = q + row * k;
    OutT* orow = out + row * k;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < k;
         i += (int64_t)gridDim.x * blockDim.x) {
      orow[i] = from_f32<OutT>(__fmul_rn(static_cast<float>(qr[i]), s));
    }
  }
}

template <typename T, bool kVector>
cudaError_t launch_quant(const T* x, int8_t* q, float* scale, int64_t rows,
                         int64_t k, int cluster, int64_t slice, float inv127,
                         float eps, cudaStream_t stream) {
  if (cluster == 1) {
    quant_rows<T, kVector, false><<<static_cast<unsigned>(rows), kThreads, 0,
                                    stream>>>(x, q, scale, k, slice, inv127,
                                              eps);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, quant_rows<T, kVector, true>, x, q, scale,
                            k, slice, inv127, eps);
}

template <typename T>
cudaError_t quant(const void* x, void* q, void* scale, int64_t rows,
                  int64_t k, float inv127, float eps, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  int64_t cluster = (k + kSliceTarget - 1) / kSliceTarget;
  if (cluster > kMaxCluster) cluster = kMaxCluster;
  if (cluster < 1) cluster = 1;
  if (rows * cluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  int64_t slice = (k + cluster - 1) / cluster;
  const bool vec = k % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % sizeof(
                       typename Vec<T>::Store) == 0;
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  if (vec) {
    slice = (slice + N - 1) / N * N;
    return launch_quant<T, true>(xp, qp, sp, rows, k, (int)cluster, slice,
                                 inv127, eps, stream);
  }
  return launch_quant<T, false>(xp, qp, sp, rows, k, (int)cluster, slice,
                                inv127, eps, stream);
}

template <typename OutT>
void launch_dequant(const void* q, const void* scale, void* out,
                    int64_t rows, int64_t k, cudaStream_t stream) {
  const int64_t col_blocks = (k + kThreads - 1) / kThreads;
  dim3 grid((unsigned)(col_blocks < 4096 ? col_blocks : 4096),
            (unsigned)(rows < 65535 ? rows : 65535));
  dequant_rows<OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<OutT*>(out), rows, k);
}

}  // namespace

// x (rows, k) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1), contiguous
// -> q (rows, k) int8 and scale (rows,) float32.  Returns the launch's
// error, else cudaGetLastError().
extern "C" int wire_quant_launch(const void* x, void* q, void* scale,
                                 long long rows, long long k, int x_bf16,
                                 float inv127, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? quant<__nv_bfloat16>(x, q, scale, rows, k, inv127, eps, st)
             : quant<float>(x, q, scale, rows, k, inv127, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// q (rows, k) int8, scale (rows,) float32 -> out (rows, k) float32
// (out_bf16 = 0) or bfloat16 (out_bf16 = 1).  Returns cudaGetLastError().
extern "C" int wire_dequant_launch(const void* q, const void* scale,
                                   void* out, long long rows, long long k,
                                   int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    launch_dequant<__nv_bfloat16>(q, scale, out, rows, k, st);
  } else {
    launch_dequant<float>(q, scale, out, rows, k, st);
  }
  return static_cast<int>(cudaGetLastError());
}
