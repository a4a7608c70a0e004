// Fused concat + linear over dense parts: the vertical split's server entry.
//
// Replaces the TPU kernel src/repro/kernels/splitcat_linear.py:
//   splitcat_linear_pallas (_splitcat_kernel) -> splitcat_dense
//
// Contract: y = sum_i part_i @ W_i, then + b, then cast to the parts' type,
// with float32 accumulation.  part_i (rows, K_i) float32 or bf16 (all parts
// one type), W (sum K_i, C) float32 or bf16 row-split at the part
// boundaries, b (C,) of W's type or absent, y (rows, C) of the parts' type.
// All parts go in one launch (a small array of pointers passed by value,
// ragged K_i).  The concatenated activation is never formed and no partial
// sum is written to device memory: each block owns one output tile for the
// whole K loop over every part.
//
// What bounds it on an H100 SXM: at the vertical VGG-16 evaluation,
// (512, 512) | (512, 512) x (1024, 10) + b in fp32, the inputs are 2.1 MB
// (0.63 us at 3.35 TB/s) against 10.5 MFLOP (0.16 us at 67 TFLOP/s of
// fp32 FMA), so it is bound by bytes; at the kernel bench's (256, 256+128)
// x (384, 512) it is 0.1 GFLOP against 1.3 MB, bound by operations.  This
// is the simple tiled product: a block of 256 threads owns a 32 x 32
// output tile, stages 32-deep K slices of the parts and of W in shared
// memory (converted to float32 on the way in, the part slice stored
// transposed and padded so neither the stores nor the reads conflict on
// banks), and each thread keeps a 2 x 2 block of float32 sums in
// registers, added with FFMA in K order.  A narrow output (C = 10 at the
// evaluation) gives 16 blocks, one per SM, each walking all of K, and
// the time goes to the shared-memory-load -> FFMA chains of those 8
// warps per SM: 47 us on an H100 SXM, against 15.6 us for torch's addmm
// over a cat.  (128-deep slices, which cut the barriers and the global
// load round trips by 4, took 53 us: the loads were not what bound it.)
// More warps per output tile (splitting K inside the block) or more
// outputs per thread are the next step.  No tensor cores: the fp32
// parity the tests hold it to forbids TF32, and wgmma for bf16 is later
// work.  Ragged rows,
// columns and K are masked with zeros in shared memory, never padded in
// device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 8;
constexpr int kTile = 32;                 // output rows = columns = K depth
constexpr int kThreads = 256;
constexpr int kSide = 16;                 // threads per tile side
constexpr int kPer = kTile / kSide;       // outputs per thread per side

struct Parts {
  const void* p[kMaxParts];
  int k[kMaxParts];
  int n;
};

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

template <typename PT, typename WT>
__global__ void __launch_bounds__(kThreads)
splitcat_dense(Parts parts, const WT* __restrict__ w,
               const WT* __restrict__ b, PT* __restrict__ out, int rows,
               int cols) {
  __shared__ float a_s[kTile][kTile + 1];   // [k][row], padded
  __shared__ float w_s[kTile][kTile];       // [k][col]

  const int t = threadIdx.x;
  const int tx = t % kSide;
  const int ty = t / kSide;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;
  }

  int64_t koff = 0;
  for (int p = 0; p < parts.n; ++p) {
    const int kp = parts.k[p];
    const PT* __restrict__ part = static_cast<const PT*>(parts.p[p]);
    const WT* __restrict__ wp = w + koff * cols;
    for (int k0 = 0; k0 < kp; k0 += kTile) {
      // stage one K slice: neighbouring threads read neighbouring
      // addresses of a part row (k) and of a W row (column)
#pragma unroll
      for (int e = t; e < kTile * kTile; e += kThreads) {
        const int hi = e / kTile;
        const int lo = e % kTile;
        const int64_t row = r0 + hi;        // part row, k0 + lo its K
        const int64_t kw = k0 + hi;         // W row, c0 + lo its column
        a_s[lo][hi] = row < rows && k0 + lo < kp
                          ? to_f32(part[row * kp + k0 + lo])
                          : 0.f;
        w_s[hi][lo] = kw < kp && c0 + lo < cols
                          ? to_f32(wp[kw * cols + c0 + lo])
                          : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk) {
        float av[kPer], wv[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) av[i] = a_s[kk][ty + kSide * i];
#pragma unroll
        for (int j = 0; j < kPer; ++j) wv[j] = w_s[kk][tx + kSide * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
#pragma unroll
          for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(av[i], wv[j],
                                                          acc[i][j]);
        }
      }
      __syncthreads();
    }
    koff += kp;
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = r0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = c0 + tx + kSide * j;
      if (row < rows && col < cols) {
        float v = acc[i][j];
        if (b != nullptr) v = __fadd_rn(v, to_f32(b[col]));
        out[(int64_t)row * cols + col] = from_f32<PT>(v);
      }
    }
  }
}

template <typename PT, typename WT>
void launch(const Parts& parts, const void* w, const void* b, void* out,
            int rows, int cols, cudaStream_t stream) {
  dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  splitcat_dense<PT, WT><<<grid, kThreads, 0, stream>>>(
      parts, static_cast<const WT*>(w), static_cast<const WT*>(b),
      static_cast<PT*>(out), rows, cols);
}

}  // namespace

// parts[i] (rows, ks[i]) float32 (parts_bf16 = 0) or bfloat16 (1), w
// (sum ks, cols) float32 (w_bf16 = 0) or bfloat16 (1), b (cols,) of w's
// type or null, out (rows, cols) of the parts' type; all contiguous.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for more than
// kMaxParts parts or too many rows for the grid.
extern "C" int splitcat_launch(int n_parts, const void* const* ps,
                               const int* ks, const void* w, const void* b,
                               void* out, int rows, int cols, int parts_bf16,
                               int w_bf16, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts ||
      (rows + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Parts parts;
  for (int i = 0; i < kMaxParts; ++i) {
    parts.p[i] = i < n_parts ? ps[i] : nullptr;
    parts.k[i] = i < n_parts ? ks[i] : 0;
  }
  parts.n = n_parts;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parts_bf16) {
    if (w_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(parts, w, b, out, rows, cols, st);
    } else {
      launch<__nv_bfloat16, float>(parts, w, b, out, rows, cols, st);
    }
  } else {
    if (w_bf16) {
      launch<float, __nv_bfloat16>(parts, w, b, out, rows, cols, st);
    } else {
      launch<float, float>(parts, w, b, out, rows, cols, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
