// Fused dequant + concat + matmul over packed int8 wire payloads.
//
// Replaces the TPU kernel src/repro/kernels/splitcat_linear.py:
//   splitcat_linear_q8_pallas (_splitcat_q8_kernel) -> splitcat_q8
//
// Contract: y = sum_i (q_i @ W_i) * s_i, then + b, then cast, with
// float32 accumulation.  q_i (rows, K_i) int8, s_i (rows,) float32 row
// scales, W (sum K_i, C) float32 or bf16 row-split at the part
// boundaries, b (C,) of W's type or absent, y (rows, C) float32 or bf16.
// All parts go in one launch (a small array of pointers passed by value).
// Neither a dequantized activation nor a partial sum is ever written to
// device memory: each block owns its output tile for the whole K loop,
// and the only cross-thread sums go through shuffles and shared memory.
//
// What bounds it on an H100 SXM (3.35 TB/s): at decode the server's entry
// QKV is (4, 1, 3072) x (3072, 5120) bf16, so reading W (31.5 MB) is
// nearly all the work: about 9.4 us at the memory rate, against
// 0.13 GFLOP.  The design keeps as many bytes of W in flight as it can
// with plain fp32 FMAs (no tensor cores yet, which a 4-row decode does
// not need): a block of 128 threads owns a tile of 4 rows by 2 column
// vectors (16 bf16 or 8 fp32 columns, 320 blocks for the entry QKV, all
// resident at once); each thread reads one 16-byte vector of W per K
// row, 64 K rows per block step, and starts the loads of 8 steps before
// it uses any of them, so 16 KB of W per block are in flight.  (A first
// version with one load in flight per thread took 259 us, a second with
// a 4-way unrolled loop the compiler did not pipeline 76 us.)  The int8
// activations are small and read through the read-only cache.  Per part,
// the 64 partial sums of each output are added by warp shuffles and then
// across the 4 warps in shared memory, and only then multiplied by the
// part's row scale (the reference's association).  Ragged rows and
// columns are masked here, not padded in memory; W whose rows are not
// 16-byte aligned takes scalar loads.  wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                         // output rows per block
constexpr int kColGroups = 2;                    // W vectors per K row
constexpr int kKLanes = kThreads / kColGroups;   // K rows per block step
constexpr int kDepth = 8;                        // block steps in flight

struct Parts {
  const int8_t* q[kMaxParts];
  const float* s[kMaxParts];
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

// one 16-byte vector of W as floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&f)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
};

template <typename WT, bool kVector>
__device__ __forceinline__ void load_w(const WT* __restrict__ row, int c,
                                       int cols, float (&f)[Vec<WT>::N]) {
  constexpr int N = Vec<WT>::N;
  if (kVector && c < cols) {        // cols % N == 0: the vector is whole
    Vec<WT>::load(row + c, f);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = c + j < cols ? to_f32(row[c + j]) : 0.f;
  }
}

template <typename WT, typename OutT, bool kVector>
__global__ void __launch_bounds__(kThreads)
splitcat_q8(Parts parts, const WT* __restrict__ w, const WT* __restrict__ b,
            OutT* __restrict__ out, int rows, int cols) {
  constexpr int N = Vec<WT>::N;
  constexpr int kCols = kColGroups * N;          // output columns per block
  constexpr int kOut = kRows * kCols;            // outputs per block
  static_assert(kOut <= kThreads, "one output per thread at most");
  __shared__ float red[kWarps][kRows][kCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = threadIdx.x % kColGroups;    // which W vector
  const int k_lane = threadIdx.x / kColGroups;   // which K row of a step
  const int c0 = blockIdx.x * kCols;
  const int c = c0 + group * N;
  const int r0 = blockIdx.y * kRows;
  const int n_rows = rows - r0 < kRows ? rows - r0 : kRows;
  // the output this thread finishes: row o / kCols, column o % kCols
  const int o_row = threadIdx.x / kCols;
  const int o_col = threadIdx.x % kCols;

  float result = 0.f;
  int64_t koff = 0;
  for (int p = 0; p < parts.n; ++p) {
    const int kp = parts.k[p];
    const int8_t* __restrict__ qp = parts.q[p] + (int64_t)r0 * kp;
    const WT* wp = w + koff * cols;

    float acc[kRows][N];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < N; ++j) acc[r][j] = 0.f;
    }
    for (int k0 = k_lane; k0 < kp; k0 += kDepth * kKLanes) {
      float wv[kDepth][N];
      float qv[kDepth][kRows];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {      // all loads first
        const int kk = k0 + u * kKLanes;
        if (kk < kp) {
          load_w<WT, kVector>(wp + (int64_t)kk * cols, c, cols, wv[u]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            qv[u][r] = r < n_rows ? static_cast<float>(
                                        __ldg(qp + (int64_t)r * kp + kk))
                                  : 0.f;
          }
        } else {
#pragma unroll
          for (int j = 0; j < N; ++j) wv[u][j] = 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) qv[u][r] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {      // then the FMAs
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            acc[r][j] = fmaf(qv[u][r], wv[u][j], acc[r][j]);
          }
        }
      }
    }
    // add the K lanes of this warp that share a W vector (the lane bits
    // above the column-group bits)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float v = acc[r][j];
#pragma unroll
        for (int off = kColGroups; off < 32; off <<= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        acc[r][j] = v;
      }
    }
    if (lane < kColGroups) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int j = 0; j < N; ++j) red[warp][r][group * N + j] = acc[r][j];
      }
    }
    __syncthreads();
    if (threadIdx.x < kOut) {
      float dot = 0.f;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) dot += red[g][o_row][o_col];
      const float sv = o_row < n_rows ? parts.s[p][r0 + o_row] : 0.f;
      result = __fadd_rn(result, __fmul_rn(dot, sv));
    }
    __syncthreads();
    koff += kp;
  }

  const int col = c0 + o_col;
  if (threadIdx.x < kOut && o_row < n_rows && col < cols) {
    float v = result;
    if (b != nullptr) v = __fadd_rn(v, to_f32(b[col]));
    out[(int64_t)(r0 + o_row) * cols + col] = from_f32<OutT>(v);
  }
}

template <typename WT, typename OutT>
void launch(const Parts& parts, const void* w, const void* b, void* out,
            int rows, int cols, cudaStream_t stream) {
  constexpr int N = Vec<WT>::N;
  constexpr int kCols = kColGroups * N;
  dim3 grid((cols + kCols - 1) / kCols, (rows + kRows - 1) / kRows);
  const WT* wp = static_cast<const WT*>(w);
  const WT* bp = static_cast<const WT*>(b);
  OutT* op = static_cast<OutT*>(out);
  if (cols % N == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    splitcat_q8<WT, OutT, true><<<grid, kThreads, 0, stream>>>(
        parts, wp, bp, op, rows, cols);
  } else {
    splitcat_q8<WT, OutT, false><<<grid, kThreads, 0, stream>>>(
        parts, wp, bp, op, rows, cols);
  }
}

}  // namespace

// qs[i] (rows, ks[i]) int8, ss[i] (rows,) float32, w (sum ks, cols)
// float32 (w_bf16 = 0) or bfloat16 (w_bf16 = 1), b (cols,) of w's type or
// null, out (rows, cols) float32 (out_bf16 = 0) or bfloat16 (out_bf16 = 1);
// all contiguous.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for more than kMaxParts parts or too many rows for the grid.
extern "C" int splitcat_q8_launch(int n_parts, const void* const* qs,
                                  const void* const* ss, const int* ks,
                                  const void* w, const void* b, void* out,
                                  int rows, int cols, int w_bf16,
                                  int out_bf16, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts ||
      (rows + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Parts parts;
  for (int i = 0; i < kMaxParts; ++i) {
    parts.q[i] = i < n_parts ? static_cast<const int8_t*>(qs[i]) : nullptr;
    parts.s[i] = i < n_parts ? static_cast<const float*>(ss[i]) : nullptr;
    parts.k[i] = i < n_parts ? ks[i] : 0;
  }
  parts.n = n_parts;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    if (out_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(parts, w, b, out, rows, cols, st);
    } else {
      launch<__nv_bfloat16, float>(parts, w, b, out, rows, cols, st);
    }
  } else {
    if (out_bf16) {
      launch<float, __nv_bfloat16>(parts, w, b, out, rows, cols, st);
    } else {
      launch<float, float>(parts, w, b, out, rows, cols, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
