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
// sum is written to device memory.
//
// What bounds it on an H100 SXM: at the vertical VGG-16 evaluation,
// (512, 512) | (512, 512) x (1024, 10) + b in fp32, the inputs are 2.1 MB
// (0.63 us at 3.35 TB/s) against 10.5 MFLOP (0.16 us at 67 TFLOP/s of
// fp32 FMA), so it is bound by bytes; at the kernel bench's (256, 256+128)
// x (384, 512) it is 0.1 GFLOP against 1.3 MB, bound by operations.  At
// both shapes latency rules: the output tiles are too few to fill the
// card, and each is a chain of dependent loads and FFMAs.
//
// Design.
// * Register blocking: each thread owns 4 x 4 outputs.  A K slice of the
//   parts sits in shared memory row-major ([row][k], rows padded by 4
//   floats) and of W as [k][col]; per 4-deep step a thread reads four
//   float4s of A and four of W and issues 64 FFMAs.
// * Tiles: 32 x 64 outputs and 128 threads, or 64 x 16 and 64 threads
//   when C <= 16 (the evaluation's C = 10).  64-deep K slices that never
//   cross a part boundary, in a 3-stage ring: float32 operands go through
//   cp.async (16 bytes where a row is 16-byte aligned, else 4 bytes per
//   element, with the zero fill at ragged edges); bf16 operands are read,
//   converted to float32 and stored by the threads.
// * Cluster split-K: when the output tiles are fewer than the SMs, the
//   K slices of one tile are split over a thread-block cluster of up to 8
//   blocks (the grid's z).  Each block keeps its partial tile in its own
//   shared memory; rank 0 adds the others' through distributed shared
//   memory in rank order (the result is the same on every run), adds the
//   bias and writes.  So no partial sum goes to device memory, and it is
//   one launch.
// * Float32 FFMA throughout: the fp32 parity the tests hold it to
//   (rtol = atol = 1e-5) forbids TF32.  Rows, columns and K are masked
//   with zeros in shared memory, never padded in device memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxParts = 8;
constexpr int kMaxSplit = 8;               // portable cluster size
constexpr int kBK = 64;                    // K slice depth
constexpr int kStages = 3;
constexpr int kALd = kBK + 4;              // padded row of the A slice

struct Parts {
  const void* p[kMaxParts];
  int k[kMaxParts];
  int vec[kMaxParts];                      // rows 16-byte aligned (fp32)
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// rows [r0, r0 + n_r) x columns [c0, c0 + n_c) of a row-major (n_rows,
// ld) matrix into float rows of `dld` in shared memory, zeros outside
// (n_rows, n_cols); `vec`: fp32 with 16-byte aligned rows and n_c % 4 == 0
template <typename T, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, int dld, const T* src,
                                          int64_t ld, int64_t r0, int n_r,
                                          int64_t n_rows, int c0, int n_c,
                                          int n_cols, bool vec) {
  const int t = threadIdx.x;
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      const int per_row = n_c / 4;
      for (int e = t; e < n_r * per_row; e += kThreads) {
        const int r = e / per_row, c = 4 * (e % per_row);
        const bool ok = r0 + r < n_rows && c0 + c < n_cols;
        cp_async16(dst + r * dld + c,
                   ok ? src + (r0 + r) * ld + c0 + c : src, ok);
      }
      return;
    }
    for (int e = t; e < n_r * n_c; e += kThreads) {
      const int r = e / n_c, c = e % n_c;
      const bool ok = r0 + r < n_rows && c0 + c < n_cols;
      cp_async4(dst + r * dld + c, ok ? src + (r0 + r) * ld + c0 + c : src,
                ok);
    }
  } else {
    for (int e = t; e < n_r * n_c; e += kThreads) {
      const int r = e / n_c, c = e % n_c;
      const bool ok = r0 + r < n_rows && c0 + c < n_cols;
      dst[r * dld + c] = ok ? to_f32(src[(r0 + r) * ld + c0 + c]) : 0.f;
    }
  }
}

template <int BM, int BN>
constexpr size_t smem_bytes() {
  return sizeof(float) * kStages * (BM * kALd + kBK * (BN + 4));
}

// grid (row tiles, column tiles, split), cluster (1, 1, split); block z
// takes K slices [z n / split, (z + 1) n / split) of the n slices of all
// parts together.  Thread (ty, tx) owns rows 4 ty .. +3 and columns
// 4 tx .. +3 of the BM x BN tile.
template <typename PT, typename WT, int BM, int BN>
__global__ void __launch_bounds__(BM* BN / 16)
    splitcat_dense(Parts parts, const WT* __restrict__ w, int w_vec,
                   const WT* __restrict__ b, PT* __restrict__ out, int rows,
                   int cols) {
  constexpr int kThreads = BM * BN / 16;
  constexpr int kWLd = BN + 4;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);            // [stage][BM][kALd]
  float* w_s = a_s + kStages * BM * kALd;                  // [stage][kBK][kWLd]

  const int tx = threadIdx.x % (BN / 4), ty = threadIdx.x / (BN / 4);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int c0 = blockIdx.y * BN;
  const int split = gridDim.z, rank = blockIdx.z;

  // this block's range of K slices
  int n_slices = 0;
  for (int p = 0; p < parts.n; ++p) n_slices += (parts.k[p] + kBK - 1) / kBK;
  const int s_begin = rank * n_slices / split;
  const int s_end = (rank + 1) * n_slices / split;

  // slice s -> (part, k0 in the part, W row of k0)
  auto locate = [&](int s, int& p, int& k0, int64_t& wrow) {
    wrow = 0;
    p = 0;
    for (;;) {
      const int n = (parts.k[p] + kBK - 1) / kBK;
      if (s < n) break;
      s -= n;
      wrow += parts.k[p];
      ++p;
    }
    k0 = s * kBK;
    wrow += k0;
  };
  auto load_slice = [&](int s, int stage) {
    int p, k0;
    int64_t wrow;
    locate(s, p, k0, wrow);
    const int kp = parts.k[p];
    load_tile<PT, kThreads>(a_s + stage * BM * kALd, kALd,
                            static_cast<const PT*>(parts.p[p]), kp, r0, BM,
                            rows, k0, kBK, kp, parts.vec[p] != 0);
    // W rows past this part's K read as zeros: the part's K ends there
    load_tile<WT, kThreads>(w_s + stage * kBK * kWLd, kWLd, w, cols, wrow,
                            kBK, wrow - k0 + kp, c0, BN, cols, w_vec != 0);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int n = s_end - s_begin;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load_slice(s_begin + s, s);
    cp_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_wait_stages();
    __syncthreads();
    const int pre = it + kStages - 1;
    if (pre < n) load_slice(s_begin + pre, pre % kStages);
    cp_commit();

    const float* as = a_s + (it % kStages) * BM * kALd + 4 * ty * kALd;
    const float* ws = w_s + (it % kStages) * kBK * kWLd + 4 * tx;
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float4 av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(as + i * kALd + k);
        wv[i] = *reinterpret_cast<const float4*>(ws + (k + i) * kWLd);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a4[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[i][0] = fmaf(a4[kk], wv[kk].x, acc[i][0]);
          acc[i][1] = fmaf(a4[kk], wv[kk].y, acc[i][1]);
          acc[i][2] = fmaf(a4[kk], wv[kk].z, acc[i][2]);
          acc[i][3] = fmaf(a4[kk], wv[kk].w, acc[i][3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (split > 1) {
    // partial tiles through distributed shared memory, added in rank order
    cg::cluster_group cluster = cg::this_cluster();
    float* red = a_s;                                      // [BM][BN]
    __syncthreads();
    if (rank > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(red + (4 * ty + i) * BN + 4 * tx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < split; ++r) {
        const float* other = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              other + (4 * ty + i) * BN + 4 * tx);
          acc[i][0] += v.x;
          acc[i][1] += v.y;
          acc[i][2] += v.z;
          acc[i][3] += v.w;
        }
      }
    }
    cluster.sync();                       // the others' tiles stay alive
    if (rank > 0) return;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = r0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 4 * tx + j;
      if (row < rows && col < cols) {
        float v = acc[i][j];
        if (b != nullptr) v = __fadd_rn(v, to_f32(b[col]));
        out[row * cols + col] = from_f32<PT>(v);
      }
    }
  }
}

template <typename PT, typename WT, int BM, int BN>
cudaError_t launch(const Parts& parts, const void* w, int w_vec,
                   const void* b, void* out, int rows, int cols,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN>();
  auto kernel = splitcat_dense<PT, WT, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sm_count = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                               dev);
  if (err != cudaSuccess) return err;
  const unsigned row_tiles = (rows + BM - 1) / BM;
  const unsigned col_tiles = (cols + BN - 1) / BN;
  int n_slices = 0;
  for (int p = 0; p < parts.n; ++p) n_slices += (parts.k[p] + kBK - 1) / kBK;
  // split K while the tiles x split still fit on the SMs in one wave
  int split = 1;
  while (2 * split <= kMaxSplit && 2 * split <= n_slices &&
         static_cast<long long>(row_tiles) * col_tiles * 2 * split <=
             sm_count) {
    split *= 2;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles, col_tiles, split);
  cfg.blockDim = dim3(BM * BN / 16);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, parts,
                            static_cast<const WT*>(w), w_vec,
                            static_cast<const WT*>(b),
                            static_cast<PT*>(out), rows, cols);
}

template <typename PT, typename WT>
cudaError_t launch_tile(const Parts& parts, const void* w, int w_vec,
                        const void* b, void* out, int rows, int cols,
                        cudaStream_t stream) {
  return cols <= 16
             ? launch<PT, WT, 64, 16>(parts, w, w_vec, b, out, rows, cols,
                                      stream)
             : launch<PT, WT, 32, 64>(parts, w, w_vec, b, out, rows, cols,
                                      stream);
}

}  // namespace

// parts[i] (rows, ks[i]) float32 (parts_bf16 = 0) or bfloat16 (1), w
// (sum ks, cols) float32 (w_bf16 = 0) or bfloat16 (1), b (cols,) of w's
// type or null, out (rows, cols) of the parts' type; all contiguous.
// Returns the launch's cudaError_t, or cudaErrorInvalidValue for more than
// kMaxParts parts or too many columns for the grid.
extern "C" int splitcat_launch(int n_parts, const void* const* ps,
                               const int* ks, const void* w, const void* b,
                               void* out, int rows, int cols, int parts_bf16,
                               int w_bf16, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || (cols + 15) / 16 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Parts parts;
  for (int i = 0; i < kMaxParts; ++i) {
    parts.p[i] = i < n_parts ? ps[i] : nullptr;
    parts.k[i] = i < n_parts ? ks[i] : 0;
    parts.vec[i] = i < n_parts && !parts_bf16 && ks[i] % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(ps[i]) % 16 == 0;
  }
  parts.n = n_parts;
  const int w_vec = !w_bf16 && cols % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (parts_bf16) {
    err = w_bf16 ? launch_tile<__nv_bfloat16, __nv_bfloat16>(
                       parts, w, w_vec, b, out, rows, cols, st)
                 : launch_tile<__nv_bfloat16, float>(parts, w, w_vec, b, out,
                                                     rows, cols, st);
  } else {
    err = w_bf16 ? launch_tile<float, __nv_bfloat16>(parts, w, w_vec, b, out,
                                                     rows, cols, st)
                 : launch_tile<float, float>(parts, w, w_vec, b, out, rows,
                                             cols, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
