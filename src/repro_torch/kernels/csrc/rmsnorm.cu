// RMSNorm over the last axis, y = x * rsqrt(mean(x^2) + eps) * scale, and
// its gradient: dx, and dscale summed over the rows.
//
// Replaces the TPU kernel in src/repro/kernels/rmsnorm.py:
//   rmsnorm_pallas (_rmsnorm_kernel) -> rmsnorm_fwd
// The reference differentiates its norm through plain jnp
// (src/repro/nn/layers.py:61-66) and has no backward kernel; the two
// backward kernels here, rmsnorm_bwd_rows and then (when scale needs a
// gradient) rmsnorm_bwd_cols, take the place of recomputing the plain
// version under autograd.
//
// Forward contract (the plain torch version, kernels.ref.rmsnorm_ref):
// every row is upcast to float32, its mean square taken in float32, and
// (x * rsqrt(var + eps)) * scale rounded once to x's type.  The mean is
// the float32 sum of squares divided by D (IEEE division, as torch's
// mean); the sum runs in another order than torch's and rsqrtf is within
// 2 ulp, so float32 outputs agree to a few ulp and bf16 outputs to one
// bf16 ulp.  `scale` may be float32 or bf16 whatever x is.  Rows are not
// padded: the TPU kernel pads only to fill its (block_rows, D) tile.
//
// Backward contract (kernels.ref.rmsnorm_bwd_ref), all in float32, with
// r = rsqrt(mean(x^2) + eps), xh = x r and gy = g scale:
//   dx     = r (gy - xh mean(gy xh)), rounded once to x's type;
//   dscale = the sum over rows of g xh, rounded once to scale's type.
// mean(gy xh) is taken as r (sum(gy x) / D), so one reduction over the
// row gives sum(x^2) and sum(gy x) together.  r is recomputed from x,
// which the backward reads anyway, rather than saved by the forward: that
// costs no byte and no extra barrier.
//
// What bounds them on an H100 SXM (3.35 TB/s): bytes.  The forward reads
// x and writes y (at (4, 512, 768) bf16 6.3 MB, about 1.9 us); below a
// few MB (4 decode rows, 128 rows of 512) the launch and one trip to
// memory and back bound it instead.  The backward reads x and g and
// writes dx (at (4, 512, 768) fp32 18.9 MB, 5.6 us); its fp32 workspace
// of one partial dscale row a CTA, written once and read once, is
// overhead on top of that.
//
// Design.
// * The mapping depends on D alone.  A row's 16-byte vectors (N = 4 fp32
//   or 8 bf16 elements; nv = ceil(D / N)) are spread over TPR threads,
//   the smallest power of two from 32 to 1024 that leaves each thread at
//   most `slots` vectors (the forward kSlots = 4: a warp a row up to 512
//   fp32 / 1024 bf16 elements, 64 threads at 768 fp32 or 1536 bf16, a
//   CTA of 512 threads at 12,288 bf16 and of 1024 at 12,288 fp32; the
//   backward kElemsBwd = 16 elements of x and 16 of g a thread).  A CTA
//   has max(TPR, 256) threads, so it holds 256 / TPR rows at once when
//   they are narrow.  The grid is what the card holds at once (resident
//   CTAs an SM x SMs) or fewer, and each CTA walks its rows in a stride of
//   the grid: 64 row blocks no longer leave half of the 132 SMs idle, and
//   a wide row at decode has a CTA of its own.
// * x (and g) are read from memory once: a thread's vectors of the row
//   stay in registers between the row's reduction and the store.  (Rows
//   wider than the threads' slots, past every served width, read them
//   twice.)  scale is loaded once per CTA, 16 bytes at a time, and stays
//   in registers across the CTA's rows.
// * The arithmetic order of a row depends on D and the type only: thread
//   t sums its vectors t, t + TPR, ... in order, element by element, with
//   fmaf; a warp adds its lanes with an xor butterfly (every lane ends
//   with the same bits); a row over several warps adds their sums in warp
//   order from shared memory.  So a row's output is bitwise the same
//   alone, among 4 rows or among 512, wherever it falls in the grid.
//   Rows that are not 16-byte aligned, or whose width is not a multiple
//   of N, take element loads in the same order, so their output is
//   bitwise the vector path's.
// * dscale without atomics.  Each thread adds g xh for its vectors into
//   fp32 accumulators of its own in shared memory (float4s laid out
//   thread-fastest: no bank conflicts), over the rows of its row group;
//   the CTA adds its row groups in order and writes its partial row to
//   the workspace; rmsnorm_bwd_cols sums each column's partials in a
//   fixed order (lane q of 32 adds partials q, q + 32, ... in order, then
//   the 32 lane sums are added in lane order).  So the gradient is
//   bitwise the same on every call with the same shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMinBlock = 256;  // threads a CTA, at least
constexpr int kSlots = 4;       // 16-byte vectors of a row a thread holds
// elements of x (and of g) a thread holds in the backward: 4 fp32
// vectors or 2 bf16 ones
constexpr int kElemsBwd = 16;
constexpr int kColLanes = 32;   // partials of a column summed side by side

__host__ __device__ constexpr int block_of(int tpr) {
  return tpr > kMinBlock ? tpr : kMinBlock;
}

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

// N elements of E: one access of a row's vector (or of scale's N elements
// beside it) where the row allows, else N element accesses
template <typename E, int N>
struct alignas(sizeof(E) * N < 16 ? sizeof(E) * N : 16) Pack {
  E e[N];
};

// vector v of a row of d elements; elements past d read as 0
template <typename E, int N>
__device__ __forceinline__ Pack<E, N> load(const E* __restrict__ row, int v,
                                           int d, bool vec) {
  Pack<E, N> p;
  if (vec) {
    p = reinterpret_cast<const Pack<E, N>*>(row)[v];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = v * N + j;
      p.e[j] = c < d ? row[c] : from_f32<E>(0.f);
    }
  }
  return p;
}

// vector v of a row, rounded once from float32; elements past d dropped
template <typename E, int N>
__device__ __forceinline__ void store(E* __restrict__ row, int v, int d,
                                      bool vec, const float (&f)[N]) {
  Pack<E, N> p;
#pragma unroll
  for (int j = 0; j < N; ++j) p.e[j] = from_f32<E>(f[j]);
  if (vec) {
    reinterpret_cast<Pack<E, N>*>(row)[v] = p;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = v * N + j;
      if (c < d) row[c] = p.e[j];
    }
  }
}

// the sum over a row's TPR threads of each of v[0..K): an xor butterfly in
// each warp, then, for a row over several warps, the warps' sums in warp
// order.  Every thread of the row ends with the same bits.  `buf` holds
// (block / 32) x K floats; callers alternate two buffers between calls, so
// one barrier a call suffices.
template <int TPR, int K>
__device__ __forceinline__ void row_sum(float (&v)[K], float* buf) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    }
  }
  if constexpr (TPR > 32) {
    constexpr int W = TPR / 32;
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) buf[warp * K + k] = v[k];
    }
    __syncthreads();
    const int first = warp / W * W;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = buf[first * K + k];
#pragma unroll 8
      for (int w = 1; w < W; ++w) s += buf[(first + w) * K + k];
      v[k] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

template <typename T, typename S, int TPR>
__global__ void __launch_bounds__(block_of(TPR))
rmsnorm_fwd(const T* __restrict__ x, const S* __restrict__ scale,
            T* __restrict__ y, int64_t rows, int d, float eps, bool vec) {
  constexpr int N = 16 / sizeof(T);
  constexpr int kRows = block_of(TPR) / TPR;
  __shared__ float buf[2][block_of(TPR) / 32];
  const int t = threadIdx.x % TPR;
  const int nv = (d + N - 1) / N;
  const bool resident = nv <= kSlots * TPR;
  Pack<S, N> sv[kSlots];
  if (resident) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int v = t + k * TPR;
      if (v < nv) sv[k] = load<S, N>(scale, v, d, vec);
    }
  }
  int it = 0;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kRows; base < rows;
       base += static_cast<int64_t>(gridDim.x) * kRows, it ^= 1) {
    const int64_t row = base + threadIdx.x / TPR;
    const bool live = row < rows;
    const T* xr = x + row * d;
    T* yr = y + row * d;
    Pack<T, N> xv[kSlots];
    float ss[1] = {0.f};
    if (resident) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int v = t + k * TPR;
        if (live && v < nv) {
          xv[k] = load<T, N>(xr, v, d, vec);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float f = to_f32(xv[k].e[j]);
            ss[0] = fmaf(f, f, ss[0]);
          }
        }
      }
    } else if (live) {
      for (int v = t; v < nv; v += TPR) {
        const Pack<T, N> p = load<T, N>(xr, v, d, vec);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float f = to_f32(p.e[j]);
          ss[0] = fmaf(f, f, ss[0]);
        }
      }
    }
    row_sum<TPR, 1>(ss, buf[it]);
    if (!live) continue;
    const float r = rsqrtf(__fdiv_rn(ss[0], static_cast<float>(d)) + eps);
    if (resident) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int v = t + k * TPR;
        if (v < nv) {
          float f[N];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            f[j] = (to_f32(xv[k].e[j]) * r) * to_f32(sv[k].e[j]);
          }
          store<T, N>(yr, v, d, vec, f);
        }
      }
    } else {
      for (int v = t; v < nv; v += TPR) {
        const Pack<T, N> p = load<T, N>(xr, v, d, vec);
        const Pack<S, N> s = load<S, N>(scale, v, d, vec);
        float f[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          f[j] = (to_f32(p.e[j]) * r) * to_f32(s.e[j]);
        }
        store<T, N>(yr, v, d, vec, f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------

// one vector's part of the backward: its sums (sum x^2, sum gy x)
template <typename T, typename S, int N>
__device__ __forceinline__ void bwd_sums(float (&s)[2], const Pack<T, N>& xv,
                                         const Pack<T, N>& gv,
                                         const Pack<S, N>& sv) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float f = to_f32(xv.e[j]);
    s[0] = fmaf(f, f, s[0]);
    s[1] = fmaf(to_f32(gv.e[j]) * to_f32(sv.e[j]), f, s[1]);
  }
}

// ... and its dx (into f) and g xh (into the thread's accumulators `acc`,
// N / 4 float4s TPR apart)
template <typename T, typename S, int N, int TPR>
__device__ __forceinline__ void bwd_vec(const Pack<T, N>& xv,
                                        const Pack<T, N>& gv,
                                        const Pack<S, N>& sv, float r,
                                        float m, float (&f)[N],
                                        float4* acc) {
  float gx[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float xh = to_f32(xv.e[j]) * r;
    const float g = to_f32(gv.e[j]);
    f[j] = r * (g * to_f32(sv.e[j]) - xh * m);
    gx[j] = g * xh;
  }
  if (acc != nullptr) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      float4 a = acc[q * TPR];
      a.x += gx[4 * q];
      a.y += gx[4 * q + 1];
      a.z += gx[4 * q + 2];
      a.w += gx[4 * q + 3];
      acc[q * TPR] = a;
    }
  }
}

// dx (if dx) and the CTA's partial dscale row (if ws: row blockIdx.x of a
// (gridDim.x, d) fp32 workspace).  Dynamic shared memory: (block / TPR) x
// ceil(nv / TPR) x (N / 4) x TPR float4 accumulators when ws, else none.
template <typename T, typename S, int TPR>
__global__ void __launch_bounds__(block_of(TPR))
rmsnorm_bwd_rows(const T* __restrict__ x, const S* __restrict__ scale,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ ws, int64_t rows, int d, float eps,
                 bool vec) {
  constexpr int N = 16 / sizeof(T);
  constexpr int Q = N / 4;
  constexpr int kBlock = block_of(TPR);
  constexpr int kRows = kBlock / TPR;
  constexpr int kSlotsBwd = kElemsBwd / N;
  extern __shared__ float4 acc[];
  __shared__ float buf[2][kBlock / 32 * 2];
  const int t = threadIdx.x % TPR;
  const int nv = (d + N - 1) / N;
  const int nk = (nv + TPR - 1) / TPR;
  const bool resident = nk <= kSlotsBwd;
  const int per_group = nk * Q * TPR;       // float4s of one row group
  float4* mine = ws != nullptr
                     ? acc + (threadIdx.x / TPR) * per_group + t
                     : nullptr;
  if (mine != nullptr) {
    for (int i = 0; i < nk * Q; ++i) {
      mine[i * TPR] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  Pack<S, N> sv[kSlotsBwd];
  if (resident) {
#pragma unroll
    for (int k = 0; k < kSlotsBwd; ++k) {
      const int v = t + k * TPR;
      if (v < nv) sv[k] = load<S, N>(scale, v, d, vec);
    }
  }
  int it = 0;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kRows; base < rows;
       base += static_cast<int64_t>(gridDim.x) * kRows, it ^= 1) {
    const int64_t row = base + threadIdx.x / TPR;
    const bool live = row < rows;
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    Pack<T, N> xv[kSlotsBwd], gv[kSlotsBwd];
    float s[2] = {0.f, 0.f};
    if (resident) {
#pragma unroll
      for (int k = 0; k < kSlotsBwd; ++k) {
        const int v = t + k * TPR;
        if (live && v < nv) {
          xv[k] = load<T, N>(xr, v, d, vec);
          gv[k] = load<T, N>(gr, v, d, vec);
          bwd_sums<T, S, N>(s, xv[k], gv[k], sv[k]);
        }
      }
    } else if (live) {
      for (int v = t; v < nv; v += TPR) {
        bwd_sums<T, S, N>(s, load<T, N>(xr, v, d, vec),
                          load<T, N>(gr, v, d, vec),
                          load<S, N>(scale, v, d, vec));
      }
    }
    row_sum<TPR, 2>(s, buf[it]);
    if (!live) continue;
    const float r = rsqrtf(__fdiv_rn(s[0], static_cast<float>(d)) + eps);
    const float m = __fdiv_rn(s[1], static_cast<float>(d)) * r;
    T* dxr = dx != nullptr ? dx + row * d : nullptr;
    if (resident) {
#pragma unroll
      for (int k = 0; k < kSlotsBwd; ++k) {
        const int v = t + k * TPR;
        if (v < nv) {
          float f[N];
          bwd_vec<T, S, N, TPR>(xv[k], gv[k], sv[k], r, m, f,
                                mine != nullptr ? mine + k * Q * TPR
                                                : nullptr);
          if (dxr != nullptr) store<T, N>(dxr, v, d, vec, f);
        }
      }
    } else {
      for (int v = t, k = 0; v < nv; v += TPR, ++k) {
        float f[N];
        bwd_vec<T, S, N, TPR>(load<T, N>(xr, v, d, vec),
                              load<T, N>(gr, v, d, vec),
                              load<S, N>(scale, v, d, vec), r, m, f,
                              mine != nullptr ? mine + k * Q * TPR : nullptr);
        if (dxr != nullptr) store<T, N>(dxr, v, d, vec, f);
      }
    }
  }
  if (ws == nullptr) return;
  // the CTA's row groups in order -> its partial row of dscale
  __syncthreads();
  float* out = ws + static_cast<int64_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < per_group; i += kBlock) {
    float4 a = acc[i];
    for (int grp = 1; grp < kRows; ++grp) {
      const float4 b = acc[grp * per_group + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const int v = i % TPR + i / (TPR * Q) * TPR;
    const int c = v * N + (i / TPR) % Q * 4;
    if (v >= nv) continue;
    if (vec) {
      *reinterpret_cast<float4*>(out + c) = a;
    } else {
      const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j < d) out[c + j] = e[j];
      }
    }
  }
}

// dscale[c] = the sum of ws[p, c] over the parts p, in a fixed order
template <typename S>
__global__ void __launch_bounds__(32 * kColLanes)
rmsnorm_bwd_cols(const float* __restrict__ ws, S* __restrict__ dscale,
                 int parts, int d) {
  __shared__ float part[kColLanes][33];
  const int lane = threadIdx.x & 31;
  const int q = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int p = q; p < parts; p += kColLanes) {
      s += ws[static_cast<int64_t>(p) * d + c];
    }
  }
  part[q][lane] = s;
  __syncthreads();
  if (q == 0 && c < d) {
    float total = part[0][lane];
#pragma unroll
    for (int k = 1; k < kColLanes; ++k) total += part[k][lane];
    dscale[c] = from_f32<S>(total);
  }
}

// ---------------------------------------------------------------------------
// the host side: the grid, and the kernel by type and width
// ---------------------------------------------------------------------------

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 1;
  }
  return cached[dev];
}

// CTAs of `kernel` an SM holds at once with `smem` bytes of dynamic
// shared memory (allowed past 48 KB first)
template <typename K>
int resident_ctas(K kernel, int block, size_t smem) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, block, smem);
  return n > 0 ? n : 1;
}

// the CTAs for `rows` rows: one a row group, at most what the card holds
int grid_for(int64_t rows, int tpr, int per_sm) {
  const int per_cta = block_of(tpr) / tpr;
  const int64_t groups = (rows + per_cta - 1) / per_cta;
  const int64_t most = static_cast<int64_t>(per_sm) * sm_count();
  return static_cast<int>(groups < most ? groups : most);
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>, Tag<S>) for x's type T and scale's type S
template <typename F>
cudaError_t by_types(int x_bf16, int scale_bf16, F&& f) {
  using bf = __nv_bfloat16;
  if (x_bf16) {
    return scale_bf16 ? f(Tag<bf>{}, Tag<bf>{}) : f(Tag<bf>{}, Tag<float>{});
  }
  return scale_bf16 ? f(Tag<float>{}, Tag<bf>{})
                    : f(Tag<float>{}, Tag<float>{});
}

// f(std::integral_constant<int, TPR>) for the TPR of a row of d elements
// of T, `slots` 16-byte vectors a thread
template <typename T, typename F>
cudaError_t by_width(int d, int slots, F&& f) {
  const int nv = (d + 16 / sizeof(T) - 1) / (16 / sizeof(T));
  int tpr = 32;
  while (tpr < 1024 && tpr * slots < nv) tpr *= 2;
  switch (tpr) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    default: return f(std::integral_constant<int, 1024>{});
  }
}

size_t bwd_smem(int d, int tpr, int n, bool with_ws) {
  if (!with_ws) return 0;
  const int nk = ((d + n - 1) / n + tpr - 1) / tpr;
  return static_cast<size_t>(block_of(tpr) / tpr) * nk * (n / 4) * tpr * 16;
}

// f(Tag<T>, Tag<S>, TPR, smem) for the backward rows kernel at these
// shapes, with or without the dscale workspace's shared memory
template <typename F>
cudaError_t by_bwd_shape(int d, int x_bf16, int scale_bf16, bool with_ws,
                         F&& f) {
  return by_types(x_bf16, scale_bf16, [&](auto xt, auto st) -> cudaError_t {
    using T = typename decltype(xt)::type;
    constexpr int N = 16 / sizeof(T);
    return by_width<T>(d, kElemsBwd / N, [&](auto tpr) -> cudaError_t {
      const size_t smem = bwd_smem(d, decltype(tpr)::value, N, with_ws);
      if (smem > 227 * 1024) return cudaErrorInvalidValue;
      return f(xt, st, tpr, smem);
    });
  });
}

}  // namespace

// x and y: (rows, d) contiguous, x_bf16 selects bf16 (else float32);
// scale: (d,), scale_bf16 likewise.  Returns the launch's cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              long long rows, int d, int x_bf16,
                              int scale_bf16, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_types(x_bf16, scale_bf16, [&](auto xt, auto st) -> cudaError_t {
    using T = typename decltype(xt)::type;
    using S = typename decltype(st)::type;
    constexpr int N = 16 / sizeof(T);
    return by_width<T>(d, kSlots, [&](auto tpr) -> cudaError_t {
      constexpr int TPR = decltype(tpr)::value;
      static const int per_sm =
          resident_ctas(rmsnorm_fwd<T, S, TPR>, block_of(TPR), 0);
      const bool vec =
          d % N == 0 && aligned(x) && aligned(y) && aligned(scale);
      rmsnorm_fwd<T, S, TPR><<<grid_for(rows, TPR, per_sm), block_of(TPR),
                               0, s>>>(
          static_cast<const T*>(x), static_cast<const S*>(scale),
          static_cast<T*>(y), rows, d, eps, vec);
      return cudaGetLastError();
    });
  });
}

// The grid rmsnorm_bwd_launch takes for these shapes, with a dscale
// workspace (with_ws) or without: the workspace's rows.  Returns the grid
// (>= 1), or minus a cudaError_t.
extern "C" int rmsnorm_bwd_grid(long long rows, int d, int x_bf16,
                                int scale_bf16, int with_ws) {
  if (rows <= 0 || d <= 0) return 1;
  int grid = 0;
  const cudaError_t err = by_bwd_shape(
      d, x_bf16, scale_bf16, with_ws != 0,
      [&](auto xt, auto st, auto tpr, size_t smem) -> cudaError_t {
        using T = typename decltype(xt)::type;
        using S = typename decltype(st)::type;
        constexpr int TPR = decltype(tpr)::value;
        grid = grid_for(rows, TPR,
                        resident_ctas(rmsnorm_bwd_rows<T, S, TPR>,
                                      block_of(TPR), smem));
        return cudaSuccess;
      });
  return err != cudaSuccess ? -static_cast<int>(err) : grid;
}

// x, g, dx: (rows, d) contiguous in x's type; scale and dscale (d,) in
// scale's type; ws (grid, d) fp32.  Launches rmsnorm_bwd_rows on `grid`
// CTAs (dx == NULL skips dx), then, unless dscale == NULL, rmsnorm_bwd_cols
// to sum the partial rows it wrote to ws into dscale: 1 or 2 launches.
// Returns the first failing launch's cudaError_t, or 0.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* g, void* dx, void* ws,
                                  void* dscale, int grid, long long rows,
                                  int d, int x_bf16, int scale_bf16,
                                  float eps, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = dscale != nullptr ? static_cast<float*>(ws) : nullptr;
  const cudaError_t err = by_bwd_shape(
      d, x_bf16, scale_bf16, w != nullptr,
      [&](auto xt, auto st, auto tpr, size_t smem) -> cudaError_t {
        using T = typename decltype(xt)::type;
        using S = typename decltype(st)::type;
        constexpr int TPR = decltype(tpr)::value;
        constexpr int N = 16 / sizeof(T);
        if (smem > 48 * 1024) {
          cudaFuncSetAttribute(rmsnorm_bwd_rows<T, S, TPR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
        }
        const bool vec = d % N == 0 && aligned(x) && aligned(g) &&
                         aligned(scale) && (dx == nullptr || aligned(dx)) &&
                         (w == nullptr || aligned(w));
        rmsnorm_bwd_rows<T, S, TPR><<<grid, block_of(TPR), smem, s>>>(
            static_cast<const T*>(x), static_cast<const S*>(scale),
            static_cast<const T*>(g), static_cast<T*>(dx), w, rows, d, eps,
            vec);
        return cudaGetLastError();
      });
  if (err != cudaSuccess || dscale == nullptr) return err;
  const dim3 cols((d + 31) / 32);
  if (scale_bf16) {
    rmsnorm_bwd_cols<__nv_bfloat16><<<cols, 32 * kColLanes, 0, s>>>(
        w, static_cast<__nv_bfloat16*>(dscale), grid, d);
  } else {
    rmsnorm_bwd_cols<float><<<cols, 32 * kColLanes, 0, s>>>(
        w, static_cast<float*>(dscale), grid, d);
  }
  return cudaGetLastError();
}
