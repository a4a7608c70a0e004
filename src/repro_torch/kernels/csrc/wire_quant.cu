// Packed int8 cut wire: per-row absmax quantize and its dequantize.
//
// Replaces the TPU kernels in src/repro/kernels/wire_quant.py:
//   wire_quant_pallas   (_quant_kernel)   -> quant_narrow, quant_wide
//   wire_dequant_pallas (_dequant_kernel) -> dequant_rows
//
// Contract (bitwise equal to the plain torch version and to the
// reference's oracle):
//   scale = max(absmax(row) * f32(1/127), f32(1e-12))
//   q     = int8(clip(round_half_even(x / scale), -127, 127))
//   deq   = (float(q) * scale) rounded to the output type
// x / scale is the IEEE quotient, formed from the row's correctly rounded
// reciprocal and one FMA correction (div_rn; this file must not be built
// with --use_fast_math).  The clipped quotient is rounded half to even
// and converted in one add of 1.5 * 2^23 (round to nearest even leaves
// the integer, two's complement, in the low byte: the value rintf then a
// cast gives).  float(q) is formed exactly as (2^23 + 128 + q) - (2^23 +
// 128) from the byte; bf16 goes through __floats2bfloat162_rn.  Inputs
// are taken to be finite: a NaN in a row does not propagate into its
// scale.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes.  The quantize reads x
// once and writes q and the scales: the RecurrentGemma prefill payload
// (4, 4096, 2560) bf16 moves 126 MB (37.6 us); the logits rows (4, 1,
// 200064) bf16 move 2.4 MB (0.72 us); the decode payloads a few KB, bound
// by the launch instead.
//
// Design.  The absmax needs the whole row before the first element can
// be quantized, so each row is read once into on-chip storage and
// quantized from there:
// - Rows of at most 16 KB of x: a group of 1, 2, 4 or 8 warps per row,
//   the group as small as fills the SMs, up to eight warps a block.  Each
//   lane loads its share of the row into registers as raw 16-byte
//   vectors, all loads issued before the first max; the max comes from
//   __shfl_xor_sync (and, for a group of several warps, one exchange
//   through shared memory); the quantize runs from the registers with
//   8-byte stores of q.
// - Wider rows (the logits): a thread-block cluster per row, 16 blocks
//   where the runtime admits that non-portable size (else 8; fewer for
//   rows under 32 KB), spread over distinct SMs.  Each thread holds one
//   group of 16 elements of its block's slice in registers (all loads
//   issued at once); a slice too large for that (rows over 256K
//   elements) comes into shared memory by bulk asynchronous copies
//   (cp.async.bulk, all issued at once, completing on one mbarrier).  Each
//   block pushes its maximum into a slot of every block of the cluster
//   (distributed shared memory), one cluster barrier publishes the
//   pushes, and each block reads the row's maximum locally: no block
//   reads a peer after the barrier, so none waits for its peers at its
//   exit.  The quantize runs from the on-chip copy with 16-byte stores.
// In both, a row whose start is not 16-byte aligned, or whose width is
// not a multiple of the vector, takes a scalar head and tail.
// - Dequantize: 16 int8 a thread (one 16-byte load), 32 B (bf16) or 64 B
//   (fp32) of output in 16-byte stores, the row's scale once a thread;
//   blocks of 64 threads along the row, rows by the grid's y.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// quantize, narrow rows
constexpr int kNarrowBytes = 16384;     // a row this wide or less: registers
constexpr int kNarrowWarps = 8;         // warps a block at most
constexpr int kUnit = 8;                // elements a lane holds per unit
constexpr int kLaneVectors = 8;         // 16-byte vectors a lane holds at most
constexpr int kWarpsPerSm = 16;         // the narrow grid's target
// quantize, wide rows
constexpr int kGroup = 16;              // elements a thread quantizes at once
constexpr int kWideMinThreads = 64;
constexpr int kWideMaxThreads = 1024;
constexpr int64_t kSliceTarget = 4096;  // bytes of x a block, for the split
constexpr int kBigCluster = 16;         // non-portable
constexpr int kPortableCluster = 8;
constexpr int kSliceCap = 200 * 1024;   // bytes of x a block holds
constexpr uint32_t kCopyChunk = 32768;  // bytes a bulk copy
// dequantize
constexpr int kDqThreads = 64;          // small blocks spread a payload wide

// ---------------------------------------------------------------------------
// element helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of x as floats
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {          // a bf16 is the top half of an f32
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

// v / s rounded once (IEEE), from y = 1/s rounded once (taken once a
// row): q0 = v y is within an ulp of v / s, the residual v - q0 s is
// exact in one FMA, and q0 + residual * y rounded once is the correctly
// rounded quotient (Markstein's theorem).  It needs no underflow in the
// residual: |v| >= 2^-103, far below any v whose quotient reaches 0.5
// (s >= 1e-12), so every quotient that can round to a nonzero q is exact.
__device__ __forceinline__ float div_rn(float v, float s, float y) {
  const float q0 = __fmul_rn(v, y);
  return __fmaf_rn(__fmaf_rn(-q0, s, v), y, q0);
}

// q of one element in the low byte: clip the quotient, then one
// round-to-nearest-even add of 1.5 * 2^23 (the sum stays in [2^23, 2^24),
// where the ulp is 1, so its mantissa is 2^22 + rint(r))
__device__ __forceinline__ uint32_t quant_bits(float v, float s, float y) {
  const float r = fminf(fmaxf(div_rn(v, s, y), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(r, 12582912.f));
}

// the low bytes of four quant_bits, little-endian
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// q of `n` consecutive floats (n a multiple of 4) as n/4 packed words
template <int n>
__device__ __forceinline__ void quant_words(const float* f, float s,
                                            float y, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < n / 4; ++i) {
    w[i] = pack4(quant_bits(f[4 * i], s, y), quant_bits(f[4 * i + 1], s, y),
                 quant_bits(f[4 * i + 2], s, y),
                 quant_bits(f[4 * i + 3], s, y));
  }
}

// `n` bytes (4 | n) at p, in the widest stores p's alignment allows
template <int n>
__device__ __forceinline__ void store_bytes(int8_t* p, const uint32_t* w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if constexpr (n == 16) {
    if ((a & 15) == 0) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
  }
  if constexpr (n % 8 == 0) {
    if ((a & 7) == 0) {
#pragma unroll
      for (int i = 0; i < n / 8; ++i) {
        reinterpret_cast<uint2*>(p)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
      }
      return;
    }
  }
  if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < n / 4; ++i) reinterpret_cast<uint32_t*>(p)[i] = w[i];
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      p[i] = static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)));
    }
  }
}

// elements before the first 16-byte boundary at p, at most k
template <typename T>
__device__ __forceinline__ int64_t head_of(const T* p, int64_t k) {
  const int64_t h =
      ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T);
  return h < k ? h : k;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

// ---------------------------------------------------------------------------
// quantize, narrow rows: a warp per row, the row in registers
// ---------------------------------------------------------------------------

// A row is held by a group of `gw` warps (1, 2, 4 or 8; up to
// kNarrowWarps / gw rows a block), kU units of kUnit elements a lane:
// unit u of the
// row's 16-byte aligned body is held by lane u % (32 gw) of the group in
// slot u / (32 gw) (neighbouring lanes, neighbouring addresses).  One
// warp a row reduces by shuffles alone; a larger group adds one exchange
// through shared memory.
template <typename T, int kU>
__global__ void __launch_bounds__(kNarrowWarps * 32)
quant_narrow(const T* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scale, int64_t rows, int64_t k, int gw,
             float inv127, float eps) {
  constexpr int N = Vec16<T>::N;
  constexpr int kV = kUnit / N;            // 16-byte vectors a unit
  __shared__ float part[kNarrowWarps];
  const int warp = threadIdx.x >> 5;
  const int glane = (warp % gw) * 32 + (threadIdx.x & 31);
  const int gsize = 32 * gw;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / gsize) + warp / gw;
  const bool valid = row < rows;
  const T* xr = x + row * k;
  int8_t* qr = q + row * k;
  const int64_t head = valid ? head_of(xr, k) : 0;
  const int units = valid ? static_cast<int>((k - head) / kUnit) : 0;
  const int64_t tail_at = head + static_cast<int64_t>(units) * kUnit;
  const int tail = valid ? static_cast<int>(k - tail_at) : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);

  uint4 raw[kU][kV];
#pragma unroll
  for (int j = 0; j < kU; ++j) {
    const int u = j * gsize + glane;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      raw[j][v] = u < units ? xv[u * kV + v] : make_uint4(0, 0, 0, 0);
    }
  }
  const float hx = glane < head ? to_f32(xr[glane]) : 0.f;
  const float tx = glane < tail ? to_f32(xr[tail_at + glane]) : 0.f;

  float amax = fmaxf(fabsf(hx), fabsf(tx));
#pragma unroll
  for (int j = 0; j < kU; ++j) {
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      float f[N];
      Vec16<T>::unpack(raw[j][v], f);
#pragma unroll
      for (int e = 0; e < N; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
  }
  amax = warp_max(amax);
  if (gw > 1) {                             // uniform across the block
    if ((threadIdx.x & 31) == 0) part[warp] = amax;
    __syncthreads();
    const int first = warp - warp % gw;
    for (int i = 0; i < gw; ++i) amax = fmaxf(amax, part[first + i]);
  }
  if (!valid) return;
  const float s = fmaxf(__fmul_rn(amax, inv127), eps);
  const float y = __frcp_rn(s);
  if (glane == 0) scale[row] = s;
  if (glane < head) qr[glane] = static_cast<int8_t>(quant_bits(hx, s, y));
  if (glane < tail) {
    qr[tail_at + glane] = static_cast<int8_t>(quant_bits(tx, s, y));
  }

  int8_t* qb = qr + head;
#pragma unroll
  for (int j = 0; j < kU; ++j) {
    const int u = j * gsize + glane;
    if (u < units) {
      float f[kUnit];
#pragma unroll
      for (int v = 0; v < kV; ++v) Vec16<T>::unpack(raw[j][v], f + v * N);
      uint32_t w[2];
      quant_words<kUnit>(f, s, y, w);
      store_bytes<kUnit>(qb + u * kUnit, w);
    }
  }
}

// ---------------------------------------------------------------------------
// quantize, wide rows: a cluster per row, each block's slice on chip
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && ++spins == (1u << 26)) __trap();   // a lost copy faults
  } while (!done);
}

// q of the `n` vectors (n <= kG) of one group of 16 elements, at q
template <typename T>
__device__ __forceinline__ void quant_group(const uint4* v, int n, float s,
                                            float y, int8_t* q) {
  constexpr int N = Vec16<T>::N;
  constexpr int kG = kGroup / N;
  float f[kGroup];
#pragma unroll
  for (int i = 0; i < kG; ++i) Vec16<T>::unpack(v[i], f + i * N);
  if (n == kG) {
    uint32_t w[4];
    quant_words<kGroup>(f, s, y, w);
    store_bytes<kGroup>(q, w);
    return;
  }
  for (int i = 0; i < n; ++i) {      // the row's last, partial group
    uint32_t w[N / 4];
    quant_words<N>(f + i * N, s, y, w);
    store_bytes<N>(q + i * N, w);
  }
}

// grid: rows * cluster blocks, cluster (cluster, 1, 1).  Block `rank` of a
// row's cluster owns elements [head + rank * slice, head + (rank + 1) *
// slice) of the row's 16-byte aligned body (slice a multiple of kGroup);
// rank 0 also the scalar head, the last rank the scalar tail.  The slice
// is held as groups of kGroup elements: one a thread in registers
// (kRegs), or all of it in shared memory, filled by bulk copies.
template <typename T, bool kRegs>
__global__ void __launch_bounds__(kWideMaxThreads)
quant_wide(const T* __restrict__ x, int8_t* __restrict__ q,
           float* __restrict__ scale, int64_t k, int cluster, int64_t slice,
           float inv127, float eps) {
  constexpr int N = Vec16<T>::N;
  constexpr int kG = kGroup / N;           // 16-byte vectors a group
  extern __shared__ __align__(128) uint4 buf[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float warp_maxes[kWideMaxThreads / 32];
  __shared__ float maxes[kBigCluster];     // the cluster's block maxima

  cluster_arrive_relaxed();   // this block has started (waited on below)
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int64_t row = blockIdx.x / cluster;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * k;
  int8_t* qr = q + row * k;
  const int64_t head = head_of(xr, k);
  const int64_t body = (k - head) / N * N;
  const int64_t tail = k - head - body;
  const int64_t lo = rank * slice < body ? rank * slice : body;
  const int64_t hi = lo + slice < body ? lo + slice : body;
  const int nvec = static_cast<int>((hi - lo) / N);
  const uint4* src = reinterpret_cast<const uint4*>(xr + head + lo);

  uint4 reg[kG];
  if constexpr (kRegs) {
#pragma unroll
    for (int v = 0; v < kG; ++v) {
      const int i = threadIdx.x * kG + v;
      reg[v] = i < nvec ? src[i] : make_uint4(0, 0, 0, 0);
    }
  } else {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0 && nvec > 0) {
      const uint32_t bytes = static_cast<uint32_t>(nvec) * 16u;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(&bar)),
          "r"(bytes)
          : "memory");
      const char* from = reinterpret_cast<const char*>(src);
      for (uint32_t off = 0; off < bytes; off += kCopyChunk) {
        const uint32_t n =
            bytes - off < kCopyChunk ? bytes - off : kCopyChunk;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(buf) + off),
            "l"(from + off), "r"(n), "r"(smem_u32(&bar))
            : "memory");
      }
    }
  }
  // the scalar head (rank 0, threads 0..) and tail (last rank, threads
  // 32..), straight into a register
  int64_t edge_at = -1;
  if (rank == 0 && threadIdx.x < head) edge_at = threadIdx.x;
  if (rank == cluster - 1 && threadIdx.x >= 32 && threadIdx.x - 32 < tail) {
    edge_at = head + body + (threadIdx.x - 32);
  }
  const float edge = edge_at >= 0 ? to_f32(xr[edge_at]) : 0.f;

  float amax = fabsf(edge);
  if constexpr (kRegs) {
#pragma unroll
    for (int v = 0; v < kG; ++v) {
      float f[N];
      Vec16<T>::unpack(reg[v], f);
#pragma unroll
      for (int e = 0; e < N; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
  } else {
    if (nvec > 0) mbar_wait(&bar, 0);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      float f[N];
      Vec16<T>::unpack(buf[i], f);
#pragma unroll
      for (int e = 0; e < N; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
  }
  amax = warp_max(amax);
  if (lane == 0) warp_maxes[threadIdx.x >> 5] = amax;
  __syncthreads();
  cluster_wait();       // every block of the cluster has started
  if (threadIdx.x < 32) {
    // the block's maximum, pushed into every block's slot for this rank
    const float m =
        warp_max(lane < static_cast<int>(blockDim.x >> 5) ? warp_maxes[lane]
                                                            : 0.f);
    if (lane < cluster) *cl.map_shared_rank(&maxes[rank], lane) = m;
  }
  // one barrier publishes the pushes; no block touches a peer after it, so
  // none has to wait for its peers before it exits
  cluster_arrive();
  cluster_wait();
  float m = 0.f;
  for (int i = 0; i < cluster; ++i) m = fmaxf(m, maxes[i]);
  const float s = fmaxf(__fmul_rn(m, inv127), eps);
  const float y = __frcp_rn(s);

  if (rank == 0 && threadIdx.x == 0) scale[row] = s;
  if (edge_at >= 0) qr[edge_at] = static_cast<int8_t>(quant_bits(edge, s, y));
  int8_t* qs = qr + head + lo;
  const int groups = (nvec + kG - 1) / kG;
  if constexpr (kRegs) {
    const int g = threadIdx.x;
    if (g < groups) {
      const int n = nvec - g * kG < kG ? nvec - g * kG : kG;
      quant_group<T>(reg, n, s, y, qs + g * kGroup);
    }
  } else {
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const int n = nvec - g * kG < kG ? nvec - g * kG : kG;
      quant_group<T>(buf + g * kG, n, s, y, qs + g * kGroup);
    }
  }
}

// ---------------------------------------------------------------------------
// dequantize
// ---------------------------------------------------------------------------

// float(q) of byte j of w ^ 0x80808080: (2^23 + q + 128) - (2^23 + 128)
__device__ __forceinline__ float i8_to_f32(uint32_t w_biased, int j) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7440 + j)),
      8388736.f);
}

template <typename OutT>
__device__ __forceinline__ OutT from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 int8 (one 16-byte vector) times s into 16 outputs at o (16-byte
// aligned)
__device__ __forceinline__ void dequant16(uint4 qv, float s, float* o) {
  const uint32_t w[4] = {qv.x ^ 0x80808080u, qv.y ^ 0x80808080u,
                         qv.z ^ 0x80808080u, qv.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    reinterpret_cast<float4*>(o)[i] = make_float4(
        __fmul_rn(i8_to_f32(w[i], 0), s), __fmul_rn(i8_to_f32(w[i], 1), s),
        __fmul_rn(i8_to_f32(w[i], 2), s), __fmul_rn(i8_to_f32(w[i], 3), s));
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void dequant16(uint4 qv, float s,
                                          __nv_bfloat16* o) {
  const uint32_t w[4] = {qv.x ^ 0x80808080u, qv.y ^ 0x80808080u,
                         qv.z ^ 0x80808080u, qv.w ^ 0x80808080u};
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[2 * i] = bf16x2_bits(__fmul_rn(i8_to_f32(w[i], 0), s),
                           __fmul_rn(i8_to_f32(w[i], 1), s));
    h[2 * i + 1] = bf16x2_bits(__fmul_rn(i8_to_f32(w[i], 2), s),
                               __fmul_rn(i8_to_f32(w[i], 3), s));
  }
  reinterpret_cast<uint4*>(o)[0] = make_uint4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<uint4*>(o)[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// slot v of a row: vector v of the row's 16-byte aligned body (where q
// and the output line up on 16-byte boundaries), slot 0 also the scalar
// head and the last slot the scalar tail; a row where they do not line up
// is scalar, 16 elements a slot.  Grid: slots by x, rows by y (and every
// gridDim.y-th row after).
template <typename OutT>
__global__ void __launch_bounds__(kDqThreads)
dequant_rows(const int8_t* __restrict__ q, const float* __restrict__ scale,
             OutT* __restrict__ out, int64_t rows, int64_t k, int64_t slots) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kDqThreads +
                    threadIdx.x;
  if (v >= slots) return;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int8_t* qr = q + row * k;
    OutT* orow = out + row * k;
    const float s = scale[row];
    const int64_t head = head_of(qr, k);
    auto one = [&](int64_t e) {
      orow[e] = from_f32<OutT>(__fmul_rn(static_cast<float>(qr[e]), s));
    };
    if ((reinterpret_cast<uintptr_t>(orow + head) & 15) != 0) {
      const int64_t hi = 16 * v + 16 < k ? 16 * v + 16 : k;
      for (int64_t e = 16 * v; e < hi; ++e) one(e);
      continue;
    }
    const int64_t nv = (k - head) / 16;
    if (v < nv) {
      dequant16(reinterpret_cast<const uint4*>(qr + head)[v], s,
                orow + head + 16 * v);
    }
    if (v == 0) {
      for (int64_t e = 0; e < head; ++e) one(e);
    }
    if (v == slots - 1) {
      for (int64_t e = head + 16 * nv; e < k; ++e) one(e);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int sm_count(cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// the narrow kernel holding kU units a lane, for the least kU >= need
template <typename T, int kU>
cudaError_t launch_narrow(int need, int gw, int per_block, const T* x,
                          int8_t* q, float* s, int64_t rows, int64_t k,
                          float inv127, float eps, cudaStream_t stream) {
  if constexpr (kU > 1) {
    if (need < kU) {
      return launch_narrow<T, kU - 1>(need, gw, per_block, x, q, s, rows, k,
                                      inv127, eps, stream);
    }
  }
  const int64_t blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quant_narrow<T, kU><<<static_cast<unsigned>(blocks), per_block * gw * 32,
                        0, stream>>>(x, q, s, rows, k, gw, inv127, eps);
  return cudaSuccess;
}

// warps a row: enough that a lane's units fit its registers, then more
// while the grid has fewer warps than the SMs take and every lane still
// holds a unit; rows a block: as many as fit kNarrowWarps, but no more
// than spreads the rows over the SMs
template <typename T>
cudaError_t narrow(const T* x, int8_t* q, float* s, int64_t rows, int64_t k,
                   float inv127, float eps, cudaStream_t stream) {
  constexpr int kMaxU = kLaneVectors / (kUnit / Vec16<T>::N);
  cudaError_t err;
  const int64_t sms = sm_count(&err);
  if (err != cudaSuccess) return err;
  const int64_t units = k / kUnit;
  int gw = 1;
  while (gw < kNarrowWarps && units > 32LL * gw * kMaxU) gw *= 2;
  while (gw < kNarrowWarps && rows * gw < sms * kWarpsPerSm &&
         units >= 64LL * gw) {
    gw *= 2;
  }
  const int64_t spread = (rows + sms - 1) / sms;
  const int per_block = static_cast<int>(
      spread < kNarrowWarps / gw ? spread : kNarrowWarps / gw);
  const int need = static_cast<int>((units + 32 * gw - 1) / (32 * gw));
  return launch_narrow<T, kMaxU>(need, gw, per_block, x, q, s, rows, k,
                                 inv127, eps, stream);
}

// the wide kernel's launch at `cluster` blocks a row: a group a thread in
// registers where a block of at most 1024 threads holds the slice so,
// else the slice in shared memory
struct WidePlan {
  int cluster;
  int64_t slice;        // elements, a multiple of kGroup
  bool regs;
  int threads;
  size_t smem;
};

template <typename T>
WidePlan wide_plan(int64_t k, int cluster) {
  WidePlan p;
  p.cluster = cluster;
  const int64_t per = (k + cluster - 1) / cluster;
  p.slice = (per + kGroup - 1) / kGroup * kGroup;
  const int64_t groups = p.slice / kGroup;
  p.regs = groups <= kWideMaxThreads;
  int64_t t = (groups + 31) / 32 * 32;
  if (t < kWideMinThreads) t = kWideMinThreads;
  if (t > kWideMaxThreads) t = kWideMaxThreads;
  p.threads = static_cast<int>(t);
  p.smem = p.regs ? 0 : static_cast<size_t>(p.slice) * sizeof(T);
  return p;
}

template <typename T>
using WideKernel = void (*)(const T*, int8_t*, float*, int64_t, int, int64_t,
                            float, float);

template <typename T>
WideKernel<T> wide_kernel(bool regs) {
  return regs ? quant_wide<T, true> : quant_wide<T, false>;
}

// clusters of a launch that fit on the card at once (0: refused), asked of
// the runtime once per kernel and shape of launch
int co_resident(const void* kernel, const cudaLaunchConfig_t& cfg) {
  struct Fit {
    const void* kernel;
    unsigned cluster, threads;
    size_t smem;
    int clusters;
  };
  static Fit fits[64];
  static int n_fits = 0;
  const unsigned cluster = cfg.attrs[0].val.clusterDim.x;
  for (int i = 0; i < n_fits; ++i) {
    if (fits[i].kernel == kernel && fits[i].cluster == cluster &&
        fits[i].threads == cfg.blockDim.x &&
        fits[i].smem == cfg.dynamicSmemBytes) {
      return fits[i].clusters;
    }
  }
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();            // a refused size is an answer here
    n = 0;
  }
  if (n_fits < 64) {
    fits[n_fits++] = {kernel, cluster, cfg.blockDim.x, cfg.dynamicSmemBytes,
                      n};
  }
  return n;
}

template <typename T>
cudaError_t wide(const T* x, int8_t* q, float* s, int64_t rows, int64_t k,
                 float inv127, float eps, cudaStream_t stream) {
  static bool opted_in = false;
  cudaError_t err;
  if (!opted_in) {
    err = cudaFuncSetAttribute(
        wide_kernel<T>(true), cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        wide_kernel<T>(false), cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wide_kernel<T>(false),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSliceCap);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicySpread;   // a block per SM where it can
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cfg.stream = stream;
  auto use = [&](const WidePlan& p, unsigned grid) {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    attr[0].val.clusterDim.x = p.cluster;
  };
  auto fit = [&](const WidePlan& p) -> int64_t {
    if (p.smem > static_cast<size_t>(kSliceCap)) return 0;
    use(p, p.cluster);
    return co_resident(
        reinterpret_cast<const void*>(wide_kernel<T>(p.regs)), cfg);
  };

  int64_t want = (k * static_cast<int64_t>(sizeof(T)) + kSliceTarget - 1) /
                 kSliceTarget;
  if (want < 2) want = 2;
  WidePlan plan = wide_plan<T>(k, static_cast<int>(
      want > kPortableCluster ? kPortableCluster : want));
  int64_t n = fit(plan);
  if (want > kPortableCluster) {
    // 16 a row where the runtime admits it and it runs at least as many
    // blocks at once as 8 does
    const WidePlan big = wide_plan<T>(k, kBigCluster);
    const int64_t n_big = fit(big);
    if (n_big > 0 && (rows < n_big ? rows : n_big) * kBigCluster >=
                         (rows < n ? rows : n) * kPortableCluster) {
      plan = big;
      n = n_big;
    }
  }
  if (n == 0) return cudaErrorInvalidValue;   // a slice too large
  if (rows * plan.cluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  use(plan, static_cast<unsigned>(rows * plan.cluster));
  return cudaLaunchKernelEx(&cfg, wide_kernel<T>(plan.regs), x, q, s, k,
                            plan.cluster, plan.slice, inv127, eps);
}

template <typename T>
cudaError_t quant(const void* x, void* q, void* scale, int64_t rows,
                  int64_t k, float inv127, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  if (k * static_cast<int64_t>(sizeof(T)) <= kNarrowBytes) {
    return narrow<T>(xp, qp, sp, rows, k, inv127, eps, stream);
  }
  return wide<T>(xp, qp, sp, rows, k, inv127, eps, stream);
}

template <typename OutT>
cudaError_t launch_dequant(const void* q, const void* scale, void* out,
                           int64_t rows, int64_t k, cudaStream_t stream) {
  const int64_t slots = (k + 15) / 16;
  const int64_t x = (slots + kDqThreads - 1) / kDqThreads;
  if (x > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(x),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  dequant_rows<OutT><<<grid, kDqThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<OutT*>(out), rows, k, slots);
  return cudaSuccess;
}

}  // namespace

// x (rows, k) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1), contiguous
// -> q (rows, k) int8 and scale (rows,) float32.  Returns the launch's
// error (cudaErrorInvalidValue for a row too wide for a cluster's shared
// memory: over 3.2 MB of x), else cudaGetLastError().
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
// (out_bf16 = 0) or bfloat16 (out_bf16 = 1).  Returns the launch's error,
// else cudaGetLastError().
extern "C" int wire_dequant_launch(const void* q, const void* scale,
                                   void* out, long long rows, long long k,
                                   int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch_dequant<__nv_bfloat16>(q, scale, out, rows, k, st)
               : launch_dequant<float>(q, scale, out, rows, k, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
