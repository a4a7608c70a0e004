// Mamba2 SSD (state-space duality) scan over a whole sequence.
//
// Replaces the TPU kernel in src/repro/kernels/ssd_scan.py:
//   ssd_scan_pallas (_ssd_kernel) -> ssd_chain, ssd_output
//
// Contract (the plain torch version, kernels.ssd_scan.ssd_chunked_plain,
// a copy of the reference's nn/ssm.py:ssd_chunked): per batch row b and
// head h, with state group g = h / (H / G), decay a_t = exp(dt_t * A_h)
// and xd_t = x_t * dt_t,
//     S_t = a_t S_{t-1} + xd_t B_t^T      (S: P x N, float32)
//     y_t = S_t C_t                        (cast to x's type)
// from an initial state S_{-1} (zero, or the caller's (B, H, P, N)
// float32 state), and optionally the final state S_{S-1} out, which the
// TPU kernel computes in its scratch and drops.  Inside, everything is
// float32.  dt is float32 (the served model's is: dt_bias is float32),
// so xd_t = x_t * dt_t is a float32 product, as the reference's
// ssd_chunked forms it in the promoted type and the TPU kernel after
// upcasting x.
//
// The chunked (dual) form: the sequence is cut into tiles of kQ = 64
// rows, independent of the model's chunk (256 in Mamba2-130M; the SSD
// does not depend on the chunk length up to rounding).  In tile c, with
// cum_t the running sum of dt * A inside the tile (a parallel scan over
// its 64 rows),
//     y_t    = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) xd_s      (intra)
//              + exp(cum_t) S_in(c) C_t                            (inter)
//     dS(c)  = sum_s exp(cum_last - cum_s) xd_s B_s^T
//     S_in(c + 1) = exp(cum_last) S_in(c) + dS(c),  S_in(0) = S_{-1}
// The mask s <= t is applied before the exponential, so no exp of a
// large positive number is formed.  A ragged last tile is padded with
// dt = x = B = C = 0 rows, which neither decay nor feed the state.
//
// What bounds it on an H100 SXM: operations.  At the Mamba2 prefill
// (batch 4, 512 rows, 24 heads of P = 64, N = 128, one state group,
// bf16) the per-head work at this tile is about 1.8 GFLOP in float32
// (the masked product with xd, dS, the carried state's product with C),
// 27 us at the 67 TFLOP/s float32 rate; C B^T per (batch, group, tile)
// is 17 MFLOP of bf16 products, well under 1 us on the tensor cores; the
// 14 MB of inputs and outputs take 4 us at 3.35 TB/s.
//
// Design: two kernels in one call, the carried states between them in a
// float32 scratch, (B, tiles, H, N, P): 25 MB at the prefill, written
// once and read once.
// 1. ssd_chain, grid (N / 32 x P / 64, H, B), 128 threads: the chain
//    across tiles is elementwise in (p, n), so each block carries a
//    64 p x 32 n slice of one head's state in registers (4 x 4 a thread)
//    through the tiles in order.  Per tile it writes S_in(c) to the
//    scratch and adds dS(c) = x^T (dt_s exp(cum_last - cum_s) B_s), a
//    register-tiled FFMA product with B's 32 columns.  The next tile's x
//    and B rows come in as one TMA box each (completing on an mbarrier)
//    while this one computes, and the decays of 8 tiles are scanned at
//    once, a warp a tile.  It writes the final state.
// 2. ssd_output, grid (tiles, G x head runs, B), 256 threads: the tiles
//    in parallel.  C B^T is computed once per block, by one warpgroup
//    with wgmma m64n64k16 (bf16 products accumulated in float32 are
//    exact) from B and C tiles that TMA loads untransposed with the
//    128-byte swizzle (C the K-major A operand, B's rows the K-major B
//    operand), then reused by every head of the block's run of the
//    group's heads, whose decays are scanned up front, a warp a head.
//    Per head: M = C B^T exp(cum_t - cum_s) masked, and y = M xd +
//    exp(cum_t) C S_in^T as two register-tiled FFMA products, written once
//    in x's type; the next head's S_in^T and x rows come in by TMA
//    meanwhile.  Each thread holds 4 t x 4 p (each reduction step two
//    16-byte shared reads: one broadcast, one contiguous across the warp;
//    a warp pairs the short rows of M with the long ones).  The runs are
//    as long as keep the blocks to one wave (6 heads at the prefill:
//    4 x 8 x 4 = 128 blocks).
// float32 B and C take C B^T as FFMA in the same block; B and C whose
// strides TMA cannot address (rows not a multiple of 16 bytes, an
// unaligned base) are copied into the swizzled layout by the threads, and
// x or B rows that TMA cannot address are read in place.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;                // sequence rows per tile
constexpr int kPC = 64;               // state rows p per pass / chain block
constexpr int kNC = 32;               // state columns n per chain block
constexpr int kChainThreads = 128;    // (64 / 4) p x (32 / 4) n
constexpr int kTG = 8;                // tiles whose decays a chain block
                                      // scans at once
constexpr int kChainBufs = 2;         // tiles of x and B in flight
constexpr int kMaxRun = 8;            // heads of one ssd_output block
constexpr int kThreads = 256;
constexpr int kMaxN = 256;
constexpr int kLdq = kQ + 4;          // padded row of a 64 x 64 tile
constexpr int kChunk = 64;            // bf16 columns of a 128-byte row
constexpr int kChunkBytes = kQ * kChunk * 2;      // one 64 x 64 box, 8 KB
constexpr size_t kSmemCap = 232448;

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

struct Args {
  const void* x;            // (B, S, H, P): strides xb, xs, P, 1
  const float* dt;          // (B, S, H): strides db, ds, 1
  const float* A;           // (H,)
  const void* b;            // (B, S, G, N): strides bb, bs, N, 1
  const void* c;            // (B, S, G, N): strides cb, cs, N, 1
  const float* init;        // (B, H, P, N) contiguous, or null (zeros)
  void* y;                  // (B, S, H, P) contiguous
  float* final_state;       // (B, H, P, N) contiguous, or null
  float* states;            // scratch (B, T, H, N, Pp): S_in transposed
  int S, H, P, G, N;
  int Pp;                   // P rounded up to 4
  int T;                    // tiles
  int run;                  // heads per ssd_output block
  int runs;                 // runs per group
  int sbufs;                // prefetch buffers of ssd_output: 2, or 1
  int b_tma, x_tma;         // B (32-column boxes) and x reachable by TMA
  int64_t xb, xs, bb, bs, cb, cs, db, ds;
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four values to 16 (float) or 8 (bf16) bytes of aligned global memory
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const __nv_bfloat16 (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(static_cast<uint32_t>(__bfloat16_as_ushort(v[0])) |
                     (static_cast<uint32_t>(__bfloat16_as_ushort(v[1])) << 16),
                 static_cast<uint32_t>(__bfloat16_as_ushort(v[2])) |
                     (static_cast<uint32_t>(__bfloat16_as_ushort(v[3])) << 16));
}

// 16 bytes of T in shared memory as 16 / sizeof(T) floats
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// the inclusive running sum of v[0..63] into out, by one warp: lane l
// holds rows 2l and 2l + 1, the pair sums are scanned across the lanes
// (Kogge-Stone), and each pair is finished from the scan of the lanes
// before it
__device__ __forceinline__ void warp_scan64(const float* v, float* out) {
  const int lane = threadIdx.x & 31;
  const float a0 = v[2 * lane], a1 = v[2 * lane + 1];
  float run = a0 + a1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, run, d);
    if (lane >= d) run += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) excl = 0.f;
  const float c0 = excl + a0;
  out[2 * lane] = c0;
  out[2 * lane + 1] = c0 + a1;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed
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

// one 64 x 64 bf16 box at (n0, group, row0, batch), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int n0, int g,
                                         int row0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(n0),
      "r"(g), "r"(row0), "r"(batch)
      : "memory");
}

// one box at (col, row) of a 2-d map, completing on `bar`
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1); byte
// offsets in 16-byte units
__device__ __forceinline__ uint64_t make_desc(const void* smem,
                                              uint32_t lbo, uint32_t sbo) {
  uint64_t d = (smem_u32(smem) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
      "+f"(d[30]), "+f"(d[31])

// d (+)= A B over one k16 step, m64n64k16, A and B in shared memory, both
// K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32
      : "l"(da), "l"(db), "r"(scale_d));
}

// byte offset of element (row, col) of a tile of 64-column chunks with the
// 128-byte swizzle (the layout TMA writes and wgmma reads)
__device__ __forceinline__ int swz(int row, int col) {
  const int cc = col % kChunk;
  return (col / kChunk) * kChunkBytes + row * 128 +
         (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
}

// ---------------------------------------------------------------------------
// 1. the chain across tiles
// ---------------------------------------------------------------------------

// grid (ceil(N / kNC) * ceil(P / kPC), H, B), kChainThreads threads.
// Block (j, h, b) carries state columns n0 .. n0 + 31 and rows
// p0 .. p0 + 63 of head h; thread (tp, tn) = (tid % 16, tid / 16) owns
// p = p0 + 4 tp .. + 3 and n = n0 + 4 tn .. + 3.
template <typename T>
__global__ void __launch_bounds__(kChainThreads)
    ssd_chain(const __grid_constant__ CUtensorMap mbn,
              const __grid_constant__ CUtensorMap mx, const Args a) {
  extern __shared__ uint8_t smem_c[];
  uint8_t* base = smem_c + ((128 - (smem_u32(smem_c) & 127)) & 127);
  T* rawB = reinterpret_cast<T*>(base);          // [kChainBufs][kQ][kNC]
  T* rawX = rawB + kChainBufs * kQ * kNC;        // [kChainBufs][kQ][kPC]
  float* sB = reinterpret_cast<float*>(rawX + kChainBufs * kQ * kPC);
  float* sXW = sB + kQ * kNC;                    // x as [kQ][kPC] float
  float* sDt = sXW + kQ * kPC;                   // [kTG][kQ]
  float* sCum = sDt + kTG * kQ;                  // [kTG][kQ]: dt A, then
                                                 // its running sum
  float* sW = sCum + kTG * kQ;                   // [kTG][kQ]: dt_s exp(
                                                 // cum_last - cum_s)
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + kTG * kQ);

  const int nch = (a.N + kNC - 1) / kNC;
  const int n0 = (blockIdx.x % nch) * kNC, p0 = (blockIdx.x / nch) * kPC;
  const int nn = min(kNC, a.N - n0), pc = min(kPC, a.P - p0);
  const int h = blockIdx.y, bi = blockIdx.z, g = h / (a.H / a.G);
  const int tid = threadIdx.x, tp = tid % 16, tn = tid / 16;
  const float A = a.A[h];
  const T* bsrc = static_cast<const T*>(a.b) + bi * a.bb +
                  static_cast<int64_t>(g) * a.N + n0;
  const T* xsrc = static_cast<const T*>(a.x) + bi * a.xb +
                  static_cast<int64_t>(h) * a.P + p0;
  const float* dsrc = a.dt + bi * a.db + h;

  if (tid == 0) {
    for (int i = 0; i < kChainBufs; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile c's B columns and x rows into buffer `buf` by TMA (one box each,
  // rows past S as zeros), by thread 0; B or x that TMA cannot address is
  // read in place
  auto fetch = [&](int c, int buf) {
    mbar_expect_tx(full + buf, (a.b_tma ? kQ * kNC * sizeof(T) : 0) +
                                   (a.x_tma ? kQ * kPC * sizeof(T) : 0));
    if (a.b_tma) {
      tma_load(rawB + buf * kQ * kNC, &mbn, full + buf, n0, g, c * kQ, bi);
    }
    if (a.x_tma) {
      tma_load(rawX + buf * kQ * kPC, &mx, full + buf, p0, h, c * kQ, bi);
    }
  };

  const int64_t head = static_cast<int64_t>(bi) * a.H + h;
  float st[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * tp + i, n = n0 + 4 * tn + j;
      st[i][j] = a.init != nullptr && p < a.P && n < a.N
                     ? a.init[(head * a.P + p) * a.N + n]
                     : 0.f;
    }
  }

  // kChainBufs - 1 tiles ahead come in while tile c computes
  if (tid == 0) {
    for (int c = 0; c < kChainBufs - 1 && c < a.T; ++c) fetch(c, c);
  }
  for (int c = 0; c < a.T; ++c) {
    const int buf = c % kChainBufs, j = c % kTG;
    const int t0 = c * kQ, L = min(kQ, a.S - t0);
    if (j == 0) {
      // the running log decays of the next kTG tiles, a warp a tile
      __syncthreads();                  // the last group is read
      for (int i = tid; i < kTG * kQ; i += kChainThreads) {
        const int s = (c + i / kQ) * kQ + i % kQ;
        const float d = s < a.S ? dsrc[s * a.ds] : 0.f;
        sDt[i] = d;
        sCum[i] = d * A;
      }
      __syncthreads();
      for (int t = tid / 32; t < kTG; t += kChainThreads / 32) {
        warp_scan64(sCum + t * kQ, sCum + t * kQ);    // in place
        __syncwarp();
        const float last = sCum[t * kQ + kQ - 1];
        for (int s = tid % 32; s < kQ; s += 32) {
          sW[t * kQ + s] = sDt[t * kQ + s] * expf(last - sCum[t * kQ + s]);
        }
      }
    }
    mbar_wait(full + buf, (c / kChainBufs) & 1);
    __syncthreads();                    // tile c is in; tile c - 1 is done
    if (tid == 0 && c + kChainBufs - 1 < a.T) {
      fetch(c + kChainBufs - 1, (c + kChainBufs - 1) % kChainBufs);
    }
    const T* rb = rawB + buf * kQ * kNC;
    const T* rx = rawX + buf * kQ * kPC;
    const float* dw = sW + j * kQ;
    // B_s dt_s exp(cum_last - cum_s), and x, as float; what TMA brought
    // (zeros past S, N and P) 16 bytes a thread at a time
    constexpr int V = 16 / sizeof(T);
    if (a.b_tma) {
      for (int i = tid; i < kQ * kNC / V; i += kChainThreads) {
        const int s = i / (kNC / V), n = V * (i % (kNC / V));
        float f[V];
        load16(rb + s * kNC + n, f);
#pragma unroll
        for (int e = 0; e < V; ++e) sB[s * kNC + n + e] = f[e] * dw[s];
      }
    } else {
      for (int i = tid; i < kQ * kNC; i += kChainThreads) {
        const int s = i / kNC, n = i % kNC;
        sB[i] = s < L && n < nn ? to_f32(bsrc[(t0 + s) * a.bs + n]) * dw[s]
                                : 0.f;
      }
    }
    if (a.x_tma) {
      for (int i = tid; i < kQ * kPC / V; i += kChainThreads) {
        float f[V];
        load16(rx + V * i, f);
#pragma unroll
        for (int e = 0; e < V; ++e) sXW[V * i + e] = f[e];
      }
    } else {
      for (int i = tid; i < kQ * kPC; i += kChainThreads) {
        const int s = i / kPC, p = i % kPC;
        sXW[i] = s < L && p < pc ? to_f32(xsrc[(t0 + s) * a.xs + p]) : 0.f;
      }
    }
    // S_in(c) to the scratch, transposed: 16 bytes of 4 p for each n
    if (p0 + 4 * tp < a.Pp) {
      float* dst = a.states +
                   ((static_cast<int64_t>(bi) * a.T + c) * a.H + h) * a.N *
                       a.Pp + p0 + 4 * tp;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = n0 + 4 * tn + jj;
        if (n < a.N) {
          *reinterpret_cast<float4*>(dst + static_cast<int64_t>(n) * a.Pp) =
              make_float4(st[0][jj], st[1][jj], st[2][jj], st[3][jj]);
        }
      }
    }
    __syncthreads();
    // S = exp(cum_last) S + dS(c), dS = x^T (dt w B)
    float acc[4][4] = {};
#pragma unroll 8
    for (int s = 0; s < kQ; ++s) {
      const float4 xv = *reinterpret_cast<const float4*>(sXW + s * kPC + 4 * tp);
      const float4 bv = *reinterpret_cast<const float4*>(sB + s * kNC + 4 * tn);
      const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(x4[i], b4[jj], acc[i][jj]);
      }
    }
    const float decay = expf(sCum[j * kQ + kQ - 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) st[i][jj] = decay * st[i][jj] + acc[i][jj];
    }
  }
  if (a.final_state != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int p = p0 + 4 * tp + i, n = n0 + 4 * tn + jj;
        if (p < a.P && n < a.N) a.final_state[(head * a.P + p) * a.N + n] = st[i][jj];
      }
    }
  }
}

size_t chain_smem(size_t esize) {
  return 128 + kChainBufs * kQ * (kNC + kPC) * esize +
         sizeof(float) * (kQ * kNC + kQ * kPC + 3 * kTG * kQ) +
         kChainBufs * sizeof(uint64_t);
}

// ---------------------------------------------------------------------------
// 2. outputs: C B^T once per block on the tensor cores, then per head
// ---------------------------------------------------------------------------

struct OutLayout {
  int rows;        // rows of C^T and S^T: N rounded up to 4
  int tile_f;      // floats of the region holding S^T (or the bf16 tiles)
  size_t bytes;
};

__host__ __device__ inline OutLayout out_layout(int N, int sbufs,
                                                int esize) {
  OutLayout o;
  o.rows = round_up(N, 4);
  const int chunks = (N + kChunk - 1) / kChunk;
  const int s_f = sbufs * o.rows * kPC, tiles_f = 2 * chunks * kChunkBytes / 4;
  o.tile_f = round_up(s_f > tiles_f ? s_f : tiles_f, 256);
  o.bytes = 1024 + sizeof(float) * (o.tile_f + o.rows * kPC + 3 * kQ * kLdq +
                                    3 * kMaxRun * kQ) +
            2 * kQ * kPC * esize + 3 * sizeof(uint64_t);
  return o;
}

// grid (T, G * runs, B), kThreads threads.  Block (c, g * runs + j, b)
// owns heads g (H / G) + j run .. + run - 1 of tile c.  Every operand of
// the FFMA products sits in shared memory with its reduction index as
// the row (C^T and S^T [n][.], M^T and xd [s][.]).
template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_output(const __grid_constant__ CUtensorMap mb,
               const __grid_constant__ CUtensorMap mc,
               const __grid_constant__ CUtensorMap ms,
               const __grid_constant__ CUtensorMap mx, const Args a) {
  constexpr bool kWg = sizeof(T) == 2;              // bf16: wgmma for C B^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const OutLayout lay = out_layout(a.N, a.sbufs, sizeof(T));
  const int nw = lay.rows;
  float* sST = reinterpret_cast<float*>(base);      // S^T [n][kPC] x sbufs,
                                                    // or the bf16 tiles
  uint8_t* sCt = base;                              // bf16 C, swizzled
  const int chunks = (a.N + kChunk - 1) / kChunk;
  uint8_t* sBt = base + chunks * kChunkBytes;       // bf16 B, swizzled
  float* sCT = sST + lay.tile_f;                    // C^T [n][kPC]
  float* sCBT = sCT + nw * kPC;                     // C B^T as [s][t]
  float* sMT = sCBT + kQ * kLdq;                    // M as [s][t]
  float* sXD = sMT + kQ * kLdq;                     // xd as [s][p]
  float* sDt = sXD + kQ * kLdq;                     // [kMaxRun][kQ] a head
  float* sCum = sDt + kMaxRun * kQ;                 // dt A, then its sum
  float* sEc = sCum + kMaxRun * kQ;                 // exp(cum_t)
  T* rawX = reinterpret_cast<T*>(sEc + kMaxRun * kQ);   // x [2][kQ][kPC]
  uint64_t* bar = reinterpret_cast<uint64_t*>(rawX + 2 * kQ * kPC);
  uint64_t* full = bar + 1;                         // [2]: an item's rows

  const int c = blockIdx.x, bi = blockIdx.z;
  const int rep = a.H / a.G;
  const int g = blockIdx.y / a.runs;
  const int h_first = g * rep + (blockIdx.y % a.runs) * a.run;
  const int h_end = min(h_first + a.run, (g + 1) * rep);
  const int t0 = c * kQ;
  const int L = min(kQ, a.S - t0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // C B^T of the tile, stored as CBT[s][t], and C^T as float
  if constexpr (kWg) {
    const int width = chunks * kChunk;
    if constexpr (kTma) {
      if (tid == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_expect_tx(bar, 2 * chunks * kChunkBytes);
        for (int k = 0; k < chunks; ++k) {
          tma_load(sCt + k * kChunkBytes, &mc, bar, k * kChunk, g, t0, bi);
          tma_load(sBt + k * kChunkBytes, &mb, bar, k * kChunk, g, t0, bi);
        }
      }
      __syncthreads();
      mbar_wait(bar, 0);
    } else {
      const T* bp = static_cast<const T*>(a.b);
      const T* cp = static_cast<const T*>(a.c);
      for (int i = tid; i < kQ * width; i += kThreads) {
        const int s = i / width, n = i % width;
        T bv = from_f32<T>(0.f), cv = from_f32<T>(0.f);
        if (s < L && n < a.N) {
          const int64_t tok = t0 + s;
          bv = bp[bi * a.bb + tok * a.bs + static_cast<int64_t>(g) * a.N + n];
          cv = cp[bi * a.cb + tok * a.cs + static_cast<int64_t>(g) * a.N + n];
        }
        *reinterpret_cast<T*>(sBt + swz(s, n)) = bv;
        *reinterpret_cast<T*>(sCt + swz(s, n)) = cv;
      }
      // generic-proxy writes, read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (tid < 128) {
      float d[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) d[r] = 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) asm volatile("" : "+f"(d[r])::"memory");
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int kk = 0; kk < chunks * (kChunk / 16); ++kk) {
        const int off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
        wgmma_ss(d, make_desc(sCt + off, 16, 1024),
                 make_desc(sBt + off, 16, 1024), kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int r = 0; r < 32; ++r) asm volatile("" : "+f"(d[r])::"memory");
      // warp w holds rows 16 w + lane / 4 (+ 8); register 4 j + e holds
      // column 8 j + 2 (lane % 4) + (e & 1)
      const int warp = tid / 32, lane = tid % 32;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * warp + lane / 4 + 8 * (e >> 1);
          const int s = 8 * j + 2 * (lane % 4) + (e & 1);
          sCBT[s * kLdq + t] = d[4 * j + e];
        }
      }
    }
    for (int i = tid; i < kQ * nw; i += kThreads) {
      const int t = i % kQ, n = i / kQ;
      sCT[n * kPC + t] =
          n < a.N ? __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                        sCt + swz(t, n)))
                  : 0.f;
    }
    __syncthreads();
  } else {
    // B^T and C^T as float, then C B^T by FFMA (4 t x 4 s a thread)
    const T* bp = static_cast<const T*>(a.b) + bi * a.bb +
                  static_cast<int64_t>(g) * a.N;
    const T* cp = static_cast<const T*>(a.c) + bi * a.cb +
                  static_cast<int64_t>(g) * a.N;
    float* sBT = sST;
    for (int i = tid; i < kQ * nw; i += kThreads) {
      const int s = i / nw, n = i % nw;
      const bool ok = s < L && n < a.N;
      sBT[n * kPC + s] = ok ? to_f32(bp[(t0 + s) * a.bs + n]) : 0.f;
      sCT[n * kPC + s] = ok ? to_f32(cp[(t0 + s) * a.cs + n]) : 0.f;
    }
    __syncthreads();
    const int ty = tid / 16, tx = tid % 16;
    float acc[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < nw; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(sCT + n * kPC + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(sBT + n * kPC + 4 * tx);
      const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(c4[i], b4[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sCBT[(4 * tx + j) * kLdq + 4 * ty + i] = acc[i][j];
    }
    __syncthreads();
  }

  // per head (and 64-row chunk of P): y = M xd + exp(cum_t) C S_in^T.
  // With two buffers, the next item's S_in^T rows and x rows come in by
  // TMA while this one computes.
  T* yp = static_cast<T*>(a.y);
  const int pchunks = (a.P + kPC - 1) / kPC;
  const int items = (h_end - h_first) * pchunks;

  // item it's S_in^T (one TMA box of the scratch: N rows of 64 p) and x
  // rows (one box) into buffer `buf`, by thread 0; x that TMA cannot
  // address is read in place
  auto x_rows = [&](int h, int p0) {
    return static_cast<const T*>(a.x) + bi * a.xb +
           static_cast<int64_t>(t0) * a.xs + static_cast<int64_t>(h) * a.P +
           p0;
  };
  auto fetch = [&](int it, int buf) {
    const int h = h_first + it / pchunks, p0 = (it % pchunks) * kPC;
    mbar_expect_tx(full + buf, a.N * kPC * sizeof(float) +
                                   (a.x_tma ? kQ * kPC * sizeof(T) : 0));
    tma_load2(sST + buf * nw * kPC, &ms, full + buf, p0,
              ((bi * a.T + c) * a.H + h) * a.N);
    if (a.x_tma) {
      tma_load(rawX + buf * kQ * kPC, &mx, full + buf, p0, h, t0, bi);
    }
  };

  // the running log decays of the run's heads over the tile, a warp a head
  for (int i = tid; i < (h_end - h_first) * kQ; i += kThreads) {
    const int hh = i / kQ, s = i % kQ;
    const float d = s < L ? a.dt[bi * a.db + static_cast<int64_t>(t0 + s) *
                                                 a.ds + h_first + hh]
                          : 0.f;
    sDt[i] = d;
    sCum[i] = d * a.A[h_first + hh];
  }
  __syncthreads();
  for (int hh = tid / 32; hh < h_end - h_first; hh += kThreads / 32) {
    warp_scan64(sCum + hh * kQ, sCum + hh * kQ);    // in place
    __syncwarp();
    for (int s = tid % 32; s < kQ; s += 32) {
      sEc[hh * kQ + s] = expf(sCum[hh * kQ + s]);
    }
  }

  // the rows of S^T past N stay zero: the copies write rows n < N only
  for (int i = tid; i < a.sbufs * (nw - a.N) * kPC; i += kThreads) {
    const int buf = i / ((nw - a.N) * kPC), r = i % ((nw - a.N) * kPC);
    sST[buf * nw * kPC + a.N * kPC + r] = 0.f;
  }
  if (items > 0 && tid == 0) fetch(0, 0);
  for (int it = 0; it < items; ++it) {
    const int h = h_first + it / pchunks;
    const int p0 = (it % pchunks) * kPC, pc = min(kPC, a.P - p0);
    const int buf = a.sbufs == 2 ? it & 1 : 0;
    const float* sS = sST + buf * nw * kPC;
    const T* rx = rawX + buf * kQ * kPC;
    const float* dts = sDt + (h - h_first) * kQ;
    const float* cum = sCum + (h - h_first) * kQ;
    const float* ecs = sEc + (h - h_first) * kQ;
    const bool next = it + 1 < items;

    mbar_wait(full + buf, (it / a.sbufs) & 1);
    __syncthreads();                    // item it is in; item it - 1 done
    if (next && a.sbufs == 2 && tid == 0) fetch(it + 1, buf ^ 1);
    // xd = x dt: what TMA brought (zeros past S and P) 16 bytes a thread
    // at a time
    const T* xsrc = x_rows(h, p0);
    constexpr int V = 16 / sizeof(T);
    if (a.x_tma) {
      for (int i = tid; i < kQ * kPC / V; i += kThreads) {
        const int s = i / (kPC / V), p = V * (i % (kPC / V));
        float f[V];
        load16(rx + s * kPC + p, f);
#pragma unroll
        for (int e = 0; e < V; ++e) sXD[s * kLdq + p + e] = f[e] * dts[s];
      }
    } else {
      for (int i = tid; i < kQ * kPC; i += kThreads) {
        const int s = i / kPC, p = i % kPC;
        sXD[s * kLdq + p] =
            s < L && p < pc ? to_f32(xsrc[s * a.xs + p]) * dts[s] : 0.f;
      }
    }
    // M[t][s] = C B^T[t][s] exp(cum_t - cum_s) for s <= t, else 0; four t
    // a thread, the exponentials only where some s <= t
    for (int i = tid; i < kQ * kQ / 4; i += kThreads) {
      const int s = i / (kQ / 4), t = 4 * (i % (kQ / 4));
      float m[4] = {0.f, 0.f, 0.f, 0.f};
      if (s <= t + 3) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (s <= t + e) {
            m[e] = sCBT[s * kLdq + t + e] * __expf(cum[t + e] - cum[s]);
          }
        }
      }
      *reinterpret_cast<float4*>(sMT + s * kLdq + t) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();

    const int pw = round_up(pc, 4), n_tp = pw / 4;
    for (int tile = tid; tile < 16 * n_tp; tile += kThreads) {
      // 4 t x 4 p; the rows of M a thread walks grow with t, so each
      // warp pairs row group u with 15 - u
      const int u = tile / n_tp, tx = tile % n_tp;
      const int ty = u & 1 ? 15 - u / 2 : u / 2;
      float intra[4][4] = {}, inter[4][4] = {};
      const int s_end = 4 * ty + 4;                     // M is 0 past t
      for (int s = 0; s < s_end; ++s) {
        const float4 mv = *reinterpret_cast<const float4*>(sMT + s * kLdq + 4 * ty);
        const float4 xv = *reinterpret_cast<const float4*>(sXD + s * kLdq + 4 * tx);
        const float m4[4] = {mv.x, mv.y, mv.z, mv.w};
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) intra[i][j] = fmaf(m4[i], x4[j], intra[i][j]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < nw; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(sCT + n * kPC + 4 * ty);
        const float4 sv = *reinterpret_cast<const float4*>(sS + n * kPC + 4 * tx);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(c4[i], s4[j], inter[i][j]);
        }
      }
      // four p of one row as one 8- or 16-byte store where P allows
      const bool whole = a.P % 4 == 0 && 4 * tx + 3 < pc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        if (t >= L) continue;
        const float ec = ecs[t];
        T* row = yp + ((static_cast<int64_t>(bi) * a.S + t0 + t) * a.H + h) *
                          a.P + p0 + 4 * tx;
        T v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = from_f32<T>(intra[i][j] + ec * inter[i][j]);
        if (whole) {
          store4(row, v);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (4 * tx + j < pc) row[j] = v[j];
          }
        }
      }
    }
    if (next && a.sbufs == 1) {
      __syncthreads();                  // the one set of buffers is read
      if (tid == 0) fetch(it + 1, 0);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's driver entry point, so the library links the runtime only
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a map over a (B, S, heads, width) tensor through its element strides
// (a size-1 axis's stride is free), boxes of `box_w` columns x 1 head x
// 64 rows x 1 batch; rows past S and columns past `width` read as zeros.
// False where TMA cannot address the tensor (a base not 16-byte aligned,
// strides not multiples of 16 bytes).
bool make_map(CUtensorMap* map, const void* ptr, int esize, int batch, int S,
              int heads, int width, long long sb, long long ss,
              int box_w, bool swizzle) {
  const long long hs = static_cast<long long>(width) * esize;
  const long long rs = ss * esize;
  const long long bs = (batch == 1 ? ss * S : sb) * esize;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || (heads > 1 && hs % 16) ||
      rs % 16 || bs % 16 || rs <= 0) {
    return false;
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(heads > 1 ? hs : rs),
                                 static_cast<cuuint64_t>(rs),
                                 static_cast<cuuint64_t>(bs)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_w), 1, kQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-d map over the scratch of transposed states, (rows, Pp) float32,
// boxes of 64 p x N rows
bool make_states_map(CUtensorMap* map, float* states, long long rows, int Pp,
                     int N) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Pp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Pp) * 4};
  const cuuint32_t box[2] = {kPC, static_cast<cuuint32_t>(N)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, states, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(Args a, int batch, cudaStream_t stream) {
  int dev = 0, sm_count = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                               dev);
  if (err != cudaSuccess) return err;
  constexpr int e = sizeof(T);
  CUtensorMap mbn = {}, mx = {}, mb = {}, mc = {}, ms = {};
  a.b_tma = make_map(&mbn, a.b, e, batch, a.S, a.G, a.N, a.bb, a.bs, kNC,
                     false);
  a.x_tma = make_map(&mx, a.x, e, batch, a.S, a.H, a.P, a.xb, a.xs, kPC,
                     false);
  if (!make_states_map(&ms, a.states,
                       static_cast<long long>(batch) * a.T * a.H * a.N,
                       a.Pp, a.N)) {
    return cudaErrorInvalidValue;
  }

  // 1. the chain: S_in(c) of every tile, and the final state
  const size_t smem1 = chain_smem(e);
  err = cudaFuncSetAttribute(ssd_chain<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  const int slices = ((a.N + kNC - 1) / kNC) * ((a.P + kPC - 1) / kPC);
  ssd_chain<T><<<dim3(slices, a.H, batch), kChainThreads, smem1, stream>>>(
      mbn, mx, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 2. outputs: runs of a group's heads, as long as keep one wave
  const int rep = a.H / a.G;
  const long long per_run = static_cast<long long>(a.T) * a.G * batch;
  int runs = static_cast<int>(sm_count / per_run);
  runs = runs < 1 ? 1 : (runs > rep ? rep : runs);
  a.run = (rep + runs - 1) / runs;
  if (a.run > kMaxRun) a.run = kMaxRun;
  a.runs = (rep + a.run - 1) / a.run;
  a.sbufs = out_layout(a.N, 2, e).bytes <= kSmemCap ? 2 : 1;
  const size_t smem2 = out_layout(a.N, a.sbufs, e).bytes;
  if (smem2 > kSmemCap) return cudaErrorInvalidValue;
  const bool tma = e == 2 &&
                   make_map(&mb, a.b, e, batch, a.S, a.G, a.N, a.bb, a.bs,
                            kChunk, true) &&
                   make_map(&mc, a.c, e, batch, a.S, a.G, a.N, a.cb, a.cs,
                            kChunk, true);
  auto kernel = tma ? ssd_output<T, true> : ssd_output<T, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.T, a.G * a.runs, batch), kThreads, smem2, stream>>>(
      mb, mc, ms, mx, a);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; x, B, C are bf16 when x_bf16 (else float32);
// dt, A, init and final_state are float32.  init and final_state may be
// null.  scratch holds B T H N round_up(P, 4) floats, T the number of
// 64-row tiles: each tile's carried-in state, transposed.  Returns the
// first launch error's cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* b, const void* c, const void* init,
                               void* y, void* final_state, void* scratch,
                               int batch, int S, int H, int P, int G, int N,
                               long long xb, long long xs, long long bb,
                               long long bs, long long cb, long long cs,
                               long long db, long long ds, int x_bf16,
                               void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  if (N <= 0 || N > kMaxN || G <= 0 || H % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.b = b;
  a.c = c;
  a.init = static_cast<const float*>(init);
  a.y = y;
  a.final_state = static_cast<float*>(final_state);
  a.states = static_cast<float*>(scratch);
  a.S = S; a.H = H; a.P = P; a.G = G; a.N = N;
  a.Pp = round_up(P, 4);
  a.T = (S + kQ - 1) / kQ;
  a.run = a.runs = a.sbufs = 1;
  a.b_tma = a.x_tma = 0;
  a.xb = xb; a.xs = xs; a.bb = bb; a.bs = bs;
  a.cb = cb; a.cs = cs; a.db = db; a.ds = ds;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? static_cast<int>(launch<__nv_bfloat16>(a, batch, s))
                : static_cast<int>(launch<float>(a, batch, s));
}
