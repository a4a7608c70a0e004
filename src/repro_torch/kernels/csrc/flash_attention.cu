// Causal / sliding-window attention with an online softmax (flash
// attention), forward only.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention_pallas (_flash_kernel) -> flash_wgmma (bf16),
//                                             flash_fwd (float32)
//
// Contract (the plain torch version, kernels.ref.flash_attention_ref):
// q (B, S, H, DQK), k (B, S, K, DQK) and v (B, S, K, DV) with H % K == 0,
// o (B, S, H, DV); query head h reads KV head h / (H / K) in place (the
// reference's jnp.repeat of the KV heads is a wrapper convenience).  q . k
// runs over DQK and p v over DV: DQK = DV for GQA, and DeepSeek-V2's MLA
// prefill attends with q/k of 128 + 64 (rope) = 192 and v of 128.  The
// kernels are templates over the pair; flash_attention_launch dispatches
// to the instantiated pairs (32, 32), (64, 64), (128, 128), (256, 256),
// (192, 128) and (64, 32).  Key j is visible to query i when
// j < S, j <= i (causal) and j > i - window (window > 0).  Scores are
// (q . k) * scale in float32, masked to NEG_INF = -1e30 BEFORE the
// exponential; the softmax runs online over KV tiles in float32 (running
// max m, normaliser l, accumulator acc, each tile rescaling by
// exp(m_old - m_new)), and the output is acc / max(l, 1e-30) rounded once
// to q's type.
//
// What bounds it on an H100 SXM: operations.  Per (query, key) pair that
// the mask leaves, 2 DQK for q . k and 2 DV for each p v product; at the
// RecurrentGemma-2B prefill (B 4, S 4096, H 10, D 256, window 2048) one
// product is 128.9 GFLOP: q . k and two bf16 products for p v (P_hi +
// P_lo, the bound chip_smoke.py:flash_bound prices) take 0.391 ms at 989
// TFLOP/s, the four this kernel runs 0.521 ms; the bytes
// (q, k, v read once, o written once) take 0.055 ms.
//
// bf16: flash_wgmma, on the tensor cores.
// * q . k on bf16 inputs accumulated in float32 by wgmma is exact per
//   product; only the order of the sum differs from the plain version.
// * p v must not round P to bf16 alone (a different rounding from the
//   reference's float32 P, about 2^-9 relative per weight: outside one
//   bf16 ulp on many outputs).  P is cut into three bf16 pieces, each the
//   rounding of what the earlier ones left (P_1 = bf16(P), P_2 =
//   bf16(P - P_1), P_3 = bf16(P - P_1 - P_2)), and the three products go
//   into one float32 accumulator: P is carried to about 2^-24 relative,
//   as float32 carries it, and V is exact.  Two pieces (about 2^-17) left
//   outputs beyond one ulp at S 4097, window 2048, where the check floors
//   the ulp at 1/256 of the outputs' rms.  So the kernel runs four bf16
//   products, all on the tensor cores.
// * One block owns a 64-row query tile of one (batch, head): 256 threads,
//   warpgroup 0 the consumer, one thread of warpgroup 1 the producer
//   (setmaxnreg moves registers from the producer to the consumer).
// * The producer copies the Q tile once and the K and V tiles into a
//   ring of kStages stages each with TMA (cp.async.bulk.tensor over a 4-d
//   map of the (B, S, heads, D) tensor through its strides, no transpose;
//   128-byte swizzle, so D is read in 64-column chunks of 8 KB).  Full
//   and empty mbarriers per stage; K and V have their own, so q . k of a
//   tile starts while its V is still in flight.  Rows past S come in as
//   zeros (TMA's out-of-bounds fill) and are masked; head_dim 32 is read
//   as 64 columns whose upper half is that fill, and not stored.
// * S = Q K^T: wgmma m64n64k16, A = the Q tile and B = the K tile in
//   shared memory, both K-major (d contiguous), DQK / 16 steps; at DQK 192
//   a row is 384 bytes, read as three 64-column boxes.
// * O += P V: wgmma m64n64k16 per 64-column chunk of DV, A = each piece of
//   P from registers (the S accumulator's layout is the A fragment's, so
//   P never goes through shared memory), B = the V tile, MN-major, with
//   the transpose bit that 16-bit types allow.  A piece is cut while the
//   products of the one before run (two fragment buffers).
// * Registers: O is 64 x DV float32 (DV / 2 a thread, 128 at DV 256), S
//   32, two pieces of P 16 each; DQK costs no registers.
// * The KV loop runs only from the first 64-row tile the window reaches
//   to the tile that holds the query tile's last row; only tiles that
//   straddle the diagonal, the window's edge or S run the per-element
//   mask.
// * Shared memory: Q 128 DQK bytes, the K ring kStages x 128 DQK and the V
//   ring kStages x 128 DV: 160 KB at (256, 256) (one block per SM), 80 KB
//   at (128, 128), 104 KB at (192, 128), 40 KB at (64, 64), (64, 32) and
//   (32, 32) (two blocks per SM; 32 columns are read as 64).
//
// float32: flash_fwd, on the FFMA units: no served model runs float32
// attention on the card, and the tensor cores would round float32
// inputs.  One block owns one 32-row query tile of one (batch, head) and
// loops over the KV tiles itself, holding m, l and acc in registers; both
// products are FFMA on float32 copies of the tiles, staged through
// registers into shared memory (rows padded by 4, K then V in one
// buffer sized for the wider of DQK and DV).  128 threads: thread t owns
// query rows 4 (t / 16) .. +3; for q . k it owns key columns t % 16 + 16 c
// of the tile (4 x 4 scores), for p v the output chunks of 4 columns
// t % 16 + 16 n.  The 16 threads of a row group reduce the row max and
// sum with shuffles.
//
// The sums run in another order than the plain version's, so float32
// outputs agree to a few ulp of the output's scale and bf16 outputs to
// one bf16 ulp.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;               // query rows per block
constexpr int kBKV = 64;              // key rows per tile
constexpr int kPLd = kBKV + 4;        // padded row of the P tile, floats
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, group;                       // group = H / K
  long long q_b, q_s, q_h;            // element strides
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
  int causal, window;                 // window <= 0: none
  float scale;
};

template <int DQK, int DV>
constexpr size_t smem_bytes() {
  constexpr int kWide = DQK > DV ? DQK : DV;
  return sizeof(float) * (size_t(kBQ) * (DQK + 4) +
                          size_t(kBKV) * (kWide + 4) + size_t(kBQ) * kPLd);
}

// rows [row0, row0 + rows) of one head (row stride `stride` floats) into
// rows of `D + 4` floats; rows at or past S read as zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long stride, int row0,
                                          int rows, int S) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) =
        row0 + r < S ? *reinterpret_cast<const float4*>(
                           base + static_cast<long long>(row0 + r) * stride +
                           c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// grid (ceil(S / 32), H, B), 128 threads, smem_bytes<DQK, DV>() dynamic
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Args a) {
  constexpr int kLd = DQK + 4;                      // Q and K rows
  constexpr int kLdV = DV + 4;                      // V rows
  constexpr int kChunks = DV / 4;                   // output float4 chunks
  constexpr int kNC = (kChunks + 15) / 16;          // chunks per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBQ * kLd;
  float* sP = sKV + kBKV * (DQK > DV ? kLd : kLdV);

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.group;
  const int q0 = blockIdx.x * kBQ;
  const int q_last = min(q0 + kBQ, a.S) - 1;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_b + kh * a.k_h;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_b + kh * a.v_h;
  float* ob = static_cast<float*>(a.o) + b * a.o_b + h * a.o_h;

  const int rg = threadIdx.x >> 4;      // rows 4 rg .. 4 rg + 3
  const int cl = threadIdx.x & 15;      // key cols / output chunks cl + 16 i

  load_tile<DQK>(sQ, qb, a.q_s, q0, kBQ, a.S);

  // the KV tiles any row of this query tile can see
  const int k_last = a.causal ? q_last : a.S - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_first = k_first / kBKV, t_last = k_last / kBKV;

  float acc[4][kNC][4];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < kNC; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][n][j] = 0.f;
    }
  }

  for (int t = t_first; t <= t_last; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();                    // the last tile's V is consumed
    load_tile<DQK>(sKV, kb, a.k_s, k0, kBKV, a.S);
    __syncthreads();

    // s = q . k over DQK, 4 rows x 4 key columns per thread
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < DQK; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = *reinterpret_cast<const float4*>(sQ + (4 * rg + r) * kLd + d);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = *reinterpret_cast<const float4*>(sKV + (cl + 16 * c) * kLd +
                                                 d);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
      }
    }

    // mask, then the online softmax update of m, l and acc
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * rg + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + cl + 16 * c;
        bool ok = kj < a.S;
        if (a.causal) ok = ok && kj <= qi;
        if (a.window > 0) ok = ok && kj > qi - a.window;
        s[r][c] = ok ? s[r][c] * a.scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + half_warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < kNC; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][n][j] *= alpha;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) sP[(4 * rg + r) * kPLd + cl + 16 * c] =
          s[r][c];
    }
    __syncthreads();                    // K consumed, P complete
    load_tile<DV>(sKV, vb, a.v_s, k0, kBKV, a.S);
    __syncthreads();

    // acc += p v
#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sP[(4 * rg + r) * kPLd + j];
#pragma unroll
      for (int n = 0; n < kNC; ++n) {
        const int ch = cl + 16 * n;
        if (kChunks % 16 == 0 || ch < kChunks) {
          const float4 vv =
              *reinterpret_cast<const float4*>(sKV + j * kLdV + 4 * ch);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][n][0] = fmaf(p[r], vv.x, acc[r][n][0]);
            acc[r][n][1] = fmaf(p[r], vv.y, acc[r][n][1]);
            acc[r][n][2] = fmaf(p[r], vv.z, acc[r][n][2]);
            acc[r][n][3] = fmaf(p[r], vv.w, acc[r][n][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * rg + r;
    if (qi >= a.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < kNC; ++n) {
      const int ch = cl + 16 * n;
      if (kChunks % 16 == 0 || ch < kChunks) {
        *reinterpret_cast<float4*>(ob + static_cast<long long>(qi) * a.o_s +
                                   4 * ch) =
            make_float4(acc[r][n][0] / den, acc[r][n][1] / den,
                        acc[r][n][2] / den, acc[r][n][3] / den);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;           // query rows per block = KV rows per tile
constexpr int kChunk = 64;            // bf16 columns per 128-byte swizzled row
constexpr int kChunkBytes = kWgRows * kChunk * 2;    // one 64 x 64 box, 8 KB
constexpr int kWgThreads = 256;       // consumer warpgroup + producer warpgroup

// per (DQK, DV): ring depth, blocks per SM, consumer / producer registers
template <int DQK, int DV>
struct WgTraits {
  static constexpr int kPadQK = DQK < kChunk ? kChunk : DQK;  // columns read
  static constexpr int kPadV = DV < kChunk ? kChunk : DV;
  static constexpr int kChunksQK = kPadQK / kChunk;
  static constexpr int kChunksV = kPadV / kChunk;
  static constexpr int kStages = 2;
  static constexpr int kQKTileBytes = kChunksQK * kChunkBytes;  // Q, K
  static constexpr int kVTileBytes = kChunksV * kChunkBytes;
  // Q, the K ring, the V ring, then the barriers; 1 KB to align the base
  static constexpr int kBarOffset =
      (1 + kStages) * kQKTileBytes + kStages * kVTileBytes;
  static constexpr size_t kSmem = kBarOffset + 64 * 8 + 1024;
  // O takes DV / 2 registers a consumer thread: at DV 256 one block per
  // SM, as also where two blocks' shared memory would not fit
  static constexpr int kMinBlocks = DV == 256 || 2 * kSmem > 232448 ? 1 : 2;
  static constexpr int kConsumerRegs = kMinBlocks == 1 ? 240 : 216;
  static constexpr int kProducerRegs = 40;
};

struct WgArgs {
  void* o;
  int S, group;                       // group = H / K
  long long o_b, o_s, o_h;            // element strides of o
  int causal, window;                 // window <= 0: none
  float scale_log2;                   // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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

// one 64 x 64 bf16 box at (d0, head, row0, batch) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int head,
                                         int row0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(head), "r"(row0), "r"(batch)
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

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of registers that an in-flight
// wgmma owns across the issue and the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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

// d += A B over one k16 step, m64n64k16, A the m64k16 fragment in
// registers, B in shared memory MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// one bf16 piece of a pair of weights; x and y keep what it leaves
__device__ __forceinline__ uint32_t cut_pair(float& x, float& y) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x);
  const __nv_bfloat16 yh = __float2bfloat16_rn(y);
  x -= __bfloat162float(xh);
  y -= __bfloat162float(yh);
  return pack_bf16(xh, yh);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// grid (ceil(S / 64), H, B), 256 threads, WgTraits<DQK, DV>::kSmem dynamic.
// Accumulator layout (wgmma m64nN, float32): warp w of the consumer owns
// rows 16 w + lane / 4 and + 8; register 4 j + e holds column
// 8 j + 2 (lane % 4) + (e & 1) of row + 8 (e >> 1).
template <int DQK, int DV>
__global__ void __launch_bounds__(kWgThreads, WgTraits<DQK, DV>::kMinBlocks)
    flash_wgmma(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const WgArgs a) {
  using Tr = WgTraits<DQK, DV>;
  constexpr int kStages = Tr::kStages;
  constexpr int kChunksQK = Tr::kChunksQK;
  constexpr int kChunks = Tr::kChunksV;             // of O and V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sK = base + Tr::kQKTileBytes;                   // kStages tiles
  uint8_t* sV = sK + kStages * Tr::kQKTileBytes;           // kStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Tr::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kWgRows;
  const int q_last = min(q0 + kWgRows, a.S) - 1;
  const int k_last = a.causal ? q_last : a.S - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_first = k_first / kWgRows, t_last = k_last / kWgRows;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 4);      // one arrival per consumer warp
      mbar_init(v_empty + s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Tr::kProducerRegs));
    if (threadIdx.x == 128) {
      const int kh = h / a.group;
      mbar_expect_tx(q_full, Tr::kQKTileBytes);
      for (int c = 0; c < kChunksQK; ++c) {
        tma_load(sQ + c * kChunkBytes, &mq, q_full, c * kChunk, h, q0, b);
      }
      for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
        const int st = i % kStages;
        const uint32_t par = ((i / kStages) & 1) ^ 1;
        uint8_t* kd = sK + st * Tr::kQKTileBytes;
        uint8_t* vd = sV + st * Tr::kVTileBytes;
        mbar_wait(k_empty + st, par);
        mbar_expect_tx(k_full + st, Tr::kQKTileBytes);
        for (int c = 0; c < kChunksQK; ++c) {
          tma_load(kd + c * kChunkBytes, &mk, k_full + st, c * kChunk, kh,
                   t * kWgRows, b);
        }
        mbar_wait(v_empty + st, par);
        mbar_expect_tx(v_full + st, Tr::kVTileBytes);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(vd + c * kChunkBytes, &mv, v_full + st, c * kChunk, kh,
                   t * kWgRows, b);
        }
      }
    }
  } else {
    // consumer warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Tr::kConsumerRegs));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row0 = 16 * warp + lane / 4;          // and row0 + 8
    const int qi[2] = {q0 + row0, q0 + row0 + 8};
    const int col = 2 * (lane % 4);                 // + 8 j + (e & 1)

    float o[kChunks][32];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int r = 0; r < 32; ++r) o[c][r] = 0.f;
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
      const int st = i % kStages;
      const uint32_t par = (i / kStages) & 1;
      const uint8_t* kd = sK + st * Tr::kQKTileBytes;
      const uint8_t* vd = sV + st * Tr::kVTileBytes;
      const int k0 = t * kWgRows;

      // S = Q K^T over DQK in k16 steps (32 bytes within a 128-byte row)
      float s[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = 0.f;
      mbar_wait(k_full + st, par);
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < Tr::kPadQK / 16; ++kk) {
        const int off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
        wgmma_ss(s, make_desc(sQ + off, 16, 1024),
                 make_desc(kd + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(k_empty + st);

      // scale (in log2 units), mask where the tile straddles an edge
      const bool edge = k0 + kWgRows > a.S ||
                        (a.causal && k0 + kWgRows - 1 > q0) ||
                        (a.window > 0 && k0 <= q0 + kWgRows - 1 - a.window);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        float v = s[r] * a.scale_log2;
        if (edge) {
          const int kj = k0 + 8 * (r / 4) + col + (r & 1);
          const int i_q = qi[(r >> 1) & 1];
          bool ok = kj < a.S;
          if (a.causal) ok = ok && kj <= i_q;
          if (a.window > 0) ok = ok && kj > i_q - a.window;
          v = ok ? v : kNegInf;
        }
        s[r] = v;
      }

      // online softmax: row max, weights, normaliser, rescale of O
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
        }
        const float m_new = fmaxf(m[hr], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * j + 2 * hr + e;
            s[r] = exp2f(s[r] - m_new);
            sum += s[r];
          }
        }
        alpha[hr] = exp2f(m[hr] - m_new);
        l[hr] = l[hr] * alpha[hr] + quad_sum(sum);
        m[hr] = m_new;
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int r = 0; r < 32; ++r) o[c][r] *= alpha[(r >> 1) & 1];
      }

      // O += P V in three bf16 pieces of P, each the rounding of what the
      // earlier pieces left, as the A fragments of four k16 steps of keys;
      // piece n + 1 is cut while the products of piece n run
      mbar_wait(v_full + st, par);
      uint32_t frag[2][4][4];
#pragma unroll
      for (int piece = 0; piece < 3; ++piece) {
        uint32_t(&f)[4][4] = frag[piece & 1];
        if (piece == 2) wg_wait<1>();             // piece 0 read its registers
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * kk + 2 * e;     // keys 16 kk + 8 (e / 2) + col
            f[kk][e] = cut_pair(s[r], s[r + 1]);
          }
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            wgmma_rs(o[c], f[kk],
                     make_desc(vd + c * kChunkBytes + kk * 2048, kChunkBytes,
                               1024));
          }
        }
        wg_commit();
      }
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
      if (lane == 0) mbar_arrive(v_empty + st);
    }

    // o / max(l, 1e-30), rounded once to bf16
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_b +
                        h * a.o_h;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (qi[hr] >= a.S) continue;
      const float den = fmaxf(l[hr], 1e-30f);
      __nv_bfloat16* orow = ob + static_cast<long long>(qi[hr]) * a.o_s;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = c * kChunk + 8 * j + col;
          if (DV >= kChunk || d < DV) {
            const int r = 4 * j + 2 * hr;
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __halves2bfloat162(__float2bfloat16_rn(o[c][r] / den),
                                   __float2bfloat16_rn(o[c][r + 1] / den));
          }
        }
      }
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

// a 4-d map over (B, S, heads, d) bf16 through its element strides,
// boxes of 64 columns x 1 head x 64 rows x 1 batch, 128-byte swizzle;
// out-of-bounds rows and columns read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int batch, int S,
              int heads, int d, long long sb, long long ss, long long sh) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kChunk, 1, kWgRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap q, k, v;
};

template <int DQK, int DV>
cudaError_t launch_wgmma(const Maps& maps, const WgArgs& a, int batch,
                         int heads, cudaStream_t stream) {
  constexpr size_t smem = WgTraits<DQK, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kWgRows - 1) / kWgRows, heads, batch);
  flash_wgmma<DQK, DV><<<grid, kWgThreads, smem, stream>>>(maps.q, maps.k,
                                                           maps.v, a);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch(const Args& a, int batch, int heads, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, heads, batch);
  flash_fwd<DQK, DV><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// one (DQK, DV) pair's kernel for the type: the bf16 wgmma kernel when
// `maps` is given, else the float32 one
template <int DQK, int DV>
cudaError_t launch_pair(const Maps* maps, const WgArgs& wa, const Args& a,
                        int batch, int heads, cudaStream_t stream) {
  return maps ? launch_wgmma<DQK, DV>(*maps, wa, batch, heads, stream)
              : launch<DQK, DV>(a, batch, heads, stream);
}

}  // namespace

// q (B, S, heads, d), k (B, S, kv_heads, d), v (B, S, kv_heads, dv) and
// o (B, S, heads, dv) with unit stride over the last axis, 16-byte aligned
// rows and strides; strides in elements (batch, seq, head).  (d, dv) is
// one of the instantiated pairs; bf16 selects bf16 (the wgmma kernel)
// else float32 for all four.  Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for a shape or a tensor map it cannot take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int S,
    int heads, int kv_heads, int d, int dv, long long q_b, long long q_s,
    long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long o_b,
    long long o_s, long long o_h, int causal, int window, float scale,
    int bf16, void* stream) {
  if (batch <= 0 || S <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Maps maps;
  if (bf16 &&
      (!make_map(&maps.q, q, batch, S, heads, d, q_b, q_s, q_h) ||
       !make_map(&maps.k, k, batch, S, kv_heads, d, k_b, k_s, k_h) ||
       !make_map(&maps.v, v, batch, S, kv_heads, dv, v_b, v_s, v_h))) {
    return cudaErrorInvalidValue;
  }
  const Maps* m = bf16 ? &maps : nullptr;
  const WgArgs wa{o, S, heads / kv_heads, o_b, o_s, o_h, causal, window,
                  scale * 1.4426950408889634f};
  const Args a{q, k, v, o, S, heads / kv_heads, q_b, q_s, q_h, k_b, k_s,
               k_h, v_b, v_s, v_h, o_b, o_s, o_h, causal, window, scale};
  if (d == dv) {
    switch (d) {
      case 32: return launch_pair<32, 32>(m, wa, a, batch, heads, s);
      case 64: return launch_pair<64, 64>(m, wa, a, batch, heads, s);
      case 128: return launch_pair<128, 128>(m, wa, a, batch, heads, s);
      case 256: return launch_pair<256, 256>(m, wa, a, batch, heads, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (d == 192 && dv == 128) {
    return launch_pair<192, 128>(m, wa, a, batch, heads, s);
  }
  if (d == 64 && dv == 32) {
    return launch_pair<64, 32>(m, wa, a, batch, heads, s);
  }
  return cudaErrorInvalidValue;
}
