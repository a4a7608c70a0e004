// Fused dequant + concat + matmul over packed int8 wire payloads.
//
// Replaces the TPU kernel src/repro/kernels/splitcat_linear.py:
//   splitcat_linear_q8_pallas (_splitcat_q8_kernel) -> splitcat_q8
//
// Contract: y = sum_i (q_i @ W_i) * s_i, then + b, then cast, with
// float32 accumulation.  q_i (rows, K_i) int8, s_i (rows,) float32 row
// scales, W (sum K_i, C) float32 or bf16 row-split at the part
// boundaries, b (C,) of W's type or absent, y (rows, C) float32 or bf16.
// The association is the reference's: each part's full sum over its K_i
// (in any order inside the part, here correctly rounded to fp32), times
// that part's row scale, the parts added in order, then the bias, then
// one cast.  All parts go in one
// launch (a small array of pointers passed by value).  Neither a
// dequantized activation nor a partial sum is written to device memory.
//
// What bounds it on an H100 SXM (3.35 TB/s): at decode the server's entry
// QKV is (4, 1, 3072) x (3072, 5120) bf16, so reading W (31.5 MB) is
// nearly all the work: 9.4 us at the memory rate, against 0.13 GFLOP.
// The card comes near that rate only if every SM keeps tens of KB of W in
// flight from the first K row to the last.
//
// Design: a streaming GEMV.
// * Tiles: a block owns kBN = 80 output columns (160-byte rows of bf16 W)
//   and a row tile of RT = 4 (or 16) rows; more rows take more row tiles
//   (grid z), each of which reads W again (at decode there is one).
// * Split K over a thread-block cluster (grid x, up to 8 blocks): the
//   launcher takes the split with the most blocks whose clusters all fit
//   on the card at once (cudaOccupancyMaxActiveClusters; clusters of 3 or
//   more do not fill the GPCs at one block per SM).  At the entry QKV that
//   is 64 column tiles x 3 = 192 blocks of 1024 K rows.
// * A ring of kMaxStages stages of up to 16 KB (96 bf16 or 48 fp32 K rows
//   of the 80 columns) in shared memory, filled by TMA (cp.async.bulk.
//   tensor over a 2-d map of W, no swizzle, out-of-bounds rows and columns
//   read as zeros) from one producer thread, with full and empty mbarriers
//   per stage.  Four stages keep a block at 84 KB, so two fit on an SM.
// * q: all threads stage the block's K slice of q for its rows in shared
//   memory as fp32 ([k][row], one K row a thread, written 16 bytes at a
//   time), so a K row's q values are one broadcast 16-byte read.  The
//   producer sends two stages first and the rest after q is in, so q's
//   loads do not queue behind the whole ring of W.  A slice longer than
//   the 16 KB window is staged window by window by the consumers.
// * Product: five consumer warps; thread t owns columns 2 (t % 40) and
//   2 (t % 40) + 1 for the stage rows r with r % 4 == t / 40 (one 4-byte
//   read of a bf16 pair per row, a warp reading contiguous bytes), all RT
//   rows.  An int8 x bf16 product is exact in fp32 and a stage's 24 of
//   them sum in fp32 nearly exactly; each stage's sum is folded into a
//   double, and the partials stay double to the end.  So a part's sum is
//   correctly rounded whatever the split (with fp32 running sums the
//   kernel missed the fp32 plain result by more than a bf16 ulp where
//   a row's sum cancels to near zero).
// * Parts: a part boundary may fall inside a rank's K range, even inside
//   a stage.  The rank then keeps one partial per part: at each part's
//   end the four row groups add theirs into the part's slot in shared
//   memory, in group order.  After the ring the cluster syncs and each
//   rank finishes a share of the tile's outputs: every rank's slot of the
//   part read at once through distributed shared memory and added in rank
//   order, rounded to float, times the part's row scale, the parts in
//   order, the bias, the cast (the reference's association).  The result
//   is the same on every run.
// * W that TMA cannot address (a base not 16-byte aligned or rows that
//   are not a multiple of 16 bytes, as fp32 W with C = 5121) takes a
//   second path inside the kernel: each consumer thread copies its own
//   two columns of its rows of each stage into a two-stage ring itself,
//   with 4-byte cp.async and its zero fill (fp32, or 4-byte aligned bf16
//   pairs), or plain loads (bf16 with an odd C or base).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxParts = 8;
constexpr int kMaxSplit = 8;                 // portable cluster size
constexpr int kBN = 80;                      // output columns per block
constexpr int kPairs = kBN / 2;              // column pairs, one a thread
constexpr int kKG = 4;                       // K row groups of a stage
constexpr int kConsumers = kPairs * kKG;     // 5 warps
constexpr int kThreads = kConsumers + 32;    // + one producer warp
constexpr int kStageTarget = 16384;       // bytes of W per stage, at most
constexpr int kMaxStages = 4;
constexpr int kEarlyStages = 2;              // ring stages issued before q
constexpr int kQWindowFloats = 4096;         // 16 KB of staged q
constexpr size_t kSmemCap = 232448;          // per block on an H100

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

// columns (2t, 2t + 1) of one K row of a stage, as floats
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

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

// one box of kBN columns x BK rows of W at (c0, k0), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int k0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(k0)
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// the part holding global K row k (the first whose end lies past k)
__device__ __forceinline__ int part_of(const int* pend, int n, int k) {
  int p = 0;
  while (p < n - 1 && pend[p] <= k) ++p;
  return p;
}

template <typename WT>
struct Stage {
  // K rows of a stage: a multiple of 16 whose box fits the target
  static constexpr int kRows = kStageTarget / (kBN * int(sizeof(WT))) / 16 * 16;
  static constexpr int kBytes = kRows * kBN * int(sizeof(WT));
  static constexpr int kStride = (kBytes + 1023) / 1024 * 1024;
  static_assert(kRows >= 16 && kRows <= 256, "a TMA box is 16..256 rows");
};

// grid (split, column tiles, row tiles), cluster (split, 1, 1), kThreads
// threads.  Rank r streams K stages [r n / split, (r + 1) n / split).
template <typename WT, typename OutT, int RT, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    splitcat_q8(const __grid_constant__ CUtensorMap wmap, const Parts parts,
                const WT* __restrict__ w, const WT* __restrict__ b,
                OutT* __restrict__ out, int rows, int cols, int K,
                int stages, int slot_count) {
  constexpr int BK = Stage<WT>::kRows;
  // the q window in K rows: whole stages, so a stage never straddles two
  constexpr int KW = kQWindowFloats / RT / BK * BK;
  static_assert(KW >= BK, "a window holds a stage");
  constexpr int kStride = Stage<WT>::kStride;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = base;                                   // stages x 16 KB
  float* qs = reinterpret_cast<float*>(ring + stages * kStride);
  double* slots = reinterpret_cast<double*>(qs + kQWindowFloats);
                                                    // [slot][RT][kBN]
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + slot_count * RT * kBN);
  uint64_t* empty = full + kMaxStages;
  __shared__ int pend[kMaxParts];                         // part ends in K
  // the slot of part p in rank q's shared memory, -1 where q's K range
  // misses p
  __shared__ int slot_of[kMaxSplit][kMaxParts];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kBN;
  const int row0 = blockIdx.z * RT;
  const int n_rows = min(RT, rows - row0);
  const int n_st = (K + BK - 1) / BK;

  auto k_range = [&](int r, int& kb, int& ke) {
    kb = (r * n_st / split) * BK;
    ke = min(((r + 1) * n_st / split) * BK, K);
  };
  int k_begin, k_end;
  k_range(rank, k_begin, k_end);
  const int st_begin = k_begin / BK;
  const int n_mine = (k_end - k_begin + BK - 1) / BK;

  if (tid == 0) {
    int e = 0;
    for (int p = 0; p < parts.n; ++p) {
      e += parts.k[p];
      pend[p] = e;
    }
    if (kTma) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, kConsumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();

  // q rows row0 .. row0 + RT - 1 over K rows [kb, ke) into qs as float
  // [k - kb][row]; rows past `rows` as zeros
  auto stage_q = [&](int kb, int ke, int nt) {
    for (int p = 0; p < parts.n; ++p) {
      const int pb = pend[p] - parts.k[p];
      const int a = max(kb, pb), e = min(ke, pend[p]);
      if (a >= e) continue;
      const int8_t* src = parts.q[p] +
                          static_cast<int64_t>(row0) * parts.k[p] + a - pb;
      // one K row a thread: its RT values, 16 bytes to shared memory at
      // a time (consecutive threads, consecutive 16-byte pieces)
      for (int i = tid; i < e - a; i += nt) {
        float v[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          v[r] = row0 + r < rows
                     ? static_cast<float>(src[static_cast<int64_t>(r) *
                                                  parts.k[p] + i])
                     : 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(qs + (a - kb + i) * RT);
#pragma unroll
        for (int r = 0; r < RT; r += 4) {
          dst[r / 4] = make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
        }
      }
    }
  };

  // one thread keeps the ring full: the first kEarlyStages stages go out
  // at once, the rest after q's first window is staged (q's loads would
  // otherwise queue behind the whole ring of W)
  const int early = min(min(kEarlyStages, stages), n_mine);
  auto produce = [&](int i) {
    const int st = i % stages;
    mbar_wait(empty + st, ((i / stages) & 1) ^ 1);
    mbar_expect_tx(full + st, Stage<WT>::kBytes);
    tma_load(ring + st * kStride, &wmap, full + st, c0, (st_begin + i) * BK);
  };
  if (kTma && tid == kConsumers) {
    for (int i = 0; i < early; ++i) produce(i);
  }
  const int first_end = min(k_begin + KW, k_end);
  stage_q(k_begin, first_end, kThreads);
  __syncthreads();

  if (tid >= kConsumers) {
    if (kTma && tid == kConsumers) {
      for (int i = early; i < n_mine; ++i) produce(i);
    } else if (tid == kConsumers + 1) {
      // meanwhile, which slot of each rank holds each part (read after
      // the cluster barrier below)
      for (int q = 0; q < split; ++q) {
        int kb, ke;
        k_range(q, kb, ke);
        for (int p = 0; p < parts.n; ++p) {
          const int pb = pend[p] - parts.k[p];
          slot_of[q][p] = kb < ke && kb < pend[p] && pb < ke && pb < pend[p]
                              ? p - part_of(pend, parts.n, kb)
                              : -1;
        }
      }
    }
  } else {
    // consumers: thread tid owns columns c0 + 2 pr, c0 + 2 pr + 1 and the
    // stage rows rr with rr % kKG == kg
    const int pr = tid % kPairs, kg = tid / kPairs;
    const int col = c0 + 2 * pr;
    int win_begin = k_begin, win_end = first_end;

    // the second path: this thread's two columns of stage i into buffer
    // i % 2, zero filled past K and C
    const bool pairs = cols % 2 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
    auto copy_stage = [&](int i) {
      WT* dst = reinterpret_cast<WT*>(ring + (i % 2) * kStride) + 2 * pr;
      const int k0 = (st_begin + i) * BK;
#pragma unroll 4
      for (int j = 0; j < BK / kKG; ++j) {
        const int rr = j * kKG + kg;
        const int k = k0 + rr;
        const WT* src = w + static_cast<int64_t>(k) * cols + col;
        const bool ok0 = k < K && col < cols, ok1 = k < K && col + 1 < cols;
        if (sizeof(WT) == 4) {
          cp_async4(dst + rr * kBN, ok0 ? src : w, ok0);
          cp_async4(dst + rr * kBN + 1, ok1 ? src + 1 : w, ok1);
        } else if (pairs) {                    // a whole, aligned bf16 pair
          cp_async4(dst + rr * kBN, ok0 ? src : w, ok0);
        } else {
          dst[rr * kBN] = ok0 ? src[0] : from_f32<WT>(0.f);
          dst[rr * kBN + 1] = ok1 ? src[1] : from_f32<WT>(0.f);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    // a stage's rows in float (an int8 x bf16 product is exact, and a short
    // sum of them nearly so), folded into double at the stage's end, so a
    // part's sum is correctly rounded whatever the split
    float fa[RT][2];
    double acc[RT][2];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      fa[r][0] = fa[r][1] = 0.f;
      acc[r][0] = acc[r][1] = 0.0;
    }
    auto fold = [&]() {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        acc[r][0] += fa[r][0];
        acc[r][1] += fa[r][1];
        fa[r][0] = fa[r][1] = 0.f;
      }
    };
    int cp = part_of(pend, parts.n, k_begin);
    const int p_first = cp;

    // this part's partials of the kKG row groups into its slot, added in
    // group order
    auto flush = [&]() {
      double* dst = slots + (cp - p_first) * RT * kBN + 2 * pr;
#pragma unroll
      for (int g = 0; g < kKG; ++g) {
        if (kg == g) {
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            double2* d2 = reinterpret_cast<double2*>(dst + r * kBN);
            const double2 prev = g ? *d2 : make_double2(0.0, 0.0);
            *d2 = make_double2(prev.x + acc[r][0], prev.y + acc[r][1]);
          }
        }
        consumers_sync();
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r][0] = acc[r][1] = 0.0;
    };
    auto fma_row = [&](const WT* ws, int rr, int wk) {
      const float2 wv = load_pair(ws + rr * kBN + 2 * pr);
      const float* qv = qs + wk * RT;
#pragma unroll
      for (int r = 0; r < RT; r += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qv + r);
        fa[r][0] = fmaf(q4.x, wv.x, fa[r][0]);
        fa[r][1] = fmaf(q4.x, wv.y, fa[r][1]);
        fa[r + 1][0] = fmaf(q4.y, wv.x, fa[r + 1][0]);
        fa[r + 1][1] = fmaf(q4.y, wv.y, fa[r + 1][1]);
        fa[r + 2][0] = fmaf(q4.z, wv.x, fa[r + 2][0]);
        fa[r + 2][1] = fmaf(q4.z, wv.y, fa[r + 2][1]);
        fa[r + 3][0] = fmaf(q4.w, wv.x, fa[r + 3][0]);
        fa[r + 3][1] = fmaf(q4.w, wv.y, fa[r + 3][1]);
      }
    };

    if (!kTma && n_mine > 0) copy_stage(0);
    for (int i = 0; i < n_mine; ++i) {
      const int a = (st_begin + i) * BK;
      const int e = min(a + BK, k_end);
      if (e > win_end) {                       // the next window of q
        consumers_sync();
        win_begin = a;
        win_end = min(a + KW, k_end);
        stage_q(win_begin, win_end, kConsumers);
        consumers_sync();
      }
      const int st = kTma ? i % stages : i % 2;
      if (kTma) {
        mbar_wait(full + st, (i / stages) & 1);
      } else {
        if (i + 1 < n_mine) {
          copy_stage(i + 1);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
      }
      const WT* ws = reinterpret_cast<const WT*>(ring + st * kStride);
      for (int k = a; k < e;) {
        const int seg_end = min(e, pend[cp]);
        if (k == a && seg_end == a + BK) {     // a whole stage of one part
#pragma unroll
          for (int j = 0; j < BK / kKG; ++j) {
            fma_row(ws, j * kKG + kg, a - win_begin + j * kKG + kg);
          }
        } else {
          for (int kk = k + (kg - (k - a) % kKG + kKG) % kKG; kk < seg_end;
               kk += kKG) {
            fma_row(ws, kk - a, kk - win_begin);
          }
        }
        fold();
        const bool part_done = seg_end == pend[cp];
        if (part_done || seg_end == k_end) flush();
        if (part_done) {
          while (cp < parts.n - 1 && pend[cp] <= seg_end) ++cp;
        }
        k = seg_end;
      }
      if (kTma) {
        __syncwarp();
        if (tid % 32 == 0) mbar_arrive(empty + st);
      }
    }
  }

  // every rank's partials through distributed shared memory: rank r
  // finishes outputs [r T / split, (r + 1) T / split) of the tile
  cluster.sync();
  const int T = RT * kBN;
  const double* theirs[kMaxSplit];
#pragma unroll
  for (int q = 0; q < kMaxSplit; ++q) {
    theirs[q] = q < split ? cluster.map_shared_rank(slots, q) : slots;
  }
  for (int o = rank * T / split + tid; o < (rank + 1) * T / split;
       o += kThreads) {
    const int r = o / kBN, cc = o % kBN;
    const int col = c0 + cc;
    if (r >= n_rows || col >= cols) continue;
    float v = 0.f;
    for (int p = 0; p < parts.n; ++p) {
      // every rank's partial at once, then added in rank order (a rank
      // that misses the part adds an exact zero)
      double part[kMaxSplit];
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q) {
        const int slot = q < split ? slot_of[q][p] : -1;
        part[q] = slot >= 0 ? theirs[q][(slot * RT + r) * kBN + cc] : 0.0;
      }
      double tot = 0.0;
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q) tot += part[q];
      v = __fadd_rn(v, __fmul_rn(__double2float_rn(tot),
                                 parts.s[p][row0 + r]));
    }
    if (b != nullptr) v = __fadd_rn(v, to_f32(b[col]));
    out[static_cast<int64_t>(row0 + r) * cols + col] = from_f32<OutT>(v);
  }
  cluster.sync();                        // the others' slots stay alive
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

// a 2-d map over W (K rows of `cols`), boxes of kBN columns x BK rows
template <typename WT>
bool make_map(CUtensorMap* map, const void* w, int K, int cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(WT)};
  const cuuint32_t box[2] = {kBN, static_cast<cuuint32_t>(Stage<WT>::kRows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map,
                sizeof(WT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(w), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the most parts one rank's K range touches when K is split `split`
// ways in stages of BK rows: one slot each
int slots_needed(const Parts& parts, int K, int BK, int split) {
  const int n_st = (K + BK - 1) / BK;
  int pend[kMaxParts], e = 0;
  for (int p = 0; p < parts.n; ++p) pend[p] = e += parts.k[p];
  int most = 1;
  for (int r = 0; r < split; ++r) {
    const int kb = (r * n_st / split) * BK;
    const int ke = ((r + 1) * n_st / split) * BK < K
                       ? ((r + 1) * n_st / split) * BK : K;
    if (kb >= ke) continue;
    int first = 0, last = 0;
    while (first < parts.n - 1 && pend[first] <= kb) ++first;
    while (last < parts.n - 1 && pend[last] < ke) ++last;
    if (last - first + 1 > most) most = last - first + 1;
  }
  return most;
}

template <typename WT, typename OutT, int RT, bool kTma>
cudaError_t launch_rt(const CUtensorMap& map, const Parts& parts,
                      const void* w, const void* b, void* out, int rows,
                      int cols, int K, cudaStream_t stream) {
  constexpr int BK = Stage<WT>::kRows;
  constexpr size_t kMaxDynamic = kSmemCap - 1024;  // room for the static
                                                   // pend[] and slot_of[]
  auto kernel = splitcat_q8<WT, OutT, RT, kTma>;
  // clusters of each size that fit on the card at once, by shared memory
  struct Fit {
    int split;
    size_t smem;
    int clusters;
  };
  static Fit fits[64];
  static int n_fits = 0;
  static bool opted_in = false;
  cudaError_t err;
  if (!opted_in) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxDynamic));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto plan = [&](int split, int& slot_count, int& stages, size_t& smem) {
    slot_count = slots_needed(parts, K, BK, split);
    const size_t fixed = 1024 + sizeof(float) * kQWindowFloats +
                         sizeof(double) * slot_count * RT * kBN +
                         2 * kMaxStages * sizeof(uint64_t);
    constexpr int kStride = Stage<WT>::kStride;
    if (fixed + 2 * kStride > kMaxDynamic) return false;
    stages = kTma ? static_cast<int>((kMaxDynamic - fixed) / kStride) : 2;
    if (stages > kMaxStages) stages = kMaxStages;
    smem = fixed + static_cast<size_t>(stages) * kStride;
    return true;
  };
  auto co_resident = [&](int split, size_t smem) {
    for (int i = 0; i < n_fits; ++i) {
      if (fits[i].split == split && fits[i].smem == smem) {
        return fits[i].clusters;
      }
    }
    cfg.gridDim = dim3(split, 1, 1);
    cfg.dynamicSmemBytes = smem;
    attr[0].val.clusterDim.x = split;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
      n = 0;
    }
    if (n_fits < 64) fits[n_fits++] = {split, smem, n};
    return n;
  };

  const int col_tiles = (cols + kBN - 1) / kBN;
  const int row_tiles = (rows + RT - 1) / RT;
  const long long clusters = static_cast<long long>(col_tiles) * row_tiles;
  const int n_st = (K + BK - 1) / BK;
  // the split with the most blocks whose clusters all fit on the card at
  // once (one wave, every busy SM the same share of W)
  int split = 1;
  long long best = 0;
  for (int s = 1; s <= kMaxSplit && s <= n_st; ++s) {
    int slot_count, stages;
    size_t smem;
    if (!plan(s, slot_count, stages, smem)) continue;
    if (clusters <= co_resident(s, smem) && clusters * s > best) {
      best = clusters * s;
      split = s;
    }
  }
  int slot_count, stages;
  size_t smem;
  if (!plan(split, slot_count, stages, smem)) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(split, col_tiles, row_tiles);
  cfg.dynamicSmemBytes = smem;
  attr[0].val.clusterDim.x = split;
  return cudaLaunchKernelEx(&cfg, kernel, map, parts,
                            static_cast<const WT*>(w),
                            static_cast<const WT*>(b),
                            static_cast<OutT*>(out), rows, cols, K, stages,
                            slot_count);
}

template <typename WT, typename OutT>
cudaError_t launch(const Parts& parts, const void* w, const void* b,
                   void* out, int rows, int cols, int K,
                   cudaStream_t stream) {
  CUtensorMap map = {};
  const bool tma = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   (static_cast<size_t>(cols) * sizeof(WT)) % 16 == 0 &&
                   K > 0 && make_map<WT>(&map, w, K, cols);
  if (rows <= 4) {
    return tma ? launch_rt<WT, OutT, 4, true>(map, parts, w, b, out, rows,
                                              cols, K, stream)
               : launch_rt<WT, OutT, 4, false>(map, parts, w, b, out, rows,
                                               cols, K, stream);
  }
  return tma ? launch_rt<WT, OutT, 16, true>(map, parts, w, b, out, rows,
                                             cols, K, stream)
             : launch_rt<WT, OutT, 16, false>(map, parts, w, b, out, rows,
                                              cols, K, stream);
}

}  // namespace

// qs[i] (rows, ks[i]) int8, ss[i] (rows,) float32, w (sum ks, cols)
// float32 (w_bf16 = 0) or bfloat16 (w_bf16 = 1), b (cols,) of w's type or
// null, out (rows, cols) float32 (out_bf16 = 0) or bfloat16 (out_bf16 = 1);
// all contiguous.  Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for more than kMaxParts parts or too many column
// or row tiles for the grid.
extern "C" int splitcat_q8_launch(int n_parts, const void* const* qs,
                                  const void* const* ss, const int* ks,
                                  const void* w, const void* b, void* out,
                                  int rows, int cols, int w_bf16,
                                  int out_bf16, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || (cols + kBN - 1) / kBN > 65535 ||
      (rows + 3) / 4 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Parts parts;
  int K = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    parts.q[i] = i < n_parts ? static_cast<const int8_t*>(qs[i]) : nullptr;
    parts.s[i] = i < n_parts ? static_cast<const float*>(ss[i]) : nullptr;
    parts.k[i] = i < n_parts ? ks[i] : 0;
    K += parts.k[i];
  }
  parts.n = n_parts;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_bf16) {
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(parts, w, b, out,
                                                          rows, cols, K, st)
                   : launch<__nv_bfloat16, float>(parts, w, b, out, rows,
                                                  cols, K, st);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(parts, w, b, out, rows,
                                                  cols, K, st)
                   : launch<float, float>(parts, w, b, out, rows, cols, K,
                                          st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
