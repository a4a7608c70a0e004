// Causal / sliding-window attention with an online softmax (flash
// attention), forward only.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention_pallas (_flash_kernel) -> flash_fwd
//
// Contract (the plain torch version, kernels.ref.flash_attention_ref):
// q (B, S, H, D), k and v (B, S, K, D) with H % K == 0; query head h
// reads KV head h / (H / K) in place (the reference's jnp.repeat of the
// KV heads is a wrapper convenience).  Key j is visible to query i when
// j < S, j <= i (causal) and j > i - window (window > 0).  Scores are
// (q . k) * scale in float32, masked to NEG_INF = -1e30 BEFORE the
// exponential; the softmax runs online over KV tiles in float32 (running
// max m, normaliser l, accumulator acc, each tile rescaling by
// exp(m_old - m_new)), and the output is acc / max(l, 1e-30) rounded once
// to q's type.  Both products are float32 FFMA on float32 copies of the
// tiles, so P stays float32 as in the reference; the sums run in another
// order than the plain version's, so float32 outputs agree to a few ulp
// of the output's scale and bf16 outputs to one bf16 ulp.
//
// What bounds it on an H100 SXM: operations.  Per (query, key) pair that
// the mask leaves, 2 D for q . k and 2 D for p v; at the RecurrentGemma-2B
// prefill (B 4, S 4096, H 10, D 256, window 2048) that is 2 x 128.9
// GFLOP, 0.13 ms at the bf16 tensor-core rate for q . k plus 1.92 ms at
// the float32 rate for p v; the bytes (q, k, v read once, o written
// once) take 0.055 ms.  This first version runs both products on the
// float32 FFMA units, so it stands well above that bound; tensor cores
// (mma/wgmma for q . k on bf16 inputs), TMA and a pipelined KV ring are
// later work.
//
// Design.  The TPU grid (B, H, nQ, nKV) runs its KV axis in order and
// carries m, l and acc in VMEM scratch across it; on the card one block
// owns one 32-row query tile of one (batch, head) and loops over the KV
// tiles itself, holding m, l and acc in registers.  The loop runs only
// from the first 64-row KV tile the window reaches to the tile holding
// the query tile's last row, so fully masked tiles are never loaded.
// 128 threads: thread t owns query rows 4 (t / 16) .. +3; for q . k it
// owns key columns t % 16 + 16 c of the tile (4 x 4 scores), for p v the
// output chunks of 4 columns t % 16 + 16 n (4 x D/4 accumulators at
// D 256).  The 16 threads of a row group reduce the row max and sum with
// shuffles.  Q, then K, then V tiles are staged in shared memory as
// float32 rows padded by 4 (16-byte reads, no bank conflicts); K and V
// share one buffer.  A ragged last tile is read as zero rows and masked
// (j < S), so any S works; inputs are read and the output written in
// (B, S, H, D) through their strides, with no transposes.

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBQ) * (D + 4) + size_t(kBKV) * (D + 4) +
                          size_t(kBQ) * kPLd);
}

// 16 bytes of T as floats, and floats back to T
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store4(__nv_bfloat16* p,
                                                const float* f) {
    uint2 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    h[0] = __halves2bfloat162(__float2bfloat16_rn(f[0]),
                              __float2bfloat16_rn(f[1]));
    h[1] = __halves2bfloat162(__float2bfloat16_rn(f[2]),
                              __float2bfloat16_rn(f[3]));
    *reinterpret_cast<uint2*>(p) = v;
  }
};

// rows [row0, row0 + rows) of one head (row stride `stride` elements)
// into float rows of `D + 4`; rows at or past S read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long stride, int row0,
                                          int rows, int S) {
  constexpr int N = Vec<T>::N;
  constexpr int kPerRow = D / N;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * N;
    float f[N];
    if (row0 + r < S) {
      Vec<T>::load(base + static_cast<long long>(row0 + r) * stride + c, f);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = 0.f;
    }
    float* d = dst + r * (D + 4) + c;
#pragma unroll
    for (int j = 0; j < N; j += 4) Vec<float>::store4(d + j, f + j);
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

// grid (ceil(S / 32), H, B), 128 threads, smem_bytes<D>() dynamic
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Args a) {
  constexpr int kLd = D + 4;
  constexpr int kChunks = D / 4;                    // output float4 chunks
  constexpr int kNC = (kChunks + 15) / 16;          // chunks per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBQ * kLd;
  float* sP = sKV + kBKV * kLd;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.group;
  const int q0 = blockIdx.x * kBQ;
  const int q_last = min(q0 + kBQ, a.S) - 1;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_b + kh * a.k_h;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_b + kh * a.v_h;
  T* ob = static_cast<T*>(a.o) + b * a.o_b + h * a.o_h;

  const int rg = threadIdx.x >> 4;      // rows 4 rg .. 4 rg + 3
  const int cl = threadIdx.x & 15;      // key cols / output chunks cl + 16 i

  load_tile<T, D>(sQ, qb, a.q_s, q0, kBQ, a.S);

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
    load_tile<T, D>(sKV, kb, a.k_s, k0, kBKV, a.S);
    __syncthreads();

    // s = q . k over D, 4 rows x 4 key columns per thread
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
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
    load_tile<T, D>(sKV, vb, a.v_s, k0, kBKV, a.S);
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
              *reinterpret_cast<const float4*>(sKV + j * kLd + 4 * ch);
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
        float f[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) f[j] = acc[r][n][j] / den;
        Vec<T>::store4(ob + static_cast<long long>(qi) * a.o_s + 4 * ch, f);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int batch, int heads, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, heads, batch);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int batch, int heads, int d,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(a, batch, heads, stream);
    case 64: return launch<T, 64>(a, batch, heads, stream);
    case 128: return launch<T, 128>(a, batch, heads, stream);
    case 256: return launch<T, 256>(a, batch, heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (B, S, heads, d) / (B, S, kv_heads, d) with unit stride
// over d, 16-byte aligned rows; strides in elements (batch, seq, head).
// d is 32, 64, 128 or 256; bf16 selects bf16 (else float32) for all four.
// Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int S,
    int heads, int kv_heads, int d, long long q_b, long long q_s,
    long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long o_b,
    long long o_s, long long o_h, int causal, int window, float scale,
    int bf16, void* stream) {
  if (batch <= 0 || S <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, S, heads / kv_heads, q_b, q_s, q_h, k_b, k_s,
               k_h, v_b, v_s, v_h, o_b, o_s, o_h, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(a, batch, heads, d, s)
              : launch_d<float>(a, batch, heads, d, s);
}
