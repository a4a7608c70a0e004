// Mamba2 SSD (state-space duality) scan over a whole sequence.
//
// Replaces the TPU kernel in src/repro/kernels/ssd_scan.py:
//   ssd_scan_pallas (_ssd_kernel) -> ssd_scan_tiles
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
// does not depend on the chunk length up to rounding, and one 256-row
// chunk's C B^T alone would need 256 KB of shared memory).  In a tile,
// with cum_t the running sum of dt * A inside the tile,
//     y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) xd_s
//            + exp(cum_t) S_in C_t
//     S_out = exp(cum_last) S_in + sum_s exp(cum_last - cum_s) xd_s B_s^T
// The mask s <= t is applied before the exponential, so no exp of a
// large positive number is formed.  A ragged last tile is padded with
// dt = x = B = C = 0 rows, which neither decay nor feed the state.
//
// What bounds it on an H100 SXM: operations.  At the Mamba2 prefill
// (batch 4, 512 rows, 24 heads of P = 64, N = 128, one state group,
// bf16) the per-head work at this tile is about 1.8 GFLOP in float32
// (the masked product with xd, the carried state's product with C, the
// state update), 27 us at the 67 TFLOP/s float32 rate; C B^T is shared
// by the group's 24 heads, 17 MFLOP of bf16 products, well under 1 us
// on the tensor cores; the 14 MB of inputs and outputs take 4 us at
// 3.35 TB/s.  This kernel recomputes C B^T, in float32, in every block.
//
// Design.  The TPU kernel walks (batch * head, chunk) with the chunk axis
// in order and the state in VMEM scratch.  Here one block owns one
// (batch, head) and kPB = 16 of the P state rows, and loops over the
// tiles in order inside the launch, carrying its 16 x N slice of the
// state in shared memory: y[:, p] needs only x[:, p] and row p of the
// state, so P splits across blocks (4 blocks per head at P = 64, 384
// blocks at batch 4 for 132 SMs) at the price of recomputing C B^T in
// each.  Per tile the block stages B and C transposed (n-major, rows of
// kQ + 4 floats, so 16-byte reads are aligned and conflict-free) and xd;
// C B^T is a register-tiled product (8 x 2 outputs per thread), then the
// outputs (4 rows per thread), then the state update.  FFMA in float32:
// no tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;              // sequence rows per tile
constexpr int kPB = 16;             // state rows p per block
constexpr int kThreads = 256;
constexpr int kLdt = kQ + 4;        // transposed tile row (floats)
constexpr int kLdm = kQ + 1;        // score row (floats)
constexpr int kMaxN = 256;
static_assert(kThreads == 32 * (kQ / 8), "step 3: 8 rows per warp");
static_assert(2 * 32 == kQ, "step 3: 2 columns per lane");
static_assert((kThreads / kPB) * 4 == kQ, "step 4: 4 rows per thread");

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
  int S, H, P, G, N;
  int64_t xb, xs, bb, bs, cb, cs, db, ds;
};

size_t smem_bytes(int n) {
  return sizeof(float) * (2 * static_cast<size_t>(n) * kLdt + kPB * kLdt +
                          kQ * kLdm + kQ * kPB + kPB * (n + 1) + 4 * kQ);
}

// grid: (B * H, ceil(P / kPB)); block (bh, j) owns head bh % H of batch
// row bh / H and state rows [16 j, 16 j + 16)
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_tiles(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N;
  const int ldst = N + 1;
  float* sBt = smem;                    // B[s][n] at n * kLdt + s
  float* sCt = sBt + N * kLdt;          // C[t][n] at n * kLdt + t
  float* sXwT = sCt + N * kLdt;         // exp(cum_last - cum_s) xd[s][p]
  float* sM = sXwT + kPB * kLdt;        // masked (C B^T) * decay, [t][s]
  float* sX = sM + kQ * kLdm;           // xd[s][p]
  float* sState = sX + kQ * kPB;        // state[p][n]
  float* sDA = sState + kPB * ldst;     // dt * A
  float* sCum = sDA + kQ;               // running sum of dt * A
  float* sEc = sCum + kQ;               // exp(cum_t)
  float* sW = sEc + kQ;                 // exp(cum_last - cum_s)

  const T* xp = static_cast<const T*>(a.x);
  const T* bp = static_cast<const T*>(a.b);
  const T* cp = static_cast<const T*>(a.c);
  T* yp = static_cast<T*>(a.y);
  const int bi = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int g = h / (a.H / a.G);
  const int p0 = blockIdx.y * kPB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float A = a.A[h];
  const int64_t state_base = (static_cast<int64_t>(bi) * a.H + h) * a.P;

  for (int i = tid; i < kPB * N; i += kThreads) {
    const int pp = i / N, n = i % N, p = p0 + pp;
    float v = 0.f;
    if (a.init != nullptr && p < a.P) v = a.init[(state_base + p) * N + n];
    sState[pp * ldst + n] = v;
  }

  for (int t0 = 0; t0 < a.S; t0 += kQ) {
    const int L = a.S - t0 < kQ ? a.S - t0 : kQ;

    // 1. stage the tile: B and C transposed, xd, dt * A
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int s = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (s < L) {
        const int64_t tok = t0 + s;
        bv = to_f32(bp[bi * a.bb + tok * a.bs + static_cast<int64_t>(g) * N + n]);
        cv = to_f32(cp[bi * a.cb + tok * a.cs + static_cast<int64_t>(g) * N + n]);
      }
      sBt[n * kLdt + s] = bv;
      sCt[n * kLdt + s] = cv;
    }
    for (int i = tid; i < kQ * kPB; i += kThreads) {
      const int s = i / kPB, pp = i % kPB, p = p0 + pp;
      float v = 0.f;
      if (s < L && p < a.P) {
        const int64_t tok = t0 + s;
        const float xv = to_f32(xp[bi * a.xb + tok * a.xs +
                                   static_cast<int64_t>(h) * a.P + p]);
        v = xv * a.dt[bi * a.db + tok * a.ds + h];
      }
      sX[s * kPB + pp] = v;
    }
    if (tid < kQ) {
      sDA[tid] = tid < L
                     ? a.dt[bi * a.db + static_cast<int64_t>(t0 + tid) * a.ds + h] * A
                     : 0.f;
    }
    __syncthreads();

    // 2. the running log decay, in order as torch.cumsum sums, and its
    //    exponentials
    if (warp == 0) {
      if (lane == 0) {
        float c = 0.f;
        for (int s = 0; s < kQ; ++s) {
          c += sDA[s];
          sCum[s] = c;
        }
      }
      __syncwarp();
      const float total = sCum[kQ - 1];
      for (int s = lane; s < kQ; s += 32) {
        sEc[s] = expf(sCum[s]);
        sW[s] = expf(total - sCum[s]);
      }
    }
    __syncthreads();

    // 3. scores M[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, else
    //    0; warp w owns rows [8 w, 8 w + 8), lane l columns 2 l and 2 l + 1
    {
      float acc[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = 0.f;
      const int tb = warp * 8, sb = 2 * lane;
      for (int n = 0; n < N; ++n) {
        const float2 bv = *reinterpret_cast<const float2*>(sBt + n * kLdt + sb);
        const float4 c0 = *reinterpret_cast<const float4*>(sCt + n * kLdt + tb);
        const float4 c1 =
            *reinterpret_cast<const float4*>(sCt + n * kLdt + tb + 4);
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] += cv[j] * bv.x;
          acc[j][1] += cv[j] * bv.y;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = tb + j;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int s = sb + k;
          sM[t * kLdm + s] =
              s <= t ? acc[j][k] * expf(sCum[t] - sCum[s]) : 0.f;
        }
      }
    }
    for (int i = tid; i < kPB * kQ; i += kThreads) {
      const int pp = i / kQ, s = i % kQ;
      sXwT[pp * kLdt + s] = sW[s] * sX[s * kPB + pp];
    }
    __syncthreads();

    // 4. outputs: thread owns p = p0 + tid % 16 and rows tid / 16 + 16 k
    {
      const int pp = tid % kPB, tr = tid / kPB;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float inter[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s <= tr + 48; ++s) {      // M is 0 beyond the diagonal
        const float xv = sX[s * kPB + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += sM[(tr + 16 * k) * kLdm + s] * xv;
      }
      for (int n = 0; n < N; ++n) {
        const float st = sState[pp * ldst + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) inter[k] += sCt[n * kLdt + tr + 16 * k] * st;
      }
      const int p = p0 + pp;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tr + 16 * k;
        if (t < L && p < a.P) {
          const int64_t out = ((static_cast<int64_t>(bi) * a.S + t0 + t) * a.H + h) *
                                  a.P + p;
          yp[out] = from_f32<T>(acc[k] + sEc[t] * inter[k]);
        }
      }
    }
    __syncthreads();

    // 5. the state carried to the next tile
    {
      const float decay = sEc[kQ - 1];
      for (int i = tid; i < kPB * N; i += kThreads) {
        const int pp = i / N, n = i % N;
        float acc = 0.f;
        for (int s = 0; s < kQ; s += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(sBt + n * kLdt + s);
          const float4 xv = *reinterpret_cast<const float4*>(sXwT + pp * kLdt + s);
          acc += xv.x * bv.x;
          acc += xv.y * bv.y;
          acc += xv.z * bv.z;
          acc += xv.w * bv.w;
        }
        sState[pp * ldst + n] = decay * sState[pp * ldst + n] + acc;
      }
    }
    __syncthreads();
  }

  if (a.final_state != nullptr) {
    for (int i = tid; i < kPB * N; i += kThreads) {
      const int pp = i / N, n = i % N, p = p0 + pp;
      if (p < a.P) a.final_state[(state_base + p) * N + n] = sState[pp * ldst + n];
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.N);
  static size_t granted = 0;           // dynamic shared memory opted in
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  const dim3 grid(static_cast<unsigned>(batch * a.H),
                  static_cast<unsigned>((a.P + kPB - 1) / kPB));
  ssd_scan_tiles<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; x, B, C are bf16 when x_bf16 (else float32);
// dt, A, init and final_state are float32.  init and final_state may be
// null.  Returns the launch's cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* b, const void* c, const void* init,
                               void* y, void* final_state, int batch, int S,
                               int H, int P, int G, int N, long long xb,
                               long long xs, long long bb, long long bs,
                               long long cb, long long cs, long long db,
                               long long ds, int x_bf16, void* stream) {
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
  a.S = S; a.H = H; a.P = P; a.G = G; a.N = N;
  a.xb = xb; a.xs = xs; a.bb = bb; a.bs = bs;
  a.cb = cb; a.cs = cs; a.db = db; a.ds = ds;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? static_cast<int>(launch<__nv_bfloat16>(a, batch, s))
                : static_cast<int>(launch<float>(a, batch, s));
}
