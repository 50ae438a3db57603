// flash_attention: causal (optionally sliding-window) GQA attention over a
// whole sequence, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel):
//   q (B, S, KV, G, hd), k/v (B, S, KV, hd) -> out (B, S, KV, G, hd)
//   out[b,s,kv,g] = softmax_t(mask ? q.k_t / sqrt(hd) : -1e30) . v_t,
//   mask = t <= s and (window == 0 or t > s - window)
// with f32 scores and f32 running max / sum / accumulator (online softmax),
// the normalizer guarded by max(l, 1e-30). q/k/v are f32 or bf16; the output
// has q's dtype.
//
// What bounds it: q, k, v and o are each touched once, while the work grows
// with S^2: 4*B*H*hd*S^2/2 flops under the causal mask. At granite-3-2b's
// prefill (B = 8, S = 512, 32 heads over 8 KV heads, hd = 64, bf16) that is
// 8.6 GFLOP against 42 MB. Against the tensor cores' bf16 rate the bound is
// the bytes (~12.5 us at 3.35 TB/s). This first kernel runs its products on
// the f32 FMA units, not the tensor cores, so in practice it is bound by
// f32 operations (and shared-memory traffic); mma/wgmma tiles are a later
// PR's work.
//
// Design: as in the TPU kernel, the G query heads of one KV group are folded
// into one q tile (R = BQ * G rows: BQ query positions times G heads), so each
// K/V tile is loaded once for all of them. One block of 128 threads per
// (q tile, b, kv); the loop over K/V tiles inside the block takes the place of
// the TPU kernel's sequential k grid axis. Threads form a 16 x 8 grid: each
// owns RPT rows (ty + 16 i) and, for the scores, CPT key columns (tx + 8 j),
// for the output HD/8 columns (tx + 8 j), so a row's softmax statistics live
// in the 8 lanes that share it (shuffle reductions). Q/K/V and P tiles sit in
// shared memory as f32, rows padded by one float against bank conflicts.
// Key tiles wholly above the diagonal or wholly before the window are not
// visited (same result: the TPU kernel computes and masks them). The TPU
// kernel needs S % block == 0; here rows and keys past S are masked, so any
// S works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr float NEG_INF = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int HD>
struct FlashShape {
  static constexpr int R = HD >= 256 ? 32 : 64;    // q-tile rows (positions x heads)
  static constexpr int TK = HD >= 128 ? 32 : 64;   // keys per K/V tile
  static constexpr int RPT = R / 16, CPT = TK / 8, DPT = HD / 8;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr size_t smem_bytes() {
    return sizeof(float) * (static_cast<size_t>(R) * (HD + 1)     // q tile
                            + static_cast<size_t>(TK) * (HD + 1)  // k tile
                            + static_cast<size_t>(TK) * HD        // v tile
                            + static_cast<size_t>(R) * (TK + 1)); // probabilities
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int KV, int G,
                       int window, float scale) {
  using Sh = FlashShape<T, HD>;
  constexpr int R = Sh::R, TK = Sh::TK, RPT = Sh::RPT, CPT = Sh::CPT, DPT = Sh::DPT;
  constexpr int VEC = Sh::VEC;
  extern __shared__ float smem[];
  float* q_s = smem;                    // [R][HD + 1]
  float* k_s = q_s + R * (HD + 1);      // [TK][HD + 1]
  float* v_s = k_s + TK * (HD + 1);     // [TK][HD]
  float* p_s = v_s + TK * HD;           // [R][TK + 1]

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;
  const int BQ = R / G;                 // query positions per tile (G <= R)
  const int q0 = blockIdx.x * BQ;
  const int bkv = blockIdx.y;           // b * KV + kv
  const int b = bkv / KV, kvh = bkv % KV;
  const long long q_pos_stride = static_cast<long long>(KV) * G * HD;
  const long long kv_pos_stride = static_cast<long long>(KV) * HD;
  const T* q_base = q + static_cast<long long>(b) * S * q_pos_stride + static_cast<long long>(kvh) * G * HD;
  T* o_base = out + static_cast<long long>(b) * S * q_pos_stride + static_cast<long long>(kvh) * G * HD;
  const T* k_base = k + static_cast<long long>(b) * S * kv_pos_stride + static_cast<long long>(kvh) * HD;
  const T* v_base = v + static_cast<long long>(b) * S * kv_pos_stride + static_cast<long long>(kvh) * HD;

  // -- the q tile: row r is head r % G of position q0 + r / G ----------------
  for (int e = tid; e < R * HD / VEC; e += THREADS) {
    const int r = e / (HD / VEC);
    const int d0 = (e % (HD / VEC)) * VEC;
    const int pos = q0 + r / G;
    float f[VEC];
    if (r < BQ * G && pos < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q_base + pos * q_pos_stride + (r % G) * HD + d0);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = to_f32(t[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) q_s[r * (HD + 1) + d0 + i] = f[i];
  }

  int qpos[RPT];
  bool row_ok[RPT];
  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    qpos[i] = q0 + r / G;
    row_ok[i] = r < BQ * G && qpos[i] < S;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = k_begin; k0 <= q_last; k0 += TK) {
    __syncthreads();  // the previous tile's K/V/P are no longer read
    // -- load the K and V tiles --------------------------------------------
    for (int e = tid; e < TK * HD / VEC; e += THREADS) {
      const int c = e / (HD / VEC);
      const int d0 = (e % (HD / VEC)) * VEC;
      float kf[VEC], vf[VEC];
      if (k0 + c < S) {
        const long long off = static_cast<long long>(k0 + c) * kv_pos_stride + d0;
        const uint4 kr = *reinterpret_cast<const uint4*>(k_base + off);
        const uint4 vr = *reinterpret_cast<const uint4*>(v_base + off);
        const T* kt = reinterpret_cast<const T*>(&kr);
        const T* vt = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          kf[i] = to_f32(kt[i]);
          vf[i] = to_f32(vt[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        k_s[c * (HD + 1) + d0 + i] = kf[i];
        v_s[c * HD + d0 + i] = vf[i];
      }
    }
    __syncthreads();
    // -- scores of the thread's RPT x CPT block ------------------------------
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RPT], bk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = q_s[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bk[j] = k_s[(tx + 8 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
    // -- mask, then the online-softmax update of each row -------------------
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool ok = row_ok[i] && kpos <= qpos[i] && (window <= 0 || kpos > qpos[i] - window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * (TK + 1) + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    // -- P.V into the thread's RPT x DPT accumulators ------------------------
#pragma unroll 4
    for (int c = 0; c < TK; ++c) {
      float p[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = p_s[(ty + 16 * i) * (TK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = v_s[c * HD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  // -- normalise and write the thread's rows -------------------------------
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!row_ok[i]) continue;
    const int r = ty + 16 * i;
    T* o_row = o_base + qpos[i] * q_pos_stride + (r % G) * HD;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) store(o_row + tx + 8 * j, acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int KV,
           int G, int window, float scale, cudaStream_t s) {
  using Sh = FlashShape<T, HD>;
  if (G > Sh::R) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_kernel<T, HD>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Sh::smem_bytes()));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int bq = Sh::R / G;
  const dim3 grid((S + bq - 1) / bq, B * KV);
  kernel<<<grid, THREADS, Sh::smem_bytes(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, KV, G, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out, int B, int S, int KV,
                int G, int hd, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, KV, G, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, KV, G, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, KV, G, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, KV, G, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are contiguous and 16-byte
// aligned (the wrapper checks). window <= 0 is plain causal attention. scale
// is the reference's 1/sqrt(hd), computed by the caller in double and rounded
// once to f32. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a shape it does not take (hd not in {32, 64, 128,
// 256}, G above the q tile's rows: 64, or 32 at hd = 256).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int KV, int G, int hd, int window,
                                     int dtype, float scale, void* stream) {
  if (G < 1 || B < 1 || KV < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(q, k, v, out, B, S, KV, G, hd, window, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, S, KV, G, hd, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
