// flash_attention: causal (optionally sliding-window) GQA attention over a
// whole sequence, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel):
//   q (B, S, KV, G, hd), k/v (B, S, KV, hd) -> out (B, S, KV, G, hd)
//   out[b,s,kv,g] = softmax_t(mask ? q.k_t / sqrt(hd) : -1e30) . v_t,
//   mask = t <= s and (window == 0 or t > s - window)
// with f32 scores and f32 running max / sum / accumulator (online softmax),
// the normalizer guarded by max(l, 1e-30). The output has q's dtype.
//
// What bounds it: q, k, v and o are each touched once, while the work grows
// with S^2: 4*B*H*hd*S^2/2 flops under the causal mask. At granite-3-2b's
// prefill (B = 8, S = 512, 32 heads over 8 KV heads, hd = 64, bf16) that is
// 8.6 GFLOP against 42 MB: ~12.5 us of bytes at 3.35 TB/s, ~8.7 us of bf16
// tensor-core work. So the bf16 kernel has to keep the products on the
// tensor cores and the loads in flight; anything slower than the tensor
// cores' rate makes it bound by operations.
//
// Two kernels, chosen by dtype in the wrapper (kernel.py):
//
// * bf16, flash_mma_kernel: the products on the tensor cores. One block of 4
//   warps per (b, kv, q tile); the q tile is 64 rows (query positions times
//   the G heads of the KV group, folded as in the TPU kernel, so a K/V tile
//   is loaded once for all G heads), 16 rows per warp. S = Q.K^T and O += P.V
//   are mma.sync.m16n8k16 (bf16 in, f32 accumulate) with fragments loaded by
//   ldmatrix (.trans for V). Q's fragments are loaded once into registers
//   (hd 32 and 128; at hd = 64 they are re-read from shared memory so that
//   four blocks fit on an SM without spills, and at hd = 256 to leave
//   registers for the 16 x 256 accumulator). The scores never leave
//   registers: the online softmax runs on the accumulator fragment (row
//   statistics reduced over the 4 lanes of a quad), and P, rounded to bf16,
//   is the A fragment of P.V as it stands (the m16n8k16 accumulator layout of
//   two n-tiles is the A layout of one k-step). K and V tiles of 64 keys (32
//   at hd = 256) stream through a 2-stage ring in shared memory by
//   cp.async.cg 16-byte copies, tile k+1 in flight while tile k is computed
//   on; rows are padded by 16 bytes, so the 8 rows an ldmatrix reads fall in
//   8 different bank groups. Key tiles wholly above the diagonal or wholly
//   before the window are not visited; only tiles that cross the diagonal
//   or the window's edge are masked per element. The heavy (late) q tiles
//   are launched first, so the causal triangle leaves no tail. Rows and keys
//   past S are masked, so any S works (the TPU kernel needs S % block == 0).
//
// * f32, flash_fma_kernel: scalar f32 FMA tiles (one block of 128 threads
//   per (q tile, b, kv), the tiles in shared memory as f32). bf16 or TF32
//   operands could not meet the reference's f32 tolerance (2e-5), and f32
//   serves only consistency checks, so it stays a plain kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's mask value
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32: scalar FMA tiles
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;  // 16 row groups x 8 column groups

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Threads form a 16 x 8 grid: each owns RPT rows (ty + 16 i) and, for the
// scores, CPT key columns (tx + 8 j), for the output HD/8 columns (tx + 8 j),
// so a row's softmax statistics live in the 8 lanes that share it (shuffle
// reductions). Q/K/V and P tiles sit in shared memory, rows padded by one
// float against bank conflicts.
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
flash_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
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


template <int HD>
int launch_fma(const void* q, const void* k, const void* v, void* out, int B, int S, int KV,
               int G, int window, float scale, cudaStream_t s) {
  using Sh = FlashShape<float, HD>;
  if (G > Sh::R) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fma_kernel<float, HD>;
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
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, KV, G, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tiles on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_ROWS = 16 * MMA_WARPS;  // q-tile rows: 16 per warp

template <int HD>
struct MmaShape {
  static constexpr int TK = HD >= 256 ? 32 : 64;  // keys per K/V tile
  static constexpr int LD = HD + 8;               // shared row stride (bf16): 16 bytes of pad
  static constexpr int CPR = HD / 8;              // 16-byte chunks per row
  static constexpr int MIN_BLOCKS = HD <= 64 ? 4 : 2;  // per SM: caps the registers
  // Q's fragments stay in registers where they fit beside the accumulator
  // under that cap; at hd = 64 (4 blocks an SM) and hd = 256 they are
  // re-read from shared memory at each key tile.
  static constexpr bool Q_IN_REGS = HD == 32 || HD == 128;
  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * (static_cast<size_t>(MMA_ROWS) * LD        // q tile (then the output)
                           + 2ull * 2 * TK * LD);                     // K and V, 2 stages each
  }
};

// A lane's two rows (see mma_bf16.cuh) are r_a = 16 * warp + g and r_b =
// r_a + 8 of the q tile, and a row's statistics are spread over the 4 lanes
// of its quad.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, MmaShape<HD>::MIN_BLOCKS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S, int KV, int G,
                 int window, float scale_log2) {
  using Sh = MmaShape<HD>;
  constexpr int TK = Sh::TK, LD = Sh::LD, CPR = Sh::CPR;
  constexpr int NT = TK / 8;   // score n-tiles of a warp
  constexpr int KS = HD / 16;  // k-steps of Q.K^T
  constexpr int NO = HD / 8;   // output n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [MMA_ROWS][LD]
  bf16* k_s = q_s + MMA_ROWS * LD;                // [2][TK][LD]
  bf16* v_s = k_s + 2 * TK * LD;                  // [2][TK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.x;                    // b * KV + kv
  const int qt = gridDim.y - 1 - blockIdx.y;     // the heaviest q tiles first
  const int b = bkv / KV, kvh = bkv % KV;
  const int BQ = MMA_ROWS / G;                   // query positions per tile (G <= 64)
  const int rows = BQ * G;
  const int q0 = qt * BQ;
  const long long q_pos_stride = static_cast<long long>(KV) * G * HD;
  const long long kv_pos_stride = static_cast<long long>(KV) * HD;
  const bf16* q_base = q + static_cast<long long>(b) * S * q_pos_stride + static_cast<long long>(kvh) * G * HD;
  bf16* o_base = out + static_cast<long long>(b) * S * q_pos_stride + static_cast<long long>(kvh) * G * HD;
  const bf16* k_base = k + static_cast<long long>(b) * S * kv_pos_stride + static_cast<long long>(kvh) * HD;
  const bf16* v_base = v + static_cast<long long>(b) * S * kv_pos_stride + static_cast<long long>(kvh) * HD;

  // -- the q tile (group 0): row r is head r % G of position q0 + r / G ------
  for (int e = tid; e < MMA_ROWS * CPR; e += MMA_THREADS) {
    const int r = e / CPR, c = e % CPR;
    const int pos = q0 + r / G;
    const bool ok = r < rows && pos < S;
    cp_async16(q_s + r * LD + c * 8, ok ? q_base + pos * q_pos_stride + (r % G) * HD + c * 8 : q, ok);
  }
  cp_async_commit();

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = (q_last - k_begin) / TK + 1;
  auto load_kv = [&](int tile) {
    const int k0 = k_begin + tile * TK;
    bf16* ks = k_s + (tile & 1) * TK * LD;
    bf16* vs = v_s + (tile & 1) * TK * LD;
    for (int e = tid; e < TK * CPR; e += MMA_THREADS) {
      const int r = e / CPR, c = e % CPR;
      const bool ok = k0 + r < S;
      const long long off = static_cast<long long>(k0 + r) * kv_pos_stride + c * 8;
      cp_async16(ks + r * LD + c * 8, ok ? k_base + off : k, ok);
      cp_async16(vs + r * LD + c * 8, ok ? v_base + off : v, ok);
    }
  };
  load_kv(0);
  cp_async_commit();  // group 1: the first K/V tile

  const int g4 = lane / 4, t4 = lane % 4;
  const int r_a = warp * 16 + g4, r_b = r_a + 8;
  const int qpos_a = q0 + r_a / G, qpos_b = q0 + r_b / G;
  const bf16* q_warp = q_s + warp * 16 * LD;

  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();
  uint32_t qf[Sh::Q_IN_REGS ? KS : 1][4];
  if constexpr (Sh::Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[kk], q_warp + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // l: this lane's share

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();   // (an empty group on the last tile keeps the count uniform)
    cp_async_wait<1>();  // tile it has landed; tile it + 1 stays in flight
    __syncthreads();
    const bf16* ks = k_s + (it & 1) * TK * LD;
    const bf16* vs = v_s + (it & 1) * TK * LD;
    const int k0 = k_begin + it * TK;

    // -- S = Q.K^T, 16 x TK per warp, in registers -----------------------------
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (Sh::Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, q_warp + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        // matrices: keys n*8.. x dims kk*16 + {0, 8}, then keys (n+1)*8.. likewise
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (n * 8 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[n], a, bk[0], bk[1]);
        mma_bf16(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // -- scale into the log2 domain; mask only tiles that cross the diagonal
    //    or the window's edge ---------------------------------------------------
    const bool need_mask = k0 + TK - 1 > q0 || (window > 0 && k0 <= q_last - window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[n][j] * scale_log2;
        if (need_mask) {
          const int kpos = k0 + n * 8 + 2 * t4 + (j % 2);
          const int qp = j < 2 ? qpos_a : qpos_b;
          if (!(kpos <= qp && (window <= 0 || kpos > qp - window))) x = NEG_INF;
        }
        s[n][j] = x;
      }
    }

    // -- online softmax on the fragment: row max over the quad ----------------
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    uint32_t p[NT][2];  // P in bf16 pairs: [n][0] row r_a, [n][1] row r_b
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = exp2f(s[n][0] - m_a), p1 = exp2f(s[n][1] - m_a);
      const float p2 = exp2f(s[n][2] - m_b), p3 = exp2f(s[n][3] - m_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      p[n][0] = pack_bf16(p0, p1);
      p[n][1] = pack_bf16(p2, p3);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // -- O += P.V: P's accumulator fragments are the A fragments ---------------
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        // matrices (transposed): keys kk*16 + {0, 8}.. x dims n*8.., then dims (n+1)*8..
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + lane % 16) * LD + n * 8 + (lane / 16) * 8);
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // -- normalise; stage the warp's 16 rows in its own q rows, then 16-byte
  //    stores ----------------------------------------------------------------
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ *= 2) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  bf16* o_s = q_s + warp * 16 * LD;  // only this warp ever read these rows
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(o_s + g4 * LD + n * 8 + 2 * t4) =
        pack_bf16(o[n][0] / den_a, o[n][1] / den_a);
    *reinterpret_cast<uint32_t*>(o_s + (g4 + 8) * LD + n * 8 + 2 * t4) =
        pack_bf16(o[n][2] / den_b, o[n][3] / den_b);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = warp * 16 + e / CPR, c = e % CPR;
    const int pos = q0 + r / G;
    if (r < rows && pos < S)
      *reinterpret_cast<uint4*>(o_base + pos * q_pos_stride + (r % G) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + (e / CPR) * LD + c * 8);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S, int KV,
               int G, int window, float scale, cudaStream_t s) {
  using Sh = MmaShape<HD>;
  if (G > MMA_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_mma_kernel<HD>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Sh::smem_bytes()));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int bq = MMA_ROWS / G;
  const int q_tiles = (S + bq - 1) / bq;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * KV, q_tiles);
  kernel<<<grid, MMA_THREADS, Sh::smem_bytes(), s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, KV, G, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points take contiguous, 16-byte aligned pointers (the wrapper
// checks); window <= 0 is plain causal attention; scale is the reference's
// 1/sqrt(hd), computed by the caller in double and rounded once to f32. They
// return cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// shape they do not take (hd not in {32, 64, 128, 256}; G above 64, or above
// 32 at hd = 256, for the f32 kernel's q tile).

// float32 q/k/v/out: the FMA kernel.
extern "C" int repro_flash_attention_fma(const void* q, const void* k, const void* v, void* out,
                                         int B, int S, int KV, int G, int hd, int window,
                                         float scale, void* stream) {
  if (G < 1 || B < 1 || KV < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_fma<32>(q, k, v, out, B, S, KV, G, window, scale, s);
    case 64: return launch_fma<64>(q, k, v, out, B, S, KV, G, window, scale, s);
    case 128: return launch_fma<128>(q, k, v, out, B, S, KV, G, window, scale, s);
    case 256: return launch_fma<256>(q, k, v, out, B, S, KV, G, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bfloat16 q/k/v/out: the tensor-core kernel.
extern "C" int repro_flash_attention_mma(const void* q, const void* k, const void* v, void* out,
                                         int B, int S, int KV, int G, int hd, int window,
                                         float scale, void* stream) {
  if (G < 1 || B < 1 || KV < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_mma<32>(q, k, v, out, B, S, KV, G, window, scale, s);
    case 64: return launch_mma<64>(q, k, v, out, B, S, KV, G, window, scale, s);
    case 128: return launch_mma<128>(q, k, v, out, B, S, KV, G, window, scale, s);
    case 256: return launch_mma<256>(q, k, v, out, B, S, KV, G, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one block, bytes (dtype: 0 = float32, 1 =
// bfloat16), or 0 for an hd the kernels do not take.
extern "C" int repro_flash_attention_smem_bytes(int hd, int dtype) {
  switch (hd) {
    case 32: return static_cast<int>(dtype ? MmaShape<32>::smem_bytes() : FlashShape<float, 32>::smem_bytes());
    case 64: return static_cast<int>(dtype ? MmaShape<64>::smem_bytes() : FlashShape<float, 64>::smem_bytes());
    case 128: return static_cast<int>(dtype ? MmaShape<128>::smem_bytes() : FlashShape<float, 128>::smem_bytes());
    case 256: return static_cast<int>(dtype ? MmaShape<256>::smem_bytes() : FlashShape<float, 256>::smem_bytes());
    default: return 0;
  }
}
