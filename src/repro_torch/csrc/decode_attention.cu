// decode_attention: one decode step's GQA attention against a ring KV cache,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention of
// src/repro/kernels/decode_attention/kernel.py (_decode_kernel):
//   q (B, KV, G, hd), k/v (B, C, KV, hd), valid (C,) bool -> out (B, KV, G, hd)
//   out[b,kv,g] = softmax_c(valid ? q.k_c / sqrt(hd) : -1e30) . v_c
// with f32 scores, f32 running max / sum / accumulator, and the normalizer
// guarded by max(l, 1e-30), as the TPU kernel does. q/k/v are f32 or bf16;
// the output has q's dtype.
//
// What bounds it: every cache entry is read once for G query rows, about
// 4*G flops per 2*hd*sizeof(T) bytes: far below the card's ridge point, so
// the bound is bytes (k and v once each). For granite-3-2b's decode
// (B = 8, KV = 8, G = 4, hd = 64, bf16) that is 9.4 MB at C = 576 (~3 us at
// 3.35 TB/s, so one launch there is bound by launch latency in practice) and
// 537 MB at C = 32,768 (~160 us).
//
// Design (simple first): one block of 128 threads per (b, kv) pair; the G
// query rows sit in shared memory; the cache is streamed through shared
// memory in tiles of TC = 8192 / hd entries (4096 / hd in f32; K transposed,
// with one column of padding against bank conflicts; V row-major). The next
// tile's loads go out into registers before the current tile is computed
// on, so their latency overlaps the arithmetic. Per tile: scores of all
// (g, c) pairs spread over the threads, an online-softmax update per row (one
// warp per row), then the P.V product with each thread owning (g, d)
// accumulators in registers. The loop over tiles inside the block takes the
// place of the TPU kernel's sequential cache grid axis. The TPU kernel needs
// C % block_k == 0; here the ragged last tile is masked (scores -inf, which
// give p = 0, and V rows zeroed), so any C works (serving's capacity S +
// new_tokens rarely is a multiple of anything).
//
// Known limit, left for a later PR: one block per (b, kv) pair gives only
// B*KV blocks (64 at B = 8 for 132 SMs) of 4 warps each, too few to hide
// latency. Split-K (flash-decoding: several blocks per pair over slices of
// the cache, then a merge) is the cure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_G = 16;
constexpr float NEG_INF = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int HD>
struct DecodeShape {
  static constexpr int TC = (sizeof(T) == 2 ? 8192 : 4096) / HD;  // cache entries per tile
  static constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  static constexpr int LOADS = TC * HD / VEC / THREADS;  // per thread per tile, of K and of V
  static constexpr int ACC = MAX_G * HD / THREADS;  // (g, d) accumulators per thread
  static size_t smem_bytes(int G) {
    return sizeof(float) * (static_cast<size_t>(HD) * (TC + 1)  // K^T tile
                            + static_cast<size_t>(TC) * HD      // V tile
                            + static_cast<size_t>(G) * HD       // q rows
                            + static_cast<size_t>(G) * TC       // scores / probabilities
                            + 3 * MAX_G);                       // m, l, alpha
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ valid,
                        T* __restrict__ out, int C, int KV, int G, float scale) {
  using Sh = DecodeShape<T, HD>;
  constexpr int TC = Sh::TC, VEC = Sh::VEC, ACC = Sh::ACC, LOADS = Sh::LOADS;
  extern __shared__ float smem[];
  float* kT_s = smem;                        // [HD][TC + 1]
  float* v_s = kT_s + HD * (TC + 1);         // [TC][HD]
  float* q_s = v_s + TC * HD;                // [G][HD]
  float* p_s = q_s + G * HD;                 // [G][TC]
  float* m_s = p_s + G * TC;                 // [MAX_G]
  float* l_s = m_s + MAX_G;
  float* a_s = l_s + MAX_G;

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x;                // b * KV + kv
  const int b = bkv / KV, kvh = bkv % KV;
  const long long row_stride = static_cast<long long>(KV) * HD;  // between cache entries
  const T* k_base = k + static_cast<long long>(b) * C * row_stride + static_cast<long long>(kvh) * HD;
  const T* v_base = v + static_cast<long long>(b) * C * row_stride + static_cast<long long>(kvh) * HD;
  const T* q_base = q + static_cast<long long>(bkv) * G * HD;

  for (int i = tid; i < G * HD; i += THREADS) q_s[i] = to_f32(q_base[i]);
  if (tid < MAX_G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  // The next tile's K/V rows are fetched into registers (LOADS 16-byte loads
  // of each per thread, all in flight at once) while the current tile is
  // computed on; rows past C read as zeros.
  uint4 k_next[LOADS], v_next[LOADS];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int e = tid + it * THREADS;
      const int c = e / (HD / VEC), d0 = (e % (HD / VEC)) * VEC;
      if (c0 + c < C) {
        const long long off = static_cast<long long>(c0 + c) * row_stride + d0;
        k_next[it] = *reinterpret_cast<const uint4*>(k_base + off);
        v_next[it] = *reinterpret_cast<const uint4*>(v_base + off);
      } else {
        k_next[it] = v_next[it] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  fetch(0);

  for (int c0 = 0; c0 < C; c0 += TC) {
    __syncthreads();  // the previous tile's K/V/P are no longer read
    // -- the fetched K and V tile into shared memory, as f32 ----------------
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int e = tid + it * THREADS;
      const int c = e / (HD / VEC), d0 = (e % (HD / VEC)) * VEC;
      const T* kt = reinterpret_cast<const T*>(&k_next[it]);
      const T* vt = reinterpret_cast<const T*>(&v_next[it]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        kT_s[(d0 + i) * (TC + 1) + c] = to_f32(kt[i]);
        v_s[c * HD + d0 + i] = to_f32(vt[i]);
      }
    }
    __syncthreads();
    if (c0 + TC < C) fetch(c0 + TC);
    // -- scores: every (g, c) pair of the tile ------------------------------
    for (int e = tid; e < G * TC; e += THREADS) {
      const int g = e / TC, c = e % TC;
      float s;
      if (c0 + c >= C) {
        s = -INFINITY;  // past the cache: p = 0
      } else if (!valid[c0 + c]) {
        s = NEG_INF;    // an empty or out-of-window slot, as the reference masks it
      } else {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(q_s[g * HD + d], kT_s[d * (TC + 1) + c], dot);
        s = dot * scale;
      }
      p_s[g * TC + c] = s;
    }
    __syncthreads();
    // -- online softmax: one warp per query row ------------------------------
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = -INFINITY;
      for (int c = lane; c < TC; c += 32) mx = fmaxf(mx, p_s[g * TC + c]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < TC; c += 32) {
        const float p = expf(p_s[g * TC + c] - m_new);
        p_s[g * TC + c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // -- P.V: each thread owns (g, d) accumulators ---------------------------
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int e = tid + j * THREADS;
      if (e < G * HD) {
        const int g = e / HD, d = e % HD;
        float a = acc[j] * a_s[g];
        const float* p_row = p_s + g * TC;
#pragma unroll 8
        for (int c = 0; c < TC; ++c) a = fmaf(p_row[c], v_s[c * HD + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();
  T* o_base = out + static_cast<long long>(bkv) * G * HD;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int e = tid + j * THREADS;
    if (e < G * HD) store(o_base + e, acc[j] / fmaxf(l_s[e / HD], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
           int B, int C, int KV, int G, float scale, cudaStream_t s) {
  using Sh = DecodeShape<T, HD>;
  auto kernel = decode_attention_kernel<T, HD>;
  static bool attr_set = false;  // opt in once to the largest tile this instance can use
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Sh::smem_bytes(MAX_G)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  kernel<<<B * KV, THREADS, Sh::smem_bytes(G), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid,
      static_cast<T*>(out), C, KV, G, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
                int B, int C, int KV, int G, int hd, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, valid, out, B, C, KV, G, scale, s);
    case 64: return launch<T, 64>(q, k, v, valid, out, B, C, KV, G, scale, s);
    case 128: return launch<T, 128>(q, k, v, valid, out, B, C, KV, G, scale, s);
    case 256: return launch<T, 256>(q, k, v, valid, out, B, C, KV, G, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are contiguous and 16-byte
// aligned (the wrapper checks). scale is the reference's 1/sqrt(hd), computed
// by the caller in double and rounded once to f32. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a shape it does not take (hd not in {32, 64,
// 128, 256}, G > 16).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const uint8_t* valid, void* out, int B, int C, int KV,
                                      int G, int hd, int dtype, float scale, void* stream) {
  if (G < 1 || G > MAX_G || B < 1 || KV < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(q, k, v, valid, out, B, C, KV, G, hd, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, valid, out, B, C, KV, G, hd, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
