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
// (B = 8, KV = 8, G = 4, hd = 64, bf16) that is 9.4 MB at C = 576 (~2.8 us at
// 3.35 TB/s) and 537 MB at C = 32,768 (~160 us). The design's job is to keep
// enough loads in flight on every SM.
//
// Design: split-K in one launch. The C entries of each (b, kv) pair are cut
// into n_split slices of ceil(C / n_split) entries (n_split <= 8, chosen by
// the wrapper from B*KV, C and the SM count, so that the grid fills the card
// in one wave); the n_split blocks of a pair form one thread-block cluster.
// Inside a block (4 warps), a group of L lanes owns one cache entry at a
// time, each lane a 16-byte piece of its k and v rows. The pieces stream
// through a per-warp ring in shared memory by cp.async.cg (3 stages: two
// batches of U entries per group in flight while one is computed on), each
// lane copying in and reading back only its own slots, so the ring needs no
// barrier; they are converted to f32 in registers. The group's lanes reduce
// the G dot products by shuffles, and each group keeps an online-softmax
// partial (m, l, acc) of its entries; a warp folds its groups together by
// shuffles, and the block folds its warps into one partial, which it writes
// straight into the rank-0 block's shared memory (distributed shared memory;
// a split cluster barrier, arrived at on entry and waited on before the
// first such write, makes sure rank 0 has started). After one cluster.sync(),
// rank 0 rescales each block's partial by exp(m_i - m), sums, divides by
// max(l, 1e-30) and writes the output. So a call is one launch, with no
// scratch in device memory and no state between launches. The warps'
// partials reuse the ring's shared memory, so that a block stays within the
// SM's 227 KB at hd 256 and G 16 (198 KB there; 58 KB at the serving shape).
//
// Masking: an invalid slot scores -1e30, as the reference masks it (a ring
// with no valid slot gives the plain mean of v); an entry past a slice's end
// scores -inf (p = 0), and a partial with no entries (m = -inf) weighs 0 in
// the merge. The TPU kernel needs C % block_k == 0; here any C works.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 16;
constexpr int MAX_SPLIT = 8;  // the portable cluster size
constexpr float NEG_INF = -1e30f;  // the reference's mask value

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The VEC elements of a 16-byte piece, as f32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);             // low half: the even element
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high half: the odd one
  }
}

// Scores are kept in the log2 domain (scaled by log2(e)), so a weight is
// one exp2. A running max that saw no entry yet is -inf; against it, use 0,
// so that exp2(-inf - 0) = 0 gives an empty partial weight 0 without a branch.
__device__ __forceinline__ float safe_max(float M) { return M == -INFINITY ? 0.f : M; }

template <typename T, int HD, int GB>
struct SplitShape {
  static constexpr int VEC = 16 / sizeof(T);               // elements per 16-byte load
  static constexpr int CHUNKS = HD / VEC;                  // 16-byte pieces per cache row
  static constexpr int L = CHUNKS < 32 ? CHUNKS : 32;      // lanes per entry
  static constexpr int CH = CHUNKS / L;                    // pieces per lane
  static constexpr int D = CH * VEC;                       // dims per lane
  static constexpr int EPW = 32 / L;                       // entries a warp holds at once
  static constexpr int NG = WARPS * EPW;                   // entry groups per block
  static constexpr int U0 = (GB >= 16 ? 2 : 4) / CH;
  static constexpr int U = U0 > 0 ? U0 : 1;                // entries per group per batch
  static constexpr int STAGES = 3;                         // batches in the ring (2 in flight)
  static constexpr int RING = U * CH * 2 * 32;             // 16-byte slots per warp per stage
  static constexpr bool Q_IN_REGS = GB * D <= 32;
  static constexpr int MIN_BLOCKS = GB <= 4 ? 4 : (GB <= 8 ? 2 : 1);  // per SM (registers)
  // Rows g >= G of the GB the instance computes have q = 0: computed, never
  // written, so the loops carry no branch on the runtime G.
  //
  // Shared memory: the load ring, then the q rows (f32) where they are not in
  // registers, while the loop runs; after it, m, l, acc of each warp over
  // them (both are dead by then); past both, m, l, acc of each block of the
  // cluster (rank 0's are the ones read; the other blocks write them while
  // rank 0 may still be in its loop, so they alias nothing).
  __host__ __device__ static constexpr size_t loop_bytes(int G) {
    return 16ull * WARPS * STAGES * RING + (Q_IN_REGS ? 0 : sizeof(float) * G * HD);
  }
  __host__ __device__ static constexpr size_t partials_bytes(int G, int n) {
    return sizeof(float) * n * G * (HD + 2);
  }
  __host__ __device__ static constexpr size_t table_offset(int G) {
    return loop_bytes(G) > partials_bytes(G, WARPS) ? loop_bytes(G) : partials_bytes(G, WARPS);
  }
  __host__ __device__ static constexpr size_t smem_bytes(int G, int n_split) {
    return table_offset(G) + partials_bytes(G, n_split);
  }
};
constexpr size_t MAX_SMEM_PER_BLOCK = 227 * 1024;  // Hopper's opt-in limit

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; zero-filled when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(THREADS, (SplitShape<T, HD, GB>::MIN_BLOCKS))
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ valid, T* __restrict__ out, int C, int KV, int G,
                    int chunk, float scale_log2) {
  using Sh = SplitShape<T, HD, GB>;
  constexpr int VEC = Sh::VEC, L = Sh::L, CH = Sh::CH, D = Sh::D, EPW = Sh::EPW, NG = Sh::NG;
  constexpr int U = Sh::U, STAGES = Sh::STAGES, RING = Sh::RING;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % L, grp = lane / L;   // lane within its entry group; the group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the warp's ring: [STAGES][U][CH][k, v][32 lanes] 16-byte slots, a lane's
  // own slots only (it copies them in and reads them back: no barrier)
  uint4* ring = reinterpret_cast<uint4*>(smem_raw) + warp * STAGES * RING;
  float* q_s = reinterpret_cast<float*>(smem_raw + 16ull * WARPS * STAGES * RING);  // [G][HD]
  float* part_m = reinterpret_cast<float*>(smem_raw);  // [WARPS][G]: each warp's partial,
  float* part_l = part_m + WARPS * G;                   // [WARPS][G]   over the ring and q
  float* part_acc = part_l + WARPS * G;                 // [WARPS][G][HD]   once the loop ends
  float* tab_m = reinterpret_cast<float*>(smem_raw + Sh::table_offset(G));  // [n_split][G]: each
  float* tab_l = tab_m + n_split * G;                   // [n_split][G]   block's partial, pushed
  float* tab_acc = tab_l + n_split * G;                 // [n_split][G][HD]   into rank 0's
  // Arrive now, wait before the first write into rank 0's shared memory: by
  // then every block of the cluster has started (and the wait is free).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int bkv = blockIdx.y;                      // b * KV + kv
  const int b = bkv / KV, kvh = bkv % KV;
  const long long row_stride = static_cast<long long>(KV) * HD;  // between cache entries
  const T* k_base = k + static_cast<long long>(b) * C * row_stride + static_cast<long long>(kvh) * HD;
  const T* v_base = v + static_cast<long long>(b) * C * row_stride + static_cast<long long>(kvh) * HD;
  const int c_begin = min(C, rank * chunk), c_end = min(C, c_begin + chunk);

  // Batch i of a group: entries first + i*NG*U + u, u < U. The warp's groups
  // run the same batches (the shuffles need every lane); entries past the
  // slice are zero-filled and masked.
  const int warp_first = c_begin + warp * EPW * U;
  const int first = warp_first + grp * U;
  const int n_batches = warp_first < c_end ? (c_end - warp_first + NG * U - 1) / (NG * U) : 0;
  auto issue = [&](int i) {
    uint4* st = ring + (i % STAGES) * RING;
    const int base = first + i * NG * U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = base + u < c_end;
      const long long row = static_cast<long long>(ok ? base + u : 0) * row_stride;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int d0 = (sub + j * L) * VEC;
        cp_async16(st + ((u * CH + j) * 2 + 0) * 32 + lane, k_base + row + d0, ok);
        cp_async16(st + ((u * CH + j) * 2 + 1) * 32 + lane, v_base + row + d0, ok);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_batches) issue(i);
    cp_async_commit();
  }

  // the q rows: the lane's dims (pieces sub + j*L, j < CH, of VEC elements)
  // straight into registers where they fit, else all of them into shared
  // memory as f32
  const T* q_base = q + static_cast<long long>(bkv) * G * HD;
  float qr[Sh::Q_IN_REGS ? GB : 1][Sh::Q_IN_REGS ? D : 1];
  if constexpr (Sh::Q_IN_REGS) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const uint4 raw = g < G ? __ldg(reinterpret_cast<const uint4*>(q_base + g * HD) + sub + j * L)
                                : make_uint4(0u, 0u, 0u, 0u);
        unpack<T>(raw, qr[g] + j * VEC);
      }
  } else {
    for (int i = tid; i < G * HD; i += THREADS) {
      if constexpr (sizeof(T) == 4) q_s[i] = q_base[i];
      else q_s[i] = __bfloat162float(q_base[i]);
    }
    __syncthreads();
  }
  auto q_at = [&](int g, int d) -> float {
    if constexpr (Sh::Q_IN_REGS) return qr[g][d];
    else return g < G ? q_s[g * HD + (sub + (d / VEC) * L) * VEC + d % VEC] : 0.f;
  };

  float m[GB], l[GB], acc[GB][D];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[g][d] = 0.f;
  }

  for (int i = 0; i < n_batches; ++i) {
    if (i + STAGES - 1 < n_batches) issue(i + STAGES - 1);
    cp_async_commit();  // (empty near the end: keeps the group count uniform)
    const int base = first + i * NG * U;
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) ok[u] = base + u < c_end && __ldg(valid + base + u);
    cp_async_wait<STAGES - 1>();  // batch i has landed; the next ones stay in flight
    const uint4* st = ring + (i % STAGES) * RING;

    // scores of the U entries for every query row, reduced over the group
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[D];
#pragma unroll
      for (int j = 0; j < CH; ++j) unpack<T>(st[((u * CH + j) * 2 + 0) * 32 + lane], kf + j * VEC);
      const float masked = base + u < c_end ? NEG_INF : -INFINITY;  // past the slice: p = 0
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(q_at(g, d), kf[d], dot);
#pragma unroll
        for (int o = L / 2; o > 0; o /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u][g] = ok[u] ? dot * scale_log2 : masked;
      }
    }
    // the online-softmax update, once per U entries: s becomes p
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float ms = safe_max(mx);
      const float alpha = exp2f(m[g] - ms);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = exp2f(s[u][g] - ms);
        sum += s[u][g];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[g][d] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[D];
#pragma unroll
      for (int j = 0; j < CH; ++j) unpack<T>(st[((u * CH + j) * 2 + 1) * 32 + lane], vf + j * VEC);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int d = 0; d < D; ++d) acc[g][d] = fmaf(s[u][g], vf[d], acc[g][d]);
      }
    }
  }

  // -- fold the warp's EPW groups together (lanes L, 2L, ... apart) ----------
#pragma unroll
  for (int o = L; o < 32; o *= 2) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float M = fmaxf(m[g], mo);
      const float fa = exp2f(m[g] - safe_max(M)), fb = exp2f(mo - safe_max(M));
      l[g] = l[g] * fa + lo * fb;
#pragma unroll
      for (int d = 0; d < D; ++d)
        acc[g][d] = acc[g][d] * fa + __shfl_xor_sync(0xffffffffu, acc[g][d], o) * fb;
      m[g] = M;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is out of the loop: the ring and q rows are free
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= G) break;  // (no shuffle below: a branch on G is harmless here)
      if (sub == 0) {
        part_m[warp * G + g] = m[g];
        part_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < CH; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          part_acc[(warp * G + g) * HD + (sub + j * L) * VEC + i] = acc[g][j * VEC + i];
    }
  }
  __syncthreads();
  // -- the block's partial, from its warps', written into rank 0's table ---
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* t_m = cluster.map_shared_rank(tab_m, 0);
  float* t_l = cluster.map_shared_rank(tab_l, 0);
  float* t_acc = cluster.map_shared_rank(tab_acc, 0);
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, part_m[w * G + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(part_m[w * G + g] - safe_max(M));
      den = fmaf(f, part_l[w * G + g], den);
      num = fmaf(f, part_acc[w * G * HD + e], num);
    }
    t_acc[rank * G * HD + e] = num;
    if (e % HD == 0) {
      t_m[rank * G + g] = M;
      t_l[rank * G + g] = den;
    }
  }
  cluster.sync();  // the table is complete; only rank 0 reads it (its own memory)
  if (rank != 0) return;

  // -- rank 0 merges the cluster's partials ----------------------------------
  T* o_base = out + static_cast<long long>(bkv) * G * HD;
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD;
    float M = -INFINITY;
    for (int r = 0; r < n_split; ++r) M = fmaxf(M, tab_m[r * G + g]);
    float num = 0.f, den = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float f = exp2f(tab_m[r * G + g] - safe_max(M));
      den = fmaf(f, tab_l[r * G + g], den);
      num = fmaf(f, tab_acc[r * G * HD + e], num);
    }
    store(o_base + e, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD, int GB>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
           int B, int C, int KV, int G, int n_split, float scale, cudaStream_t s) {
  using Sh = SplitShape<T, HD, GB>;
  static_assert(Sh::smem_bytes(GB, MAX_SPLIT) <= MAX_SMEM_PER_BLOCK, "a block must fit an SM");
  auto kernel = decode_split_kernel<T, HD, GB>;
  static bool attr_set = false;  // opt in once to the largest G this instance takes
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Sh::smem_bytes(GB, MAX_SPLIT)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * KV, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Sh::smem_bytes(G, n_split);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int chunk = (C + n_split - 1) / n_split;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      valid, static_cast<T*>(out), C, KV, G, chunk, scale * 1.4426950408889634f);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of n_split blocks the card holds at once (cudaOccupancy-
// MaxActiveClusters): the grid runs in one wave when B*KV is at most this.
template <typename T, int HD, int GB>
int cluster_capacity(int G, int n_split) {
  using Sh = SplitShape<T, HD, GB>;
  auto kernel = decode_split_kernel<T, HD, GB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Sh::smem_bytes(GB, MAX_SPLIT)));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Sh::smem_bytes(G, n_split);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return occ == cudaSuccess ? clusters : -static_cast<int>(occ);
}

template <typename T, int HD>
int capacity_g(int G, int n_split) {
  if (G <= 2) return cluster_capacity<T, HD, 2>(G, n_split);
  if (G <= 4) return cluster_capacity<T, HD, 4>(G, n_split);
  if (G <= 8) return cluster_capacity<T, HD, 8>(G, n_split);
  return cluster_capacity<T, HD, MAX_G>(G, n_split);
}

template <typename T>
int capacity_hd(int hd, int G, int n_split) {
  switch (hd) {
    case 32: return capacity_g<T, 32>(G, n_split);
    case 64: return capacity_g<T, 64>(G, n_split);
    case 128: return capacity_g<T, 128>(G, n_split);
    case 256: return capacity_g<T, 256>(G, n_split);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int HD>
int dispatch_g(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
               int B, int C, int KV, int G, int n_split, float scale, cudaStream_t s) {
  if (G <= 2) return launch<T, HD, 2>(q, k, v, valid, out, B, C, KV, G, n_split, scale, s);
  if (G <= 4) return launch<T, HD, 4>(q, k, v, valid, out, B, C, KV, G, n_split, scale, s);
  if (G <= 8) return launch<T, HD, 8>(q, k, v, valid, out, B, C, KV, G, n_split, scale, s);
  return launch<T, HD, MAX_G>(q, k, v, valid, out, B, C, KV, G, n_split, scale, s);
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
                int B, int C, int KV, int G, int hd, int n_split, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return dispatch_g<T, 32>(q, k, v, valid, out, B, C, KV, G, n_split, scale, s);
    case 64: return dispatch_g<T, 64>(q, k, v, valid, out, B, C, KV, G, n_split, scale, s);
    case 128: return dispatch_g<T, 128>(q, k, v, valid, out, B, C, KV, G, n_split, scale, s);
    case 256: return dispatch_g<T, 256>(q, k, v, valid, out, B, C, KV, G, n_split, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are contiguous and 16-byte
// aligned (the wrapper checks). n_split (1..8) is the blocks of a (b, kv)
// pair, one cluster; scale is the reference's 1/sqrt(hd), computed by the
// caller in double and rounded once to f32. Returns the launch's CUDA error,
// or cudaErrorInvalidValue for a shape it does not take (hd not in {32, 64,
// 128, 256}, G > 16, B * KV > 65535).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const uint8_t* valid, void* out, int B, int C, int KV,
                                      int G, int hd, int dtype, int n_split, float scale,
                                      void* stream) {
  if (G < 1 || G > MAX_G || B < 1 || KV < 1 || C < 1 || B * KV > 65535 || n_split < 1 ||
      n_split > MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, valid, out, B, C, KV, G, hd, n_split, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, valid, out, B, C, KV, G, hd, n_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block, bytes (dtype: 0 = float32, 1 = bfloat16).
extern "C" int repro_decode_attention_smem_bytes(int hd, int G, int dtype, int n_split) {
  if (G < 1 || G > MAX_G) return 0;
  const int GB = G <= 2 ? 2 : G <= 4 ? 4 : (G <= 8 ? 8 : MAX_G);
#define REPRO_SMEM(T, HD)                                                               \
  if (hd == HD)                                                                         \
    return static_cast<int>(GB == 2   ? SplitShape<T, HD, 2>::smem_bytes(G, n_split)    \
                            : GB == 4 ? SplitShape<T, HD, 4>::smem_bytes(G, n_split)    \
                            : GB == 8 ? SplitShape<T, HD, 8>::smem_bytes(G, n_split)    \
                                      : SplitShape<T, HD, MAX_G>::smem_bytes(G, n_split));
  if (dtype) {
    REPRO_SMEM(__nv_bfloat16, 32) REPRO_SMEM(__nv_bfloat16, 64)
    REPRO_SMEM(__nv_bfloat16, 128) REPRO_SMEM(__nv_bfloat16, 256)
  } else {
    REPRO_SMEM(float, 32) REPRO_SMEM(float, 64) REPRO_SMEM(float, 128) REPRO_SMEM(float, 256)
  }
#undef REPRO_SMEM
  return 0;
}

// Clusters of n_split blocks resident at once on the current card, or minus
// a CUDA error.
extern "C" int repro_decode_attention_cluster_capacity(int hd, int G, int dtype, int n_split) {
  if (G < 1 || G > MAX_G || n_split < 1 || n_split > MAX_SPLIT)
    return -static_cast<int>(cudaErrorInvalidValue);
  return dtype ? capacity_hd<__nv_bfloat16>(hd, G, n_split) : capacity_hd<float>(hd, G, n_split);
}
