// ssd_scan: the Mamba2 SSD chunked scan, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_scan of
// src/repro/kernels/ssd_scan/kernel.py (_ssd_kernel). Per (batch, head) and
// per chunk of c rows, with an f32 state (P, N) carried from chunk to chunk
// (cums = running sum of dA within the chunk):
//   L[i,j] = exp(cums_i - cums_j) for j <= i, else 0
//   y      = (C.B^T o L).x + (C.state^T) o exp(cums)
//   state <- state * exp(cums_last) + (x o exp(cums_last - cums))^T . B
// x is dt-premultiplied (S, P), dA = dt*A (S,), B/C (S, N). Beyond the TPU
// kernel's contract, and exactly as the model's ssd_chunked does, the state
// may start from an initial state (else zero), the final state is written as
// a second output (B, H, P, N) f32, and a ragged S is masked (the padded rows
// have x = B = C = 0 and dA = 0, so the final state is that of row S-1).
// The initial and final state may be the same buffer (a decode cache updated
// in place).
//
// Layout: x/y (B, S, H, P) and dA (B, S, H) by element strides; B/C
// (B, S, [H,] N) by strides with a head stride that may be 0, so the (B, S, N)
// matrices that every head shares are read in place, never broadcast into
// memory. x, B, C and y are f32 or bf16 (one dtype); dA and the state f32.
// IEEE expf/exp2f (no fast math).
//
// Precision: the decays are exponents of differences of the running sum,
// cums_i - cums_j. At the model's dA (A down to -24, dt ~ 1) cums reaches
// ~-5000 within a chunk, where one f32 step is ~5e-4: a running sum kept in
// f32, as the reference keeps it, puts errors of that size into exponents
// whose true value is small, and so ~1e-3 into y. Both kernels keep cums (256
// values a chunk) in f64; the f32 kernel rounds each difference to f32 only
// before the exponential, the bf16 kernel gets that difference to within an
// ulp in f32 arithmetic (below). The decay is selected, not multiplied, for
// j > i, where the exponential overflows.
//
// What bounds it: at mamba2-130m's serving prefill (B = 8, S = 2048, H = 24,
// P = 64, N = 128, c = 256, bf16) the call moves 123 MB (x and y dominate;
// B/C are read once per batch row, the state read and written once) and does
// 32 GFLOP under the causal mask: on the tensor cores the bytes bound is
// 0.037 ms and the operations bound 0.033 ms. Everything hangs on keeping the
// products on the tensor cores and the whole card busy.
//
// Two kernels, chosen by dtype:
//
// * bf16, ssd_mma_kernel: the chunks run in parallel, in one launch. The
//   blocks of one (b, h) form a thread-block cluster of up to 8 along the
//   chunk axis; where there are more chunks than blocks, the cluster walks
//   rounds of chunks. The wrapper sizes the cluster (kernel.py,
//   cluster_size) from how many clusters of each size the card holds at
//   once: at the serving shape (8 chunks, 192 (b, h) pairs) clusters of 2
//   walking 4 rounds, 66 of them resident, beat clusters of 8 in one round,
//   15 resident.
//   In a round, each block (8 warps; x's and B's 256 rows in shared memory
//   by 16-byte cp.async) computes
//     phase A: its chunk's own contribution to the state,
//       S_c = (x o exp(cums_last - cums))^T . B (P x N, f32), and its decay
//       exp(cums_last), pushed into every rank's shared memory;
//     a cluster barrier;
//     the scan: rank s owns rows [s*P/n, (s+1)*P/n) of the state. It reads
//       those rows of every rank's S_c through distributed shared memory
//       (cluster.map_shared_rank), chains h <- h * exp(cums_last_q) + S_q
//       from the state carried into the round (the initial state, or the
//       previous round's result, kept in the final-state buffer), and writes
//       the state entering each rank's chunk back over that rank's S_c rows;
//       the state after the round goes to the final-state buffer. Each
//       block moves one state's worth of shared memory, whatever the
//       cluster size;
//     a cluster barrier (no block reads another's shared memory after it,
//       so any block may then exit);
//     phase B, for the warp's two 16-row query tiles, 15 - w and w (the same
//       work in every warp under the causal mask), one after the other:
//       y = (C.state^T) o exp(cums) + (C.B^T o L).x. C's fragments come from
//       device memory straight into registers (only their own rows use
//       them), the first tile's while the scan runs.
//   Products on the tensor cores, mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), fragments by ldmatrix (mma_bf16.cuh). C.B^T lands in an
//   accumulator fragment, two 16-key blocks a step (four independent
//   accumulator chains); the decay is applied there in registers, selected
//   for j <= i, and the fragment, split into two bf16 terms hi = bf16(s) and
//   lo = bf16(s - hi), gives the A fragments of two products with x (as
//   flash's P.V, twice). Rounded to one bf16 term (2^-9), the scores miss
//   y's tolerance (2e-2, atol scaled by min(1, max|y|)) at outputs near zero
//   on slowly decaying heads, which sum the most scores
//   (tests/test_torch_ssd_split.py). The decay's exponent is the difference
//   of two running sums of dA kept in f64 and stored as f32 pairs hi + lo of
//   cums * log2(e): (hi_i - hi_j) + (lo_i - lo_j) is the f64 difference to
//   within an ulp of f32, and ex2.approx (relative error ~2^-22) takes it.
//   (With the f64 difference converted per element, the decay took over
//   half of the intra-chunk term's time: f64 arithmetic and f64-to-f32
//   conversions run at 1/2 and 1/8 of the f32 rate.)
//   C.state^T takes the entering state as bf16 hi + lo likewise (two
//   products, both terms in the f32 state's shared memory), in f32
//   accumulators scaled by exp(cums) after; the carried state stays f32.
//   The state update's operand x o exp(cums_last - cums) is split into two
//   bf16 terms, hi = bf16(v) and lo = bf16(v - hi), and both are multiplied
//   by B: one bf16 term alone puts ~1e-3 into the final state, which is held
//   at 1e-4 relative. One block an SM (x, B and the state take 145 KB at
//   P = 64, N = 128, and the warps up to 255 registers): the cluster
//   barriers and the scan are not hidden behind another block's products;
//   two blocks an SM would need 128 registers a thread, and spilled.
//
// * f32, ssd_scan_kernel: scalar f32 FMA tiles, one block of 256 threads per
//   (b, h) walking the chunks in order (the loop takes the place of the TPU
//   grid's sequential chunk axis). A chunk is cut into 64-row tiles and never
//   builds its c x c matrix whole: for each query tile, C^T sits in shared
//   memory; the inter-chunk term C.state^T comes first, then for each key
//   tile j <= i the scores (C.B^T, 64 x 64) are formed with the decay
//   selected, stored transposed, and applied to x. Each thread owns a 4 x 4
//   (scores) or 4 x P/16 (y) register tile. The carried state lives in
//   registers and is copied to shared memory at each chunk start for the
//   inter-chunk term; its update rides on the last query tile's pass. f32
//   serves only the reference's f32 checks (1e-4), which bf16 operands could
//   not meet, so it stays this plain kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 64;            // query rows per tile
constexpr int TK = 64;            // key rows per tile
constexpr int LD = TQ + 4;        // padded row of a transposed tile (float4-aligned)
constexpr int MAX_CHUNK = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Args {
  const void* x;
  const float* dA;
  const void* Bm;
  const void* Cm;
  void* y;
  const float* init_state;  // (B, H, P, N) or null (zeros)
  float* final_state;       // (B, H, P, N)
  int H, S, chunk;
  long long x_sb, x_ss, x_sh;
  long long y_sb, y_ss, y_sh;
  long long da_sb, da_ss, da_sh;
  long long bc_sb, bc_ss, bc_sh;
};

template <int P, int N>
struct Shape {
  static constexpr size_t floats = static_cast<size_t>(N) * LD   // C^T tile
                                   + static_cast<size_t>(N) * LD // B^T tile
                                   + static_cast<size_t>(TK) * P // x tile
                                   + static_cast<size_t>(TK) * LD  // scores^T
                                   + static_cast<size_t>(N) * P  // state^T entering the chunk
                                   + 4 * MAX_CHUNK;              // cums (f64), exp(cums), decay
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Args a) {
  constexpr int RP = P / 16;  // y columns per thread, and state rows (p) per thread
  constexpr int RN = N / 16;  // state columns (n) per thread
  static_assert(RP % 4 == 0, "P must be a multiple of 64");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ct = smem;               // [N][LD]   C rows of the query tile, transposed
  float* Bt = Ct + N * LD;        // [N][LD]   B rows of the key tile, transposed
  float* xs = Bt + N * LD;        // [TK][P]   x rows of the key tile
  float* St = xs + TK * P;        // [TK][LD]  masked, decayed scores, transposed
  float* stT = St + TK * LD;      // [N][P]    the state entering the chunk, transposed
  double* cums = reinterpret_cast<double*>(stT + N * P);  // [MAX_CHUNK], 8-byte aligned
  float* ecum = reinterpret_cast<float*>(cums + MAX_CHUNK);  // exp(cums)
  float* wdec = ecum + MAX_CHUNK;                            // exp(cums_last - cums)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int S = a.S, chunk = a.chunk;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const T* Bm = static_cast<const T*>(a.Bm) + b * a.bc_sb + h * a.bc_sh;
  const T* Cm = static_cast<const T*>(a.Cm) + b * a.bc_sb + h * a.bc_sh;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;
  const float* dA = a.dA + b * a.da_sb + h * a.da_sh;
  const long long state_off = static_cast<long long>(bh) * P * N;

  // the carried state: rows p = ty*RP + k, columns n = tx + 16*m
  float st[RP][RN];
#pragma unroll
  for (int k = 0; k < RP; ++k)
#pragma unroll
    for (int m = 0; m < RN; ++m)
      st[k][m] = a.init_state ? a.init_state[state_off + (ty * RP + k) * N + tx + 16 * m] : 0.f;

  const int nq = (chunk + TQ - 1) / TQ;
  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int clen = min(chunk, S - c0);  // rows past clen are padding
    // -- cums over the chunk: warp 0, a segment per lane, then a lane scan --
    if (tid < 32) {
      const int per = (chunk + 31) / 32, r0 = tid * per;
      double run = 0.0;
      for (int k = 0; k < per; ++k) {
        const int r = r0 + k;
        if (r < chunk) {
          run += r < clen ? static_cast<double>(dA[(c0 + r) * a.da_ss]) : 0.0;
          cums[r] = run;
        }
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const double t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      const double excl = incl - run;
      for (int k = 0; k < per; ++k)
        if (r0 + k < chunk) cums[r0 + k] += excl;
    }
    __syncthreads();
    const double last = cums[chunk - 1];
    for (int r = tid; r < chunk; r += THREADS) {
      ecum[r] = expf(static_cast<float>(cums[r]));
      wdec[r] = expf(static_cast<float>(last - cums[r]));
    }
    // -- the state entering the chunk, for the inter-chunk term; the carried
    //    copy is decayed now and gathers the chunk's inputs below ------------
    const float elast = expf(static_cast<float>(last));
#pragma unroll
    for (int k = 0; k < RP; ++k)
#pragma unroll
      for (int m = 0; m < RN; ++m) {
        stT[(tx + 16 * m) * P + ty * RP + k] = st[k][m];
        st[k][m] *= elast;
      }
    __syncthreads();

    for (int qi = 0; qi < nq; ++qi) {
      const int q0 = qi * TQ;
      for (int e = tid; e < TQ * N; e += THREADS) {
        const int i = e / N, n = e % N, r = q0 + i;
        Ct[n * LD + i] = r < clen ? to_f32(Cm[(c0 + r) * a.bc_ss + n]) : 0.f;
      }
      __syncthreads();
      // inter-chunk term: acc[i][p] = exp(cums_i) * sum_n C[i][n] state[p][n]
      float acc[4][RP];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int pp = 0; pp < RP; ++pp) acc[ii][pp] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * LD + ty * 4]);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        float sv[RP];
#pragma unroll
        for (int pp = 0; pp < RP; pp += 4) {
          const float4 t = *reinterpret_cast<const float4*>(&stT[n * P + tx * RP + pp]);
          sv[pp] = t.x; sv[pp + 1] = t.y; sv[pp + 2] = t.z; sv[pp + 3] = t.w;
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int pp = 0; pp < RP; ++pp) acc[ii][pp] = fmaf(c4[ii], sv[pp], acc[ii][pp]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float e = ecum[min(q0 + ty * 4 + ii, chunk - 1)];
#pragma unroll
        for (int pp = 0; pp < RP; ++pp) acc[ii][pp] *= e;
      }

      // intra-chunk term, one key tile at a time (tiles above the diagonal skipped)
      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = kj * TK;
        for (int e = tid; e < TK * N; e += THREADS) {
          const int j = e / N, n = e % N, r = k0 + j;
          Bt[n * LD + j] = r < clen ? to_f32(Bm[(c0 + r) * a.bc_ss + n]) : 0.f;
        }
        for (int e = tid; e < TK * P; e += THREADS) {
          const int j = e / P, p = e % P, r = k0 + j;
          xs[j * P + p] = r < clen ? to_f32(x[(c0 + r) * a.x_ss + p]) : 0.f;
        }
        __syncthreads();
        // scores[i][j] = C_i . B_j, rows i = ty*4.., columns j = tx*4..
        float s[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * LD + ty * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(&Bt[n * LD + tx * 4]);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(c4[ii], b4[jj], s[ii][jj]);
        }
        // the decay, selected: j > i (and padding rows past the chunk) give 0
        double ci[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) ci[ii] = cums[min(q0 + ty * 4 + ii, chunk - 1)];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = k0 + tx * 4 + jj;
          const double cj = cums[min(j, chunk - 1)];
          float out[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int i = q0 + ty * 4 + ii;
            out[ii] = (j <= i && i < chunk)
                          ? s[ii][jj] * expf(static_cast<float>(ci[ii] - cj)) : 0.f;
          }
          *reinterpret_cast<float4*>(&St[(tx * 4 + jj) * LD + ty * 4]) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
        __syncthreads();
        // y[i][p] += sum_j scores[i][j] x[j][p]
#pragma unroll 4
        for (int j = 0; j < TK; ++j) {
          const float4 sv = *reinterpret_cast<const float4*>(&St[j * LD + ty * 4]);
          const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
          float xv[RP];
#pragma unroll
          for (int pp = 0; pp < RP; pp += 4) {
            const float4 t = *reinterpret_cast<const float4*>(&xs[j * P + tx * RP + pp]);
            xv[pp] = t.x; xv[pp + 1] = t.y; xv[pp + 2] = t.z; xv[pp + 3] = t.w;
          }
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int pp = 0; pp < RP; ++pp) acc[ii][pp] = fmaf(s4[ii], xv[pp], acc[ii][pp]);
        }
        // the last query tile's pass sees every key tile of the chunk once:
        // state[p][n] += sum_j x[j][p] exp(cums_last - cums_j) B[j][n]
        if (qi == nq - 1) {
#pragma unroll 2
          for (int j = 0; j < TK; ++j) {
            const int r = k0 + j;
            const float w = r < chunk ? wdec[r] : 0.f;
            float xv[RP];
#pragma unroll
            for (int k = 0; k < RP; k += 4) {
              const float4 t = *reinterpret_cast<const float4*>(&xs[j * P + ty * RP + k]);
              xv[k] = t.x * w; xv[k + 1] = t.y * w; xv[k + 2] = t.z * w; xv[k + 3] = t.w * w;
            }
#pragma unroll
            for (int m = 0; m < RN; ++m) {
              const float bv = Bt[(tx + 16 * m) * LD + j];
#pragma unroll
              for (int k = 0; k < RP; ++k) st[k][m] = fmaf(xv[k], bv, st[k][m]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = q0 + ty * 4 + ii;
        if (i < clen) {
          T* row = y + (c0 + i) * a.y_ss + tx * RP;
#pragma unroll
          for (int pp = 0; pp < RP; ++pp) store(row + pp, acc[ii][pp]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RP; ++k)
#pragma unroll
    for (int m = 0; m < RN; ++m)
      a.final_state[state_off + (ty * RP + k) * N + tx + 16 * m] = st[k][m];
}

template <typename T, int P, int N>
int launch(const Args& a, int BH, cudaStream_t s) {
  auto kernel = ssd_scan_kernel<T, P, N>;
  static bool attr_set = false;  // opt in once to more than 48 KB of shared memory
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Shape<P, N>::bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  kernel<<<BH, THREADS, Shape<P, N>::bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: chunks in parallel over a thread-block cluster, mma.sync products
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MMA_THREADS = 256;     // 8 warps
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int MAX_SMEM = 232448;     // a block's shared memory on Hopper
constexpr double LOG2E = 1.4426950408889634;

template <int P, int N>
struct MmaShape {
  static constexpr int LDX = P + 8;  // bf16 row stride of x: 16 bytes of pad, so the 8 rows
  static constexpr int LDB = N + 8;  // an ldmatrix reads fall in 8 bank groups; B and the
  static constexpr int LDS = N + 8;  // bf16 state likewise; f32 state (float2 stores)
  static constexpr size_t x_off = 0;                                             // [256][LDX] bf16
  static constexpr size_t b_off = x_off + sizeof(bf16) * MAX_CHUNK * LDX;        // [256][LDB] bf16
  static constexpr size_t st_off = b_off + sizeof(bf16) * MAX_CHUNK * LDB;       // [P][LDS] f32
  static constexpr size_t cums_off = st_off + sizeof(float) * P * LDS;           // [256] float2
  static constexpr size_t ecum_off = cums_off + sizeof(float2) * MAX_CHUNK;      // [256] f32
  static constexpr size_t wdec_off = ecum_off + sizeof(float) * MAX_CHUNK;       // [256] f32
  static constexpr size_t dq_off = wdec_off + sizeof(float) * MAX_CHUNK;         // [8] f32
  static constexpr size_t wsum_off = dq_off + sizeof(float) * MAX_CLUSTER;       // [8] f64
  static constexpr size_t bytes = wsum_off + sizeof(double) * MMA_THREADS / 32;
  static_assert(bytes <= MAX_SMEM, "a block must fit an SM");
  static_assert(2 * sizeof(bf16) * LDB <= sizeof(float) * LDS,
                "the entering state's bf16 hi and lo fit in its f32 rows");
  static_assert(b_off % 16 == 0 && st_off % 16 == 0 && cums_off % 16 == 0 && wsum_off % 8 == 0,
                "alignment");
};

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// 2^x, relative error ~2^-22 (PTX ex2.approx): for the scores, which are
// then split into bf16 hi + lo (~2^-17).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The f32 pair (v0, v1) as two bf16 pairs, hi = bf16(v) and lo = bf16(v - hi).
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// hi + lo = bf16 pair * (w.x, w.y), each rounded to bf16: the two bf16 terms
// of an f32 product.
__device__ __forceinline__ void split_scaled(uint32_t pair, float2 w, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(&pair);
  split_pair(__low2float(v2) * w.x, __high2float(v2) * w.y, hi, lo);
}

// One step of the intra-chunk term for a 16-row query tile: key blocks kb
// and, with TWO, kb + 1 (16 keys each). The scores C.B^T in accumulator
// fragments (four independent chains with TWO), the decay 2^(cl2_i - cl2_j)
// = exp(cums_i - cums_j) selected for j <= i, the fragment split into bf16
// hi + lo as the A fragments of y += scores . x (two products).
template <int KS, int NP, int LDB, int LDX, bool TWO>
__device__ __forceinline__ void intra_step(float (&yacc)[NP][4], const uint32_t (&cf)[KS][4],
                                           const bf16* bs, const bf16* xs, const float2* cl2,
                                           float2 ci_a, float2 ci_b, int kb, int ia, int ib,
                                           int lane, int t4) {
  constexpr int NK = TWO ? 2 : 1;
  float s[2 * NK][4];  // keys kb*16 + n*8..
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      uint32_t bk[4];  // B rows (keys) (kb+k)*16 + 0..7, 8..15 x columns kk*16..
      ldmatrix_x4(bk, bs + ((kb + k) * 16 + lane % 8 + (lane / 16) * 8) * LDB + kk * 16 +
                          ((lane / 8) % 2) * 8);
      mma_bf16(s[2 * k], cf[kk], bk[0], bk[1]);
      mma_bf16(s[2 * k + 1], cf[kk], bk[2], bk[3]);
    }
  }
  uint32_t pa[NK][4], pl[NK][4];  // the scores' bf16 hi and lo terms
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) {
    const int j0 = kb * 16 + n * 8 + 2 * t4;
    const float4 cj = *reinterpret_cast<const float4*>(cl2 + j0);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? ia : ib, j = j0 + e % 2;
      const float2 c_i = e < 2 ? ci_a : ci_b;
      const float hj = e % 2 ? cj.z : cj.x, lj = e % 2 ? cj.w : cj.y;
      v[e] = j <= i ? s[n][e] * ex2((c_i.x - hj) + (c_i.y - lj)) : 0.f;
    }
    split_pair(v[0], v[1], pa[n / 2][2 * (n % 2)], pl[n / 2][2 * (n % 2)]);
    split_pair(v[2], v[3], pa[n / 2][2 * (n % 2) + 1], pl[n / 2][2 * (n % 2) + 1]);
  }
#pragma unroll
  for (int n = 0; n < NP; n += 2) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      uint32_t bv[4];  // x's rows (keys) (kb+k)*16.. x columns n*8.., (n+1)*8..: .trans
      ldmatrix_x4_trans(bv, xs + ((kb + k) * 16 + lane % 16) * LDX + n * 8 + (lane / 16) * 8);
      mma_bf16(yacc[n], pa[k], bv[0], bv[1]);
      mma_bf16(yacc[n], pl[k], bv[0], bv[1]);
      mma_bf16(yacc[n + 1], pa[k], bv[2], bv[3]);
      mma_bf16(yacc[n + 1], pl[k], bv[2], bv[3]);
    }
  }
}

// One block per (b, h, rank); rank r of round k takes chunk k * n + r, where
// n is the cluster's size. Fragment indices: lane = 4 * g4 + t4 (see
// mma_bf16.cuh).
template <int P, int N>
__global__ void __launch_bounds__(MMA_THREADS, 1) ssd_mma_kernel(Args a) {
  using Sh = MmaShape<P, N>;
  constexpr int LDX = Sh::LDX, LDB = Sh::LDB, LDS = Sh::LDS;
  constexpr int KS = N / 16;               // k-steps over N: C.B^T and C.state^T
  constexpr int NP = P / 8;                // n-tiles over P: y
  constexpr int MT = P / 16;               // m-tiles over P: the chunk state's rows
  constexpr int NPW = (N / 8) * MT / 8;    // the chunk state's n-tiles per warp (phase A)
  constexpr int CV = P * N / (4 * MMA_THREADS);  // float4s of the state per thread
  static_assert(NPW >= 2 && NPW % 2 == 0 && CV >= 1, "shape");
  static_assert(MMA_THREADS == MAX_CHUNK, "a thread per row of the chunk");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + Sh::x_off);
  bf16* bs = reinterpret_cast<bf16*>(smem + Sh::b_off);
  float* st = reinterpret_cast<float*>(smem + Sh::st_off);  // [P][LDS]: S_c, then the entering state
  // [P][LDB] each: the entering state's bf16 hi and lo terms
  bf16* sb = reinterpret_cast<bf16*>(smem + Sh::st_off);
  bf16* sl = sb + P * LDB;
  // cums * log2(e) as an f32 pair hi + lo (hi = f32(v), lo = f32(v - hi)): the
  // difference of two rows, (hi_i - hi_j) + (lo_i - lo_j), is within an ulp
  // of the f64 difference rounded to f32, in f32 arithmetic
  float2* cl2 = reinterpret_cast<float2*>(smem + Sh::cums_off);
  float* ecum = reinterpret_cast<float*>(smem + Sh::ecum_off);  // exp(cums)
  float* wdec = reinterpret_cast<float*>(smem + Sh::wdec_off);  // exp(cums_last - cums)
  float* dq = reinterpret_cast<float*>(smem + Sh::dq_off);  // each rank's exp(cums_last), pushed
  double* wsum = reinterpret_cast<double*>(smem + Sh::wsum_off);  // each warp's sum of dA

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x / cs, b = bh / a.H, h = bh % a.H;
  const int S = a.S, chunk = a.chunk;
  const int cpad = (chunk + 15) / 16 * 16;  // rows the 16-row tiles cover
  const int nc = (S + chunk - 1) / chunk;
  const int rounds = (nc + cs - 1) / cs;
  const bf16* x = static_cast<const bf16*>(a.x) + b * a.x_sb + h * a.x_sh;
  const bf16* Bm = static_cast<const bf16*>(a.Bm) + b * a.bc_sb + h * a.bc_sh;
  const bf16* Cm = static_cast<const bf16*>(a.Cm) + b * a.bc_sb + h * a.bc_sh;
  bf16* y = static_cast<bf16*>(a.y) + b * a.y_sb + h * a.y_sh;
  const float* dA = a.dA + b * a.da_sb + h * a.da_sh;
  const long long state_off = static_cast<long long>(bh) * P * N;
  // the state rows this rank chains in the scan, float4s of them
  const int rows_per = (P + cs - 1) / cs;
  const int p_lo = min(P, rank * rows_per), p_hi = min(P, p_lo + rows_per);
  const int ngroups = (p_hi - p_lo) * (N / 4);
  // phase A: this warp's m-tile of the chunk state and its first n-tile
  const int mt = warp % MT, nb = (warp / MT) * NPW;
  // phase B: the warp's two 16-row query tiles, 15 - w and w (the same work
  // in every warp under the causal mask)
  const int qts[2] = {15 - warp, warp};

  // every block of the cluster has started once this phase completes (the
  // first write into another block's shared memory waits for it)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // C's A fragments of query tile qt (zero past clen), from device memory
  // straight into registers: only its own rows use them
  auto load_c = [&](uint32_t (&cf)[KS][4], int qt, int c0, int clen) {
    const int ia = qt * 16 + g4, ib = ia + 8;
    const bf16* ca = Cm + (c0 + ia) * a.bc_ss + 2 * t4;
    const bf16* cb = Cm + (c0 + ib) * a.bc_ss + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      cf[kk][0] = ia < clen ? ld_u32(ca + kk * 16) : 0u;
      cf[kk][1] = ib < clen ? ld_u32(cb + kk * 16) : 0u;
      cf[kk][2] = ia < clen ? ld_u32(ca + kk * 16 + 8) : 0u;
      cf[kk][3] = ib < clen ? ld_u32(cb + kk * 16 + 8) : 0u;
    }
  };

  for (int round = 0; round < rounds; ++round) {
    const int ci = round * cs + rank;
    const int n_act = min(cs, nc - round * cs);  // ranks with a chunk in this round
    const bool active = ci < nc;                 // (block-uniform)
    const int c0 = ci * chunk;
    const int clen = active ? min(chunk, S - c0) : 0;  // rows past clen are padding
    uint32_t cf[KS][4];  // C's A fragments of the query tile at hand
    float last = 0.f;    // the chunk's decay, exp(cums_last)

    if (active) {
      // dA of this thread's row (0 past clen), in flight while the copies are issued
      const float da_row = tid < clen ? dA[(c0 + tid) * a.da_ss] : 0.f;
      // -- x's and B's rows of the chunk by 16-byte cp.async, zero past clen --
      for (int e = tid; e < cpad * (P / 8); e += MMA_THREADS) {
        const int r = e / (P / 8), c = e % (P / 8);
        const bool ok = r < clen;
        cp_async16(xs + r * LDX + c * 8, ok ? x + (c0 + r) * a.x_ss + c * 8 : x, ok);
      }
      for (int e = tid; e < cpad * (N / 8); e += MMA_THREADS) {
        const int r = e / (N / 8), c = e % (N / 8);
        const bool ok = r < clen;
        cp_async16(bs + r * LDB + c * 8, ok ? Bm + (c0 + r) * a.bc_ss + c * 8 : Bm, ok);
      }
      cp_async_commit();
      // -- cums over the chunk in f64: a scan in each warp, then the warps' sums --
      double run = static_cast<double>(da_row);
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const double t = __shfl_up_sync(0xffffffffu, run, o);
        if (lane >= o) run += t;
      }
      if (lane == 31) wsum[warp] = run;
      __syncthreads();
      double total = 0.0;  // the sum over the chunk: dA is 0 past clen
#pragma unroll
      for (int w = 0; w < MMA_THREADS / 32; ++w) {
        if (w < warp) run += wsum[w];
        total += wsum[w];
      }
      last = expf(static_cast<float>(total));
      if (tid < cpad) {
        const double v = run * LOG2E;
        const float hi = static_cast<float>(v);
        cl2[tid] = make_float2(hi, static_cast<float>(v - hi));
        ecum[tid] = expf(static_cast<float>(run));
        wdec[tid] = expf(static_cast<float>(total - run));
      }
      cp_async_wait<0>();
      __syncthreads();

      // -- phase A: S_c = (x o wdec)^T . B, the operand split into bf16 hi + lo --
      float sacc[NPW][4];
#pragma unroll
      for (int n = 0; n < NPW; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
      for (int kk = 0; kk < cpad / 16; ++kk) {
        // A = x^T (rows p of m-tile mt, columns = keys kk*16..): .trans of x's rows
        uint32_t ax[4], lo[4];
        ldmatrix_x4_trans(ax, xs + (kk * 16 + (lane / 16) * 8 + lane % 8) * LDX + mt * 16 +
                                  ((lane / 8) % 2) * 8);
        const float2 w01 = *reinterpret_cast<const float2*>(wdec + kk * 16 + 2 * t4);
        const float2 w89 = *reinterpret_cast<const float2*>(wdec + kk * 16 + 2 * t4 + 8);
        split_scaled(ax[0], w01, ax[0], lo[0]);
        split_scaled(ax[1], w01, ax[1], lo[1]);
        split_scaled(ax[2], w89, ax[2], lo[2]);
        split_scaled(ax[3], w89, ax[3], lo[3]);
#pragma unroll
        for (int n = 0; n < NPW; n += 2) {
          uint32_t bb[4];  // B's rows kk*16.. (keys) x columns (nb + n)*8.., (nb + n + 1)*8..
          ldmatrix_x4_trans(bb, bs + (kk * 16 + lane % 16) * LDB + (nb + n) * 8 + (lane / 16) * 8);
          mma_bf16(sacc[n], ax, bb[0], bb[1]);
          mma_bf16(sacc[n], lo, bb[0], bb[1]);
          mma_bf16(sacc[n + 1], ax, bb[2], bb[3]);
          mma_bf16(sacc[n + 1], lo, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NPW; ++n) {
        const int p = mt * 16 + g4, col = (nb + n) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(st + p * LDS + col) = make_float2(sacc[n][0], sacc[n][1]);
        *reinterpret_cast<float2*>(st + (p + 8) * LDS + col) = make_float2(sacc[n][2], sacc[n][3]);
      }
      load_c(cf, qts[0], c0, clen);  // the first query tile's, in flight across the scan
    }
    if (round == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all started
    // the chunk's decay, into every rank's shared memory (for the scan)
    if (active && tid < cs) *cluster.map_shared_rank(dq + rank, tid) = last;

    // the state carried into this round, for this thread's first group of the scan
    const long long goff0 = state_off + (p_lo + tid / (N / 4)) * N + (tid % (N / 4)) * 4;
    float4 carry0 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < ngroups) {
      if (round > 0) carry0 = *reinterpret_cast<const float4*>(a.final_state + goff0);
      else if (a.init_state) carry0 = *reinterpret_cast<const float4*>(a.init_state + goff0);
    }
    cluster.sync();  // every active rank's S_c and decay are in place

    // -- the scan: rank s chains its rows of the state through the round's chunks --
    for (int gi = tid; gi < ngroups; gi += MMA_THREADS) {
      const int p = p_lo + gi / (N / 4), n = (gi % (N / 4)) * 4;
      const int off = p * LDS + n;
      const long long goff = state_off + p * N + n;
      float4 hc = carry0;
      if (gi != tid) {
        hc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (round > 0) hc = *reinterpret_cast<const float4*>(a.final_state + goff);
        else if (a.init_state) hc = *reinterpret_cast<const float4*>(a.init_state + goff);
      }
#pragma unroll
      for (int q0 = 0; q0 < MAX_CLUSTER; q0 += 4) {  // four ranks' values in flight at once
        if (q0 >= n_act) break;
        float4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q0 + q < n_act)
            v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(st, q0 + q) + off);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q0 + q < n_act) {
            // the state entering chunk q0 + q
            *reinterpret_cast<float4*>(cluster.map_shared_rank(st, q0 + q) + off) = hc;
            const float d = dq[q0 + q];
            hc = make_float4(fmaf(hc.x, d, v[q].x), fmaf(hc.y, d, v[q].y), fmaf(hc.z, d, v[q].z),
                             fmaf(hc.w, d, v[q].w));
          }
        }
      }
      *reinterpret_cast<float4*>(a.final_state + goff) = hc;  // after the round
    }
    cluster.sync();  // every entering state is written; no shared memory is read remotely after

    if (active) {
      // -- the entering state as bf16 hi + lo, over the f32 one (every value read first) --
      float4 sv[CV];
#pragma unroll
      for (int k = 0; k < CV; ++k) {
        const int e4 = tid + k * MMA_THREADS, p = e4 / (N / 4), n = (e4 % (N / 4)) * 4;
        sv[k] = *reinterpret_cast<const float4*>(st + p * LDS + n);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < CV; ++k) {
        const int e4 = tid + k * MMA_THREADS, p = e4 / (N / 4), n = (e4 % (N / 4)) * 4;
        uint2 hi, lo;
        split_pair(sv[k].x, sv[k].y, hi.x, lo.x);
        split_pair(sv[k].z, sv[k].w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(sb + p * LDB + n) = hi;
        *reinterpret_cast<uint2*>(sl + p * LDB + n) = lo;
      }
      __syncthreads();

      // -- phase B, each query tile: y = (C.B^T o L).x + (C.state^T) o exp(cums) --
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const int qt = qts[tt];
        if (qt * 16 >= clen) continue;
        if (tt > 0) load_c(cf, qt, c0, clen);
        const int ia = qt * 16 + g4, ib = ia + 8;
        float yacc[NP][4];
#pragma unroll
        for (int n = 0; n < NP; ++n) yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;
        // inter-chunk term first, C . state^T, scaled by exp(cums) per row
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int n = 0; n < NP; n += 2) {
            // state rows (p) n*8.. and (n+1)*8.. x columns kk*16.., hi and lo
            const int off = (n * 8 + lane % 8 + (lane / 16) * 8) * LDB + kk * 16 +
                            ((lane / 8) % 2) * 8;
            uint32_t bsf[4], bsl[4];
            ldmatrix_x4(bsf, sb + off);
            ldmatrix_x4(bsl, sl + off);
            mma_bf16(yacc[n], cf[kk], bsf[0], bsf[1]);
            mma_bf16(yacc[n], cf[kk], bsl[0], bsl[1]);
            mma_bf16(yacc[n + 1], cf[kk], bsf[2], bsf[3]);
            mma_bf16(yacc[n + 1], cf[kk], bsl[2], bsl[3]);
          }
        }
        const float ea = ecum[ia], eb = ecum[ib];
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          yacc[n][0] *= ea;
          yacc[n][1] *= ea;
          yacc[n][2] *= eb;
          yacc[n][3] *= eb;
        }
        // intra-chunk term, two 16-key blocks a step
        const float2 ci_a = cl2[ia], ci_b = cl2[ib];
        int kb = 0;
        for (; kb + 1 <= qt; kb += 2)
          intra_step<KS, NP, LDB, LDX, true>(yacc, cf, bs, xs, cl2, ci_a, ci_b, kb, ia, ib, lane, t4);
        if (kb == qt)
          intra_step<KS, NP, LDB, LDX, false>(yacc, cf, bs, xs, cl2, ci_a, ci_b, kb, ia, ib, lane, t4);
        // y rows < clen, bf16 pairs
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          if (ia < clen)
            *reinterpret_cast<uint32_t*>(y + (c0 + ia) * a.y_ss + n * 8 + 2 * t4) =
                pack_bf16(yacc[n][0], yacc[n][1]);
          if (ib < clen)
            *reinterpret_cast<uint32_t*>(y + (c0 + ib) * a.y_ss + n * 8 + 2 * t4) =
                pack_bf16(yacc[n][2], yacc[n][3]);
        }
      }
    }
    __syncthreads();  // x, B, the cums and the state are free for the next round
  }
}

template <int P, int N>
cudaLaunchConfig_t mma_config(int BH, int cluster, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * BH, 1, 1);
  cfg.blockDim = dim3(MMA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = MmaShape<P, N>::bytes;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int P, int N>
cudaError_t mma_attr() {
  static bool attr_set = false;  // opt in once to more than 48 KB of shared memory
  if (attr_set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(ssd_mma_kernel<P, N>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(MmaShape<P, N>::bytes));
  attr_set = err == cudaSuccess;
  return err;
}

template <int P, int N>
int launch_mma(const Args& a, int BH, int cluster, cudaStream_t s) {
  const cudaError_t set = mma_attr<P, N>();
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = mma_config<P, N>(BH, cluster, s, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ssd_mma_kernel<P, N>, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of `cluster` blocks the card holds at once
// (cudaOccupancyMaxActiveClusters), or -error.
template <int P, int N>
int mma_capacity(int cluster) {
  const cudaError_t set = mma_attr<P, N>();
  if (set != cudaSuccess) return -static_cast<int>(set);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = mma_config<P, N>(1, cluster, nullptr, attr);
  int clusters = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveClusters(&clusters, ssd_mma_kernel<P, N>, &cfg);
  return occ == cudaSuccess ? clusters : -static_cast<int>(occ);
}

// Calls F<P, N>::run(args...) for the (P, N) given at run time.
template <template <int, int> class F, typename... A>
int by_shape(int P, int N, A... args) {
#define REPRO_SSD_SHAPE(PP, NN) \
  if (P == PP && N == NN) return F<PP, NN>::run(args...);
  REPRO_SSD_SHAPE(64, 32) REPRO_SSD_SHAPE(64, 64) REPRO_SSD_SHAPE(64, 128)
  REPRO_SSD_SHAPE(128, 32) REPRO_SSD_SHAPE(128, 64) REPRO_SSD_SHAPE(128, 128)
#undef REPRO_SSD_SHAPE
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <int P, int N>
struct RunF32 {
  static int run(const Args& a, int BH, cudaStream_t s) { return launch<float, P, N>(a, BH, s); }
};
template <int P, int N>
struct RunMma {
  static int run(const Args& a, int BH, int cluster, cudaStream_t s) {
    return launch_mma<P, N>(a, BH, cluster, s);
  }
};
template <int P, int N>
struct SmemBytes {
  static int run(int dtype) {
    return static_cast<int>(dtype ? MmaShape<P, N>::bytes : Shape<P, N>::bytes);
  }
};
template <int P, int N>
struct Capacity {
  static int run(int cluster) { return mma_capacity<P, N>(cluster); }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y; dA and the states are
// f32). Strides are in elements; the innermost dimension of x, y (P) and
// B/C (N) has stride 1, and the states are contiguous (B, H, P, N). B and C
// share their strides; bc_sh may be 0. bf16 runs the cluster kernel with
// `cluster` blocks (1..8) per (b, h) and needs every base pointer and stride
// of x, B and C, and the states, 16-byte aligned; f32 ignores `cluster`.
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// shape it does not take (P not in {64, 128}, N not in {32, 64, 128}, chunk
// not in [1, 256], cluster not in [1, 8]).
extern "C" int repro_ssd_scan(const void* x, const float* dA, const void* Bm, const void* Cm,
                              void* y, const float* init_state, float* final_state, int B,
                              int H, int S, int P, int N, int chunk, long long x_sb,
                              long long x_ss, long long x_sh, long long y_sb, long long y_ss,
                              long long y_sh, long long da_sb, long long da_ss, long long da_sh,
                              long long bc_sb, long long bc_ss, long long bc_sh, int dtype,
                              int cluster, void* stream) {
  if (B < 1 || H < 1 || S < 1 || chunk < 1 || chunk > MAX_CHUNK || final_state == nullptr ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && (cluster < 1 || cluster > MAX_CLUSTER)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, dA, Bm, Cm, y, init_state, final_state, H, S, chunk,
               x_sb, x_ss, x_sh, y_sb, y_ss, y_sh, da_sb, da_ss, da_sh, bc_sb, bc_ss, bc_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0 ? by_shape<RunF32>(P, N, a, B * H, s)
                             : by_shape<RunMma>(P, N, a, B * H, cluster, s);
  return err < 0 ? -err : err;
}

// Dynamic shared memory of one block, or 0 for a shape it does not take.
extern "C" int repro_ssd_scan_smem_bytes(int P, int N, int dtype) {
  const int bytes = by_shape<SmemBytes>(P, N, dtype);
  return bytes < 0 ? 0 : bytes;
}

// Clusters of `cluster` blocks of the bf16 kernel the current card holds at
// once, or -error.
extern "C" int repro_ssd_scan_cluster_capacity(int P, int N, int cluster) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return -static_cast<int>(cudaErrorInvalidValue);
  return by_shape<Capacity>(P, N, cluster);
}
