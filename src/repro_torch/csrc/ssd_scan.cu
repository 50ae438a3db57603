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
// in place): each block reads its own slice before it writes it.
//
// Layout: x/y (B, S, H, P) and dA (B, S, H) by element strides; B/C
// (B, S, [H,] N) by strides with a head stride that may be 0, so the (B, S, N)
// matrices that every head shares are read in place, never broadcast into
// memory. x, B, C and y are f32 or bf16 (one dtype); dA and the state f32;
// every product accumulates in f32 with IEEE expf (no fast math).
//
// Precision: the decays are exponents of differences of the running sum,
// cums_i - cums_j. At the model's dA (A down to -24, dt ~ 1) cums reaches
// ~-5000 within a chunk, where one f32 step is ~5e-4: a running sum kept in
// f32, as the reference keeps it, puts errors of that size into exponents
// whose true value is small, and so ~1e-3 into y. The kernel keeps cums (256
// values a chunk) in f64 and rounds each difference to f32 only before expf,
// so the f32 products are what is left of the error.
//
// What bounds it: at mamba2-130m's serving prefill (B = 8, S = 2048, H = 24,
// P = 64, N = 128, c = 256, bf16) the call moves 123 MB (x and y dominate;
// the state read and written once) and does 32 GFLOP under the causal mask:
// on the tensor cores both bounds are ~0.035 ms. This first version does its products on the f32 FMA units
// (67 TFLOP/s at most), so it is bound by operations, far above that bound.
//
// Design (simple first): one block of 256 threads per (b, h), walking the
// chunks in order (the loop takes the place of the TPU grid's sequential
// chunk axis). A chunk is cut into 64-row tiles and never builds its c x c
// matrix whole: for each query tile, C^T sits in shared memory; the inter-
// chunk term C.state^T comes first, then for each key tile j <= i the
// scores (C.B^T, 64 x 64) are formed with the decay selected (not multiplied:
// exp(cums_i - cums_j) overflows for j > i), stored transposed, and applied
// to x. Each thread owns a 4 x 4 (scores) or 4 x P/16 (y) register tile.
// The carried state lives in registers (each thread a P/16 x N/16 tile) and
// is copied to shared memory at each chunk start for the inter-chunk term;
// its update rides on the last query tile's pass, which loads every key
// tile of the chunk anyway.
//
// Known limits, left for a later PR: no tensor cores (mma/wgmma), one block
// per SM (139 KB of shared memory at P = 64, N = 128), and B*H blocks only:
// 192 at the serving shape, 1.45 waves on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 64;            // query rows per tile
constexpr int TK = 64;            // key rows per tile
constexpr int LD = TQ + 4;        // padded row of a transposed tile (float4-aligned)
constexpr int MAX_CHUNK = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <typename T, int P>
int dispatch_n(const Args& a, int BH, int N, cudaStream_t s) {
  switch (N) {
    case 32: return launch<T, P, 32>(a, BH, s);
    case 64: return launch<T, P, 64>(a, BH, s);
    case 128: return launch<T, P, 128>(a, BH, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const Args& a, int BH, int P, int N, cudaStream_t s) {
  switch (P) {
    case 64: return dispatch_n<T, 64>(a, BH, N, s);
    case 128: return dispatch_n<T, 128>(a, BH, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y; dA and the states are
// f32). Strides are in elements; the innermost dimension of x, y (P) and
// B/C (N) has stride 1, and the states are contiguous (B, H, P, N). B and C
// share their strides; bc_sh may be 0. Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a shape it does not take (P not in
// {64, 128}, N not in {32, 64, 128}, chunk not in [1, 256]).
extern "C" int repro_ssd_scan(const void* x, const float* dA, const void* Bm, const void* Cm,
                              void* y, const float* init_state, float* final_state, int B,
                              int H, int S, int P, int N, int chunk, long long x_sb,
                              long long x_ss, long long x_sh, long long y_sb, long long y_ss,
                              long long y_sh, long long da_sb, long long da_ss, long long da_sh,
                              long long bc_sb, long long bc_ss, long long bc_sh, int dtype,
                              void* stream) {
  if (B < 1 || H < 1 || S < 1 || chunk < 1 || chunk > MAX_CHUNK || final_state == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, dA, Bm, Cm, y, init_state, final_state, H, S, chunk,
               x_sb, x_ss, x_sh, y_sb, y_ss, y_sh, da_sb, da_ss, da_sh, bc_sb, bc_ss, bc_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B * H, P, N, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B * H, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
