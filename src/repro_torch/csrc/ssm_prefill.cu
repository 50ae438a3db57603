// ssm_prefill_in / ssm_prefill_out: the Mamba2 mixer's elementwise work
// around ssd_scan in serving's bulk prefill, written by hand for Hopper
// (sm_90a).
//
// They replace no TPU kernel: the reference leaves this chain to XLA, which
// fuses it. Run eagerly it is ~33 separate launches a layer over (B, S, .)
// tensors, many of them reading strided views of the conv output; these two
// kernels do the same arithmetic in two passes:
//
//   ssm_prefill_in_kernel, before the scan. Per batch row, time tile and
//   channel vector it reads the x, B and C projections where they lie (no
//   concatenation) and the conv cache as the K-1 rows before time 0 (no
//   window), then computes the width-K causal depthwise conv, + bias, SiLU;
//   on the x channels dt = softplus(dt_raw + dt_bias), xdt = xh * T(dt) and
//   dA = dt * A, A = -exp(A_log). It writes xh and xdt (B, S, H, P), dA
//   (B, S, H) f32, B and C (B, S, N) contiguous, and the new conv cache (the
//   last K-1 raw rows of cache ++ xBC) in place.
//   ssm_prefill_out_kernel, after it. One token row per block: y + xh * T(D),
//   times silu(z), then the RMSNorm over d_inner in f32 (the row's sum of
//   squares reduced on chip) times the norm's scale: the input of out_proj.
//
// Numerics: the plain composition's rounding points, in its order. T is the
// model dtype (bf16 or f32). Each conv product is rounded to T, the running
// sum starts at 0 + p0 (Python's sum) and is rounded after each add, then
// + bias and the SiLU are rounded; dt and dA stay f32, T(dt) and xdt are
// rounded; T(D), xh * T(D), y + xh * T(D), silu(z) and the product are
// rounded; the norm is f32 throughout, (x * rsqrt(var + eps)) * scale,
// rounded to T once, var the mean of the squares summed in the order of
// PyTorch's CUDA mean (norm_lanes). A product or sum of two T values that the plain path
// computes in f32 and rounds to T is computed here by T's own round-to-
// nearest instruction (mul.rn / add.rn .bf16x2, two lanes at once; __fmul_rn
// / __fadd_rn in f32). For bf16 operands the two agree bit for bit: the f32
// product of two bf16 values is exact, and an f32 sum is exact unless the
// smaller term is below 2^-15 of the larger, where both round to the larger.
// None of these is contracted into an FMA. The SiLU, softplus and norm run
// in f32 (IEEE expf/log1pf and division, rsqrtf as torch.rsqrt; no fast
// math). So both kernels give the plain composition's bits on the card.
//
// What bounds them: bytes. At mamba2-130m's serving prefill (B = 8,
// S = 8,192, d_inner = 1,536, N = 128, H = 24, bf16) the first moves the
// projections in (238 MB with dt) and xh, xdt, B, C and dA out (443 MB); the
// second reads y, xh and z and writes one row (805 MB): ~0.44 ms a layer at
// 3.35 TB/s, against ~12 GB of traffic for the eager chain.
//
// Design. In: a block covers TT time rows of one batch row and a run of
// channel vectors; each thread owns VEC channels (16 bytes: 8 bf16 or 4 f32)
// and walks its TT rows, keeping the conv's K-1 previous input rows in
// registers and loading the next row while it computes this one, so each
// input row is read once and the halo costs K-1 rows a tile. The block of
// tile 0 is the only reader of the old conv cache: its threads load their
// channels' old rows into registers before they write the new rows of the
// same channels, so the cache is updated in place without a race, for any S
// (S < K-1 keeps some old rows). A vector never straddles x, B and C
// (d_inner, N and P are multiples of VEC). Out: a thread per channel vector,
// its values in registers between the row's sum of squares and the scale;
// the squares go through shared memory to `lanes` threads that sum them as
// PyTorch's mean kernel does for a row (norm_lanes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int K = 4;              // conv width (every configuration's ssm_conv)
constexpr int TT = 64;            // time rows a block of ssm_prefill_in
constexpr int IN_THREADS = 256;   // most threads a block of ssm_prefill_in
constexpr int OUT_THREADS = 1024; // most threads a block of ssm_prefill_out: one a vector

// Two lanes of the model dtype and the arithmetic the plain path rounds to it.
template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  using Pair = float2;
  static __device__ __forceinline__ Pair mul(Pair a, Pair b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  static __device__ __forceinline__ Pair add(Pair a, Pair b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  static __device__ __forceinline__ float2 to_f2(Pair a) { return a; }
  static __device__ __forceinline__ Pair from_f2(float2 a) { return a; }
};

template <>
struct Lanes<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ Pair mul(Pair a, Pair b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d)
        : "r"(*reinterpret_cast<uint32_t*>(&a)), "r"(*reinterpret_cast<uint32_t*>(&b)));
    return *reinterpret_cast<Pair*>(&d);
  }
  static __device__ __forceinline__ Pair add(Pair a, Pair b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d)
        : "r"(*reinterpret_cast<uint32_t*>(&a)), "r"(*reinterpret_cast<uint32_t*>(&b)));
    return *reinterpret_cast<Pair*>(&d);
  }
  static __device__ __forceinline__ float2 to_f2(Pair a) { return __bfloat1622float2(a); }
  static __device__ __forceinline__ Pair from_f2(float2 a) {  // round to nearest even
    return __floats2bfloat162_rn(a.x, a.y);
  }
};

// VEC channels = 16 bytes = NP pairs
template <typename T>
struct alignas(16) Vec {
  using L = Lanes<T>;
  static constexpr int NP = 8 / sizeof(T);
  typename L::Pair p[NP];

  static __device__ __forceinline__ Vec load(const T* src) {
    Vec v;
    *reinterpret_cast<uint4*>(v.p) = *reinterpret_cast<const uint4*>(src);
    return v;
  }
  __device__ __forceinline__ void store(T* dst) const {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
  }
  // parameters may lie unaligned in a weight buffer: an element at a time
  static __device__ __forceinline__ Vec load_unaligned(const T* src) {
    Vec v;
    T* e = reinterpret_cast<T*>(v.p);
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) e[j] = src[j];
    return v;
  }
  static __device__ __forceinline__ Vec splat(float x) {
    Vec v;
#pragma unroll
    for (int j = 0; j < NP; ++j) v.p[j] = L::from_f2(make_float2(x, x));
    return v;
  }
};

template <typename T>
__device__ __forceinline__ Vec<T> vmul(const Vec<T>& a, const Vec<T>& b) {
  Vec<T> r;
#pragma unroll
  for (int j = 0; j < Vec<T>::NP; ++j) r.p[j] = Lanes<T>::mul(a.p[j], b.p[j]);
  return r;
}

template <typename T>
__device__ __forceinline__ Vec<T> vadd(const Vec<T>& a, const Vec<T>& b) {
  Vec<T> r;
#pragma unroll
  for (int j = 0; j < Vec<T>::NP; ++j) r.p[j] = Lanes<T>::add(a.p[j], b.p[j]);
  return r;
}

// PyTorch's silu: x / (1 + exp(-x)) in f32
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// T(silu(v)) lane by lane
template <typename T>
__device__ __forceinline__ Vec<T> vsilu(const Vec<T>& v) {
  Vec<T> r;
#pragma unroll
  for (int j = 0; j < Vec<T>::NP; ++j) {
    const float2 f = Lanes<T>::to_f2(v.p[j]);
    r.p[j] = Lanes<T>::from_f2(make_float2(silu(f.x), silu(f.y)));
  }
  return r;
}

// PyTorch's softplus at beta 1, threshold 20
__device__ __forceinline__ float softplus(float v) { return v > 20.0f ? v : log1pf(expf(v)); }

template <typename T>
struct InArgs {
  const T* x;         // (B, S, d_inner) by (x_sb, x_ss)
  const T* bm;        // (B, S, N) by (b_sb, b_ss)
  const T* cm;        // (B, S, N) by (c_sb, c_ss)
  const T* dt_raw;    // (B, S, H) by (dt_sb, dt_ss)
  T* conv;            // (B, K-1, C) by (cv_sb, cv_st): read, then rewritten
  const T* w;         // (K, C)
  const T* bias;      // (C,)
  const float* dt_bias, *a_log;  // (H,)
  T* xh, *xdt;        // (B, S, d_inner)
  float* dA;          // (B, S, H)
  T* bo, *co;         // (B, S, N)
  int S, d_inner, N, H, P;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, cv_sb, cv_st;
};

template <typename T>
__global__ void __launch_bounds__(IN_THREADS) ssm_prefill_in_kernel(const InArgs<T> a) {
  using V = Vec<T>;
  constexpr int VEC = 16 / sizeof(T);
  const int C = a.d_inner + 2 * a.N;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= C) return;
  const long long b = blockIdx.z;
  const int t0 = blockIdx.y * TT;
  const int t1 = min(t0 + TT, a.S);

  // the input that holds channels c0 .. c0 + VEC - 1, and its row stride
  const int seg = c0 < a.d_inner ? 0 : (c0 < a.d_inner + a.N ? 1 : 2);
  const T* src;
  long long ss;
  if (seg == 0) {
    src = a.x + b * a.x_sb + c0;
    ss = a.x_ss;
  } else if (seg == 1) {
    src = a.bm + b * a.b_sb + (c0 - a.d_inner);
    ss = a.b_ss;
  } else {
    src = a.cm + b * a.c_sb + (c0 - a.d_inner - a.N);
    ss = a.c_ss;
  }
  T* cache = a.conv + b * a.cv_sb + c0;
  // row r of cache ++ xBC, r counted from the first new token: r < 0 is cache row K-1+r
  auto row = [&](int r) {
    return r < 0 ? V::load(cache + (K - 1 + r) * a.cv_st) : V::load(src + r * ss);
  };

  V w[K];
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = V::load_unaligned(a.w + i * C + c0);
  const V bias = V::load_unaligned(a.bias + c0), zero = V::splat(0.0f);
  V hist[K - 1];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) hist[i] = row(t0 - (K - 1) + i);

  if (blockIdx.y == 0) {
    // tile 0 holds every old cache row of its channels (hist), so it writes
    // the new ones: row j of the new cache is row S + j - (K-1) of cache ++ xBC
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      const int r = a.S + j - (K - 1);
      V v = zero;
      if (r >= 0) v = V::load(src + r * ss);
#pragma unroll
      for (int m = 0; m < K - 1; ++m)  // hist[K-1+r], indexed statically (registers)
        if (m == K - 1 + r) v = hist[m];
      v.store(cache + j * a.cv_st);
    }
  }

  int h = 0;
  float A = 0.0f, dtb = 0.0f;
  if (seg == 0) {
    h = c0 / a.P;
    A = -expf(a.a_log[h]);
    dtb = a.dt_bias[h];
  }
  const bool writes_dA = seg == 0 && c0 % a.P == 0;
  const T* dt_src = a.dt_raw + b * a.dt_sb + h;
  V cur = row(t0);
  T dt_cur = dt_src[t0 * a.dt_ss];
  for (int t = t0; t < t1; ++t) {
    // the next row's loads go out before this row's arithmetic
    const int tn = min(t + 1, t1 - 1);
    const V nxt = row(tn);
    const T dt_nxt = seg == 0 ? dt_src[tn * a.dt_ss] : dt_cur;

    V acc = vadd(zero, vmul(hist[0], w[0]));
#pragma unroll
    for (int i = 1; i < K - 1; ++i) acc = vadd(acc, vmul(hist[i], w[i]));
    acc = vadd(acc, vmul(cur, w[K - 1]));
    const V out = vsilu(vadd(acc, bias));
#pragma unroll
    for (int i = 0; i < K - 2; ++i) hist[i] = hist[i + 1];
    hist[K - 2] = cur;

    const long long tok = b * a.S + t;
    if (seg == 0) {
      const float dt = softplus(__fadd_rn(static_cast<float>(dt_cur), dtb));
      out.store(a.xh + tok * a.d_inner + c0);
      vmul(out, V::splat(dt)).store(a.xdt + tok * a.d_inner + c0);
      if (writes_dA) a.dA[tok * a.H + h] = __fmul_rn(dt, A);
    } else {
      out.store(seg == 1 ? a.bo + tok * a.N + (c0 - a.d_inner)
                         : a.co + tok * a.N + (c0 - a.d_inner - a.N));
    }
    cur = nxt;
    dt_cur = dt_nxt;
  }
}

template <typename T>
struct OutArgs {
  const T* y, *xh, *z;  // (B, S, d_inner) by their (sb, ss)
  const float* D;       // (H,)
  const T* scale;       // (d_inner,)
  T* out;               // (B, S, d_inner)
  int S, d_inner, P;
  long long y_sb, y_ss, xh_sb, xh_ss, z_sb, z_ss;
  float eps;
  float factor;         // the mean's 1/d_inner, as PyTorch computes it
  int lanes;            // norm_lanes(B * S, d_inner)
};

// How PyTorch's CUDA mean over the last dim of a contiguous (rows, d) f32
// tensor sums a row (ATen's Reduce.cuh, setReduceConfig and ReduceOp, where
// it loads 4 floats at a time): `lanes` threads, lane l adding the 4-float
// chunks l, l + lanes, ... into 4 running sums, which it adds as
// ((s0 + s1) + s2) + s3; then lane l < o adds lane l + o's value for
// o = lanes/2, ..., 32 (shared memory) and o = 16, ..., 1 (shuffles); the sum
// times float(rows) / float(rows * d). `lanes` is the block width ATen picks
// from rows and d. Returns 0 where ATen would also split a row across warps
// (more than ~8,000 values) or not load 4 at a time (d < 256 taken to be
// such), orders this kernel does not follow.
int norm_lanes(long long rows, int d) {
  if (d < 256 || d % 4 != 0 || rows < 1) return 0;
  auto last_pow2 = [](long long n) {
    long long p = 1;
    while (p * 2 <= n) p *= 2;
    return static_cast<int>(p);
  };
  const int most = 512;
  const int dim0 = d / 4 < most ? last_pow2(d / 4) : most;
  const int dim1 = rows < most ? last_pow2(rows) : most;
  int width = dim0 < 32 ? dim0 : 32;
  const int height = dim1 < most / width ? dim1 : most / width;
  width = dim0 < most / height ? dim0 : most / height;
  const int per_thread = (d + width - 1) / width;
  const int split_at = height * 16 < 256 ? height * 16 : 256;
  return per_thread < split_at ? width : 0;
}

template <typename T>
__global__ void __launch_bounds__(OUT_THREADS) ssm_prefill_out_kernel(const OutArgs<T> a) {
  using V = Vec<T>;
  using L = Lanes<T>;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float4 smem[];
  float* sq = reinterpret_cast<float*>(smem);  // the row's squares (d_inner)
  float* part = sq + a.d_inner;                 // a value a lane, then 1/rms
  const long long tok = blockIdx.x;
  const long long b = tok / a.S, t = tok % a.S;
  const int c0 = threadIdx.x * VEC;
  const bool mine = c0 < a.d_inner;
  const int lane = threadIdx.x;

  V m;
  if (mine) {
    const V y = V::load(a.y + b * a.y_sb + t * a.y_ss + c0);
    const V xh = V::load(a.xh + b * a.xh_sb + t * a.xh_ss + c0);
    const V z = V::load(a.z + b * a.z_sb + t * a.z_ss + c0);
    m = vmul(vadd(y, vmul(xh, V::splat(a.D[c0 / a.P]))), vsilu(z));
#pragma unroll
    for (int j = 0; j < V::NP; ++j) {
      const float2 f = L::to_f2(m.p[j]);
      sq[c0 + 2 * j] = __fmul_rn(f.x, f.x);
      sq[c0 + 2 * j + 1] = __fmul_rn(f.y, f.y);
    }
  }
  __syncthreads();
  float v = 0.0f;
  if (lane < a.lanes) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int c = lane; 4 * c + 3 < a.d_inner; c += a.lanes) {
      const float4 q = smem[c];
      s0 = __fadd_rn(s0, q.x);
      s1 = __fadd_rn(s1, q.y);
      s2 = __fadd_rn(s2, q.z);
      s3 = __fadd_rn(s3, q.w);
    }
    v = __fadd_rn(__fadd_rn(__fadd_rn(s0, s1), s2), s3);
    part[lane] = v;
  }
  for (int o = a.lanes / 2; o >= 32; o >>= 1) {
    __syncthreads();
    if (lane < o) {
      v = __fadd_rn(v, part[lane + o]);
      part[lane] = v;
    }
  }
  if (lane < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  if (lane == 0) part[0] = rsqrtf(__fadd_rn(__fmul_rn(v, a.factor), a.eps));
  __syncthreads();
  if (!mine) return;
  const float r = part[0];

  const T* scale = a.scale + c0;  // may lie unaligned in a weight buffer
  V o;
#pragma unroll
  for (int j = 0; j < V::NP; ++j) {
    const float2 f = L::to_f2(m.p[j]);
    o.p[j] = L::from_f2(make_float2(
        __fmul_rn(__fmul_rn(f.x, r), static_cast<float>(scale[2 * j])),
        __fmul_rn(__fmul_rn(f.y, r), static_cast<float>(scale[2 * j + 1]))));
  }
  o.store(a.out + tok * a.d_inner + c0);
}

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// threads of one block over n units, at most `most`, a multiple of 32, so that
// the blocks over n are as even as they can be
int even_threads(int n, int most) {
  const int blocks = ceil_div(n, most);
  return ceil_div(ceil_div(n, blocks), 32) * 32;
}

template <typename T>
int launch_in(const InArgs<T>& a, int B, cudaStream_t s) {
  const int nvec = (a.d_inner + 2 * a.N) / (16 / sizeof(T));
  const int threads = even_threads(nvec, IN_THREADS);
  const dim3 grid(ceil_div(nvec, threads), ceil_div(a.S, TT), B);
  ssm_prefill_in_kernel<T><<<grid, threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// threads of an ssm_prefill_out block: one a vector, at least norm_lanes; 0
// where that is more than a block holds or norm_lanes takes no such rows
template <typename T>
int out_threads(long long rows, int d_inner) {
  const int lanes = norm_lanes(rows, d_inner);
  const int vec = ceil_div(d_inner / (16 / sizeof(T)), 32) * 32;
  const int threads = vec > lanes ? vec : lanes;
  return lanes == 0 || threads > OUT_THREADS ? 0 : threads;
}

template <typename T>
int launch_out(OutArgs<T> a, int B, cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * a.S;
  const int threads = out_threads<T>(rows, a.d_inner);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  a.lanes = norm_lanes(rows, a.d_inner);
  a.factor = static_cast<float>(rows) / (rows * a.d_inner);  // as ATen's mean computes it
  const size_t smem = (static_cast<size_t>(a.d_inner) + a.lanes) * sizeof(float);
  ssm_prefill_out_kernel<T><<<static_cast<unsigned>(rows), threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool vectors_fit(int d_inner, int N, int P) {
  constexpr int VEC = 16 / sizeof(T);
  return d_inner % VEC == 0 && N % VEC == 0 && P % VEC == 0;
}

}  // namespace

// The conv width the kernels are built for.
extern "C" int repro_ssm_prefill_conv_width() { return K; }

// 1 if ssm_prefill_out takes `rows` (B * S) token rows of d_inner in dtype (0
// f32, 1 bf16): one block a row, at most OUT_THREADS vectors, summed in
// PyTorch's order (norm_lanes); else 0.
extern "C" int repro_ssm_prefill_out_takes(long long rows, int d_inner, int dtype) {
  return (dtype == 1 ? out_threads<__nv_bfloat16>(rows, d_inner)
                     : out_threads<float>(rows, d_inner)) > 0;
}

// dtype 0 is f32, 1 bf16. d_inner, N and head_dim are multiples of one 16-byte
// vector, and every activation's base pointer and outer strides multiples of
// 16 bytes. Strides (elements): x (b, s), B (b, s), C (b, s), dt_raw (b, s),
// conv cache (b, row). Returns cudaGetLastError().
extern "C" int repro_ssm_prefill_in(const void* x, const void* bm, const void* cm,
                                    const void* dt_raw, void* conv, const void* w,
                                    const void* bias, const float* dt_bias, const float* a_log,
                                    void* xh, void* xdt, float* dA, void* bo, void* co, int B,
                                    int S, int d_inner, int N, int H, int P, long long x_sb,
                                    long long x_ss, long long b_sb, long long b_ss,
                                    long long c_sb, long long c_ss, long long dt_sb,
                                    long long dt_ss, long long cv_sb, long long cv_st, int dtype,
                                    void* stream) {
  if (B < 1 || S < 1 || N < 1 || H < 1 || P < 1 || d_inner != H * P || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (!vectors_fit<T>(d_inner, N, P)) return static_cast<int>(cudaErrorInvalidValue);
    const InArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(bm),
                      static_cast<const T*>(cm), static_cast<const T*>(dt_raw),
                      static_cast<T*>(conv), static_cast<const T*>(w),
                      static_cast<const T*>(bias), dt_bias, a_log, static_cast<T*>(xh),
                      static_cast<T*>(xdt), dA, static_cast<T*>(bo), static_cast<T*>(co),
                      S, d_inner, N, H, P,
                      x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, cv_sb, cv_st};
    return launch_in(a, B, s);
  }
  using T = float;
  if (!vectors_fit<T>(d_inner, N, P)) return static_cast<int>(cudaErrorInvalidValue);
  const InArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(bm),
                    static_cast<const T*>(cm), static_cast<const T*>(dt_raw),
                    static_cast<T*>(conv), static_cast<const T*>(w),
                    static_cast<const T*>(bias), dt_bias, a_log, static_cast<T*>(xh),
                    static_cast<T*>(xdt), dA, static_cast<T*>(bo), static_cast<T*>(co),
                    S, d_inner, N, H, P,
                    x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, cv_sb, cv_st};
  return launch_in(a, B, s);
}

// Strides (elements): y, xh, z (b, s) each; a row of d_inner is contiguous.
// Returns cudaGetLastError().
extern "C" int repro_ssm_prefill_out(const void* y, const void* xh, const void* z, const float* D,
                                     const void* scale, void* out, int B, int S, int d_inner,
                                     int P, long long y_sb, long long y_ss, long long xh_sb,
                                     long long xh_ss, long long z_sb, long long z_ss, float eps,
                                     int dtype, void* stream) {
  if (B < 1 || S < 1 || d_inner < 1 || P < 1 || d_inner % P != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (!vectors_fit<T>(d_inner, 8, P)) return static_cast<int>(cudaErrorInvalidValue);
    const OutArgs<T> a{static_cast<const T*>(y), static_cast<const T*>(xh),
                       static_cast<const T*>(z), D, static_cast<const T*>(scale),
                       static_cast<T*>(out), S, d_inner, P,
                       y_sb, y_ss, xh_sb, xh_ss, z_sb, z_ss, eps, 0.0f, 0};
    return launch_out(a, B, s);
  }
  using T = float;
  if (!vectors_fit<T>(d_inner, 4, P)) return static_cast<int>(cudaErrorInvalidValue);
  const OutArgs<T> a{static_cast<const T*>(y), static_cast<const T*>(xh),
                     static_cast<const T*>(z), D, static_cast<const T*>(scale),
                     static_cast<T*>(out), S, d_inner, P,
                     y_sb, y_ss, xh_sb, xh_ss, z_sb, z_ss, eps, 0.0f, 0};
  return launch_out(a, B, s);
}
