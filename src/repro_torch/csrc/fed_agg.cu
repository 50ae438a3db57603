// fed_agg / fed_opt: the federation loop's two aggregation kernels, written
// by hand for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of src/repro/kernels/fed_agg/kernel.py:
//   fed_agg_kernel  <- fed_agg  (_fed_agg_kernel, _fed_agg_acc_kernel)
//   fed_opt_kernel  <- fed_opt  (_fed_opt_kernel, _fed_opt_apply_kernel, _opt_step)
//
// What bounds them: both are a weighted sum over K client rows (K = 2 to a few
// hundred) of an N-wide f32 stack, about 2K flops for every 4(K+1) bytes, far
// below the card's ridge point. They are bound by device-memory bandwidth:
//   fed_agg moves (K+1)*N*4 bytes (the stack read once, the sum written once);
//   fed_opt moves (K+6)*N*4 bytes (the stack, x/m/v read, x'/m'/v' written).
// For ResNet-18 (N = 11,176,970) at K = 4 on an H100 SXM at 3.35 TB/s that is
// ~67 us for fed_agg and ~133 us for fed_opt.
//
// Design: one coalesced pass over the stack. Each thread owns VEC consecutive
// columns and loops over all K rows, accumulating in f32 registers, then
// writes its columns once. The loop inside the thread takes the place of the
// TPU kernel's sequential k grid axis: no reduction crosses blocks, so the
// result does not depend on launch order, and one kernel serves every K (there
// is no separate wide-fleet route). The weights are staged in shared memory in
// chunks of KCHUNK rows.
//
// VEC = 4 reads each row as float4. That needs a row stride `ld` that is a
// multiple of 4 elements and 16-byte aligned pointers (the wrapper checks
// both; the strategies pad their stack's rows for it). Otherwise VEC = 1:
// scalar loads, still coalesced across the warp. In both, the ragged tail
// past N is masked.
//
// Built without --use_fast_math: sqrtf and the division are IEEE-rounded.
// Outputs are separate buffers from the inputs (the wrapper allocates them).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int KCHUNK = 256;

enum Variant { ADAM = 0, YOGI = 1, ADAGRAD = 2 };

struct OptParams {
  float lr, b1, one_minus_b1, b2, one_minus_b2, tau;
};

// acc[j] = sum_k w[k] * x[k * ld + n + j] for the thread's columns n + j < N.
// Every thread of the block must call this (it holds __syncthreads).
template <int VEC>
__device__ __forceinline__ void weighted_sum(const float* __restrict__ x, long long ld,
                                             const float* __restrict__ w, int K,
                                             long long n, long long N, float* w_s,
                                             float (&acc)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const bool full = n + VEC <= N;
  for (int k0 = 0; k0 < K; k0 += KCHUNK) {
    const int kc = min(KCHUNK, K - k0);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = threadIdx.x; i < kc; i += blockDim.x) w_s[i] = w[k0 + i];
    __syncthreads();
    const float* row = x + static_cast<long long>(k0) * ld + n;
    if (full) {
#pragma unroll 4
      for (int k = 0; k < kc; ++k, row += ld) {
        const float wk = w_s[k];
        if constexpr (VEC == 4) {
          const float4 v = *reinterpret_cast<const float4*>(row);
          acc[0] = fmaf(wk, v.x, acc[0]);
          acc[1] = fmaf(wk, v.y, acc[1]);
          acc[2] = fmaf(wk, v.z, acc[2]);
          acc[3] = fmaf(wk, v.w, acc[3]);
        } else {
          acc[0] = fmaf(wk, row[0], acc[0]);
        }
      }
    } else if (n < N) {  // ragged tail: masked scalar loads
      for (int k = 0; k < kc; ++k, row += ld) {
        const float wk = w_s[k];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (n + j < N) acc[j] = fmaf(wk, row[j], acc[j]);
      }
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ a, long long n, long long N,
                                         float (&out)[VEC]) {
  if constexpr (VEC == 4) {
    if (n + 4 <= N) {
      const float4 v = *reinterpret_cast<const float4*>(a + n);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = (n + j < N) ? a[n + j] : 0.f;
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ a, long long n, long long N,
                                          const float (&val)[VEC]) {
  if constexpr (VEC == 4) {
    if (n + 4 <= N) {
      *reinterpret_cast<float4*>(a + n) = make_float4(val[0], val[1], val[2], val[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (n + j < N) a[n + j] = val[j];
}

// The reference's _opt_step: pseudo-gradient, moments, server step.
template <int VARIANT>
__device__ __forceinline__ void opt_step(float avg, float& p, float& m, float& v,
                                         const OptParams& hp) {
  const float d = p - avg;
  m = hp.b1 * m + hp.one_minus_b1 * d;
  const float d2 = d * d;
  if constexpr (VARIANT == ADAM) {
    v = hp.b2 * v + hp.one_minus_b2 * d2;
  } else if constexpr (VARIANT == YOGI) {
    const float t = v - d2;
    // jnp.sign: 0 at 0 (copysignf would give +-1), NaN stays NaN
    const float s = t > 0.f ? 1.f : (t < 0.f ? -1.f : t);
    v = v - hp.one_minus_b2 * d2 * s;
  } else {
    v = v + d2;
  }
  p = p - hp.lr * m / (sqrtf(v) + hp.tau);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
fed_agg_kernel(const float* __restrict__ x, long long ld, const float* __restrict__ w,
               float* __restrict__ out, int K, long long N) {
  __shared__ float w_s[KCHUNK];
  const long long n = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  float acc[VEC];
  weighted_sum<VEC>(x, ld, w, K, n, N, w_s, acc);
  store_vec<VEC>(out, n, N, acc);
}

template <int VEC, int VARIANT>
__global__ void __launch_bounds__(THREADS)
fed_opt_kernel(const float* __restrict__ x, long long ld, const float* __restrict__ w,
               const float* __restrict__ p_in, const float* __restrict__ m_in,
               const float* __restrict__ v_in, float* __restrict__ p_out,
               float* __restrict__ m_out, float* __restrict__ v_out, int K, long long N,
               OptParams hp) {
  __shared__ float w_s[KCHUNK];
  const long long n = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  float avg[VEC], p[VEC], m[VEC], v[VEC];
  weighted_sum<VEC>(x, ld, w, K, n, N, w_s, avg);
  if (n >= N) return;
  load_vec<VEC>(p_in, n, N, p);
  load_vec<VEC>(m_in, n, N, m);
  load_vec<VEC>(v_in, n, N, v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) opt_step<VARIANT>(avg[j], p[j], m[j], v[j], hp);
  store_vec<VEC>(p_out, n, N, p);
  store_vec<VEC>(m_out, n, N, m);
  store_vec<VEC>(v_out, n, N, v);
}

unsigned int num_blocks(long long N, int vec) {
  const long long per_block = static_cast<long long>(THREADS) * vec;
  return static_cast<unsigned int>((N + per_block - 1) / per_block);
}

template <int VEC>
void launch_fed_opt(int variant, unsigned int blocks, cudaStream_t s, const float* x,
                    long long ld, const float* w, const float* p, const float* m,
                    const float* v, float* po, float* mo, float* vo, int K, long long N,
                    const OptParams& hp) {
  if (variant == ADAM)
    fed_opt_kernel<VEC, ADAM><<<blocks, THREADS, 0, s>>>(x, ld, w, p, m, v, po, mo, vo, K, N, hp);
  else if (variant == YOGI)
    fed_opt_kernel<VEC, YOGI><<<blocks, THREADS, 0, s>>>(x, ld, w, p, m, v, po, mo, vo, K, N, hp);
  else
    fed_opt_kernel<VEC, ADAGRAD><<<blocks, THREADS, 0, s>>>(x, ld, w, p, m, v, po, mo, vo, K, N, hp);
}

}  // namespace

// out[n] = sum_k w[k] * x[k * ld + n], n < N. Returns cudaGetLastError().
extern "C" int repro_fed_agg(const float* x, long long ld, const float* w, float* out, int K,
                             long long N, int vec, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    fed_agg_kernel<4><<<num_blocks(N, 4), THREADS, 0, s>>>(x, ld, w, out, K, N);
  else
    fed_agg_kernel<1><<<num_blocks(N, 1), THREADS, 0, s>>>(x, ld, w, out, K, N);
  return static_cast<int>(cudaGetLastError());
}

// The fused FedAdam (variant 0) / FedYogi (1) / FedAdagrad (2) step:
// avg = w^T x; (p', m', v') = _opt_step(avg, p, m, v). Returns cudaGetLastError().
extern "C" int repro_fed_opt(const float* x, long long ld, const float* w, const float* p,
                             const float* m, const float* v, float* p_out, float* m_out,
                             float* v_out, int K, long long N, int variant, float lr,
                             float b1, float one_minus_b1, float b2, float one_minus_b2,
                             float tau, int vec, void* stream) {
  if (N <= 0) return 0;
  if (variant < ADAM || variant > ADAGRAD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 1 - b arrives computed by the caller in double precision, as the
  // reference's (1.0 - b1) is, and rounded once to f32
  const OptParams hp{lr, b1, one_minus_b1, b2, one_minus_b2, tau};
  if (vec == 4)
    launch_fed_opt<4>(variant, num_blocks(N, 4), s, x, ld, w, p, m, v, p_out, m_out, v_out, K, N, hp);
  else
    launch_fed_opt<1>(variant, num_blocks(N, 1), s, x, ld, w, p, m, v, p_out, m_out, v_out, K, N, hp);
  return static_cast<int>(cudaGetLastError());
}
