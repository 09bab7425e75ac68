// Shared pieces of the cross-channel LRN kernels (lrn.cu, lrn_pool.cu).
//
// A thread walks the channels of one position, holding a window of
// 2D+1 channel values in registers as a shift register; every index is a
// compile-time constant, so the window never leaves the registers.  The
// arithmetic repeats the plain version's (ops/cuda_lrn.py) one rounding
// at a time: every product, sum and quotient is an explicitly rounded
// intrinsic, so no pair is contracted into an FMA.
//
// Each kernel takes float32 or bfloat16 tensors (its element type T).
// The window and every operation stay float32 either way: ld() widens an
// element as it is loaded (exact), st() narrows a result once, round to
// nearest even, as it is stored.  So a bf16 kernel equals the float32
// kernel on the widened input with its output narrowed, which is the
// TPU kernels' contract (pallas_lrn.py:65-77, pallas_plp.py:148-234:
// float32 math, the output in the input's dtype).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// the largest window reach max(pre, post) the kernels are built for:
// local_size up to 15
#define LRN_MAX_D 7

struct LrnParams {
  int pre, post;    // window reach below / above the centre channel
  float k;          // the normaliser's offset
  float alpha_n;    // alpha / n
  float coef;       // 2 alpha beta / n (backward)
  int q;            // 4 beta when an integer in 1..8, else 0
  float neg_beta;   // -beta (the powf path)
};

// push v in at the top, dropping r[0]
template <int M>
__device__ __forceinline__ void shift_in(float (&r)[M], float v) {
#pragma unroll
  for (int m = 0; m + 1 < M; ++m) r[m] = r[m + 1];
  r[M - 1] = v;
}

// element access: loads widen to float32, stores narrow from it
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// channel c of a position (zero outside [0, C), as the Pallas kernel pads)
template <typename T>
__device__ __forceinline__ float load_channel(const T* p, int c, int C,
                                              long long plane) {
  return (c >= 0 && c < C) ? ld(p + c * plane) : 0.f;
}

// the centred window sum of r (centre r[D]) in the Pallas order: centre,
// post side d = 1.., pre side d = 1.. (pallas_lrn.py:50-61)
template <int D>
__device__ __forceinline__ float window_sum(const float (&r)[2 * D + 1],
                                            const LrnParams& hp) {
  float acc = r[D];
#pragma unroll
  for (int d = 1; d <= D; ++d) {
    if (d <= hp.post) acc = __fadd_rn(acc, r[D + d]);
  }
#pragma unroll
  for (int d = 1; d <= D; ++d) {
    if (d <= hp.pre) acc = __fadd_rn(acc, r[D - d]);
  }
  return acc;
}

// s^-beta: the JAX package's _fast_negpow composition
__device__ __forceinline__ float negpow(float s, const LrnParams& hp) {
  int q = hp.q;
  if (q == 0) return powf(s, hp.neg_beta);
  float p = rsqrtf(__fsqrt_rn(s));
  float out = 0.f;
  bool have = false;
  while (q) {
    if (q & 1) {
      out = have ? __fmul_rn(out, p) : p;
      have = true;
    }
    q >>= 1;
    if (q) p = __fmul_rn(p, p);
  }
  return out;
}

// the backward's window term dy x p / scale
__device__ __forceinline__ float lrn_term(float dy, float x, float p,
                                          float scale) {
  return __fdiv_rn(__fmul_rn(__fmul_rn(dy, x), p), scale);
}

// dx = p dy - (2 alpha beta / n) x inner, with p dy formed when the term
// was (D channels before dx is written)
__device__ __forceinline__ float lrn_dx(float p_dy, float x, float inner,
                                        const LrnParams& hp) {
  return __fsub_rn(p_dy, __fmul_rn(__fmul_rn(hp.coef, x), inner));
}

// Caffe's default LRN (local_size 5, beta 0.75: pre = post = 2, q = 3)
// with its window and power fixed at compile time: a FAST kernel runs the
// same operations in the same order as window_sum and negpow, without
// negpow's runtime loop or window_sum's runtime reach.
template <int D, bool FAST>
__device__ __forceinline__ float window_sum_t(const float (&r)[2 * D + 1],
                                              const LrnParams& hp) {
  if constexpr (FAST) {
    float acc = r[D];
#pragma unroll
    for (int d = 1; d <= D; ++d) acc = __fadd_rn(acc, r[D + d]);
#pragma unroll
    for (int d = 1; d <= D; ++d) acc = __fadd_rn(acc, r[D - d]);
    return acc;
  } else {
    return window_sum<D>(r, hp);
  }
}

// scale = k + (alpha/n) S(x^2), from the squares of the window (each
// formed once, as its channel enters, where the kernel keeps them)
template <int D, bool FAST>
__device__ __forceinline__ float lrn_scale_sq_t(const float (&sq)[2 * D + 1],
                                                const LrnParams& hp) {
  return __fadd_rn(hp.k, __fmul_rn(hp.alpha_n, window_sum_t<D, FAST>(sq, hp)));
}

// the same from the x window, the squares formed here
template <int D, bool FAST = false>
__device__ __forceinline__ float lrn_scale(const float (&xr)[2 * D + 1],
                                           const LrnParams& hp) {
  float sq[2 * D + 1];
#pragma unroll
  for (int m = 0; m <= 2 * D; ++m) sq[m] = __fmul_rn(xr[m], xr[m]);
  return lrn_scale_sq_t<D, FAST>(sq, hp);
}

template <bool FAST>
__device__ __forceinline__ float negpow_t(float s, const LrnParams& hp) {
  if constexpr (FAST) {  // q = 3: r (r r), r = s^-1/4, as negpow forms it
    const float r = rsqrtf(__fsqrt_rn(s));
    return __fmul_rn(r, __fmul_rn(r, r));
  } else {
    return negpow(s, hp);
  }
}

// whether a launch takes the FAST kernel: its reach is the template's
// D = 2, the window centred, q = 3
__host__ __device__ __forceinline__ bool lrn_fast(int D, const LrnParams& hp) {
  return D == 2 && hp.pre == 2 && hp.post == 2 && hp.q == 3;
}
