// Shared pieces of the cross-channel LRN kernels (lrn.cu, lrn_pool.cu).
//
// A thread walks the channels of one position, holding a window of
// 2D+1 channel values in registers as a shift register; every index is a
// compile-time constant, so the window never leaves the registers.  The
// arithmetic repeats the plain version's (ops/cuda_lrn.py) one rounding
// at a time: every product, sum and quotient is an explicitly rounded
// intrinsic, so no pair is contracted into an FMA.

#pragma once

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

// channel c of a position (zero outside [0, C), as the Pallas kernel pads)
__device__ __forceinline__ float load_channel(const float* p, int c, int C,
                                              long long plane) {
  return (c >= 0 && c < C) ? __ldg(p + c * plane) : 0.f;
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

// scale = k + (alpha/n) S(x^2), the squares formed from the x window
template <int D>
__device__ __forceinline__ float lrn_scale(const float (&xr)[2 * D + 1],
                                           const LrnParams& hp) {
  float sq[2 * D + 1];
#pragma unroll
  for (int m = 0; m <= 2 * D; ++m) sq[m] = __fmul_rn(xr[m], xr[m]);
  return __fadd_rn(hp.k, __fmul_rn(hp.alpha_n, window_sum<D>(sq, hp)));
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

// dx = p dy - (2 alpha beta / n) x inner
__device__ __forceinline__ float lrn_dx(float p, float dy, float x,
                                        float inner, const LrnParams& hp) {
  return __fsub_rn(__fmul_rn(p, dy), __fmul_rn(__fmul_rn(hp.coef, x), inner));
}
