// Cross-channel LRN (Caffe ACROSS_CHANNELS), float32, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of sparknet_tpu/ops/pallas_lrn.py
// (pallas_call at :89 in _call):
//   sparknet_lrn_fwd_f32 <- _fwd_kernel (:64)
//   sparknet_lrn_bwd_f32 <- _bwd_kernel (:70)
// With S the centred window sum over channels (Caffe's pre-pad
// pre = (n-1)/2, post = n-1-pre):
//   forward   scale = k + (alpha/n) S(x^2),  y = x scale^-beta
//   backward  p = scale^-beta (recomputed from x: only x is saved),
//             dx = p dy - (2 alpha beta/n) x S(dy x p / scale)
//
// Design.  The TPU kernel takes a (C, 1024-lane) block per grid cell and
// forms the window sum with sublane shifts.  Here consecutive threads
// own consecutive h*w positions of one image, so every channel's load is
// coalesced over the NCHW plane, and each thread walks the channels of
// its position in order, holding the window in registers as a shift
// register: x[c-D .. c+D] in the forward; in the backward also the
// terms dy x p / scale of the last 2D+1 channels and, delayed by D
// channels, the p, dy and x of the channel being written.  D is a
// template parameter >= max(pre, post) (n up to 15), so every register
// index is a compile-time constant.  One pass over x (backward: over x
// and dy), no shared memory.  The channels are cut into chunks of
// CHUNK, one per grid row, so that the small late planes of AlexNet
// (256 x 27 x 27) still give the card ~190,000 threads; a chunk
// re-reads its D (backward 2D) halo channels on each side, mostly from
// L2.
//
// Bound on this card: bytes.  The forward reads x and writes y (8 bytes
// per element), the backward reads x and dy and writes dx (12 bytes);
// arithmetic is ~15 (forward) to ~30 (backward) flops per element,
// ~20x below the fp32 rate at that traffic.
//
// Numerics.  Each window sum is an explicit n-term sum in the Pallas
// order (centre, then the post side d = 1.., then the pre side d = 1..;
// pallas_lrn.py:50-61), never a running add-and-subtract, whose
// cancellation error would grow with C.  Channels outside [0, C) are
// zeros, as the Pallas kernel pads them (adding 0 is exact), which also
// covers C < n and even n.  Every product, sum and quotient is an
// explicitly rounded intrinsic, so nvcc's default contraction cannot
// fuse a pair into an FMA: the kernels repeat the plain version's
// operations (ops/cuda_lrn.py) one rounding at a time.  scale^-beta is
// the JAX package's _fast_negpow: rsqrtf(sqrtf(s)) and products when
// q = 4 beta is an integer in 1..8, powf(s, -beta) otherwise (q = 0).
// Built without --use_fast_math.

#include <cuda_runtime.h>

#include "lrn_common.cuh"

namespace {

constexpr int THREADS = 128;

template <int D>
__global__ void __launch_bounds__(THREADS) lrn_fwd_kernel(
    const float* __restrict__ x, float* __restrict__ y, int C, int L,
    int chunk, LrnParams hp) {
  const int pos = blockIdx.x * THREADS + threadIdx.x;
  if (pos >= L) return;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(C, c0 + chunk);
  const long long plane = static_cast<long long>(L);
  const long long base = static_cast<long long>(blockIdx.z) * C * plane + pos;
  const float* xp = x + base;
  float* yp = y + base;

  float xr[2 * D + 1];  // x at channels c-D .. c+D
#pragma unroll
  for (int m = 0; m <= 2 * D; ++m) xr[m] = 0.f;
  for (int cc = c0 - D; cc < c0 + D; ++cc) {
    shift_in<2 * D + 1>(xr, load_channel(xp, cc, C, plane));
  }
  for (int c = c0; c < c1; ++c) {
    shift_in<2 * D + 1>(xr, load_channel(xp, c + D, C, plane));
    const float scale = lrn_scale<D>(xr, hp);
    yp[c * plane] = __fmul_rn(xr[D], negpow(scale, hp));
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) lrn_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    float* __restrict__ dx, int C, int L, int chunk, LrnParams hp) {
  const int pos = blockIdx.x * THREADS + threadIdx.x;
  if (pos >= L) return;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(C, c0 + chunk);
  const long long plane = static_cast<long long>(L);
  const long long base = static_cast<long long>(blockIdx.z) * C * plane + pos;
  const float* xp = x + base;
  const float* dyp = dy + base;
  float* dxp = dx + base;

  float xr[2 * D + 1];  // x at channels j-D .. j+D (j: the term's channel)
  float tr[2 * D + 1];  // dy x p / scale at channels j-2D .. j
  float pd[D + 1], gd[D + 1], xd[D + 1];  // p, dy, x at channels j-D .. j
#pragma unroll
  for (int m = 0; m <= 2 * D; ++m) xr[m] = tr[m] = 0.f;
#pragma unroll
  for (int m = 0; m <= D; ++m) pd[m] = gd[m] = xd[m] = 0.f;
  // step j computes the term of channel j and writes dx at c = j - D
  const int j0 = c0 - D;
  for (int cc = j0 - D; cc < j0 + D; ++cc) {
    shift_in<2 * D + 1>(xr, load_channel(xp, cc, C, plane));
  }
  for (int j = j0; j < c1 + D; ++j) {
    shift_in<2 * D + 1>(xr, load_channel(xp, j + D, C, plane));
    float t = 0.f, p = 0.f, g = 0.f;
    if (j >= 0 && j < C) {
      const float scale = lrn_scale<D>(xr, hp);
      p = negpow(scale, hp);
      g = __ldg(dyp + j * plane);
      t = lrn_term(g, xr[D], p, scale);
    }
    shift_in<2 * D + 1>(tr, t);
    shift_in<D + 1>(pd, p);
    shift_in<D + 1>(gd, g);
    shift_in<D + 1>(xd, xr[D]);
    const int c = j - D;
    if (c >= c0) {
      dxp[c * plane] = lrn_dx(pd[0], gd[0], xd[0], window_sum<D>(tr, hp), hp);
    }
  }
}

template <int D>
cudaError_t launch(const float* x, const float* dy, float* out, int N, int C,
                   int L, int chunk, const LrnParams& hp, cudaStream_t s) {
  dim3 grid((L + THREADS - 1) / THREADS, (C + chunk - 1) / chunk, N);
  if (dy == nullptr) {
    lrn_fwd_kernel<D><<<grid, THREADS, 0, s>>>(x, out, C, L, chunk, hp);
  } else {
    lrn_bwd_kernel<D><<<grid, THREADS, 0, s>>>(x, dy, out, C, L, chunk, hp);
  }
  return cudaGetLastError();
}

int dispatch(const float* x, const float* dy, float* out, int N, int C, int L,
             int chunk, int pre, int post, float k, float alpha_n,
             float coef, int q, float neg_beta, void* stream) {
  if (N < 1 || C < 1 || L < 1 || chunk < 1 || N > 65535 ||
      (C + chunk - 1) / chunk > 65535 || pre < 0 || post < pre ||
      post > LRN_MAX_D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LrnParams hp{pre, post, k, alpha_n, coef, q, neg_beta};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (post) {  // post = max(pre, post): the window's reach
#define LRN_CASE(DD) \
  case DD:           \
    return static_cast<int>(launch<DD>(x, dy, out, N, C, L, chunk, hp, s));
    LRN_CASE(0) LRN_CASE(1) LRN_CASE(2) LRN_CASE(3)
    LRN_CASE(4) LRN_CASE(5) LRN_CASE(6) LRN_CASE(7)
#undef LRN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y (N, C, H*W) contiguous float32.  alpha_n = alpha/n, q = 4 beta
// when that is an integer in 1..8 (else 0: powf), neg_beta = -beta.
// Returns the cudaError_t of the launch.
extern "C" int sparknet_lrn_fwd_f32(const float* x, float* y, int N, int C,
                                    int L, int chunk, int pre, int post,
                                    float k, float alpha_n, int q,
                                    float neg_beta, void* stream) {
  return dispatch(x, nullptr, y, N, C, L, chunk, pre, post, k, alpha_n, 0.f,
                  q, neg_beta, stream);
}

// x, dy, dx (N, C, H*W) contiguous float32; coef = 2 alpha beta / n.
extern "C" int sparknet_lrn_bwd_f32(const float* x, const float* dy, float* dx,
                                    int N, int C, int L, int chunk, int pre,
                                    int post, float k, float alpha_n,
                                    float coef, int q, float neg_beta,
                                    void* stream) {
  return dispatch(x, dy, dx, N, C, L, chunk, pre, post, k, alpha_n, coef, q,
                  neg_beta, stream);
}
