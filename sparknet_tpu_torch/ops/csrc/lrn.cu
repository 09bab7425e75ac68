// Cross-channel LRN (Caffe ACROSS_CHANNELS) for Hopper (sm_90a): the
// forward in float32 and bfloat16, the backward in float32.
//
// Replaces the two Pallas kernels of sparknet_tpu/ops/pallas_lrn.py
// (pallas_call at :89 in _call):
//   sparknet_lrn_fwd_f32, sparknet_lrn_fwd_bf16 <- _fwd_kernel (:64)
//   sparknet_lrn_bwd_f32 <- _bwd_kernel (:70)
// With S the centred window sum over channels (Caffe's pre-pad
// pre = (n-1)/2, post = n-1-pre):
//   forward   scale = k + (alpha/n) S(x^2),  y = x scale^-beta
//   backward  p = scale^-beta (recomputed from x: only x is saved),
//             dx = p dy - (2 alpha beta/n) x S(dy x p / scale)
//
// Design.  The TPU kernel takes a (C, 1024-lane) block per grid cell and
// forms the window sum with sublane shifts.  Here consecutive threads
// own consecutive positions, so every channel's load is coalesced over
// the NCHW plane, and each thread walks the channels of its position in
// order, holding the window in registers as a shift register:
// x[c-D .. c+D] in the forward; in the backward also the terms
// dy x p / scale of the last 2D+1 channels and, delayed by D channels,
// the p, dy and x of the channel being written.  D is a template
// parameter >= max(pre, post) (n up to 15), so every register index is a
// compile-time constant.  One pass over x (backward: over x and dy), no
// shared memory.  The channels are cut into chunks, one per grid row, so
// that the small late planes of AlexNet (256 x 27 x 27) still give the
// card enough threads; a chunk re-reads its D (backward 2D) halo
// channels on each side, mostly from L2.  Both kernels take the
// positions of all images as one index and load a group of channels
// ahead (below); each square of x is formed once, as its channel enters
// the window.
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
//
// bfloat16 forward: as the TPU kernel does (pallas_lrn.py:65-67: fp32
// math, output in the input's dtype), each x is widened to float32 as
// it is loaded (exact), the scale and y run the float32 operations above,
// and y is narrowed once, round-to-nearest-even, at the store.  So the
// bf16 kernel equals the float32 kernel on the widened input, narrowed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "lrn_common.cuh"

namespace {

// K5's launch shape, chosen by tools/lrn_tiles.py --fwd, which times the
// alternatives (PERF.md §6): threads a block, the channels of x a thread
// loads a group ahead, and the blocks an SM should hold.
constexpr int K5_THREADS = 256, K5_G = 4, K5_MB = 4;

// K5's element access: loads widen to float32, stores narrow from it
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float load_channel_t(const T* p, int c, int C,
                                                long long plane) {
  return (c >= 0 && c < C) ? ld(p + c * plane) : 0.f;
}

// Forward (K5).  The positions of all N images are one index, each
// thread one position (consecutive threads, consecutive positions), as
// in K6.  At the top of each group of K5_G steps the thread issues the
// next group's K5_G loads of x, then computes the current group from
// registers.  Step c shifts x[c + D] into the window: its square into
// the squares' register (channels c-D .. c+D), x itself into a register
// of D + 1 (channels c .. c+D), whose bottom is the x of y[c].  FAST
// fixes Caffe's default window and power at compile time
// (lrn_common.cuh).  T is the element type of x and y (float or
// __nv_bfloat16); the window and the arithmetic are float32 either way.
template <typename T, int D, bool FAST>
__global__ void __launch_bounds__(K5_THREADS, K5_MB) lrn_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, int C, int L,
    long long NL, int chunk, LrnParams hp) {
  constexpr int G = K5_G;
  const long long q =
      static_cast<long long>(blockIdx.x) * K5_THREADS + threadIdx.x;
  if (q >= NL) return;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(C, c0 + chunk);
  const long long plane = static_cast<long long>(L);
  const long long at = (q / L) * C * plane + q % L;
  const T* xp = x + at;
  T* yp = y + at;

  float xr[D + 1];      // x at channels c .. c+D
  float sr[2 * D + 1];  // the squares of x at channels c-D .. c+D
#pragma unroll
  for (int m = 0; m <= D; ++m) xr[m] = 0.f;
#pragma unroll
  for (int m = 0; m <= 2 * D; ++m) sr[m] = 0.f;
  for (int cc = c0 - D; cc < c0 + D; ++cc) {
    const float v = load_channel_t(xp, cc, C, plane);
    shift_in<D + 1>(xr, v);
    shift_in<2 * D + 1>(sr, __fmul_rn(v, v));
  }
  // x of channels c + D for the steps c of a group; a group whose
  // channels all lie in [0, C) loads without checks
  float xn[G];
  auto fetch = [&](int cg) {
    if (cg + G + D <= C) {
      const T* xq = xp + (cg + D) * plane;
#pragma unroll
      for (int s = 0; s < G; ++s) xn[s] = ld(xq + s * plane);
    } else {
#pragma unroll
      for (int s = 0; s < G; ++s) {
        xn[s] = load_channel_t(xp, cg + s + D, C, plane);
      }
    }
  };
  fetch(c0);
  for (int cg = c0; cg < c1; cg += G) {
    float xc[G];
#pragma unroll
    for (int s = 0; s < G; ++s) xc[s] = xn[s];
    if (cg + G < c1) fetch(cg + G);
#pragma unroll
    for (int s = 0; s < G; ++s) {
      shift_in<D + 1>(xr, xc[s]);
      shift_in<2 * D + 1>(sr, __fmul_rn(xc[s], xc[s]));
      if (cg + s < c1) {
        const float scale = lrn_scale_sq_t<D, FAST>(sr, hp);
        st(yp + (cg + s) * plane, __fmul_rn(xr[0], negpow_t<FAST>(scale, hp)));
      }
    }
  }
}

// K6's launch shape, chosen by tools/lrn_tiles.py, which times the
// alternatives (PERF.md §6): threads a block, the channels of x and dy a
// thread loads a group ahead, and the blocks an SM should hold.
constexpr int K6_THREADS = 384, K6_G = 4, K6_MB = 2;

// Backward (K6).  The positions of all N images are one index (no block
// of a small plane runs part empty); each thread owns one position
// (consecutive threads, consecutive positions: each warp's loads stay
// coalesced) and walks its chunk's channels as the shift registers of
// lrn_common.cuh.  The loads are a group ahead: at the top of each group
// of K6_G steps the thread issues the next group's K6_G loads of x and of
// dy, then computes the current group from registers, so ~2 K6_G loads
// are in flight across the group's arithmetic (Little's law: the HBM
// latency times its rate over the threads an SM holds).  FAST fixes
// Caffe's default window and power at compile time (lrn_common.cuh).
template <int D, bool FAST>
__global__ void __launch_bounds__(K6_THREADS, K6_MB) lrn_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    float* __restrict__ dx, int C, int L, long long NL, int chunk,
    LrnParams hp) {
  constexpr int G = K6_G;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(C, c0 + chunk);
  const long long plane = static_cast<long long>(L);
  const long long q =
      static_cast<long long>(blockIdx.x) * K6_THREADS + threadIdx.x;
  const bool ok = q < NL;
  const long long at = ok ? (q / L) * C * plane + q % L : 0;
  const float* xp = x + at;
  const float* dyp = dy + at;
  float* dxp = dx + at;

  float xr[2 * D + 1];  // x at channels j-D .. j+D (j: the term's channel)
  float sr[2 * D + 1];  // their squares, each formed once
  float tr[2 * D + 1];  // dy x p / scale at channels j-2D .. j
  float pa[D + 1];      // p dy at channels j-D .. j
  // step j computes the term of channel j and writes dx at c = j - D,
  // whose x is then xr[0]
  const int j0 = c0 - D, j1 = c1 + D;
#pragma unroll
  for (int m = 0; m <= 2 * D; ++m) xr[m] = sr[m] = tr[m] = 0.f;
#pragma unroll
  for (int m = 0; m <= D; ++m) pa[m] = 0.f;
  if (ok) {
    for (int cc = j0 - D; cc < j0 + D; ++cc) {
      const float v = load_channel(xp, cc, C, plane);
      shift_in<2 * D + 1>(xr, v);
      shift_in<2 * D + 1>(sr, __fmul_rn(v, v));
    }
  }
  // x of channels j + D and dy of channels j, for the steps j of a group;
  // a group whose channels all lie in [0, C) loads without checks (a
  // position past NL reads image 0's and writes nothing)
  float xn[G], gn[G];
  auto fetch = [&](int jg) {
    if (jg >= 0 && jg + G + D <= C) {
      const float* xq = xp + (jg + D) * plane;
      const float* gq = dyp + jg * plane;
#pragma unroll
      for (int s = 0; s < G; ++s) {
        xn[s] = __ldg(xq + s * plane);
        gn[s] = __ldg(gq + s * plane);
      }
    } else {
#pragma unroll
      for (int s = 0; s < G; ++s) {
        const int j = jg + s;
        xn[s] = load_channel(xp, j + D, C, plane);
        gn[s] = j >= 0 && j < C ? __ldg(dyp + j * plane) : 0.f;
      }
    }
  };
  fetch(j0);
  for (int jg = j0; jg < j1; jg += G) {
    float xc[G], gc[G];
#pragma unroll
    for (int s = 0; s < G; ++s) {
      xc[s] = xn[s];
      gc[s] = gn[s];
    }
    if (jg + G < j1) fetch(jg + G);
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const int j = jg + s, c = j - D;
      shift_in<2 * D + 1>(xr, xc[s]);
      shift_in<2 * D + 1>(sr, __fmul_rn(xc[s], xc[s]));
      float t = 0.f, pw = 0.f, g = 0.f;
      if (j >= 0 && j < C) {
        const float scale = lrn_scale_sq_t<D, FAST>(sr, hp);
        pw = negpow_t<FAST>(scale, hp);
        g = gc[s];
        t = lrn_term(g, xr[D], pw, scale);
      }
      shift_in<2 * D + 1>(tr, t);
      shift_in<D + 1>(pa, __fmul_rn(pw, g));
      if (c >= c0 && c < c1 && ok) {
        dxp[(jg - D) * plane + s * plane] =
            lrn_dx(pa[0], xr[0], window_sum_t<D, FAST>(tr, hp), hp);
      }
    }
  }
}

// the forward (dy == nullptr: K5, element type T) or the backward (K6,
// float32) at window reach D
template <typename T, int D>
cudaError_t launch(const T* x, const float* dy, T* out, int N, int C, int L,
                   int chunk, const LrnParams& hp, cudaStream_t s) {
  const int nchunks = (C + chunk - 1) / chunk;
  const long long NL = static_cast<long long>(N) * L;
  const int threads = dy == nullptr ? K5_THREADS : K6_THREADS;
  dim3 grid(static_cast<unsigned>((NL + threads - 1) / threads), nchunks);
  bool fast = false;
  if constexpr (D == 2) {  // the FAST kernels exist for D = 2 alone
    fast = lrn_fast(D, hp);
    if (fast && dy == nullptr) {
      lrn_fwd_kernel<T, D, true><<<grid, threads, 0, s>>>(x, out, C, L, NL,
                                                          chunk, hp);
    } else if (fast) {
      if constexpr (std::is_same_v<T, float>) {
        lrn_bwd_kernel<D, true><<<grid, threads, 0, s>>>(x, dy, out, C, L, NL,
                                                         chunk, hp);
      }
    }
  }
  if (!fast && dy == nullptr) {
    lrn_fwd_kernel<T, D, false><<<grid, threads, 0, s>>>(x, out, C, L, NL,
                                                         chunk, hp);
  } else if (!fast) {
    if constexpr (std::is_same_v<T, float>) {
      lrn_bwd_kernel<D, false><<<grid, threads, 0, s>>>(x, dy, out, C, L, NL,
                                                        chunk, hp);
    }
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const float* dy, T* out, int N, int C, int L,
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
    return static_cast<int>(launch<T, DD>(x, dy, out, N, C, L, chunk, hp, s));
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
  return dispatch<float>(x, nullptr, y, N, C, L, chunk, pre, post, k,
                         alpha_n, 0.f, q, neg_beta, stream);
}

// x, y (N, C, H*W) contiguous bfloat16 (the bits, as uint16); float32
// arithmetic, y rounded to nearest even once.  Arguments as above.
extern "C" int sparknet_lrn_fwd_bf16(const void* x, void* y, int N, int C,
                                     int L, int chunk, int pre, int post,
                                     float k, float alpha_n, int q,
                                     float neg_beta, void* stream) {
  return dispatch<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), nullptr,
      static_cast<__nv_bfloat16*>(y), N, C, L, chunk, pre, post, k, alpha_n,
      0.f, q, neg_beta, stream);
}

// x, dy, dx (N, C, H*W) contiguous float32; coef = 2 alpha beta / n.
extern "C" int sparknet_lrn_bwd_f32(const float* x, const float* dy, float* dx,
                                    int N, int C, int L, int chunk, int pre,
                                    int post, float k, float alpha_n,
                                    float coef, int q, float neg_beta,
                                    void* stream) {
  return dispatch<float>(x, dy, dx, N, C, L, chunk, pre, post, k, alpha_n,
                         coef, q, neg_beta, stream);
}
