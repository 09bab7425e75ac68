// Fused cross-channel LRN + 3x3/2 max pool, float32, for Hopper (sm_90a):
// maxpool_3x3_s2(lrn_across(x)) on NCHW with odd H, W >= 3 (pallas_plp
// .fusable), pooled to ((H-3)/2+1, (W-3)/2+1).
//
// Replaces the two Pallas kernels of sparknet_tpu/ops/pallas_plp.py:
//   sparknet_lrn_pool_fwd_f32 <- _fwd_kernel (:148, pallas_call at :288)
//   sparknet_lrn_pool_bwd_f32 <- _bwd_kernel (:166, pallas_call at :322)
//
// Forward (K7).  One block per (image, channel chunk, tile of 8 x 8
// pooled outputs).  Each of its 17 x 17 input positions is one thread,
// which walks the chunk's channels holding x[c-D .. c+D] of its position
// in registers (lrn_common.cuh), computes the LRN output y there and
// writes it into a shared plane; after one barrier the 64 pool threads
// take the max of their 3 x 3 windows and write the pooled value.  The
// plane is double-buffered, so a channel costs one barrier.  y never
// reaches device memory.
//
// Backward (K8).  Recomputed from x alone (the custom_vjp saves only x,
// pallas_plp.py:281-307).  One block per (image, channel chunk, tile of
// 16 x 16 dx positions).  With stride 2 and kernel 3, windows share
// their border row and column, so a position's routed gradient depends
// on up to four windows, which reach two rows and columns before the
// tile and one after: the block computes y on the 19 x 19 positions of
// the tile plus that halo (the TPU kernel's pre/post halo blocks,
// :330-345), so no two blocks write one dx and no atomics are needed.
// Per channel j the block routes in three steps, each on shared memory
// and each computed once: (1) one thread per window of the tile's 9 x 9
// windows picks the window's column; (2) one thread per (window-row,
// tile column) sums the gradients the column receives and picks its
// row; (3) each tile position reads what its (at most two) window-rows
// routed to it, forms the LRN backward term g x p / scale, and keeps the
// last 2D+1 terms in registers; D channels later it writes dx.
//
// Routing is the Pallas kernel's, not Caffe's row-major scan.  Stage 1
// (:192-212): a window sends its gradient to the FIRST COLUMN b = 0, 1, 2
// whose 3-row max equals the pooled value; stage 2 (:214-221): a column's
// gathered gradient goes to the FIRST ROW whose value equals the column
// max.  The sums follow the Pallas order too: a column's gradient is
// ((0 + from b=0) + from b=1) + from b=2, a row's is (first row of its
// window-row below) + (last row of the window-row above).  The TPU
// kernel's 0/1 selection matmul (_dot3 with _sel_matrices) was a Mosaic
// workaround for stride-2 lane packing; index arithmetic replaces it.
//
// Bound on this card: bytes.  K7 reads x and writes the pooled tensor
// (|x| + |x|/4 per image); K8 reads x and the pooled dy and writes dx
// (2|x| + |x|/4).  Both recompute y on a tile's halo (17^2/16^2 and
// 19^2/16^2 of the tile) and take one barrier (K7) or three (K8) per
// channel; tensor cores and TMA have no role (no matrix product).  Built
// without --use_fast_math; every operation of the LRN is an explicitly
// rounded intrinsic, as in lrn.cu.

#include <cuda_runtime.h>

#include "lrn_common.cuh"

namespace {

constexpr int TP = 8;                  // K7: pooled rows and columns per tile
constexpr int FW = 2 * TP + 1;         // K7: input window side (17)
constexpr int FWD_THREADS = 320;       // >= FW * FW, whole warps
constexpr int TB = 16;                 // K8: dx rows and columns per tile
constexpr int BW = TB + 3;             // K8: tile + 2 halo before, 1 after
constexpr int BWD_THREADS = 384;       // >= BW * BW, whole warps
constexpr int WN = TB / 2 + 1;         // K8: window rows, columns per tile

// max that keeps a NaN from either side (torch.maximum / jnp.maximum)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS) lrn_pool_fwd_kernel(
    const float* __restrict__ x, float* __restrict__ out, int C, int H, int W,
    int PH, int PW, int chunk, int nchunks, LrnParams hp) {
  __shared__ float ys[2][FW * FW];
  const int u0 = blockIdx.y * TP, v0 = blockIdx.x * TP;
  const int n = blockIdx.z / nchunks;
  const int c0 = (blockIdx.z % nchunks) * chunk;
  const int c1 = min(C, c0 + chunk);
  const int tph = min(TP, PH - u0), tpw = min(TP, PW - v0);
  const int er = threadIdx.x / FW, ec = threadIdx.x % FW;
  const bool lrn_thread = er <= 2 * tph && ec <= 2 * tpw;
  const int pu = threadIdx.x / TP, pv = threadIdx.x % TP;
  const bool pool_thread = threadIdx.x < TP * TP && pu < tph && pv < tpw;
  const long long plane = static_cast<long long>(H) * W;
  const long long pplane = static_cast<long long>(PH) * PW;
  const float* xp = x + static_cast<long long>(n) * C * plane +
                    static_cast<long long>(2 * u0 + er) * W + (2 * v0 + ec);
  float* op = out + static_cast<long long>(n) * C * pplane +
              static_cast<long long>(u0 + pu) * PW + (v0 + pv);

  float xr[2 * D + 1];  // x at channels c-D .. c+D of this position
#pragma unroll
  for (int m = 0; m <= 2 * D; ++m) xr[m] = 0.f;
  if (lrn_thread) {
    for (int cc = c0 - D; cc < c0 + D; ++cc) {
      shift_in<2 * D + 1>(xr, load_channel(xp, cc, C, plane));
    }
  }
  for (int c = c0; c < c1; ++c) {
    float* yb = ys[c & 1];
    if (lrn_thread) {
      shift_in<2 * D + 1>(xr, load_channel(xp, c + D, C, plane));
      yb[er * FW + ec] =
          __fmul_rn(xr[D], negpow(lrn_scale<D>(xr, hp), hp));
    }
    __syncthreads();
    if (pool_thread) {
      const float* w = yb + (2 * pu) * FW + 2 * pv;
      float rm[3];  // the 3-row max of each window column
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        rm[b] = max_nan(max_nan(w[b], w[FW + b]), w[2 * FW + b]);
      }
      op[c * pplane] = max_nan(max_nan(rm[0], rm[1]), rm[2]);
    }
  }
}

// stage 1 of the routing: the column b in 0..2 whose 3-row max equals
// the pooled value, the first that does (3: none, a NaN window); w
// points at the window's top-left y
__device__ __forceinline__ int chosen_column(const float* w) {
  float rm[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    rm[b] = max_nan(max_nan(w[b], w[BW + b]), w[2 * BW + b]);
  }
  const float pooled = max_nan(max_nan(rm[0], rm[1]), rm[2]);
  return rm[0] == pooled ? 0 : rm[1] == pooled ? 1 : rm[2] == pooled ? 2 : 3;
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS) lrn_pool_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    float* __restrict__ dx, int C, int H, int W, int PH, int PW, int chunk,
    int nchunks, LrnParams hp) {
  __shared__ float ys[BW * BW];          // y, origin (h0 - 2, w0 - 2)
  __shared__ int bsel[WN * WN];          // stage 1: each window's column
  __shared__ float colg[WN * TB];        // stage 2: a column's gradient
  __shared__ int rsel[WN * TB];          //          and the row it goes to
  const int h0 = blockIdx.y * TB, w0 = blockIdx.x * TB;
  const int u0 = h0 / 2 - 1, v0 = w0 / 2 - 1;  // the first window row, col
  const int n = blockIdx.z / nchunks;
  const int c0 = (blockIdx.z % nchunks) * chunk;
  const int c1 = min(C, c0 + chunk);
  const int t = threadIdx.x;
  const int er = t / BW, ec = t % BW;
  const int h = h0 - 2 + er, w = w0 - 2 + ec;
  const bool lrn_thread = t < BW * BW && h >= 0 && h < H && w >= 0 && w < W;
  const bool out_thread = lrn_thread && h >= h0 && h < h0 + TB && w >= w0 &&
                          w < w0 + TB;
  // stage 1 threads: window (u0 + wi, v0 + wj)
  const int wi = t / WN, wj = t % WN;
  const bool win_thread = t < WN * WN && u0 + wi >= 0 && u0 + wi < PH &&
                          v0 + wj >= 0 && v0 + wj < PW;
  // stage 2 threads: window-row u0 + ci, tile column w0 + cj
  const int ci = t / TB, cj = t % TB;
  const int cu = u0 + ci, cw = w0 + cj;
  const bool col_thread = t < WN * TB && cu >= 0 && cu < PH && cw < W;
  const long long plane = static_cast<long long>(H) * W;
  const long long pplane = static_cast<long long>(PH) * PW;
  const long long at =
      static_cast<long long>(n) * C * plane + static_cast<long long>(h) * W + w;
  const float* xp = x + at;
  float* dxp = dx + at;
  const float* dyimg = dy + static_cast<long long>(n) * C * pplane;
  // the window-rows holding row h, in the order their gradients add: an
  // even row is row 0 of window-row h/2 and row 2 of h/2 - 1, an odd row
  // row 1 of (h-1)/2 (indices relative to u0)
  const int ia = h % 2 == 0 ? 0 : 1;
  const int ua = (h % 2 == 0 ? h / 2 : (h - 1) / 2) - u0;
  const int ub = h % 2 == 0 ? h / 2 - 1 - u0 : -1;

  float xr[2 * D + 1];  // x at channels j-D .. j+D
  float tr[2 * D + 1];  // g x p / scale at channels j-2D .. j
  float pd[D + 1], gd[D + 1], xd[D + 1];  // p, g, x at channels j-D .. j
#pragma unroll
  for (int m = 0; m <= 2 * D; ++m) xr[m] = tr[m] = 0.f;
#pragma unroll
  for (int m = 0; m <= D; ++m) pd[m] = gd[m] = xd[m] = 0.f;
  const int j0 = c0 - D;
  if (lrn_thread) {
    for (int cc = j0 - D; cc < j0 + D; ++cc) {
      shift_in<2 * D + 1>(xr, load_channel(xp, cc, C, plane));
    }
  }
  for (int j = j0; j < c1 + D; ++j) {
    const bool live = j >= 0 && j < C;  // uniform over the block
    float scale = 1.f, p = 0.f;
    if (lrn_thread) {
      shift_in<2 * D + 1>(xr, load_channel(xp, j + D, C, plane));
      if (live) {
        scale = lrn_scale<D>(xr, hp);
        p = negpow(scale, hp);
        ys[er * BW + ec] = __fmul_rn(xr[D], p);
      }
    }
    __syncthreads();
    if (live && win_thread) {
      bsel[t] = chosen_column(ys + (2 * wi) * BW + 2 * wj);
    }
    __syncthreads();
    if (live && col_thread) {
      // stage 2: the column's gradient, ((0 + from b=0) + from b=1) +
      // from b=2 (the Pallas sum order), then its first row equal to the
      // column max
      const float* dyc = dyimg + j * pplane + static_cast<long long>(cu) * PW;
      const int s = cw - (w0 - 2);  // the column in the y plane
      float placed[3] = {0.f, 0.f, 0.f};
      if (cw % 2 == 0) {
        const int v = cw / 2;  // this column is window v's b = 0
        if (v < PW && bsel[ci * WN + (v - v0)] == 0) placed[0] = __ldg(dyc + v);
        if (v >= 1 && bsel[ci * WN + (v - 1 - v0)] == 2) {
          placed[2] = __ldg(dyc + v - 1);
        }
      } else {
        const int v = (cw - 1) / 2;
        if (bsel[ci * WN + (v - v0)] == 1) placed[1] = __ldg(dyc + v);
      }
      colg[t] = __fadd_rn(__fadd_rn(__fadd_rn(0.f, placed[0]), placed[1]),
                          placed[2]);
      const float r0 = ys[(2 * ci) * BW + s];
      const float r1 = ys[(2 * ci + 1) * BW + s];
      const float r2 = ys[(2 * ci + 2) * BW + s];
      const float cm = max_nan(max_nan(r0, r1), r2);
      rsel[t] = r0 == cm ? 0 : r1 == cm ? 1 : r2 == cm ? 2 : 3;
    }
    __syncthreads();
    if (out_thread) {
      float g = 0.f, tt = 0.f;
      if (live) {
        // what window-row ua (row ia of it) and ub (row 2) routed here;
        // a window-row outside the pooled rows routes nothing
        const int col = w - w0;
        const int ga = ua * TB + col, gb = ub * TB + col;
        const bool a_ok = u0 + ua >= 0 && u0 + ua < PH;
        const bool b_ok = ub >= 0 && u0 + ub >= 0 && u0 + ub < PH;
        const float from_a = a_ok && rsel[ga] == ia ? colg[ga] : 0.f;
        const float from_b = b_ok && rsel[gb] == 2 ? colg[gb] : 0.f;
        g = __fadd_rn(from_a, from_b);
        tt = lrn_term(g, xr[D], p, scale);
      }
      shift_in<2 * D + 1>(tr, tt);
      shift_in<D + 1>(pd, p);
      shift_in<D + 1>(gd, g);
      shift_in<D + 1>(xd, xr[D]);
      const int c = j - D;
      if (c >= c0) {
        dxp[c * plane] =
            lrn_dx(pd[0], gd[0], xd[0], window_sum<D>(tr, hp), hp);
      }
    }
  }
}

template <int D>
cudaError_t launch(const float* x, const float* dy, float* out, int N, int C,
                   int H, int W, int chunk, const LrnParams& hp,
                   cudaStream_t s) {
  const int PH = (H - 3) / 2 + 1, PW = (W - 3) / 2 + 1;
  const int nchunks = (C + chunk - 1) / chunk;
  if (dy == nullptr) {
    dim3 grid((PW + TP - 1) / TP, (PH + TP - 1) / TP, N * nchunks);
    lrn_pool_fwd_kernel<D><<<grid, FWD_THREADS, 0, s>>>(
        x, out, C, H, W, PH, PW, chunk, nchunks, hp);
  } else {
    dim3 grid((W + TB - 1) / TB, (H + TB - 1) / TB, N * nchunks);
    lrn_pool_bwd_kernel<D><<<grid, BWD_THREADS, 0, s>>>(
        x, dy, out, C, H, W, PH, PW, chunk, nchunks, hp);
  }
  return cudaGetLastError();
}

int dispatch(const float* x, const float* dy, float* out, int N, int C, int H,
             int W, int chunk, int pre, int post, float k, float alpha_n,
             float coef, int q, float neg_beta, void* stream) {
  if (N < 1 || C < 1 || H < 3 || W < 3 || H % 2 == 0 || W % 2 == 0 ||
      chunk < 1 ||
      static_cast<long long>(N) * ((C + chunk - 1) / chunk) > 65535 ||
      pre < 0 || post < pre || post > LRN_MAX_D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LrnParams hp{pre, post, k, alpha_n, coef, q, neg_beta};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (post) {
#define LRN_CASE(DD)                                                       \
  case DD:                                                                 \
    return static_cast<int>(                                               \
        launch<DD>(x, dy, out, N, C, H, W, chunk, hp, s));
    LRN_CASE(0) LRN_CASE(1) LRN_CASE(2) LRN_CASE(3)
    LRN_CASE(4) LRN_CASE(5) LRN_CASE(6) LRN_CASE(7)
#undef LRN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (N, C, H, W) contiguous float32, H and W odd >= 3; out (N, C, PH, PW).
// alpha_n = alpha/n, q = 4 beta when an integer in 1..8 (else 0: powf),
// neg_beta = -beta.  Returns the cudaError_t of the launch.
extern "C" int sparknet_lrn_pool_fwd_f32(const float* x, float* out, int N,
                                         int C, int H, int W, int chunk,
                                         int pre, int post, float k,
                                         float alpha_n, int q, float neg_beta,
                                         void* stream) {
  return dispatch(x, nullptr, out, N, C, H, W, chunk, pre, post, k, alpha_n,
                  0.f, q, neg_beta, stream);
}

// x, dx (N, C, H, W), dy (N, C, PH, PW), contiguous float32; coef =
// 2 alpha beta / n.
extern "C" int sparknet_lrn_pool_bwd_f32(const float* x, const float* dy,
                                         float* dx, int N, int C, int H,
                                         int W, int chunk, int pre, int post,
                                         float k, float alpha_n, float coef,
                                         int q, float neg_beta,
                                         void* stream) {
  return dispatch(x, dy, dx, N, C, H, W, chunk, pre, post, k, alpha_n, coef,
                  q, neg_beta, stream);
}
