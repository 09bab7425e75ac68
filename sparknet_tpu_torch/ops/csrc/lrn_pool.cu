// Fused cross-channel LRN + 3x3/2 max pool, float32, for Hopper (sm_90a):
// maxpool_3x3_s2(lrn_across(x)) on NCHW with odd H, W >= 3 (pallas_plp
// .fusable), pooled to ((H-3)/2+1, (W-3)/2+1).
//
// Replaces the two Pallas kernels of sparknet_tpu/ops/pallas_plp.py:
//   sparknet_lrn_pool_fwd_f32 <- _fwd_kernel (:148, pallas_call at :288)
//   sparknet_lrn_pool_bwd_f32 <- _bwd_kernel (:166, pallas_call at :322)
//
// Forward (K7).  One block per (tile of pooled outputs, image, channel
// chunk): whole pooled rows, as many as a block holds (AlexNet's 27-wide
// plane in one block, its 55-wide plane in bands of 7 pooled rows).  The
// block walks the chunk's channels in groups with one barrier a group:
// the next group's x copied into shared memory by cp.async a group ahead,
// 16 bytes at a time; every thread shifting the group's x of its
// positions into registers and writing the LRN output y into shared
// planes; after the barrier, one thread per (channel, pooled position)
// taking the max of its 3 x 3 window.  y never reaches device memory.
//
// Backward (K8).  Recomputed from x alone (the custom_vjp saves only x,
// pallas_plp.py:281-307).  One block per (image, channel chunk, tile of
// dx positions shaped to the plane: one shape for narrow planes, one for
// wide ones, chosen by tools/lrn_pool_tiles.py).  With stride 2 and
// kernel 3, windows share their border row and column, so a position's
// routed gradient depends on up to four windows, which reach two rows and
// columns before the tile and one after: the block computes y on the tile
// plus that halo (the TPU kernel's pre/post halo blocks, :330-345), so no
// two blocks write one dx and no atomics are needed.  A tile as wide as a
// narrow plane, or half a wide one, spends few threads on the halo.  The
// block routes K8_G channels per group of three barriers, each step on
// shared memory and each computed once per channel: (1) one thread per
// (channel, window) picks the window's column; (2) one thread per
// (channel, window-row, tile column) sums the gradients the column
// receives and picks its row; (3) each tile position reads what its (at
// most two) window-rows routed to it, forms the LRN backward term
// g x p / scale, and keeps the last 2D+1 terms in registers; D channels
// later it writes dx.  x (by cp.async, into shared memory) and dy (into
// registers) are loaded a group ahead, so their latency hides behind the
// group's barriers; the dy values of both candidate windows are loaded
// and selected after the routing.  The group's p and scale wait in shared
// memory from the first step to the last, which keeps the registers
// under the 64 a 992-thread block allows.
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
// (2|x| + |x|/4).  Both recompute y on a tile's halo (K7 one input row a
// band, 15/14 at the 55-wide plane) and take one barrier per G channels
// (K7) or three per K8_G (K8); tensor cores and TMA have no role (no
// matrix product).  Built
// without --use_fast_math; every operation of the LRN is an explicitly
// rounded intrinsic, as in lrn.cu.

#include <cuda_runtime.h>

#include "lrn_common.cuh"

namespace {

// max that keeps a NaN from either side (torch.maximum / jnp.maximum)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// a 4-byte asynchronous copy into shared memory (zeros when !valid)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// a 16-byte asynchronous copy into shared memory, both sides on 16 bytes
// (zeros when !valid)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// the float offset of p past its 16-byte boundary
__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
}

// K7's blocks, one shape for planes up to K7_NARROW columns wide and one
// for wider planes: the channels per barrier group, the threads, the tile
// positions a thread may own (a block holds at most threads x that many
// input positions), the pool items a thread may own per group, and the
// blocks an SM should hold.  These constants were chosen by
// tools/lrn_pool_tiles.py --fwd, which times the alternatives (PERF.md §6).
constexpr int K7_NARROW = 32;
constexpr int K7_G_NARROW = 8, K7_NT_NARROW = 384, K7_PPT_NARROW = 2;
constexpr int K7_IPT_NARROW = 4, K7_MB_NARROW = 1;
constexpr int K7_G_WIDE = 4, K7_NT_WIDE = 288, K7_PPT_WIDE = 3;
constexpr int K7_IPT_WIDE = 3, K7_MB_WIDE = 3;

template <int G_, int NT_, int PPT_, int IPT_>
struct K7Shape {
  static constexpr int G = G_, NT = NT_, PPT = PPT_, IPT = IPT_;
  static constexpr int NB = NT * PPT;      // tile positions a block holds
  static constexpr int XS = NB + NB / 4;   // a staged channel, row slack included
  static constexpr size_t SMEM = sizeof(float) * 2 * G * (XS + NB);
  static_assert(NT % 32 == 0 && NB % 16 == 0, "whole warps, 16-byte rows");
};

// a staged row of BW floats: up to 3 of misalignment ahead, a multiple of
// 4 so that every row starts on 16 bytes
__host__ __device__ __forceinline__ int staged_row(int bw) {
  return (bw + 3 + 3) / 4 * 4;
}

// K7's tile of pooled outputs (rows, columns): whole pooled rows while
// three input rows fit a block (a narrow plane in one block), else one
// pooled row cut into column tiles; sizes spread evenly over the tiles.
// {0, 0} when the pool items would overflow S::IPT a thread.
template <class S>
void k7_tile(int PH, int PW, int W, int* tph, int* tpw) {
  auto fits = [](int th, int tw) {
    const int bh = 2 * th + 1, bw = 2 * tw + 1;
    return bh * bw <= S::NB && bh * staged_row(bw) <= S::XS;
  };
  auto even = [](int total, int most) {
    const int tiles = (total + most - 1) / most;
    return (total + tiles - 1) / tiles;
  };
  int th = 0, tw = PW;
  while (th < PH && fits(th + 1, PW)) ++th;
  if (th == 0) {
    th = 1;
    tw = 0;
    while (tw < PW && fits(1, tw + 1)) ++tw;
    tw = even(PW, tw);
  } else {
    th = even(PH, th);
  }
  const bool ok = tw > 0 && S::G * th * tw <= S::IPT * S::NT;
  *tph = ok ? th : 0;
  *tpw = ok ? tw : 0;
}

// Forward (K7).  One block per (tile of pooled outputs, image, channel
// chunk); the tile's input box has 2 tph + 1 rows and 2 tpw + 1 columns
// (whole rows of a plane up to ~340 columns wide).  The block walks the
// chunk's channels in groups of G with one barrier a group, software-
// pipelined:
//   - the x of the next group's channels (the window's leading edge, D
//     channels ahead) is copied into shared memory by cp.async, row by
//     row, 16 bytes at a time from the 16-byte boundary below each row
//     (a row's partial first and last 16 bytes 4 bytes at a time), one
//     group ahead;
//   - each thread owns up to S::PPT box positions (strided by S::NT, so
//     a warp reads and writes consecutive words), shifts the group's x
//     into its registers (x[c-D .. c+D] of each position, lrn_common.cuh)
//     and writes the group's LRN outputs y into shared planes, double-
//     buffered;
//   - after the next barrier each thread takes up to S::IPT items (a
//     channel of the group and a pooled position of the tile), the max
//     of its 3 x 3 window of y, and writes the pooled value, coalesced.
// So every thread works after every barrier, y never reaches device
// memory, and a tile recomputes one input row (column) of its
// neighbour's.  FAST fixes Caffe's default window and power at compile
// time (lrn_common.cuh).
template <int D, bool FAST, class S, int MB>
__global__ void __launch_bounds__(S::NT, MB) lrn_pool_fwd_kernel(
    const float* __restrict__ x, float* __restrict__ out, int C, int H, int W,
    int PH, int PW, int tph, int tpw, int chunk, int nchunks, LrnParams hp) {
  constexpr int G = S::G, NT = S::NT, PPT = S::PPT, IPT = S::IPT;
  constexpr int NB = S::NB, XS = S::XS;
  extern __shared__ float4 k7_smem[];
  float* xs = reinterpret_cast<float*>(k7_smem);  // [2][G][XS] staged x
  float* ys = xs + 2 * G * XS;                     // [2][G][NB] y
  const int t = threadIdx.x;
  const int u0 = blockIdx.y * tph, v0 = blockIdx.x * tpw;  // first pooled
  const int bph = min(tph, PH - u0), bpw = min(tpw, PW - v0);
  const int bh = 2 * bph + 1, bw = 2 * bpw + 1;  // the input box
  const int rs = staged_row(bw);
  const int n = blockIdx.z / nchunks;
  const int c0 = (blockIdx.z % nchunks) * chunk;
  const int c1 = min(C, c0 + chunk);
  const int n_groups = (c1 - c0 + G - 1) / G;
  const long long plane = static_cast<long long>(H) * W;
  const long long pplane = static_cast<long long>(PH) * PW;
  // the box's top-left x of channel 0; channel c's is c planes on
  const float* xbox = x + static_cast<long long>(n) * C * plane +
                      static_cast<long long>(2 * u0) * W + 2 * v0;
  float* obox = out + static_cast<long long>(n) * C * pplane +
                static_cast<long long>(u0) * PW + v0;
  const int mis0 = misalign(xbox);
  // the float offset past 16 bytes of row r of channel c's box
  auto row_off = [&](int c, int r) {
    return static_cast<int>((mis0 + c * plane + static_cast<long long>(r) * W)
                            & 3);
  };

  // copy channels c .. c + G - 1 of the box into staging buffer buf; a
  // channel outside [0, C) is zeros, as the Pallas kernel pads.  A
  // thread copies the same 16-byte chunks of every channel (FPT at
  // most): their rows, their places in a staged channel, and their rows'
  // offsets past 16 bytes in channel 0 are worked out once.
  constexpr int FPT = (XS / 4 + NT - 1) / NT;
  const int cpr = rs / 4;  // 16-byte chunks a staged row
  int f_dst[FPT], f_src[FPT], f_k4[FPT], f_off[FPT];
#pragma unroll
  for (int m = 0; m < FPT; ++m) {
    const int i = t + m * NT, r = i / cpr;
    f_k4[m] = i < bh * cpr ? 4 * (i % cpr) : bw + 4;  // past bw: no chunk
    f_dst[m] = r * rs + f_k4[m];
    f_src[m] = r * W + f_k4[m];
    f_off[m] = row_off(0, r);
  }
  // (c * plane) & 3 of each channel: its offset past 16 bytes, less
  // channel 0's
  const int plane4 = static_cast<int>(plane & 3);
  auto fetch = [&](int c, int buf) {
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const int cc = c + s;
      const bool in = cc >= 0 && cc < C;
      const int ci = in ? cc : 0;
      const float* src = xbox + ci * plane;
      float* dst = xs + (buf * G + s) * XS;
      const int coff = (ci * plane4) & 3;
#pragma unroll
      for (int m = 0; m < FPT; ++m) {
        const int off = (f_off[m] + coff) & 3;
        const int e0 = f_k4[m] - off;  // the row index of the chunk's first float
        if (e0 >= bw) continue;
        const float* a = src + f_src[m] - off;  // on 16 bytes
        float* d = dst + f_dst[m];
        if (e0 >= 0 && e0 + 4 <= bw) {
          cp_async16(d, a, in);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const bool ok = in && e0 + k >= 0 && e0 + k < bw;
            cp_async4(d + k, ok ? a + k : x, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  // this thread's pool items, the same every group: the channel of the
  // group, the offset of the window's top-left y in a plane of the box,
  // the pooled value's offset in a channel's tile (s = G: no item)
  int it_s[IPT], it_y[IPT], it_o[IPT];
  const int per_s = bph * bpw;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = t + k * NT;
    it_s[k] = G;
    it_y[k] = it_o[k] = 0;
    if (i < G * per_s) {
      const int s = i / per_s, r = i % per_s;
      const int pu = r / bpw, pv = r % bpw;
      it_s[k] = s;
      it_y[k] = (2 * pu) * bw + 2 * pv;
      it_o[k] = pu * PW + pv;
    }
  }
  auto pool = [&](int g0, int buf) {
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int s = it_s[k];
      if (s == G || g0 + s >= c1) continue;
      const float* w = ys + (buf * G + s) * NB + it_y[k];
      float rm[3];  // the 3-row max of each window column
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        rm[b] = max_nan(max_nan(w[b], w[bw + b]), w[2 * bw + b]);
      }
      obox[(g0 + s) * pplane + it_o[k]] = max_nan(max_nan(rm[0], rm[1]), rm[2]);
    }
  };

  // this thread's box positions: index in a staged channel, and the
  // float offset of its row's start past 16 bytes in channel 0
  int pst[PPT], prw[PPT];
  // x at channels g0-D-G .. g0+D-1 of each position, then g0-D .. g0+G-1+D
  float xr[PPT][2 * D + G];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int e = t + p * NT, r = e / bw;
    pst[p] = r * rs + e % bw;
    prw[p] = row_off(0, r);
#pragma unroll
    for (int m = 0; m < 2 * D + G; ++m) xr[p][m] = 0.f;
    if (e < bh * bw) {
      const float* xp = xbox + static_cast<long long>(r) * W + e % bw;
#pragma unroll
      for (int m = 0; m < 2 * D; ++m) {
        xr[p][G + m] = load_channel(xp, c0 - D + m, C, plane);
      }
    }
  }
  fetch(c0 + D, 0);
  for (int gi = 0; gi < n_groups; ++gi) {
    const int g0 = c0 + gi * G, buf = gi & 1;
    cp_async_wait_all();
    __syncthreads();  // x of this group landed; y of the last group written
    if (gi + 1 < n_groups) fetch(g0 + G + D, buf ^ 1);
    if (gi > 0) pool(g0 - G, buf ^ 1);
    // each staged channel's offset past 16 bytes, less channel 0's (a
    // channel outside [0, C) was staged as channel 0)
    int coff[G];
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const int cc = g0 + D + s;
      coff[s] = ((cc >= 0 && cc < C ? cc : 0) * plane4) & 3;
    }
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int e = t + p * NT;
      if (e >= bh * bw) continue;
#pragma unroll
      for (int s = 0; s < G; ++s) {
        const float* st = xs + (buf * G + s) * XS;
        shift_in<2 * D + G>(xr[p], st[pst[p] + ((prw[p] + coff[s]) & 3)]);
      }
#pragma unroll
      for (int s = 0; s < G; ++s) {
        if (g0 + s >= c1) continue;
        float win[2 * D + 1];
#pragma unroll
        for (int m = 0; m <= 2 * D; ++m) win[m] = xr[p][s + m];
        ys[(buf * G + s) * NB + e] = __fmul_rn(
            win[D], negpow_t<FAST>(lrn_scale<D, FAST>(win, hp), hp));
      }
    }
  }
  __syncthreads();
  pool(c0 + (n_groups - 1) * G, (n_groups - 1) & 1);
}

// K8's dx tiles (rows, columns) and the blocks an SM should hold: one
// shape for planes up to K8_NARROW columns wide, one for wider planes
// (even sides; a tile may reach past the plane, whose positions stay
// idle).  The block's threads cover the tile and its halo, (rows + 3) x
// (columns + 3) positions.  These constants were chosen by
// tools/lrn_pool_tiles.py, which times the alternatives (PERF.md §6).
constexpr int K8_NARROW = 32;
constexpr int K8_TH_NARROW = 28, K8_TW_NARROW = 28, K8_MB_NARROW = 1;
constexpr int K8_TH_WIDE = 14, K8_TW_WIDE = 28, K8_MB_WIDE = 2;
constexpr int K8_G = 4;    // channels per barrier group
constexpr int K8_IPT = 2;  // stage-2 items a thread may own

template <int TH_, int TW_>
struct K8Shape {
  static constexpr int TH = TH_, TW = TW_;
  static constexpr int BW = TW + 3, BH = TH + 3;  // the y box: tile + halo
  static constexpr int WR = (TH - 1) / 2 + 2;     // window rows of the tile
  static constexpr int WC = (TW - 1) / 2 + 2;     // window columns
  static constexpr int NT = (BH * BW + 31) / 32 * 32;
  static constexpr int N_B1 = K8_G * WR * WC;     // stage-1 items
  static constexpr int N_B2 = K8_G * WR * TW;     // stage-2 items
  static constexpr size_t SMEM =
      sizeof(float) * K8_G *
      (BH * BW + WR * WC + 2 * WR * TW + 3 * NT);
  static_assert(TH % 2 == 0 && TW % 2 == 0, "K8's tiles have even sides");
  static_assert(NT <= 1024, "a block holds the tile and its halo");
  static_assert(N_B2 <= K8_IPT * NT, "stage 2 fits K8_IPT items a thread");
};

// stage 1 of the routing: the column b in 0..2 whose 3-row max equals
// the pooled value, the first that does (3: none, a NaN window); w
// points at the window's top-left y in a plane of row stride bw
__device__ __forceinline__ int chosen_column(const float* w, int bw) {
  float rm[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    rm[b] = max_nan(max_nan(w[b], w[bw + b]), w[2 * bw + b]);
  }
  const float pooled = max_nan(max_nan(rm[0], rm[1]), rm[2]);
  return rm[0] == pooled ? 0 : rm[1] == pooled ? 1 : rm[2] == pooled ? 2 : 3;
}

// One block per (image, channel chunk, tile of TH x TW dx positions).
// The block walks the chunk's channels, and the D before and after it, in
// groups of K8_G, with three barriers a group:
//   A  each position of the tile and its halo shifts in the group's x
//      (copied a group ahead into shared memory by cp.async), computes
//      scale, p and y for every channel of the group, writes y into the
//      group's planes, parks p and scale in shared memory, and issues the
//      next group's x copies;
//   B1 one thread per (channel, window) of the tile's windows picks the
//      window's column;
//   B2 one thread per (channel, window-row, tile column) sums the
//      gradients the column receives (its dy values loaded a group ahead
//      and selected here) and picks its row;
//   C  each tile position gathers what its (at most two) window-rows
//      routed to it, for every channel of the group, forms the LRN
//      backward term g x p / scale, and writes dx D channels later.
// y, the column choices and the routed sums live in shared memory, one
// plane per channel of the group.
template <int D, class S, int MB>
__global__ void __launch_bounds__(S::NT, MB) lrn_pool_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    float* __restrict__ dx, int C, int H, int W, int PH, int PW, int chunk,
    int nchunks, LrnParams hp) {
  constexpr int G = K8_G, TH = S::TH, TW = S::TW, NT = S::NT;
  constexpr int BW = S::BW, BHh = S::BH, WR = S::WR, WC = S::WC;
  extern __shared__ float smem[];
  float* ys = smem;                                          // [G][BHh*BW]
  int* bsel = reinterpret_cast<int*>(ys + G * BHh * BW);     // [G][WR*WC]
  float* colg = reinterpret_cast<float*>(bsel + G * WR * WC);  // [G][WR*TW]
  int* rsel = reinterpret_cast<int*>(colg + G * WR * TW);      // [G][WR*TW]
  // this thread's slots: the next group's x, the group's p and scale
  float* xs = reinterpret_cast<float*>(rsel + G * WR * TW) + threadIdx.x;
  float* pss = xs + G * NT;  // [p, scale][G], stride NT

  const int h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const int u0 = h0 / 2 - 1, v0 = w0 / 2 - 1;  // the first window row, col
  const int n = blockIdx.z / nchunks;
  const int c0 = (blockIdx.z % nchunks) * chunk;
  const int c1 = min(C, c0 + chunk);
  const int t = threadIdx.x;
  const int er = t / BW, ec = t % BW;
  const int h = h0 - 2 + er, w = w0 - 2 + ec;
  const bool lrn_thread = t < BHh * BW && h >= 0 && h < H && w >= 0 && w < W;
  const bool out_thread = lrn_thread && h >= h0 && h < h0 + TH && w >= w0 &&
                          w < w0 + TW;
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
  const bool a_ok = u0 + ua >= 0 && u0 + ua < PH;
  const bool b_ok = ub >= 0 && u0 + ub >= 0 && u0 + ub < PH;
  const int col = w - w0;

  // channel j is computed when it lies in [0, C) and some dx of the chunk
  // needs it (j < c1 + D); the rest stay zero, as the Pallas kernel pads
  const int j0 = c0 - D;
  const int n_groups = (c1 - c0 + 2 * D + G - 1) / G;
  auto live = [&](int j) { return j >= 0 && j < C && j < c1 + D; };

  // stage-2 items of this thread: (channel of the group, window-row,
  // tile column), and their dy values, loaded a group ahead: [0] the
  // window this column is b = 0 or 1 of, [1] the window it is b = 2 of
  constexpr int n_b2 = S::N_B2;
  float dyv[K8_IPT][2];
  auto load_dy = [&](int g0) {
#pragma unroll
    for (int k = 0; k < K8_IPT; ++k) {
      dyv[k][0] = dyv[k][1] = 0.f;
      const int i = t + k * NT;
      if (i >= n_b2) continue;
      const int s = i / (WR * TW), r = i % (WR * TW);
      const int cu = u0 + r / TW, cw = w0 + r % TW;
      const int j = g0 + s;
      if (!live(j) || cu < 0 || cu >= PH || cw >= W) continue;
      const float* dyc = dyimg + j * pplane + static_cast<long long>(cu) * PW;
      const int v = cw / 2;  // even cw: window v's b = 0; odd: b = 1
      if (v < PW) dyv[k][0] = __ldg(dyc + v);
      if (cw % 2 == 0 && v >= 1) dyv[k][1] = __ldg(dyc + v - 1);
    }
  };

  float xr[2 * D + G];  // x at channels j0-D-G .. j0+D-1, then j0-D .. j0+G-1+D
  float tr[2 * D + 1];  // g x p / scale at channels j-2D .. j
  float pa[D + 1];      // p g at channels j-D .. j
#pragma unroll
  for (int m = 0; m < 2 * D + G; ++m) xr[m] = 0.f;
#pragma unroll
  for (int m = 0; m <= 2 * D; ++m) tr[m] = 0.f;
#pragma unroll
  for (int m = 0; m <= D; ++m) pa[m] = 0.f;
  // x of channels c .. c + G - 1 at this position, a group ahead
  auto fetch_x = [&](int c) {
    if (!lrn_thread) return;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const bool in = c + s >= 0 && c + s < C;
      cp_async4(xs + s * NT, in ? xp + (c + s) * plane : x, in);
    }
    cp_async_commit();
  };
  if (lrn_thread) {
#pragma unroll
    for (int m = 0; m < 2 * D; ++m) xr[G + m] = load_channel(xp, j0 - D + m, C, plane);
  }
  fetch_x(j0 + D);
  load_dy(j0);

  for (int gi = 0; gi < n_groups; ++gi) {
    const int g0 = j0 + gi * G;  // the group's first channel
    // A: y of the group's channels at this position
    if (lrn_thread) {
      cp_async_wait_all();
#pragma unroll
      for (int s = 0; s < G; ++s) shift_in<2 * D + G>(xr, xs[s * NT]);
    }
    fetch_x(g0 + G + D);
#pragma unroll
    for (int s = 0; s < G; ++s) {
      float p = 0.f, sc = 1.f;
      if (lrn_thread && live(g0 + s)) {
        float win[2 * D + 1];
#pragma unroll
        for (int m = 0; m <= 2 * D; ++m) win[m] = xr[s + m];
        sc = lrn_scale<D>(win, hp);
        p = negpow(sc, hp);
        ys[s * BHh * BW + er * BW + ec] = __fmul_rn(xr[s + D], p);
      }
      if (out_thread) {
        pss[s * NT] = p;
        pss[(G + s) * NT] = sc;
      }
    }
    __syncthreads();

    // B1: each window's column
    for (int i = t; i < S::N_B1; i += NT) {
      const int s = i / (WR * WC), r = i % (WR * WC);
      const int wi = r / WC, wj = r % WC;
      if (live(g0 + s) && u0 + wi >= 0 && u0 + wi < PH && v0 + wj >= 0 &&
          v0 + wj < PW) {
        bsel[i] = chosen_column(ys + s * BHh * BW + (2 * wi) * BW + 2 * wj, BW);
      }
    }
    __syncthreads();

    // B2: a column's gradient, ((0 + from b=0) + from b=1) + from b=2 (the
    // Pallas sum order), then its first row equal to the column max
#pragma unroll
    for (int k = 0; k < K8_IPT; ++k) {
      const int i = t + k * NT;
      if (i >= n_b2) continue;
      const int s = i / (WR * TW), r = i % (WR * TW);
      const int ci = r / TW, cj = r % TW;
      const int cu = u0 + ci, cw = w0 + cj;
      if (!live(g0 + s) || cu < 0 || cu >= PH || cw >= W) continue;
      // window (u0 + ci, v)'s column is bs[v - v0]
      const int* bs = bsel + s * WR * WC + ci * WC;
      float placed[3] = {0.f, 0.f, 0.f};
      const int v = cw / 2;
      if (cw % 2 == 0) {
        if (v < PW && bs[v - v0] == 0) placed[0] = dyv[k][0];
        if (v >= 1 && bs[v - 1 - v0] == 2) placed[2] = dyv[k][1];
      } else if (bs[v - v0] == 1) {
        placed[1] = dyv[k][0];
      }
      colg[i] = __fadd_rn(__fadd_rn(__fadd_rn(0.f, placed[0]), placed[1]),
                          placed[2]);
      const float* yc = ys + s * BHh * BW + (2 * ci) * BW + cj + 2;
      const float r0 = yc[0], r1 = yc[BW], r2 = yc[2 * BW];
      const float cm = max_nan(max_nan(r0, r1), r2);
      rsel[i] = r0 == cm ? 0 : r1 == cm ? 1 : r2 == cm ? 2 : 3;
    }
    load_dy(g0 + G);
    __syncthreads();

    // C: the routed gradient, the LRN backward term, dx D channels later
    if (out_thread) {
#pragma unroll
      for (int s = 0; s < G; ++s) {
        const int j = g0 + s;
        const float p = pss[s * NT], sc = pss[(G + s) * NT];
        float g = 0.f, tt = 0.f;
        if (live(j)) {
          // what window-row ua (row ia of it) and ub (row 2) routed here;
          // a window-row outside the pooled rows routes nothing
          const int base = s * WR * TW + col;
          const int ga = base + ua * TW, gb = base + ub * TW;
          const float from_a = a_ok && rsel[ga] == ia ? colg[ga] : 0.f;
          const float from_b = b_ok && rsel[gb] == 2 ? colg[gb] : 0.f;
          g = __fadd_rn(from_a, from_b);
          tt = lrn_term(g, xr[s + D], p, sc);
        }
        shift_in<2 * D + 1>(tr, tt);
        shift_in<D + 1>(pa, __fmul_rn(p, g));
        const int c = j - D;
        if (c >= c0 && c < c1) {
          // x of channel c is xr[s]
          dxp[c * plane] = lrn_dx(pa[0], xr[s], window_sum<D>(tr, hp), hp);
        }
      }
    }
  }
}

template <int D, class S, int MB>
cudaError_t launch_bwd(const float* x, const float* dy, float* dx, int N,
                       int C, int H, int W, int PH, int PW, int chunk,
                       int nchunks, const LrnParams& hp, cudaStream_t s) {
  static bool configured = false;
  if (!configured && S::SMEM > 48 * 1024) {  // above 48 KB: the opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        lrn_pool_bwd_kernel<D, S, MB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::SMEM));
    if (e != cudaSuccess) return e;
  }
  configured = true;
  dim3 grid((W + S::TW - 1) / S::TW, (H + S::TH - 1) / S::TH, N * nchunks);
  lrn_pool_bwd_kernel<D, S, MB><<<grid, S::NT, S::SMEM, s>>>(
      x, dy, dx, C, H, W, PH, PW, chunk, nchunks, hp);
  return cudaGetLastError();
}

template <int D, bool FAST, class S, int MB>
cudaError_t launch_fwd_as(const float* x, float* out, int N, int C, int H,
                          int W, int PH, int PW, int chunk, int nchunks,
                          const LrnParams& hp, cudaStream_t s) {
  int tph, tpw;
  k7_tile<S>(PH, PW, W, &tph, &tpw);
  if (tph == 0) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured && S::SMEM > 48 * 1024) {  // above 48 KB: the opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        lrn_pool_fwd_kernel<D, FAST, S, MB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::SMEM));
    if (e != cudaSuccess) return e;
  }
  configured = true;
  dim3 grid((PW + tpw - 1) / tpw, (PH + tph - 1) / tph, N * nchunks);
  lrn_pool_fwd_kernel<D, FAST, S, MB><<<grid, S::NT, S::SMEM, s>>>(
      x, out, C, H, W, PH, PW, tph, tpw, chunk, nchunks, hp);
  return cudaGetLastError();
}

template <int D, class S, int MB>
cudaError_t launch_fwd(const float* x, float* out, int N, int C, int H, int W,
                       int PH, int PW, int chunk, int nchunks,
                       const LrnParams& hp, cudaStream_t s) {
  if constexpr (D == 2) {  // the FAST kernel exists for D = 2 alone
    if (lrn_fast(D, hp)) {
      return launch_fwd_as<D, true, S, MB>(x, out, N, C, H, W, PH, PW, chunk,
                                           nchunks, hp, s);
    }
  }
  return launch_fwd_as<D, false, S, MB>(x, out, N, C, H, W, PH, PW, chunk,
                                        nchunks, hp, s);
}

template <int D>
cudaError_t launch(const float* x, const float* dy, float* out, int N, int C,
                   int H, int W, int chunk, const LrnParams& hp,
                   cudaStream_t s) {
  const int PH = (H - 3) / 2 + 1, PW = (W - 3) / 2 + 1;
  const int nchunks = (C + chunk - 1) / chunk;
  if (dy == nullptr && W <= K7_NARROW) {
    return launch_fwd<D,
                      K7Shape<K7_G_NARROW, K7_NT_NARROW, K7_PPT_NARROW,
                              K7_IPT_NARROW>,
                      K7_MB_NARROW>(x, out, N, C, H, W, PH, PW, chunk, nchunks,
                                    hp, s);
  } else if (dy == nullptr) {
    return launch_fwd<D,
                      K7Shape<K7_G_WIDE, K7_NT_WIDE, K7_PPT_WIDE, K7_IPT_WIDE>,
                      K7_MB_WIDE>(x, out, N, C, H, W, PH, PW, chunk, nchunks,
                                  hp, s);
  } else if (W <= K8_NARROW) {
    return launch_bwd<D, K8Shape<K8_TH_NARROW, K8_TW_NARROW>, K8_MB_NARROW>(
        x, dy, out, N, C, H, W, PH, PW, chunk, nchunks, hp, s);
  } else {
    return launch_bwd<D, K8Shape<K8_TH_WIDE, K8_TW_WIDE>, K8_MB_WIDE>(
        x, dy, out, N, C, H, W, PH, PW, chunk, nchunks, hp, s);
  }
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
