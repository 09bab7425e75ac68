// Decode attention (one query position), float32, for Hopper (sm_90a).
//
// Replaces the Pallas kernel sparknet_tpu/ops/pallas_attention.py:320
// _decode_kernel (pallas_call at :387, behind decode_attention :358).
// It computes the same function: for each (b, h), the single query
// q[b, 0, h] attends over the gathered context k/v[b, :, h] where only
// the first lengths[b] positions are valid; the rest are masked.
//
// Design.  One block per (b, h), 8 warps.  The warps split the valid
// positions (warp w takes positions w, w + 8, ...); a warp reads one
// key row at a time with its 32 lanes across D (coalesced), reduces the
// dot product with shuffles, and keeps its own running max, sum and
// output slice (ceil(D/32) values per lane; at D = 16 or 48 the last of
// them idles on half the lanes) in registers, in fp32.  Built for every
// head dim of head_dims.cuh.  Positions
// at or past lengths[b] are never read.  At the end the 8 partial
// softmax states are merged through shared memory.  The TPU kernel
// masks a whole static S with a select; here the loop simply stops at
// the length, so the bytes read follow the data.
//
// Bound on this card.  At the serving shape (B=8 slots, S=256, H=4,
// D=64) a step reads at most 2 x 8 x 256 x 4 x 64 x 4 B = 4.2 MB of K
// and V, about 1.3 us at 3.35 TB/s, and does ~4 MFLOP: the call is
// bound by launch latency at these sizes, then by bytes.  Reading the
// paged arena through the block table (instead of the caller's gathered
// copy) and a CUDA graph around the decode step are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "head_dims.cuh"

namespace {

constexpr int NW = 8;  // warps per block
constexpr unsigned FULL = 0xffffffffu;

template <int D>
__global__ void __launch_bounds__(NW * 32) decode_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ o, int H, int S,
    long long sqb, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, float scale) {
  constexpr int DPL = (D + 31) / 32;  // elements of D per lane
  __shared__ float sm_m[NW];
  __shared__ float sm_l[NW];
  __shared__ float sm_acc[NW][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int n = max(0, min(lengths[b], S));

  const float* qp = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  float qv[DPL], acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    qv[e] = lane + 32 * e < D ? qp[lane + 32 * e] : 0.f;
    acc[e] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  for (int t = w; t < n; t += NW) {
    const float* kp = kb + t * sks;
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (lane + 32 * e < D) part = fmaf(qv[e], kp[lane + 32 * e], part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(FULL, part, off);
    const float s = part * scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);  // 0 on the first position
    const float p = expf(s - m_new);
    l = l * alpha + p;
    const float* vp = vb + t * svs;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (lane + 32 * e < D) acc[e] = fmaf(p, vp[lane + 32 * e], acc[e] * alpha);
    m = m_new;
  }

  if (lane == 0) {
    sm_m[w] = m;
    sm_l[w] = l;
  }
#pragma unroll
  for (int e = 0; e < DPL; ++e)
    if (lane + 32 * e < D) sm_acc[w][lane + 32 * e] = acc[e];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += NW * 32) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < NW; ++i) mx = fmaxf(mx, sm_m[i]);
    float sum = 0.f, out = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      // a warp that saw no position contributes nothing
      const float c = (sm_m[i] == -CUDART_INF_F) ? 0.f : expf(sm_m[i] - mx);
      sum += sm_l[i] * c;
      out += sm_acc[i][d] * c;
    }
    o[static_cast<long long>(bh) * D + d] = (sum > 0.f) ? out / sum : 0.f;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, float* o, int B, int H, int S,
                   long long sqb, long long sqh, long long skb,
                   long long sks, long long skh, long long svb,
                   long long svs, long long svh, float scale,
                   cudaStream_t stream) {
  decode_kernel<D><<<B * H, NW * 32, 0, stream>>>(
      q, k, v, lengths, o, H, S, sqb, sqh, skb, sks, skh, svb, svs, svh,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D); k and v (B, S, H, D), unit stride along D and the
// given element strides; lengths (B,) int32 on the device; o (B, 1, H,
// D) contiguous.  Returns the cudaError_t of the launch.
extern "C" int sparknet_decode_attention_f32(
    const float* q, const float* k, const float* v, const int* lengths,
    float* o, int B, int S, int H, int D,
    long long sqb, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(d)                                                         \
  case d:                                                                 \
    return launch<d>(q, k, v, lengths, o, B, H, S, sqb, sqh, skb, sks, skh, \
                     svb, svs, svh, scale, s);
  switch (D) {
    FLASH_HEAD_DIMS(LAUNCH)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
