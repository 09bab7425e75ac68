// Decode attention (one query position) over the paged KV arena, float32,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel sparknet_tpu/ops/pallas_attention.py:320
// _decode_kernel (pallas_call at :387, behind decode_attention :358).
// It computes the same function,
//   o[b, h] = softmax_{j < lengths[b]}(q[b, h] . k_j * scale) . v_j,
// but reads k_j and v_j where they live: position j of slot b is row
// table[b, j / bs] * bs + j % bs of one layer's (rows, H, DP) arena, so
// no gathered copy of the context is made.  The gathered entry point
// (ops/cuda_attention.py decode_attention) runs this same kernel on a
// (B, S, H, D) context seen as B blocks of S rows with the identity
// table.
//
// Bound on this card.  The function moves the valid keys and values
// once: at the serving shape (8 slots, H=4, D=64, 1021 valid positions
// in chip_smoke.py) 2.1 MB, 0.63 us at 3.35 TB/s, and does 0.5 MFLOP.
// That little work is bound by latency: the launch, then a chain of
// dependent loads (the length, the table, K) and the merge of the
// splits.
//
// Design.
// - A grid over (sequence split, slot, head): a split is SPLIT
//   consecutive positions (whole KV blocks when the block size divides
//   SPLIT, as the serving arena's 16 does), so a 256-position context
//   runs on 256 / SPLIT CTAs per (slot, head), not one.  The grid is
//   sized from the table's width, never from the lengths, so the host
//   reads nothing back; splits at or past lengths[b] leave after reading
//   the length.
// - Each CTA stages its split's V rows into shared memory with 16-byte
//   cp.async, and reads K meanwhile: a key's D floats are split over TPK
//   neighbouring lanes (1 up to D = 64, 2 up to 128, 4 above), each lane
//   holding its slice's 16-byte loads in flight at once and dotting them
//   with q (in shared memory, zero past the true head dim) in four
//   independent FMA chains.  Every key of the split is scored in the
//   same pass; the only shuffles are the TPK - 1 that join a key's
//   slices.
// - One max and one sum per split (fixed butterfly and warp order), then
//   p . V from shared memory: threads across D's 16-byte columns, key
//   groups summed in group order.
// - A split that is its slot's only one writes o directly.  Otherwise
//   each split writes its partial (m, l, acc) to a workspace, and the
//   partials of a (slot, head) are joined in split order: by the CTA that
//   draws the last ticket (MERGE_IN_KERNEL 1, as K9's slice reductions
//   do; it resets the ticket for the next launch) or by a second launch
//   (0).  The order is fixed, so two launches on the same inputs give the
//   same bits.
// - Built for every head dim of head_dims.cuh (DP).  The arena's rows
//   are DP wide; the true head dim d <= DP is a runtime value: q is read
//   and o written only below d, so a pool kept at DP with its pad columns
//   zero serves any d without a copy.  A length of 0 gives o = 0.
// tools/decode_tiles.py sweeps SPLIT, NT and MERGE_IN_KERNEL.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "head_dims.cuh"

namespace {

constexpr int SPLIT = 64;           // positions a CTA takes
constexpr int NT = 128;             // threads a CTA
constexpr int MERGE_IN_KERNEL = 1;  // 1: the last ticket merges; 0: a second launch
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* table;
  const int* lengths;
  float* o;        // (B, H, d)
  float* acc;      // (B, H, nsplit, DP) partial outputs
  float* ml;       // (B, H, nsplit, 2) partial max and sum
  unsigned* tickets;  // (B, H), zero between launches
  int H, d, max_blocks, block_size, nsplit;
  long long sqb, sqh;            // q's slot and head strides
  long long skb, skr, skh;       // k's block, row-in-block and head strides
  long long svb, svr, svh;
  long long stb;                 // the table's slot stride
  float scale;
};

template <int DP>
struct Tile {
  static constexpr int TPK = DP <= 64 ? 1 : (DP <= 128 ? 2 : 4);  // lanes a key
  static constexpr int SL4 = DP / TPK / 4;  // 16-byte loads of a lane's slice
  static constexpr int C4 = DP / 4;         // 16-byte columns of a row
  static constexpr int G = NT >= C4 ? NT / C4 : 1;  // key groups of p . V
  static constexpr int KPT = (SPLIT * TPK + NT - 1) / NT;  // keys a lane
  static constexpr int DPT = (DP + NT - 1) / NT;  // columns a thread merges
};

__host__ __device__ __forceinline__ int splits_for(int positions) {
  return (positions + SPLIT - 1) / SPLIT;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// positions of slot b that are read: lengths[b], within the table's width
__device__ __forceinline__ int valid_length(const Args& a, int b) {
  return max(0, min(a.lengths[b], a.max_blocks * a.block_size));
}

// One value a thread -> the block's max or sum, the same in every thread:
// a butterfly within each warp, then the warps' values in warp order.
template <bool MAX>
__device__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(FULL, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// o of (b, h) from its nact partials, joined in split order; every load
// of a split is issued before its state is joined.  The partials were
// written by other CTAs: read them from L2 (ld.global.cg).
template <int DP>
__device__ void merge(const Args& a, long long bh, int nact) {
  using T = Tile<DP>;
  const float* ml = a.ml + bh * a.nsplit * 2;
  const float* acc = a.acc + bh * a.nsplit * DP;
  float m = -CUDART_INF_F, l = 0.f, out[T::DPT];
#pragma unroll
  for (int e = 0; e < T::DPT; ++e) out[e] = 0.f;
#pragma unroll 4
  for (int s = 0; s < nact; ++s) {
    const float ms = __ldcg(ml + 2 * s), ls = __ldcg(ml + 2 * s + 1);
    float as[T::DPT];
#pragma unroll
    for (int e = 0; e < T::DPT; ++e) {
      const int d = threadIdx.x + e * NT;
      as[e] = d < a.d ? __ldcg(acc + (long long)s * DP + d) : 0.f;
    }
    const float mx = fmaxf(m, ms);  // ms is finite: a split has a key
    const float c0 = expf(m - mx), c1 = expf(ms - mx);  // c0 0 at first
    l = l * c0 + ls * c1;
#pragma unroll
    for (int e = 0; e < T::DPT; ++e) out[e] = out[e] * c0 + as[e] * c1;
    m = mx;
  }
#pragma unroll
  for (int e = 0; e < T::DPT; ++e) {
    const int d = threadIdx.x + e * NT;
    if (d < a.d) a.o[bh * a.d + d] = out[e] / l;
  }
}

template <int DP>
__global__ void __launch_bounds__(NT) paged_decode_kernel(Args a) {
  using T = Tile<DP>;
  extern __shared__ float4 v_s4[];  // the split's V rows, SPLIT x DP
  __shared__ float4 q_s4[DP / 4];
  __shared__ float p_s[SPLIT];
  __shared__ long long koff_s[SPLIT], voff_s[SPLIT];
  __shared__ float max_s[NW], sum_s[NW];
  __shared__ float4 gacc_s4[T::G * DP / 4];
  __shared__ int last_s;

  const int s = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long bh = (long long)b * a.H + h;
  const int n = valid_length(a, b);
  const int nact = (n + SPLIT - 1) / SPLIT;
  if (nact == 0) {  // an empty context
    if (s == 0)
      for (int d = tid; d < a.d; d += NT) a.o[bh * a.d + d] = 0.f;
    return;
  }
  if (s >= nact) return;  // past the length: nothing to read
  const int j0 = s * SPLIT;
  const int cnt = min(SPLIT, n - j0);

  // where each position of the split lives, from the block table
  for (int j = tid; j < cnt; j += NT) {
    const int pos = j0 + j;
    const long long blk = a.table[b * a.stb + pos / a.block_size];
    const long long in = pos % a.block_size;
    koff_s[j] = blk * a.skb + in * a.skr + h * a.skh;
    voff_s[j] = blk * a.svb + in * a.svr + h * a.svh;
  }
  float* q_s = reinterpret_cast<float*>(q_s4);
  const float* qp = a.q + b * a.sqb + h * a.sqh;
  for (int d = tid; d < DP; d += NT) q_s[d] = d < a.d ? qp[d] : 0.f;
  __syncthreads();

  // V into shared memory, 16 bytes a copy, while K is read below
  float* v_s = reinterpret_cast<float*>(v_s4);
  for (int i = tid; i < cnt * T::C4; i += NT) {
    const int j = i / T::C4, c = i % T::C4;
    cp_async16(v_s + j * DP + 4 * c, a.v + voff_s[j] + 4 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // every key's score in one pass, TPK neighbouring lanes a key
  float sc[T::KPT], x = -CUDART_INF_F;
#pragma unroll
  for (int it = 0; it < T::KPT; ++it) {
    const int item = w * 32 + it * NT + lane;
    const int j = item / T::TPK, part = item % T::TPK;
    float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < cnt) {
      const float4* kp =
          reinterpret_cast<const float4*>(a.k + koff_s[j]) + part * T::SL4;
      const float4* qq = q_s4 + part * T::SL4;
      float4 kv[T::SL4];
#pragma unroll
      for (int e = 0; e < T::SL4; ++e) kv[e] = __ldg(kp + e);
#pragma unroll
      for (int e = 0; e < T::SL4; ++e) {  // four chains, not one
        const float4 qv = qq[e];
        dot.x = fmaf(qv.x, kv[e].x, dot.x);
        dot.y = fmaf(qv.y, kv[e].y, dot.y);
        dot.z = fmaf(qv.z, kv[e].z, dot.z);
        dot.w = fmaf(qv.w, kv[e].w, dot.w);
      }
    }
    float dj = (dot.x + dot.y) + (dot.z + dot.w);
#pragma unroll
    for (int off = 1; off < T::TPK; off <<= 1)
      dj += __shfl_xor_sync(FULL, dj, off);
    sc[it] = dj * a.scale;
    if (part == 0 && j < cnt) x = fmaxf(x, sc[it]);
  }

  // one max and one sum for the split, and each key's p
  const float m = block_reduce<true>(x, max_s);
  x = 0.f;
#pragma unroll
  for (int it = 0; it < T::KPT; ++it) {
    const int item = w * 32 + it * NT + lane;
    const int j = item / T::TPK;
    if (item % T::TPK == 0 && j < cnt) {
      const float p = expf(sc[it] - m);
      p_s[j] = p;
      x += p;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  const float l = block_reduce<false>(x, sum_s);  // its barrier publishes V, p

  // p . V: threads across D's 16-byte columns, G groups of keys
  for (int i = tid; i < T::G * T::C4; i += NT) {
    const int c = i % T::C4, g = i / T::C4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = g; j < cnt; j += T::G) {
      const float p = p_s[j];
      const float4 vv = v_s4[j * T::C4 + c];
      acc.x = fmaf(p, vv.x, acc.x);
      acc.y = fmaf(p, vv.y, acc.y);
      acc.z = fmaf(p, vv.z, acc.z);
      acc.w = fmaf(p, vv.w, acc.w);
    }
    gacc_s4[i] = acc;
  }
  __syncthreads();

  // the split's output: its key groups summed in group order; alone, it
  // is o, else a partial
  const float* gacc = reinterpret_cast<const float*>(gacc_s4);
  float* part = nact == 1 ? a.o + bh * a.d : a.acc + (bh * a.nsplit + s) * DP;
  for (int d = tid; d < a.d; d += NT) {
    float y = 0.f;
#pragma unroll
    for (int g = 0; g < T::G; ++g) y += gacc[g * DP + d];
    part[d] = nact == 1 ? y / l : y;
  }
  if (nact == 1) return;
  if (tid == 0) {
    a.ml[(bh * a.nsplit + s) * 2] = m;
    a.ml[(bh * a.nsplit + s) * 2 + 1] = l;
  }
  if (!MERGE_IN_KERNEL) return;
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the partial is visible before the ticket is drawn
    last_s = atomicAdd(a.tickets + bh, 1u) == (unsigned)(nact - 1);
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  merge<DP>(a, bh, nact);
  if (tid == 0) a.tickets[bh] = 0;  // ready for the next launch
}

// The second launch of MERGE_IN_KERNEL 0: one CTA per (slot, head).
template <int DP>
__global__ void __launch_bounds__(NT) paged_decode_merge_kernel(Args a) {
  const int nact = (valid_length(a, blockIdx.x / a.H) + SPLIT - 1) / SPLIT;
  if (nact > 1) merge<DP>(a, blockIdx.x, nact);
}

template <int DP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int vbytes = SPLIT * DP * static_cast<int>(sizeof(float));
  static bool attr = false;  // V above 48 KB needs the opt-in, once
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        vbytes);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  paged_decode_kernel<DP>
      <<<dim3(a.nsplit, B, a.H), NT, vbytes, stream>>>(a);
  if (!MERGE_IN_KERNEL)
    paged_decode_merge_kernel<DP><<<B * a.H, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace a launch needs for contexts of up to `positions`
// (max_blocks * block_size) at head dim dp.
extern "C" int sparknet_paged_decode_workspace(int B, int H, int dp,
                                               int positions) {
  return B * H * splits_for(positions) * (dp + 2);
}

// q (B, 1, H, d) with unit stride along d; k and v: position j of slot b
// at k + table[b * stb + j / block_size] * skb + (j % block_size) * skr
// + h * skh, DP floats with unit stride, 16-byte aligned; table (B,
// max_blocks) and lengths (B,) int32 on the device; o (B, 1, H, d)
// contiguous; work as sparknet_paged_decode_workspace says; tickets
// B * H zeros.  Returns the cudaError_t of the launch.
extern "C" int sparknet_paged_decode_f32(
    const float* q, const float* k, const float* v, const int* table,
    const int* lengths, float* o, float* work, unsigned* tickets, int B,
    int H, int d, int dp, int max_blocks, int block_size, long long sqb,
    long long sqh, long long skb, long long skr, long long skh,
    long long svb, long long svr, long long svh, long long stb, float scale,
    void* stream) {
  const int nsplit = splits_for(max_blocks * block_size);
  const long long parts = static_cast<long long>(B) * H * nsplit;
  Args a{q,   k,   v,   table, lengths, o,   work, work + parts * dp,
         tickets, H, d, max_blocks, block_size, nsplit,
         sqb, sqh, skb, skr, skh, svb, svr, svh, stb, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(D) \
  case D:         \
    return launch<D>(a, B, s);
  switch (dp) {
    FLASH_HEAD_DIMS(LAUNCH)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
