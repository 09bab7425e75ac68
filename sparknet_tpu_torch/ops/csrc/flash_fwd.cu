// Flash-attention forward for Hopper (sm_90a): float32 in and out, the
// products on the tensor cores in split TF32.
//
// Replaces the Pallas kernel sparknet_tpu/ops/pallas_attention.py:67
// _fwd_kernel (pallas_call at :152 in _fwd_call, behind _flash_core,
// flash_attention and flash_attention_step).  It computes the same
// function: per (batch*head), o = softmax(scale * q k^T + mask) v and
// the row log-sum-exp, with the causal mask taken from ABSOLUTE
// positions (query row r at q_offset + r, key column c at k_offset + c;
// the dense end-aligned convention is q_offset = Tk - Tq, k_offset = 0),
// for every head dim of head_dims.cuh.
// A fully-masked row comes out (o = 0, lse = -inf), never NaN.
//
// Precision.  Both products (s = q k^T and p v) run as three TF32
// mma.sync m16n8k8 products of hi/lo splits (flash_common.cuh), so the
// results keep float32 accuracy; the softmax (max, exp, sums) is float32
// on the CUDA cores.
//
// Design.  The TPU kernel keeps the whole of K/V for one (batch*head) in
// VMEM and makes one pass per q-block.  Here a block owns F_GROUPS x 16
// query rows of one (batch*head) and streams K/V through shared memory in
// stages of F_SPLIT x F_SLICE keys, two stages in flight (cp.async, 16
// bytes a copy, into XOR-swizzled tiles), up to the causal frontier of
// the block's last row.  F_SPLIT warps share each group of 16 rows, each
// taking its own F_SLICE of every stage, with an online softmax of its
// own: per slice it forms s (16 x F_SLICE) in mma accumulators, scales
// and masks it in place, updates its running row max m and sum l, and
// uses the probabilities in place as the A operand of p v into its
// 16 x D partial (no probability tile goes through shared memory).  At
// the end the F_SPLIT partials (m, l, acc) of a group are merged through
// shared memory in split order: o = sum_s acc_s e^(m_s - M) / sum_s l_s
// e^(m_s - M) with M the largest m_s.  One owner per output row and a
// fixed merge order: no atomics, and two launches give the same bits.
// The group's q fragments are split into hi/lo once and kept in shared
// memory.  Blocks are numbered heaviest first under the causal mask (the
// last query tiles walk the most keys), so the long ones start before
// the short ones fill the card.  Inputs are read through their (B, T, H,
// D) strides: every row must start on 16 bytes (the wrapper checks);
// rows past T load as zeros and a ragged T_q is masked in place, nothing
// is padded in memory.
// Two groups of 16 rows a block, four warps a group, 16-key slices (64
// keys a stage) were the fastest at the LM training shape of the shapes
// sparknet_tpu_torch/tools/flash_fwd_tiles.py times (PERF.md §6).
// Above D = 128 (flash_common.cuh out_halves) a block writes one half of
// o's columns: its warps form s over the full D as below but keep a
// 16 x D/2 partial of p v, from V tiles of that half only; slices of 8
// keys (32 a stage) keep the q fragments and two stages of K and V
// inside shared memory (161 KB at D = 256).  Both halves run the same
// code on the same s, so their m and l agree; half 0 writes lse.
//
// Bound on this card.  At the LM training shape (B=8, T=256, H=4, D=64,
// causal) the two products are ~0.27 GFLOP of float32 work, 0.81 GFLOP of
// TF32 work as three passes (~1.6 us at 495 TFLOP/s), and q, k, v, o move
// ~8.4 MB (~2.5 us at 3.35 TB/s): bytes bound it at the card's peaks.  At
// the serving prefill shape (B=1, T=128, H=4) the call moves ~0.5 MB and
// is bound by launch latency and by the longest block's chain of stages.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "head_dims.cuh"

namespace {

// A block owns F_GROUPS x 16 query rows; F_SPLIT warps share each group
// of 16 rows; every stage holds F_SPLIT x F_SLICE keys, each of those
// warps taking its own F_SLICE of them.
constexpr int F_GROUPS = 2;
constexpr int F_SPLIT = 4;
constexpr int F_SLICE = 16;
constexpr int F_ROWS = 16 * F_GROUPS;
constexpr int F_NT = 32 * F_GROUPS * F_SPLIT;
static_assert(F_SLICE % 8 == 0, "slices of 8-key tiles");

// keys of a warp's slice and of a stage at head dim D
template <int D>
__host__ __device__ constexpr int f_slice() {
  return out_halves<D>() > 1 ? 8 : F_SLICE;
}
template <int D>
__host__ __device__ constexpr int f_stage() {
  return F_SPLIT * f_slice<D>();
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;    // (B, Tq, H, D) contiguous
  float* lse;  // (B, H, Tq) contiguous
  int BH, H, Tq, Tk;
  // element strides along (b, t, h) of q, k, v; unit along D
  long long sq[3], sk[3], sv[3];
  int q_offset, k_offset, causal;
  float scale;
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(uint4) * 2 * F_GROUPS * (D / 8) * 32 +
         sizeof(float) * (2 * f_stage<D>() * (D + D / out_halves<D>()) +
                          F_GROUPS * F_SPLIT * 32);
}

template <int D>
__global__ void __launch_bounds__(F_NT, 1) flash_fwd_kernel(const Args a) {
  constexpr int NH = out_halves<D>();
  constexpr int DH = D / NH;       // o's columns this block writes
  constexpr int KS = D / 8;        // 8-deep steps over the head dim
  constexpr int KO = DH / 8;       // 8-column groups of the partial
  constexpr int SLICE = f_slice<D>();
  constexpr int STAGE = f_stage<D>();
  constexpr int NK = SLICE / 8;    // 8-key column groups of a slice
  constexpr int TILE = STAGE * D;  // a stage of K
  constexpr int VTILE = STAGE * DH;  // a stage of V's half
  constexpr int FR = F_GROUPS * KS * 32;
  static_assert(F_GROUPS * F_SPLIT * KO * 32 * 4 <= 2 * (TILE + VTILE),
                "the partials fit in the stages");
  extern __shared__ uint4 smem4[];
  uint4* Qh = smem4;  // [group][KS][lane] q fragments, hi and lo
  uint4* Ql = Qh + FR;
  float* Ks = reinterpret_cast<float*>(Ql + FR);  // [2][TILE]
  float* Vs = Ks + 2 * TILE;                      // [2][VTILE]
  float* ML = Vs + 2 * VTILE;  // [group][split][m of 16 rows, l of 16 rows]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / F_SPLIT, split_id = warp % F_SPLIT;
  const int Tq = a.Tq, Tk = a.Tk;
  const int n_qt = (Tq + F_ROWS - 1) / F_ROWS;
  const int half = static_cast<int>(blockIdx.x) % NH;
  const int rest = static_cast<int>(blockIdx.x) / NH;
  const int bh = rest % a.BH;
  const int q0 = (n_qt - 1 - rest / a.BH) * F_ROWS;
  const int b = bh / a.H, h = bh % a.H;

  const float* qb = a.q + b * a.sq[0] + h * a.sq[2];
  const float* kb = a.k + b * a.sk[0] + h * a.sk[2];
  // this block's half of v's columns (16-byte aligned: DH is a multiple
  // of 16)
  const float* vb = a.v + b * a.sv[0] + h * a.sv[2] + half * DH;

  // keys [0, k_end) are visible to at least one real row of this block
  int k_end = Tk;
  if (a.causal) {
    const int last = min(q0 + F_ROWS, Tq) - 1;
    k_end = max(0, min(Tk, a.q_offset + last - a.k_offset + 1));
  }
  const int n_st = (k_end + STAGE - 1) / STAGE;
  if (n_st > 0) {
    load_tile<D, STAGE, F_NT>(Ks, kb, a.sk[1], 0, Tk);
    load_tile<DH, STAGE, F_NT>(Vs, vb, a.sv[1], 0, Tk);
  }
  cp_async_commit();

  // this group's rows ra, rb: q fragments (written by the group's first
  // warp, presplit)
  const int ra = q0 + group * 16 + g, rb = ra + 8;
  const bool ina = ra < Tq, inb = rb < Tq;
  const int f = group * KS * 32 + lane;
  if (split_id == 0) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      store_a(Qh + f + ks * 32, Ql + f + ks * 32,
              a_from_global(qb, a.sq[1], ra, rb, ina, inb, ks * 8 + t));
    }
  }
  const int pos_a = a.q_offset + ra, pos_b = a.q_offset + rb;

  // this warp's online softmax: the running max and (this lane's share
  // of) the running sum of rows ra, rb, and its 16 x DH partial of p v
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  float acc[KO][4];
#pragma unroll
  for (int i = 0; i < KO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_st; ++j) {
    if (j + 1 < n_st) {
      const int nxt = (j + 1) & 1;
      load_tile<D, STAGE, F_NT>(Ks + nxt * TILE, kb, a.sk[1], (j + 1) * STAGE, Tk);
      load_tile<DH, STAGE, F_NT>(Vs + nxt * VTILE, vb, a.sv[1], (j + 1) * STAGE,
                                 Tk);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // stage j (and the q fragments) are in for every thread
    const int k_lo = j * STAGE + split_id * SLICE;  // this warp's keys
    if (k_lo < k_end) {
      // the slice's rows keep their swizzle: SLICE is a multiple of 8
      const float* K = Ks + (j & 1) * TILE + split_id * SLICE * D;
      const float* V = Vs + (j & 1) * VTILE + split_id * SLICE * DH;
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const Frag<4> qa = load_a(Qh + f + ks * 32, Ql + f + ks * 32);
#pragma unroll
        for (int n = 0; n < NK; ++n)
          mma3(s[n], qa, b_rowwise<D>(K, n * 8 + g, ks * 8 + t));
      }

      // scale and mask in place; the slice's row maxima
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k_lo + n * 8 + 2 * t + (e & 1);
          const bool ok = col < Tk && (!a.causal ||
                                       a.k_offset + col <= (e < 2 ? pos_a : pos_b));
          s[n][e] = ok ? s[n][e] * a.scale : -CUDART_INF_F;
          if (e < 2) {
            mx_a = fmaxf(mx_a, s[n][e]);
          } else {
            mx_b = fmaxf(mx_b, s[n][e]);
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a row with nothing visible yet keeps exp() away from -inf - -inf
      const float mu_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
      const float mu_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
      const float al_a = expf(m_a - mu_a), al_b = expf(m_b - mu_b);
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - (e < 2 ? mu_a : mu_b));
          if (e < 2) {
            ps_a += s[n][e];
          } else {
            ps_b += s[n][e];
          }
        }
      l_a = l_a * al_a + ps_a;
      l_b = l_b * al_b + ps_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int dn = 0; dn < KO; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn][e] *= e < 2 ? al_a : al_b;

      // acc += p v
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const Frag<4> pa = acc_as_a(s[kk]);
#pragma unroll
        for (int dn = 0; dn < KO; ++dn)
          mma3(acc[dn], pa, b_colwise<DH>(V, kk * 8 + 2 * t, dn * 8 + g));
      }
    }
    __syncthreads();  // stage j & 1 is free for stage j + 2
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(FULL, l_a, off);
    l_b += __shfl_xor_sync(FULL, l_b, off);
  }

  // the group's F_SPLIT partials, merged in split order: each warp merges
  // and stores every F_SPLIT-th 8-column group of o
  float4* part = reinterpret_cast<float4*>(Ks);  // [group][split][KO][lane]
  float4* mine = part + (group * F_SPLIT + split_id) * KO * 32 + lane;
#pragma unroll
  for (int dn = 0; dn < KO; ++dn)
    mine[dn * 32] = make_float4(acc[dn][0], acc[dn][1], acc[dn][2], acc[dn][3]);
  if (t == 0) {
    float* ml = ML + (group * F_SPLIT + split_id) * 32;
    ml[g] = m_a;
    ml[g + 8] = m_b;
    ml[16 + g] = l_a;
    ml[16 + g + 8] = l_b;
  }
  __syncthreads();
  const float* gml = ML + group * F_SPLIT * 32;
  float M_a = -CUDART_INF_F, M_b = -CUDART_INF_F;
#pragma unroll
  for (int sp = 0; sp < F_SPLIT; ++sp) {
    M_a = fmaxf(M_a, gml[sp * 32 + g]);
    M_b = fmaxf(M_b, gml[sp * 32 + g + 8]);
  }
  const float Mu_a = M_a == -CUDART_INF_F ? 0.f : M_a;
  const float Mu_b = M_b == -CUDART_INF_F ? 0.f : M_b;
  float w_a[F_SPLIT], w_b[F_SPLIT];
  float L_a = 0.f, L_b = 0.f;
#pragma unroll
  for (int sp = 0; sp < F_SPLIT; ++sp) {
    w_a[sp] = expf(gml[sp * 32 + g] - Mu_a);
    w_b[sp] = expf(gml[sp * 32 + g + 8] - Mu_b);
    L_a += gml[sp * 32 + 16 + g] * w_a[sp];
    L_b += gml[sp * 32 + 16 + g + 8] * w_b[sp];
  }
  const float d_a = fmaxf(L_a, 1e-30f), d_b = fmaxf(L_b, 1e-30f);
  const float4* first = part + group * F_SPLIT * KO * 32 + lane;
  for (int dn = split_id; dn < KO; dn += F_SPLIT) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < F_SPLIT; ++sp) {
      const float4 x = first[(sp * KO + dn) * 32];
      sum.x = fmaf(x.x, w_a[sp], sum.x);
      sum.y = fmaf(x.y, w_a[sp], sum.y);
      sum.z = fmaf(x.z, w_b[sp], sum.z);
      sum.w = fmaf(x.w, w_b[sp], sum.w);
    }
    const int c = half * DH + dn * 8 + 2 * t;
    if (ina)
      *reinterpret_cast<float2*>(
          a.o + ((static_cast<long long>(b) * Tq + ra) * a.H + h) * D + c) =
          make_float2(sum.x / d_a, sum.y / d_a);
    if (inb)
      *reinterpret_cast<float2*>(
          a.o + ((static_cast<long long>(b) * Tq + rb) * a.H + h) * D + c) =
          make_float2(sum.z / d_b, sum.w / d_b);
  }
  if (half == 0 && split_id == 0 && t == 0) {
    const long long li = static_cast<long long>(bh) * Tq;
    if (ina) a.lse[li + ra] = L_a > 0.f ? Mu_a + logf(L_a) : -CUDART_INF_F;
    if (inb) a.lse[li + rb] = L_b > 0.f ? Mu_b + logf(L_b) : -CUDART_INF_F;
  }
}

template <int D>
cudaError_t launch(Args a, int B, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  static bool configured = false;
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, smem, &configured);
  if (e != cudaSuccess) return e;
  a.BH = B * a.H;
  const int blocks = (a.Tq + F_ROWS - 1) / F_ROWS * a.BH * out_halves<D>();
  if (blocks == 0) return cudaSuccess;
  flash_fwd_kernel<D><<<blocks, F_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D) with unit stride along D, every
// (b, t, h) row starting on 16 bytes, and the given element strides for
// b, t, h; o (B, Tq, H, D) contiguous; lse (B, H, Tq) contiguous.  Returns
// the cudaError_t of the launch.
extern "C" int sparknet_flash_fwd_f32(
    const float* q, const float* k, const float* v, float* o, float* lse,
    int B, int H, int Tq, int Tk, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    int q_offset, int k_offset, int causal, float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.BH = 0;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  const long long st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = st[i];
    a.sk[i] = st[3 + i];
    a.sv[i] = st[6 + i];
  }
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(d) \
  case d:          \
    return launch<d>(a, B, s);
  switch (D) {
    FLASH_HEAD_DIMS(LAUNCH)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
