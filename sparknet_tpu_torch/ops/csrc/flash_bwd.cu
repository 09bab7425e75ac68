// Flash-attention backward for Hopper (sm_90a): dq and dk/dv, float32 in
// and out, the products on the tensor cores in split TF32.
//
// Replaces the two Pallas kernels of _flash_core_bwd
// (sparknet_tpu/ops/pallas_attention.py:188):
//   K3 _bwd_dq_kernel  (:91,  pallas_call at :200) -> flash_bwd_dq_kernel
//   K4 _bwd_dkv_kernel (:119, pallas_call at :218) -> flash_bwd_dkv_kernel
// with the JAX package's formulas, per (batch*head), for every head dim of
// head_dims.cuh:
//   s     = scale * q k^T, causal mask from ABSOLUTE positions (query row
//           r at q_offset + r, key column c at k_offset + c)
//   p     = exp(s - lse_safe), lse_safe = 0 on rows whose lse is -inf
//   delta = rowsum(do * o) - dlse
//   ds    = p * (do v^T - delta) * scale
//   dq    = ds k          (K3)
//   dv    = p^T do,  dk = ds^T q   (K4)
// Masked entries give p = 0 exactly, so a fully-masked row contributes
// nothing and never produces NaN.
//
// Precision.  Every product runs as three TF32 mma.sync m16n8k8 products
// of hi/lo splits (flash_common.cuh), so the results keep float32
// accuracy: at the training shape they lie ~1e-6 of the output's
// magnitude from the plain float32 version, where one TF32 pass would lie
// ~5e-4 away (tests/test_torch_flash_bwd.py emulates both).
//
// Design.  On the TPU, the dq kernel is gridded per q-block and the
// dk/dv kernel per (batch*head) with all of T_q and T_k in VMEM.  Here
// both loop over stages of tiles, and each output tile is owned by exactly
// one block: no atomics, so both stay deterministic, as the TPU's split
// into two kernels is.  At the training shape there are only 512 warps'
// worth of 16-row tiles, and under the causal mask the last query tile
// (K3) or first key tile (K4) walks all 256 keys or queries: one warp per
// 16 rows leaves ~1 warp per scheduler, each waiting on its own chain of
// mma.sync (measured slower than float32 on the CUDA cores).  So
// every group of 16 rows is shared by SPLIT warps, each taking its own
// SLICE of every stage, and the partial sums are added at the end in
// split order through shared memory (deterministic):
//   K3: one block per (batch*head, 16 query rows), 4 warps (128
//       threads, two blocks a SM), stages of 4 x 8 keys.  The group's q and do
//       fragments are split once into hi/lo and kept in shared memory;
//       delta and lse_safe of its rows stay in registers.  K/V stages
//       stream through two buffers with cp.async (16 bytes a copy), the
//       next in flight while the current one computes, up to the causal
//       frontier of the block's last row.  Per slice a warp forms s and
//       dp (16 x 8) in mma accumulators, turns them into ds in place,
//       and multiplies ds by the slice of K into its 16 x D dq partial.
//   K4: one block per (batch*head, 2 x 16 key rows), 4 warps per group
//       (2 at D = 128, for shared memory), stages of 4 x 16 q/do/o rows
//       from the first query that sees the block's keys.  The block
//       computes the stage's delta, then each warp forms s^T and dp^T (16
//       keys x 16 queries), turns them into p^T and ds^T, and adds p^T do
//       to its dv partial and ds^T q to its dk partial.  Slices that none
//       of the group's keys can see are skipped.
// (sparknet_tpu_torch/tools/flash_bwd_tiles.py times other groups,
// splits and slices.)
// Above D = 128 (flash_common.cuh out_halves) a block writes one half of
// the columns of its output: K3 a half of dq, forming s and dp over the
// full D as above into a 16 x D/2 partial (its stages of K and V full
// width, 192 KB of shared memory at D = 256, one block a SM); K4 one
// half of dk and of dv, so that a warp keeps two 16 x D/2 accumulators,
// as it keeps dk and dv at D = 128, and forms s^T and dp^T over the full
// D once per half: one group of 16 keys a block, WIDE_K_SPLIT warps of
// 8-query slices, o's stages in one buffer (224 KB at D = 256).  Every block of a row or key tile
// forms s (and dp) over the full D in the same order, so the halves
// agree on p bit for bit.
// No score tile goes through shared memory: the accumulator layout of
// m16n8k8 (thread (g, t) holds columns 2t, 2t+1 of rows g, g+8) is
// taken as an A operand whose k slots t and t+4 stand for columns 2t and
// 2t+1, and the B operand is read with the same permutation.  Shared
// tiles are unpadded rows of D floats with 16-byte chunks XOR-swizzled
// by the row (flash_common.cuh), so the row-wise B reads (k^T, v^T, q^T,
// do^T) and the column-wise ones (k, q, do) spread over the banks.  Blocks are numbered heaviest first under
// the causal mask (K3's last query tiles, K4's first key tiles), so the
// long ones start before the short ones fill the card.  Inputs are read
// through their (B, T, H, D) strides: every row must start on 16 bytes
// (the wrapper checks), rows past T load as zeros, nothing is padded
// in memory.
//
// Bound on this card.  At the training shape (B=8, T=256, H=4, D=64,
// causal) K3 does three causal products (s, do v^T, ds k) and K4 four
// (s, do v^T, p^T do, ds^T q): ~0.40 and ~0.54 GFLOP, 1.2 and 1.6 GFLOP
// of TF32 work as three passes, which the tensor cores do in ~2.4 and
// ~3.3 us (495 TFLOP/s); each moves ~13-15 MB (~4 us at 3.35 TB/s).  So
// both are bound by bytes at the card's peaks; in practice by the latency
// of the longest block's chain of stages and by mma.sync, which issues
// at well below the rate of Hopper's warpgroup wgmma.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "head_dims.cuh"

namespace {

// K3: a block owns Q_GROUPS x 16 query rows.  Q_SPLIT warps share each
// group of 16 rows; every stage holds Q_SPLIT x Q_SLICE keys, and each of
// those warps takes its own Q_SLICE of them.  Their dq partials are summed
// in a fixed order at the end.  Two blocks a SM (registers held to 255 a
// thread at 128 threads).
constexpr int Q_GROUPS = 1;
constexpr int Q_SPLIT = 4;
constexpr int Q_SLICE = 8;
constexpr int Q_ROWS = 16 * Q_GROUPS;
constexpr int Q_STAGE = Q_SPLIT * Q_SLICE;
constexpr int Q_NT = 32 * Q_GROUPS * Q_SPLIT;
// K4: the same over key rows; a stage holds K_SPLIT x K_SLICE queries
// (two splits at D = 128, so that the stages fit in shared memory).
// Above D = 128: one group of 16 keys, WIDE_K_SPLIT splits of 8 queries,
// and a block keeps dk and dv for one half of their columns.
constexpr int K_GROUPS = 2;
constexpr int K_SLICE = 16;
constexpr int WIDE_K_SPLIT = 4;
template <int D>
__host__ __device__ constexpr int k_split() {
  if (out_halves<D>() > 1) return WIDE_K_SPLIT;
  return D > 64 ? 2 : 4;
}
template <int D>
__host__ __device__ constexpr int k_groups() {
  return out_halves<D>() > 1 ? 1 : K_GROUPS;
}
template <int D>
__host__ __device__ constexpr int k_slice() {
  return out_halves<D>() > 1 ? 8 : K_SLICE;
}
template <int D>
__host__ __device__ constexpr int k_rows() { return 16 * k_groups<D>(); }
template <int D>
__host__ __device__ constexpr int k_nt() { return 32 * k_groups<D>() * k_split<D>(); }
// o is read only for delta: above D = 128 its stages take one buffer,
// refilled once the stage's delta is formed, so that 4 warps' stages fit
template <int D>
__host__ __device__ constexpr int o_bufs() { return out_halves<D>() > 1 ? 1 : 2; }
static_assert(Q_SLICE % 8 == 0 && K_SLICE % 8 == 0, "slices of 8-row tiles");

// The loops over the head dim unroll all D / 8 steps up to D = 128;
// above, Q_WIDE_UNROLL (K3) or K_WIDE_UNROLL (K4's products, beside its
// dk and dv accumulators' 128 registers) or K_FRAG_UNROLL (K4's k/v
// fragments) at a time, so that the loads the scheduler hoists fit in
// 255 registers (fully unrolled, K4 spilled 24 B at D = 224).
constexpr int Q_WIDE_UNROLL = 4;
constexpr int K_WIDE_UNROLL = 2;
constexpr int K_FRAG_UNROLL = 4;
template <int D, int WIDE>
__host__ __device__ constexpr int d_unroll() {
  return out_halves<D>() > 1 ? WIDE : D / 8;
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;   // (B, H, Tq) contiguous
  const float* dlse;  // (B, H, Tq) contiguous
  float* dq;          // (B, Tq, H, D) contiguous
  float* dk;          // (B, Tk, H, D) contiguous
  float* dv;          // (B, Tk, H, D) contiguous
  int BH, H, Tq, Tk;
  // element strides along (b, t, h) of q, k, v, o, do; unit along D
  long long sq[3], sk[3], sv[3], so[3], sd[3];
  int q_offset, k_offset, causal;
  float scale;
};

__device__ __forceinline__ float lse_safe(float l) {
  return isfinite(l) ? l : 0.f;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(uint4) * 4 * Q_GROUPS * (D / 8) * 32 +
         sizeof(float) * 4 * Q_STAGE * D;
}

// k/v fragments; q, do and o stages
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(uint4) * 4 * k_groups<D>() * (D / 8) * 32 +
         sizeof(float) * ((4 + o_bufs<D>()) * k_split<D>() * k_slice<D>() * D +
                          2 * k_split<D>() * k_slice<D>());
}

// ---------------------------------------------------------------------
// K3: dq
// ---------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Q_NT, 2) flash_bwd_dq_kernel(const Args a) {
  constexpr int NH = out_halves<D>();
  constexpr int DH = D / NH;       // dq's columns this block writes
  constexpr int KS = D / 8;        // 8-deep steps over the head dim
  constexpr int KO = DH / 8;       // 8-column groups of the partial
  constexpr int NK = Q_SLICE / 8;  // 8-key column groups of a slice
  constexpr int TILE = Q_STAGE * D;
  constexpr int FR = Q_GROUPS * KS * 32;
  static_assert(Q_GROUPS * Q_SPLIT * KO * 32 * 4 <= 4 * TILE,
                "the dq partials fit in the stages");
  extern __shared__ uint4 smem4[];
  uint4* Qh = smem4;  // [group][KS][lane] q fragments, hi and lo
  uint4* Ql = Qh + FR;
  uint4* Gh = Ql + FR;  // do fragments
  uint4* Gl = Gh + FR;
  float* Ks = reinterpret_cast<float*>(Gl + FR);  // [2][TILE]
  float* Vs = Ks + 2 * TILE;                      // [2][TILE]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / Q_SPLIT, split_id = warp % Q_SPLIT;
  const int Tq = a.Tq, Tk = a.Tk;
  const int n_qt = (Tq + Q_ROWS - 1) / Q_ROWS;
  const int half = static_cast<int>(blockIdx.x) % NH;
  const int rest = static_cast<int>(blockIdx.x) / NH;
  const int bh = rest % a.BH;
  const int q0 = (n_qt - 1 - rest / a.BH) * Q_ROWS;
  const int b = bh / a.H, h = bh % a.H;

  const float* qb = a.q + b * a.sq[0] + h * a.sq[2];
  const float* kb = a.k + b * a.sk[0] + h * a.sk[2];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[2];
  const float* ob = a.o + b * a.so[0] + h * a.so[2];
  const float* gb = a.dout + b * a.sd[0] + h * a.sd[2];

  // keys [0, k_end) are visible to at least one real row of this block
  int k_end = Tk;
  if (a.causal) {
    const int last = min(q0 + Q_ROWS, Tq) - 1;
    k_end = max(0, min(Tk, a.q_offset + last - a.k_offset + 1));
  }
  const int n_st = (k_end + Q_STAGE - 1) / Q_STAGE;
  if (n_st > 0) {
    load_tile<D, Q_STAGE, Q_NT>(Ks, kb, a.sk[1], 0, Tk);
    load_tile<D, Q_STAGE, Q_NT>(Vs, vb, a.sv[1], 0, Tk);
  }
  cp_async_commit();

  // this group's rows ra, rb: q and do fragments (written by the group's
  // first warp), lse_safe and delta (in every warp's registers)
  const int ra = q0 + group * 16 + g, rb = ra + 8;
  const bool ina = ra < Tq, inb = rb < Tq;
  const int f = group * KS * 32 + lane;
  float dsa = 0.f, dsb = 0.f;
#pragma unroll (d_unroll<D, Q_WIDE_UNROLL>())
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 8 + t;
    const float4 gv = a_from_global(gb, a.sd[1], ra, rb, ina, inb, c);
    const float4 ov = a_from_global(ob, a.so[1], ra, rb, ina, inb, c);
    if (split_id == 0) {
      store_a(Qh + f + ks * 32, Ql + f + ks * 32,
              a_from_global(qb, a.sq[1], ra, rb, ina, inb, c));
      store_a(Gh + f + ks * 32, Gl + f + ks * 32, gv);
    }
    dsa = fmaf(gv.x, ov.x, dsa);
    dsa = fmaf(gv.z, ov.z, dsa);
    dsb = fmaf(gv.y, ov.y, dsb);
    dsb = fmaf(gv.w, ov.w, dsb);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    dsa += __shfl_xor_sync(FULL, dsa, off);
    dsb += __shfl_xor_sync(FULL, dsb, off);
  }
  const long long li = static_cast<long long>(bh) * Tq;
  const float ls_a = ina ? lse_safe(a.lse[li + ra]) : 0.f;
  const float ls_b = inb ? lse_safe(a.lse[li + rb]) : 0.f;
  const float dl_a = ina ? dsa - a.dlse[li + ra] : 0.f;
  const float dl_b = inb ? dsb - a.dlse[li + rb] : 0.f;

  float acc[KO][4];
#pragma unroll
  for (int i = 0; i < KO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_st; ++j) {
    if (j + 1 < n_st) {
      const int nxt = ((j + 1) & 1) * TILE;
      load_tile<D, Q_STAGE, Q_NT>(Ks + nxt, kb, a.sk[1], (j + 1) * Q_STAGE, Tk);
      load_tile<D, Q_STAGE, Q_NT>(Vs + nxt, vb, a.sv[1], (j + 1) * Q_STAGE, Tk);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // stage j (and the fragments) are in for every thread
    const int k_lo = j * Q_STAGE + split_id * Q_SLICE;  // this warp's keys
    if (k_lo < k_end) {
      // the slice's rows keep their swizzle: Q_SLICE is a multiple of 8
      const float* K = Ks + (j & 1) * TILE + split_id * Q_SLICE * D;
      const float* V = Vs + (j & 1) * TILE + split_id * Q_SLICE * D;
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll (d_unroll<D, Q_WIDE_UNROLL>())
      for (int ks = 0; ks < KS; ++ks) {
        const Frag<4> qa = load_a(Qh + f + ks * 32, Ql + f + ks * 32);
        const Frag<4> ga = load_a(Gh + f + ks * 32, Gl + f + ks * 32);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          mma3(s[n], qa, b_rowwise<D>(K, n * 8 + g, ks * 8 + t));
          mma3(dp[n], ga, b_rowwise<D>(V, n * 8 + g, ks * 8 + t));
        }
      }

      // s -> ds in place
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb;
          const int col = k_lo + n * 8 + 2 * t + (e & 1);
          const bool ok =
              col < Tk && (!a.causal || a.k_offset + col <= a.q_offset + row);
          const float p =
              ok ? expf(s[n][e] * a.scale - (e < 2 ? ls_a : ls_b)) : 0.f;
          s[n][e] = p * (dp[n][e] - (e < 2 ? dl_a : dl_b)) * a.scale;
        }

      // dq += ds k, over this block's half of k's columns
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const Frag<4> da = acc_as_a(s[kk]);
#pragma unroll
        for (int dn = 0; dn < KO; ++dn)
          mma3(acc[dn], da,
               b_colwise<D>(K, kk * 8 + 2 * t, half * DH + dn * 8 + g));
      }
    }
    __syncthreads();  // stage j & 1 is free for stage j + 2
  }

  // the group's Q_SPLIT partials, summed in split order: each warp sums
  // and stores up to PER of the 8-column groups
  float4* part = reinterpret_cast<float4*>(Ks);  // [group][split][KO][lane]
  float4* mine = part + (group * Q_SPLIT + split_id) * KO * 32 + lane;
#pragma unroll
  for (int dn = 0; dn < KO; ++dn)
    mine[dn * 32] = make_float4(acc[dn][0], acc[dn][1], acc[dn][2], acc[dn][3]);
  __syncthreads();
  const float4* first = part + group * Q_SPLIT * KO * 32 + lane;
  constexpr int PER = (KO + Q_SPLIT - 1) / Q_SPLIT;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int dn = split_id * PER + i;
    if (dn >= KO) break;
    float4 sum = first[dn * 32];
#pragma unroll
    for (int sp = 1; sp < Q_SPLIT; ++sp) {
      const float4 x = first[(sp * KO + dn) * 32];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int c = half * DH + dn * 8 + 2 * t;
    if (ina)
      *reinterpret_cast<float2*>(
          a.dq + ((static_cast<long long>(b) * Tq + ra) * a.H + h) * D + c) =
          make_float2(sum.x, sum.y);
    if (inb)
      *reinterpret_cast<float2*>(
          a.dq + ((static_cast<long long>(b) * Tq + rb) * a.H + h) * D + c) =
          make_float2(sum.z, sum.w);
  }
}

// ---------------------------------------------------------------------
// K4: dk and dv
// ---------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(k_nt<D>()) flash_bwd_dkv_kernel(const Args a) {
  constexpr int NH = out_halves<D>();
  constexpr int DH = D / NH;        // columns of dk and dv this block writes
  constexpr int GROUPS = k_groups<D>();
  constexpr int SLICE = k_slice<D>();
  constexpr int ROWS = k_rows<D>();
  constexpr int SPLIT = k_split<D>();
  constexpr int NT = k_nt<D>();
  constexpr int STAGE = SPLIT * SLICE;  // queries per stage
  constexpr int KS = D / 8;             // 8-deep steps over the head dim
  constexpr int KO = DH / 8;            // 8-column groups of a partial
  constexpr int NQ = SLICE / 8;         // 8-query column groups of a slice
  constexpr int TILE = STAGE * D;
  constexpr int FR = GROUPS * KS * 32;
  constexpr int LPR = NT / STAGE;  // lanes per row for delta
  constexpr int OB = o_bufs<D>();
  static_assert(2 * GROUPS * SPLIT * KO * 32 * 4 <= (4 + OB) * TILE,
                "the dk/dv partials fit in the stages");
  extern __shared__ uint4 smem4[];
  uint4* Kh = smem4;  // [group][KS][lane] k fragments, hi and lo
  uint4* Kl = Kh + FR;
  uint4* Vh = Kl + FR;  // v fragments
  uint4* Vl = Vh + FR;
  float* Qs = reinterpret_cast<float*>(Vl + FR);  // [2][TILE]
  float* Gs = Qs + 2 * TILE;                      // do
  float* Os = Gs + 2 * TILE;                      // [OB][TILE] o
  float* Ls = Os + OB * TILE;  // [STAGE] lse_safe of the stage's rows
  float* Dl = Ls + STAGE;     // [STAGE] delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / SPLIT, split_id = warp % SPLIT;
  const int Tq = a.Tq, Tk = a.Tk;
  const int half = static_cast<int>(blockIdx.x) % NH;
  const int rest = static_cast<int>(blockIdx.x) / NH;
  const int bh = rest % a.BH;
  const int k0 = rest / a.BH * ROWS;
  const int b = bh / a.H, h = bh % a.H;

  const float* qb = a.q + b * a.sq[0] + h * a.sq[2];
  const float* kb = a.k + b * a.sk[0] + h * a.sk[2];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[2];
  const float* ob = a.o + b * a.so[0] + h * a.so[2];
  const float* gb = a.dout + b * a.sd[0] + h * a.sd[2];

  // query rows below q_begin see none of this block's keys
  const int q_begin = a.causal ? max(0, a.k_offset + k0 - a.q_offset) : 0;
  const int n_st = q_begin < Tq ? (Tq - q_begin + STAGE - 1) / STAGE : 0;
  if (n_st > 0) {
    load_tile<D, STAGE, NT>(Qs, qb, a.sq[1], q_begin, Tq);
    load_tile<D, STAGE, NT>(Gs, gb, a.sd[1], q_begin, Tq);
    load_tile<D, STAGE, NT>(Os, ob, a.so[1], q_begin, Tq);
  }
  cp_async_commit();

  // this group's key rows ka, kb8: k and v fragments (the first warp)
  const int ka = k0 + group * 16 + g, kb8 = ka + 8;
  const bool ina = ka < Tk, inb = kb8 < Tk;
  const int f = group * KS * 32 + lane;
  if (split_id == 0) {
#pragma unroll (d_unroll<D, K_FRAG_UNROLL>())
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 8 + t;
      store_a(Kh + f + ks * 32, Kl + f + ks * 32,
              a_from_global(kb, a.sk[1], ka, kb8, ina, inb, c));
      store_a(Vh + f + ks * 32, Vl + f + ks * 32,
              a_from_global(vb, a.sv[1], ka, kb8, ina, inb, c));
    }
  }
  // the group's first key, for skipping slices it cannot see
  const int key_first = a.k_offset + k0 + group * 16;

  // dk in acc[0] and dv in acc[1]
  float acc[2][KO][4];
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int i = 0; i < KO; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][i][e] = 0.f;

  const long long li = static_cast<long long>(bh) * Tq;
  for (int j = 0; j < n_st; ++j) {
    const int qt = q_begin + j * STAGE;
    if (j + 1 < n_st) {
      const int nxt = ((j + 1) & 1) * TILE;
      load_tile<D, STAGE, NT>(Qs + nxt, qb, a.sq[1], qt + STAGE, Tq);
      load_tile<D, STAGE, NT>(Gs + nxt, gb, a.sd[1], qt + STAGE, Tq);
      if constexpr (OB == 2)
        load_tile<D, STAGE, NT>(Os + nxt, ob, a.so[1], qt + STAGE, Tq);
    }
    cp_async_commit();
    cp_async_wait_prev();  // all but the group just issued (o's with OB 1)
    __syncthreads();  // stage j (and the fragments) are in for every thread
    const float* Qt = Qs + (j & 1) * TILE;
    const float* Gt = Gs + (j & 1) * TILE;
    {
      // lse_safe and delta of the stage's rows: LPR lanes per row
      const float* O = Os + (OB == 2 ? (j & 1) * TILE : 0);
      const int r = threadIdx.x / LPR, lp = threadIdx.x % LPR;
      float sum = 0.f;
      for (int c = lp * 4; c < D; c += LPR * 4) {
        const float4 gv = *reinterpret_cast<const float4*>(Gt + sw<D>(r, c));
        const float4 ov = *reinterpret_cast<const float4*>(O + sw<D>(r, c));
        sum = fmaf(gv.x, ov.x, sum);
        sum = fmaf(gv.y, ov.y, sum);
        sum = fmaf(gv.z, ov.z, sum);
        sum = fmaf(gv.w, ov.w, sum);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      if (lp == 0) {
        const int row = qt + r;
        Ls[r] = row < Tq ? lse_safe(a.lse[li + row]) : 0.f;
        Dl[r] = row < Tq ? sum - a.dlse[li + row] : 0.f;
      }
    }
    __syncthreads();  // the stage's lse_safe and delta are in
    if constexpr (OB == 1) {  // o's one buffer is free: the next stage's
      if (j + 1 < n_st)       // o, in flight during this stage's products
        load_tile<D, STAGE, NT>(Os, ob, a.so[1], qt + STAGE, Tq);
      cp_async_commit();
    }

    const int q_lo = qt + split_id * SLICE;  // this warp's queries
    if (q_lo < Tq &&
        (!a.causal || a.q_offset + q_lo + SLICE - 1 >= key_first)) {
      // the slice's rows keep their swizzle: SLICE is a multiple of 8
      const float* Q = Qt + split_id * SLICE * D;
      const float* G = Gt + split_id * SLICE * D;
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll (d_unroll<D, K_WIDE_UNROLL>())
      for (int ks = 0; ks < KS; ++ks) {
        const Frag<4> ka4 = load_a(Kh + f + ks * 32, Kl + f + ks * 32);
        const Frag<4> va4 = load_a(Vh + f + ks * 32, Vl + f + ks * 32);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          mma3(st[n], ka4, b_rowwise<D>(Q, n * 8 + g, ks * 8 + t));
          mma3(dpt[n], va4, b_rowwise<D>(G, n * 8 + g, ks * 8 + t));
        }
      }

      // s^T -> p^T and dp^T -> ds^T in place
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? ka : kb8;
          const int ql = split_id * SLICE + n * 8 + 2 * t + (e & 1);
          const int qrow = qt + ql;
          const bool ok = qrow < Tq &&
                          (!a.causal || a.k_offset + key <= a.q_offset + qrow);
          const float p = ok ? expf(st[n][e] * a.scale - Ls[ql]) : 0.f;
          dpt[n][e] = p * (dpt[n][e] - Dl[ql]) * a.scale;
          st[n][e] = p;
        }

      // dv += p^T do, dk += ds^T q (over this block's columns)
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        const Frag<4> pa = acc_as_a(st[kk]);
        const Frag<4> da = acc_as_a(dpt[kk]);
#pragma unroll
        for (int dn = 0; dn < KO; ++dn) {
          const int c = half * DH + dn * 8 + g;
          mma3(acc[1][dn], pa, b_colwise<D>(G, kk * 8 + 2 * t, c));
          mma3(acc[0][dn], da, b_colwise<D>(Q, kk * 8 + 2 * t, c));
        }
      }
    }
    __syncthreads();  // stage j & 1, Ls and Dl are free
  }

  // the group's SPLIT partials, summed in split order: each warp sums and
  // stores up to PER of the 8-column groups of dk and of dv
  float4* part = reinterpret_cast<float4*>(Qs);  // [group][split][2][KO][lane]
  float4* mine = part + (group * SPLIT + split_id) * 2 * KO * 32 + lane;
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int dn = 0; dn < KO; ++dn)
      mine[(o * KO + dn) * 32] =
          make_float4(acc[o][dn][0], acc[o][dn][1], acc[o][dn][2], acc[o][dn][3]);
  __syncthreads();
  const float4* first = part + group * SPLIT * 2 * KO * 32 + lane;
  constexpr int PER = (KO + SPLIT - 1) / SPLIT;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    float* dst = o ? a.dv : a.dk;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int dn = split_id * PER + i;
      if (dn >= KO) break;
      float4 sum = first[(o * KO + dn) * 32];
#pragma unroll
      for (int sp = 1; sp < SPLIT; ++sp) {
        const float4 x = first[((sp * 2 + o) * KO + dn) * 32];
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      const int c = half * DH + dn * 8 + 2 * t;
      if (ina)
        *reinterpret_cast<float2*>(
            dst + ((static_cast<long long>(b) * Tk + ka) * a.H + h) * D + c) =
            make_float2(sum.x, sum.y);
      if (inb)
        *reinterpret_cast<float2*>(
            dst + ((static_cast<long long>(b) * Tk + kb8) * a.H + h) * D + c) =
            make_float2(sum.z, sum.w);
    }
  }
}

template <int D>
cudaError_t launch_dq(Args a, int B, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, smem, &configured);
  if (e != cudaSuccess) return e;
  a.BH = B * a.H;
  const int blocks = (a.Tq + Q_ROWS - 1) / Q_ROWS * a.BH * out_halves<D>();
  if (blocks == 0) return cudaSuccess;
  flash_bwd_dq_kernel<D><<<blocks, Q_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(Args a, int B, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<D>, smem, &configured);
  if (e != cudaSuccess) return e;
  a.BH = B * a.H;
  const int blocks =
      (a.Tk + k_rows<D>() - 1) / k_rows<D>() * a.BH * out_halves<D>();
  if (blocks == 0) return cudaSuccess;
  flash_bwd_dkv_kernel<D><<<blocks, k_nt<D>(), smem, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               const float* dlse, float* dq, float* dk, float* dv, int H,
               int Tq, int Tk, const long long* strides, int q_offset,
               int k_offset, int causal, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.dlse = dlse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.BH = 0;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  long long* dst[5] = {a.sq, a.sk, a.sv, a.so, a.sd};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

// q, o, do (B, Tq, H, D) and k, v (B, Tk, H, D) with unit stride along D,
// 16-byte aligned base pointers and the element strides given in
// `strides` (a host array of 15: b, t, h of q, k, v, o, do in that order,
// each a multiple of 4); lse and dlse (B, H, Tq) contiguous; dq (B, Tq,
// H, D) contiguous.  Returns the cudaError_t of the launch.
extern "C" int sparknet_flash_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, const float* dlse, float* dq, int B,
    int H, int Tq, int Tk, int D, const long long* strides, int q_offset,
    int k_offset, int causal, float scale, void* stream) {
  const Args a = make_args(q, k, v, o, dout, lse, dlse, dq, nullptr, nullptr,
                           H, Tq, Tk, strides, q_offset, k_offset, causal,
                           scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_DQ(d) \
  case d:             \
    return launch_dq<d>(a, B, s);
  switch (D) {
    FLASH_HEAD_DIMS(LAUNCH_DQ)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above; dk and dv (B, Tk, H, D) contiguous.
extern "C" int sparknet_flash_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, const float* dlse, float* dk,
    float* dv, int B, int H, int Tq, int Tk, int D, const long long* strides,
    int q_offset, int k_offset, int causal, float scale, void* stream) {
  const Args a = make_args(q, k, v, o, dout, lse, dlse, nullptr, dk, dv, H, Tq,
                           Tk, strides, q_offset, k_offset, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_DKV(d) \
  case d:              \
    return launch_dkv<d>(a, B, s);
  switch (D) {
    FLASH_HEAD_DIMS(LAUNCH_DKV)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
