// Flash-attention forward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas kernel sparknet_tpu/ops/pallas_attention.py:67
// _fwd_kernel (pallas_call at :152 in _fwd_call, behind _flash_core,
// flash_attention and flash_attention_step).  It computes the same
// function: per (batch*head), o = softmax(scale * q k^T + mask) v and
// the row log-sum-exp, with the causal mask taken from ABSOLUTE
// positions (query row r at q_offset + r, key column c at k_offset + c;
// the dense end-aligned convention is q_offset = Tk - Tq, k_offset = 0).
// A fully-masked row comes out (o = 0, lse = -inf), never NaN.
//
// Design.  The TPU kernel keeps the whole of K/V for one (batch*head)
// in VMEM and makes one pass.  A Hopper block has at most 227 KB of
// shared memory, so this kernel loops over K/V tiles instead and keeps
// an online softmax: one block per (batch*head, tile of 64 query rows),
// 256 threads; each thread owns 4 query rows x 2 key columns of the
// score tile and 4 rows x D/16 output columns, with the running max and
// sum of each row in registers (fp32 throughout) and the row reductions
// done with warp shuffles inside 16-lane groups.  Key tiles wholly past
// the causal frontier of the block's last row are never loaded.  A
// ragged T_q is masked in the kernel (rows past T_q load as zeros and
// are not written); nothing is padded in memory.  q, k and v are read
// through their (B, T, H, D) strides, so no transpose copy is made.
// Shared rows are padded by one float so column reads hit distinct
// banks.
//
// Bound on this card.  At the serving shapes (B=1, H=4, D=64, T up to
// 256) one call moves at most ~1 MB and does at most ~67 MFLOP (T=256,
// causal, both products), which an H100 SXM does in about 1 us
// (float32 outside the tensor cores, 67 TFLOP/s): the call is bound by
// launch latency, not by bytes or operations.  The products run on
// the CUDA cores in full float32, because the port keeps float32
// products exact (TF32 tensor cores would keep ~3 decimal digits).
// wgmma, TMA and a persistent grid are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // key rows per shared-memory tile
constexpr int NT = 256;        // threads per block
constexpr int CG = 16;         // lanes sharing one group of rows
constexpr int RPT = BQ / (NT / CG);  // query rows per thread (4)
constexpr int KPT = BK / CG;   // key columns per thread (2)
constexpr int PS = BK + 1;     // padded row of the probability tile
constexpr unsigned FULL = 0xffffffffu;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int Tq, int Tk,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    int q_offset, int k_offset, int causal, float scale) {
  constexpr int DP = D + 1;     // padded row of the q and k tiles
  constexpr int DPT = D / CG;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][DP]
  float* Ks = Qs + BQ * DP;      // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][PS]

  const int tid = threadIdx.x;
  const int row0 = (tid / CG) * RPT;  // first of this thread's rows
  const int cg = tid % CG;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    Qs[r * DP + c] = (t < Tq) ? qb[t * sqt + c] : 0.f;
  }

  // keys [0, k_end) are visible to at least one real row of this block
  int k_end = Tk;
  if (causal) {
    const int last = min(q0 + BQ, Tq) - 1;
    k_end = max(0, min(Tk, q_offset + last - k_offset + 1));
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int t = kt + r;
      const bool in = t < Tk;
      Ks[r * DP + c] = in ? kb[t * skt + c] : 0.f;
      Vs[r * D + c] = in ? vb[t * svt + c] : 0.f;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float kv[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = Ks[(cg + CG * j) * DP + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qv = Qs[(row0 + i) * DP + c];
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q_offset + q0 + row0 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int col = kt + cg + CG * j;
        const bool ok = col < Tk && (!causal || k_offset + col <= qpos);
        s[i][j] = ok ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing visible yet keeps exp() away from -inf - -inf
      const float m_use = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[(row0 + i) * PS + cg + CG * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(FULL, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[kk * D + cg + CG * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(row0 + i) * PS + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + row0 + i;
    if (row >= Tq) continue;
    float* orow = o + ((static_cast<long long>(b) * Tq + row) * H + h) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[cg + CG * j] = acc[i][j] / denom;
    if (cg == 0) {
      lse[static_cast<long long>(bh) * Tq + row] =
          (l[i] > 0.f) ? m[i] + logf(l[i]) : -CUDART_INF_F;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* o, float* lse, int B, int H, int Tq, int Tk,
                   long long sqb, long long sqt, long long sqh,
                   long long skb, long long skt, long long skh,
                   long long svb, long long svt, long long svh,
                   int q_offset, int k_offset, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    // above 48 KB a block needs the opt-in (D = 128 does)
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      q, k, v, o, lse, H, Tq, Tk, sqb, sqt, sqh, skb, skt, skh, svb, svt,
      svh, q_offset, k_offset, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D) with unit stride along D and
// the given element strides for b, t, h; o (B, Tq, H, D) contiguous;
// lse (B, H, Tq) contiguous.  Returns the cudaError_t of the launch.
extern "C" int sparknet_flash_fwd_f32(
    const float* q, const float* k, const float* v, float* o, float* lse,
    int B, int H, int Tq, int Tk, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    int q_offset, int k_offset, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, lse, B, H, Tq, Tk, sqb, sqt, sqh, skb,
                        skt, skh, svb, svt, svh, q_offset, k_offset, causal,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, Tq, Tk, sqb, sqt, sqh, skb,
                        skt, skh, svb, svt, svh, q_offset, k_offset, causal,
                        scale, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, Tq, Tk, sqb, sqt, sqh, skb,
                         skt, skh, svb, svt, svh, q_offset, k_offset, causal,
                         scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
