// Flash-attention backward, float32, for Hopper (sm_90a): dq and dk/dv.
//
// Replaces the two Pallas kernels of _flash_core_bwd
// (sparknet_tpu/ops/pallas_attention.py:188):
//   K3 _bwd_dq_kernel  (:91,  pallas_call at :200) -> flash_bwd_dq_kernel
//   K4 _bwd_dkv_kernel (:119, pallas_call at :218) -> flash_bwd_dkv_kernel
// with the JAX package's formulas, per (batch*head):
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
// Design.  On the TPU, the dq kernel is gridded per q-block and the
// dk/dv kernel per (batch*head) with all of T_q and T_k in VMEM.  A
// Hopper block has at most 227 KB of shared memory and blocks run in
// parallel, so both kernels loop over tiles instead, and each output
// tile is owned by exactly one block: no atomics, so both stay
// deterministic, as the TPU's split into two kernels is.
//   K3: one block per (batch*head, 64 query rows), 256 threads.  The
//       q and do tiles stay in shared memory; the block walks 32-row
//       K/V tiles up to the causal frontier of its last row.  Each
//       thread owns 4 query rows x 2 key columns of the score tile and
//       4 rows x D/16 columns of dq.
//   K4: one block per (batch*head, 64 key rows), 256 threads.  The k
//       and v tiles stay in shared memory; the block walks 32-row q/do
//       tiles from the first row that can see its keys.  Each thread
//       owns 4 key rows x 2 query columns of the transposed score tile
//       and 4 key rows x D/16 columns of both dk and dv.
// delta is computed inside each kernel from do and o (K4 recomputes it
// once per key block), as the TPU kernels do.  Row reductions run with
// warp shuffles inside 16-lane (K3) or 8-lane (K4) groups.  Inputs are
// read through their (B, T, H, D) strides, so no transpose copy is
// made; rows past T are masked in the kernel, nothing is padded in
// memory.  Shared rows are padded by one float so column reads hit
// distinct banks.
//
// Bound on this card.  At the training shape (B=8, T=256, H=4, D=64,
// causal) K3 does three causal products (s, do v^T, ds k) and K4 four
// (s, do v^T, p^T do, ds^T q): ~0.40 and ~0.54 GFLOP, which an H100 SXM
// does in ~6 and ~8 us in float32 outside the tensor cores (67
// TFLOP/s); each moves ~13-15 MB (~4 us at 3.35 TB/s).  So both are
// bound by operations.  The products run on the CUDA cores in full
// float32, as the port keeps float32 products exact; wgmma/TMA tiles
// (TF32 or bf16) are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr unsigned FULL = 0xffffffffu;

// K3 tiling
constexpr int Q_BQ = 64;                   // query rows per block
constexpr int Q_BK = 32;                   // key rows per tile
constexpr int Q_CG = 16;                   // lanes sharing a group of rows
constexpr int Q_RPT = Q_BQ / (NT / Q_CG);  // query rows per thread (4)
constexpr int Q_KPT = Q_BK / Q_CG;         // key columns per thread (2)
constexpr int Q_PS = Q_BK + 1;             // padded row of the ds tile

// K4 tiling
constexpr int K_BK = 64;                   // key rows per block
constexpr int K_BQ = 32;                   // query rows per tile
constexpr int K_CG = 16;
constexpr int K_RPT = K_BK / (NT / K_CG);  // key rows per thread (4)
constexpr int K_QPT = K_BQ / K_CG;         // query columns per thread (2)
constexpr int K_PS = K_BQ + 1;             // padded row of the p^T/ds^T tiles
constexpr int K_LPR = NT / K_BQ;           // lanes per row for delta (8)

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
  int H, Tq, Tk;
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
  return sizeof(float) * (2 * Q_BQ * (D + 1) + 2 * Q_BK * (D + 1) +
                          Q_BQ * Q_PS);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * K_BK * (D + 1) + 2 * K_BQ * (D + 1) +
                          2 * K_BK * K_PS + 2 * K_BQ);
}

// ---------------------------------------------------------------------
// K3: dq
// ---------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Args a) {
  constexpr int DP = D + 1;      // padded row of the q/do/k/v tiles
  constexpr int DPT = D / Q_CG;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][DP]
  float* Gs = Qs + Q_BQ * DP;    // [BQ][DP] do
  float* Ks = Gs + Q_BQ * DP;    // [BK][DP]
  float* Vs = Ks + Q_BK * DP;    // [BK][DP]
  float* Ss = Vs + Q_BK * DP;    // [BQ][PS] ds

  const int tid = threadIdx.x;
  const int row0 = (tid / Q_CG) * Q_RPT;
  const int cg = tid % Q_CG;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = blockIdx.x * Q_BQ;
  const int Tq = a.Tq, Tk = a.Tk;

  const float* qb = a.q + b * a.sq[0] + h * a.sq[2];
  const float* kb = a.k + b * a.sk[0] + h * a.sk[2];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[2];
  const float* ob = a.o + b * a.so[0] + h * a.so[2];
  const float* gb = a.dout + b * a.sd[0] + h * a.sd[2];

  for (int i = tid; i < Q_BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    const bool in = t < Tq;
    Qs[r * DP + c] = in ? qb[t * a.sq[1] + c] : 0.f;
    Gs[r * DP + c] = in ? gb[t * a.sd[1] + c] : 0.f;
  }
  __syncthreads();

  // per-row lse_safe and delta = rowsum(do * o) - dlse, in registers
  float ls[Q_RPT], delta[Q_RPT];
#pragma unroll
  for (int i = 0; i < Q_RPT; ++i) {
    const int t = q0 + row0 + i;
    float part = 0.f;
    if (t < Tq) {
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int c = cg + Q_CG * j;
        part = fmaf(Gs[(row0 + i) * DP + c], ob[t * a.so[1] + c], part);
      }
    }
#pragma unroll
    for (int off = Q_CG / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(FULL, part, off);
    const long long li = static_cast<long long>(bh) * Tq + t;
    ls[i] = (t < Tq) ? lse_safe(a.lse[li]) : 0.f;
    delta[i] = (t < Tq) ? part - a.dlse[li] : 0.f;
  }

  // keys [0, k_end) are visible to at least one real row of this block
  int k_end = Tk;
  if (a.causal) {
    const int last = min(q0 + Q_BQ, Tq) - 1;
    k_end = max(0, min(Tk, a.q_offset + last - a.k_offset + 1));
  }

  float acc[Q_RPT][DPT];
#pragma unroll
  for (int i = 0; i < Q_RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < k_end; kt += Q_BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < Q_BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int t = kt + r;
      const bool in = t < Tk;
      Ks[r * DP + c] = in ? kb[t * a.sk[1] + c] : 0.f;
      Vs[r * DP + c] = in ? vb[t * a.sv[1] + c] : 0.f;
    }
    __syncthreads();

    float s[Q_RPT][Q_KPT], dp[Q_RPT][Q_KPT];
#pragma unroll
    for (int i = 0; i < Q_RPT; ++i)
#pragma unroll
      for (int j = 0; j < Q_KPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float kv[Q_KPT], vv[Q_KPT];
#pragma unroll
      for (int j = 0; j < Q_KPT; ++j) {
        kv[j] = Ks[(cg + Q_CG * j) * DP + c];
        vv[j] = Vs[(cg + Q_CG * j) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < Q_RPT; ++i) {
        const float qv = Qs[(row0 + i) * DP + c];
        const float gv = Gs[(row0 + i) * DP + c];
#pragma unroll
        for (int j = 0; j < Q_KPT; ++j) {
          s[i][j] = fmaf(qv, kv[j], s[i][j]);
          dp[i][j] = fmaf(gv, vv[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < Q_RPT; ++i) {
      const int qpos = a.q_offset + q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < Q_KPT; ++j) {
        const int col = kt + cg + Q_CG * j;
        const bool ok = col < Tk && (!a.causal || a.k_offset + col <= qpos);
        const float p = ok ? expf(s[i][j] * a.scale - ls[i]) : 0.f;
        Ss[(row0 + i) * Q_PS + cg + Q_CG * j] =
            p * (dp[i][j] - delta[i]) * a.scale;
      }
    }
    __syncthreads();  // the ds tile is complete

#pragma unroll 4
    for (int kk = 0; kk < Q_BK; ++kk) {
      float kv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = Ks[kk * DP + cg + Q_CG * j];
#pragma unroll
      for (int i = 0; i < Q_RPT; ++i) {
        const float d = Ss[(row0 + i) * Q_PS + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(d, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < Q_RPT; ++i) {
    const int row = q0 + row0 + i;
    if (row >= Tq) continue;
    float* out = a.dq + ((static_cast<long long>(b) * Tq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) out[cg + Q_CG * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------
// K4: dk and dv
// ---------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Args a) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / K_CG;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][DP]
  float* Vs = Ks + K_BK * DP;    // [BK][DP]
  float* Qs = Vs + K_BK * DP;    // [BQ][DP]
  float* Gs = Qs + K_BQ * DP;    // [BQ][DP] do
  float* Pt = Gs + K_BQ * DP;    // [BK][PS] p^T
  float* St = Pt + K_BK * K_PS;  // [BK][PS] ds^T
  float* Ls = St + K_BK * K_PS;  // [BQ] lse_safe
  float* Dl = Ls + K_BQ;         // [BQ] delta

  const int tid = threadIdx.x;
  const int row0 = (tid / K_CG) * K_RPT;  // this thread's key rows
  const int cg = tid % K_CG;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int k0 = blockIdx.x * K_BK;
  const int Tq = a.Tq, Tk = a.Tk;

  const float* qb = a.q + b * a.sq[0] + h * a.sq[2];
  const float* kb = a.k + b * a.sk[0] + h * a.sk[2];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[2];
  const float* ob = a.o + b * a.so[0] + h * a.so[2];
  const float* gb = a.dout + b * a.sd[0] + h * a.sd[2];

  for (int i = tid; i < K_BK * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = k0 + r;
    const bool in = t < Tk;
    Ks[r * DP + c] = in ? kb[t * a.sk[1] + c] : 0.f;
    Vs[r * DP + c] = in ? vb[t * a.sv[1] + c] : 0.f;
  }

  // query rows below q_begin see none of this block's keys
  int q_begin = 0;
  if (a.causal) {
    q_begin = max(0, a.k_offset + k0 - a.q_offset);
    q_begin = (q_begin / K_BQ) * K_BQ;
  }

  float dk[K_RPT][DPT], dv[K_RPT][DPT];
#pragma unroll
  for (int i = 0; i < K_RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int qt = q_begin; qt < Tq; qt += K_BQ) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < K_BQ * D; i += NT) {
      const int r = i / D, c = i % D;
      const int t = qt + r;
      const bool in = t < Tq;
      Qs[r * DP + c] = in ? qb[t * a.sq[1] + c] : 0.f;
      Gs[r * DP + c] = in ? gb[t * a.sd[1] + c] : 0.f;
    }
    __syncthreads();
    {
      // lse_safe and delta of the tile's rows: K_LPR lanes per row
      const int r = tid / K_LPR, part = tid % K_LPR;
      const int t = qt + r;
      float sum = 0.f;
      if (t < Tq) {
        for (int c = part; c < D; c += K_LPR)
          sum = fmaf(Gs[r * DP + c], ob[t * a.so[1] + c], sum);
      }
#pragma unroll
      for (int off = K_LPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      if (part == 0) {
        const long long li = static_cast<long long>(bh) * Tq + t;
        Ls[r] = (t < Tq) ? lse_safe(a.lse[li]) : 0.f;
        Dl[r] = (t < Tq) ? sum - a.dlse[li] : 0.f;
      }
    }
    __syncthreads();

    float s[K_RPT][K_QPT], dp[K_RPT][K_QPT];
#pragma unroll
    for (int i = 0; i < K_RPT; ++i)
#pragma unroll
      for (int j = 0; j < K_QPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[K_QPT], gv[K_QPT];
#pragma unroll
      for (int j = 0; j < K_QPT; ++j) {
        qv[j] = Qs[(cg + K_CG * j) * DP + c];
        gv[j] = Gs[(cg + K_CG * j) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < K_RPT; ++i) {
        const float kv = Ks[(row0 + i) * DP + c];
        const float vv = Vs[(row0 + i) * DP + c];
#pragma unroll
        for (int j = 0; j < K_QPT; ++j) {
          s[i][j] = fmaf(qv[j], kv, s[i][j]);
          dp[i][j] = fmaf(gv[j], vv, dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < K_RPT; ++i) {
      const int krow = k0 + row0 + i;
#pragma unroll
      for (int j = 0; j < K_QPT; ++j) {
        const int qc = cg + K_CG * j;
        const int qrow = qt + qc;
        const bool ok = krow < Tk && qrow < Tq &&
                        (!a.causal || a.k_offset + krow <= a.q_offset + qrow);
        const float p = ok ? expf(s[i][j] * a.scale - Ls[qc]) : 0.f;
        Pt[(row0 + i) * K_PS + qc] = p;
        St[(row0 + i) * K_PS + qc] = p * (dp[i][j] - Dl[qc]) * a.scale;
      }
    }
    __syncthreads();  // the p^T and ds^T tiles are complete

#pragma unroll 4
    for (int qq = 0; qq < K_BQ; ++qq) {
      float gv[DPT], qv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        gv[j] = Gs[qq * DP + cg + K_CG * j];
        qv[j] = Qs[qq * DP + cg + K_CG * j];
      }
#pragma unroll
      for (int i = 0; i < K_RPT; ++i) {
        const float p = Pt[(row0 + i) * K_PS + qq];
        const float d = St[(row0 + i) * K_PS + qq];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv[i][j] = fmaf(p, gv[j], dv[i][j]);
          dk[i][j] = fmaf(d, qv[j], dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < K_RPT; ++i) {
    const int row = k0 + row0 + i;
    if (row >= Tk) continue;
    const long long base = ((static_cast<long long>(b) * Tk + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      a.dk[base + cg + K_CG * j] = dk[i][j];
      a.dv[base + cg + K_CG * j] = dv[i][j];
    }
  }
}

template <int D>
cudaError_t launch_dq(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {  // above 48 KB a block needs the opt-in
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.Tq + Q_BQ - 1) / Q_BQ, B * a.H);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.Tk + K_BK - 1) / K_BK, B * a.H);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(a);
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

// q, o, do (B, Tq, H, D) and k, v (B, Tk, H, D) with unit stride along D
// and the element strides given in `strides` (a host array of 15: b, t, h
// of q, k, v, o, do in that order); lse and dlse (B, H, Tq) contiguous;
// dq (B, Tq, H, D) contiguous.  Returns the cudaError_t of the launch.
extern "C" int sparknet_flash_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, const float* dlse, float* dq, int B,
    int H, int Tq, int Tk, int D, const long long* strides, int q_offset,
    int k_offset, int causal, float scale, void* stream) {
  const Args a = make_args(q, k, v, o, dout, lse, dlse, dq, nullptr, nullptr,
                           H, Tq, Tk, strides, q_offset, k_offset, causal,
                           scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dq<32>(a, B, s);
    case 64: return launch_dq<64>(a, B, s);
    case 128: return launch_dq<128>(a, B, s);
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
  switch (D) {
    case 32: return launch_dkv<32>(a, B, s);
    case 64: return launch_dkv<64>(a, B, s);
    case 128: return launch_dkv<128>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
