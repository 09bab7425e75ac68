// Averaging-epilogue kernels of the comm plane, for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of sparknet_tpu/ops/pallas_comm.py:
//   sparknet_comm_encode            <- _encode_kernel (:83)
//   sparknet_comm_apply_barriered   <- _apply_barriered_kernel (:164)
//   sparknet_comm_apply_correction  <- _apply_correction_kernel (:224)
// One launch per comm chunk, as on the TPU.  Where Pallas hands each leaf
// of the chunk in as its own ref, here a table of per-leaf records
// (pointers, elements per worker, quantization mode) rides in as the
// kernel's parameter block (__grid_constant__, read in place from the
// constant bank), so a launch needs no host-to-device copy and no
// synchronisation to set it up.
//
// Grid: one block per (leaf, worker).  Each block walks its leaf's slice
// of one worker with a strided loop; the int8 encode makes two passes
// over it (max |delta|, then quantize).  The leaves of the ported models
// hold at most 51,200 floats per worker, so a block covers a leaf.
//
// What bounds them: bytes.  Per element the int8 encode reads x, anchor
// and residual (12 B) and writes the int8 payload and the new residual
// (5 B); the applies move 17-21 B.  Arithmetic is a few flops per
// element.  This first version keeps the grid small (chunk leaves x W
// blocks) and is far from the memory bound; splitting large leaves over
// many blocks is later work (ROADMAP).
//
// Numerics: bit-identical to the plain PyTorch versions in
// ops/cuda_comm.py, which follow the JAX package's unfused closures
// (parallel/comm.py:313-425) as XLA computes them:
//   delta = (x - a) + r                        round after each op
//   int8: amax = max |delta|  (NaN wins, as jnp.max)
//         scale = amax > 0 ? amax * (1/127) : 1   (XLA turns /127 into a
//                                                  multiply by 1/127)
//         q = isnan(v) ? 0 : clip(rint(delta / scale), -127, 127),
//             true division, ties to even
//         err = fma(-q, scale, delta)        (XLA contracts delta - q*s)
//   bf16: q = bf16_rn(delta), err = delta - float(q)
//   fp32: q = delta, err = delta - delta
//   barriered: x' = denom0 > 0 ? a + mean : x;
//              r' = (alive <= 0 && denom0 > 0) ? 0 : r
//   correction: corr = int8 ? fma(-q, scale, mean) : mean - float(q);
//               x' = x + corr, a' = a + corr
// Every operation is written with an explicitly rounded intrinsic, so
// nvcc's default contraction (-fmad=true) cannot fuse any other pair,
// and there is no --use_fast_math.  The optional error readout (per
// worker and leaf: max |err|, sum delta^2, sum err^2) is reduced in a
// fixed order inside the block; max |err| is exact, the sums are held to
// a tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEAVES 32
#define THREADS 512

enum { MODE_F32 = 0, MODE_BF16 = 1, MODE_INT8 = 2 };

// one leaf of a chunk; which pointers a kernel reads is noted per field
struct Leaf {
  const float* x;     // (W, n) params                      all three
  const float* a;     // (W, n) anchor                      all three
  const float* r;     // (W, n) error-feedback residual     encode, barriered
  const float* mean;  // (n)    chunk mean                  applies
  void* q;            // (W, n) payload: encode out, correction in
  float* scale;       // (W)    per-worker scale: encode out, correction in
  float* out0;        // (W, n) encode: residual; applies: params
  float* out1;        // (W, n) barriered: residual; correction: anchor
  long long n;        // elements per worker
  int mode;           // MODE_*
};

struct LeafTable {
  Leaf leaf[MAX_LEAVES];
};

// max that keeps a NaN from either side (jnp.max / jnp.maximum semantics)
__device__ __forceinline__ float nan_max(float acc, float v) {
  return (v > acc || isnan(v)) ? v : acc;
}

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return nan_max(a, b); }
};
struct AddOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

// Block-wide reduction in a fixed order (xor butterfly in each warp, then
// the warp leaders in warp 0); every input is >= 0 or NaN, so 0 is the
// identity of both ops.  The result is returned to every thread.
template <typename Op>
__device__ float block_reduce(float v, float* smem, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // smem may still be read by a previous reduction
  if (lane == 0) smem[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  return smem[0];
}

__device__ __forceinline__ float delta_at(const float* x, const float* a,
                                          const float* r, long long i) {
  return __fadd_rn(__fsub_rn(x[i], a[i]), r[i]);
}

__global__ void __launch_bounds__(THREADS)
encode_kernel(const __grid_constant__ LeafTable t, float* partials, int n_leaves) {
  __shared__ float smem[32];
  const int li = blockIdx.x, w = blockIdx.y;
  const Leaf L = t.leaf[li];
  const long long off = (long long)w * L.n;
  const float* x = L.x + off;
  const float* a = L.a + off;
  const float* r = L.r + off;
  float* nr = L.out0 + off;

  float scale = 0.0f;
  if (L.mode == MODE_INT8) {
    float m = 0.0f;
#pragma unroll 4
    for (long long i = threadIdx.x; i < L.n; i += blockDim.x)
      m = nan_max(m, fabsf(delta_at(x, a, r, i)));
    const float amax = block_reduce(m, smem, MaxOp());
    scale = amax > 0.0f ? __fmul_rn(amax, (float)(1.0 / 127.0)) : 1.0f;
  }
  if (threadIdx.x == 0) L.scale[w] = scale;

  float mx = 0.0f, dsq = 0.0f, esq = 0.0f;
#pragma unroll 4
  for (long long i = threadIdx.x; i < L.n; i += blockDim.x) {
    const float d = delta_at(x, a, r, i);
    float e;
    if (L.mode == MODE_INT8) {
      const float v = rintf(__fdiv_rn(d, scale));
      const int8_t qi = isnan(v) ? (int8_t)0
                                 : (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
      static_cast<int8_t*>(L.q)[off + i] = qi;
      e = __fmaf_rn(-(float)qi, scale, d);
    } else if (L.mode == MODE_BF16) {
      const __nv_bfloat16 qb = __float2bfloat16_rn(d);
      static_cast<__nv_bfloat16*>(L.q)[off + i] = qb;
      e = __fsub_rn(d, __bfloat162float(qb));
    } else {
      static_cast<float*>(L.q)[off + i] = d;
      e = __fsub_rn(d, d);
    }
    nr[i] = e;
    if (partials != nullptr) {
      mx = nan_max(mx, fabsf(e));
      dsq = __fmaf_rn(d, d, dsq);
      esq = __fmaf_rn(e, e, esq);
    }
  }
  if (partials != nullptr) {
    float* p = partials + ((long long)w * n_leaves + li) * 3;
    const float m0 = block_reduce(mx, smem, MaxOp());
    const float s1 = block_reduce(dsq, smem, AddOp());
    const float s2 = block_reduce(esq, smem, AddOp());
    if (threadIdx.x == 0) {
      p[0] = m0;
      p[1] = s1;
      p[2] = s2;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
apply_barriered_kernel(const __grid_constant__ LeafTable t, const float* alive,
                       const float* denom0) {
  const int li = blockIdx.x, w = blockIdx.y;
  const Leaf L = t.leaf[li];
  const long long off = (long long)w * L.n;
  const bool have = denom0[0] > 0.0f;
  const bool rejoin = alive[w] <= 0.0f && have;
  const float* x = L.x + off;
  const float* a = L.a + off;
  const float* r = L.r + off;
  float* nx = L.out0 + off;
  float* nr = L.out1 + off;
#pragma unroll 4
  for (long long i = threadIdx.x; i < L.n; i += blockDim.x) {
    nx[i] = have ? __fadd_rn(a[i], L.mean[i]) : x[i];
    nr[i] = rejoin ? 0.0f : r[i];
  }
}

__global__ void __launch_bounds__(THREADS)
apply_correction_kernel(const __grid_constant__ LeafTable t) {
  const int li = blockIdx.x, w = blockIdx.y;
  const Leaf L = t.leaf[li];
  const long long off = (long long)w * L.n;
  const float s = L.scale[w];
  const float* x = L.x + off;
  const float* a = L.a + off;
  float* nx = L.out0 + off;
  float* na = L.out1 + off;
#pragma unroll 4
  for (long long i = threadIdx.x; i < L.n; i += blockDim.x) {
    const float m = L.mean[i];
    float corr;
    if (L.mode == MODE_INT8) {
      corr = __fmaf_rn(-(float)static_cast<const int8_t*>(L.q)[off + i], s, m);
    } else if (L.mode == MODE_BF16) {
      corr = __fsub_rn(m, __bfloat162float(
                                static_cast<const __nv_bfloat16*>(L.q)[off + i]));
    } else {
      corr = __fsub_rn(m, static_cast<const float*>(L.q)[off + i]);
    }
    nx[i] = __fadd_rn(x[i], corr);
    na[i] = __fadd_rn(a[i], corr);
  }
}

static int fill_table(LeafTable* t, const Leaf* leaves, int n_leaves) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_leaves; ++i) t->leaf[i] = leaves[i];
  return 0;
}

extern "C" {

// partials: (W, n_leaves, 3) float32, or null for no error readout
int sparknet_comm_encode(const Leaf* leaves, int n_leaves, int workers,
                         float* partials, void* stream) {
  LeafTable t;
  int rc = fill_table(&t, leaves, n_leaves);
  if (rc) return rc;
  encode_kernel<<<dim3(n_leaves, workers), THREADS, 0, (cudaStream_t)stream>>>(
      t, partials, n_leaves);
  return (int)cudaGetLastError();
}

// alive: (W,) float32; denom0: one float32, both on the device
int sparknet_comm_apply_barriered(const Leaf* leaves, int n_leaves, int workers,
                                  const float* alive, const float* denom0,
                                  void* stream) {
  LeafTable t;
  int rc = fill_table(&t, leaves, n_leaves);
  if (rc) return rc;
  apply_barriered_kernel<<<dim3(n_leaves, workers), THREADS, 0,
                           (cudaStream_t)stream>>>(t, alive, denom0);
  return (int)cudaGetLastError();
}

int sparknet_comm_apply_correction(const Leaf* leaves, int n_leaves, int workers,
                                   void* stream) {
  LeafTable t;
  int rc = fill_table(&t, leaves, n_leaves);
  if (rc) return rc;
  apply_correction_kernel<<<dim3(n_leaves, workers), THREADS, 0,
                            (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

}  // extern "C"
