// Averaging-epilogue kernels of the comm plane, for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of sparknet_tpu/ops/pallas_comm.py:
//   sparknet_comm_encode            <- _encode_kernel (:83)
//   sparknet_comm_apply_barriered   <- _apply_barriered_kernel (:164)
//   sparknet_comm_apply_correction  <- _apply_correction_kernel (:224)
// One call per comm chunk, as on the TPU, for a chunk of at most
// MAX_LEAVES leaves; the wrapper (ops/cuda_comm.py) cuts a larger chunk
// into consecutive groups of MAX_LEAVES and makes one call a group.
// Where Pallas hands each leaf of the chunk in as its own ref, here a
// table of per-leaf records
// (pointers, elements per worker, quantization mode, where the leaf's
// tiles start) rides in as the kernel's parameter block
// (__grid_constant__, read in place from the constant bank), so a launch
// needs no host-to-device copy and no synchronisation to set it up.
//
// What bounds them: bytes.  Per element the int8 encode reads x, anchor
// and residual (12 B) and writes the int8 payload and the new residual
// (5 B); the applies move 16-21 B.  Arithmetic is a few flops per
// element.  A chunk's leaves range from a few floats to fc6's 37,748,736
// per worker (AlexNet), so the grid is cut by elements, not by leaves:
//
// Tile map (all three kernels).  Each worker's slice of a leaf is
// cut into tiles of TILE elements (a slice shorter than that, even an
// empty one, is one tile), and every (leaf, worker, tile) is one block of
// THREADS threads: leaf-major, then worker, then tile, so a slice's tiles
// are consecutive blocks.  The table carries each leaf's first block; a
// block finds its leaf by a binary search over at most MAX_LEAVES
// entries.  Inside a tile the threads move 16 bytes a load (x, a, r,
// mean, the residual; 4 bytes of int8 or 8 of bf16 payload), UNROLL
// loads of each array in flight before any is used.  A worker's slice
// starts at w * n, which is a multiple of 4 only when n is: the elements
// before the first 16-byte boundary and after the last are taken one by
// one, and a leaf whose pointers are not all 16-byte aligned is taken
// one by one throughout.
//
// Encode, int8.  The scale needs max |delta| over the whole slice before
// any element can be quantized, so two launches: A forms delta, stores it
// where the residual goes, and writes each tile's max |delta| to a
// scratch array; the last tile of a slice to finish (it draws the last
// ticket of the slice's counter) reduces the slice's tile maxima into
// the scale.  B reads delta back, quantizes it with the scale and writes
// q and the residual over it.  bf16 and fp32 need no scale: B alone, one
// pass from x, a and r.  With the error readout, B writes each tile's
// [max |err|, sum delta^2, sum err^2] to scratch and the last tile of the
// slice reduces them, in tile order, into the (W, leaves, 3) readout.
// The counters are zeros the caller provides for each call.  An int8
// encode moves 25 B per element (A: x, a, r in, delta out; B: delta in,
// q and the residual out), against the function's 17 B.
//
// Overlap correction (K11): one pass on the same tile map.  A block
// reads its worker's scale once; each thread keeps UNROLL 16-byte loads
// of x, a and the mean and UNROLL 4-element loads of the payload (4 B of
// int8, 8 of bf16, 16 of fp32) in flight, and writes x' and a'.  No
// scratch, no counters.  It moves 18 B an element for bf16 (x, a, q in,
// x', a' out) plus the mean, which each worker's tiles read again: 22 B.
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
// and there is no --use_fast_math.  A max is exact in any order, so the
// scale and the readout's max |err| are too; the readout's two sums are
// reduced in a fixed order (threads in element order, the block's
// threads, then the slice's tiles in tile order) and held to a
// tolerance against the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEAVES 32

namespace {

// the tile map's kernels: elements of one worker's slice a block takes,
// threads a block, 16-byte loads of each array a thread has in flight.
// Of the shapes tools/comm_tiles.py times, 8,192-element tiles gave the
// least K9 + K10 time at AlexNet's leaves but for 16,384 (1% less there,
// 28% more at cifar10_full's); 4,096 lose 6% at AlexNet, where an int8
// encode's launch B reads one array, and gain 0.01 ms a round at
// cifar10_full's.  K11 takes within 1% of the same time at 4,096-16,384
// (PERF.md §6).
constexpr int TILE = 8192;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;
static_assert(TILE % 4 == 0 && THREADS % 32 == 0, "tiles of 16-byte vectors");

enum { MODE_F32 = 0, MODE_BF16 = 1, MODE_INT8 = 2 };

}  // namespace

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
  long long first;    // the leaf's first block in the tile map (filled here)
  int mode;           // MODE_*
  int tiles;          // tiles of one worker's slice (filled here)
};

struct LeafTable {
  Leaf leaf[MAX_LEAVES];
};

namespace {

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

__device__ __forceinline__ float delta_of(float x, float a, float r) {
  return __fadd_rn(__fsub_rn(x, a), r);
}

// ---------------------------------------------------------------------
// the tile map
// ---------------------------------------------------------------------
// this block's (leaf, worker, tile) and the elements of its tile in the
// worker's slice: [i0, i0 + len), of which [i0 + head, i0 + head + 4 nvec)
// start on 16 bytes in every array of the leaf (vectorize)
struct Tile {
  int li, w;
  long long tile;  // within the slice
  long long i0;    // first element, in slice coordinates
  long long off;   // the slice's first element in the (W, n) arrays
  int len, head, nvec;
};

__device__ __forceinline__ Tile locate(const LeafTable& t, int n_leaves) {
  const long long b = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;  // the last leaf whose first block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  Tile k;
  k.li = lo;
  const long long local = b - L.first;
  k.w = (int)(local / L.tiles);
  k.tile = local % L.tiles;
  k.i0 = k.tile * TILE;
  k.off = (long long)k.w * L.n;
  k.len = (int)max(0LL, min((long long)TILE, L.n - k.i0));
  return k;
}

// head and nvec of the tile; a leaf with a pointer off 16 bytes is taken
// one element at a time
__device__ __forceinline__ void vectorize(Tile& k, bool aligned) {
  const int head = aligned ? (int)((4 - ((k.off + k.i0) & 3)) & 3) : k.len;
  k.head = min(head, k.len);
  k.nvec = (k.len - k.head) >> 2;
}

// the i-th of the tile's elements taken one by one (head, then tail), for
// i < head + tail
__device__ __forceinline__ long long scalar_at(const Tile& k, int i) {
  return k.i0 + (i < k.head ? i : k.head + 4 * k.nvec + (i - k.head));
}

__device__ __forceinline__ int scalar_count(const Tile& k) {
  return k.len - 4 * k.nvec;
}

__device__ __forceinline__ bool al16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Publish this tile's K values to scratch[block K .. block K + K) and
// draw a ticket of its slice's counter; true in every thread of the
// block that drew the slice's last ticket, which may then read every
// tile's values of the slice.
template <int K>
__device__ bool publish(float* scratch, const float (&v)[K],
                        unsigned* counter, int tiles) {
  __shared__ int last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) scratch[(long long)blockIdx.x * K + j] = v[j];
    __threadfence();  // the values are visible before the ticket is
    const unsigned ticket = atomicAdd(counter, 1u);
    last = ticket == (unsigned)(tiles - 1);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// the slice's tile values j of scratch, reduced with op: threads in tile
// order, then the block
template <int K, typename Op>
__device__ float reduce_tiles(const float* scratch, long long first, int tiles,
                              int j, float* smem, Op op) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < tiles; i += blockDim.x)
    v = op(v, __ldcg(scratch + (first + i) * K + j));
  return block_reduce(v, smem, op);
}

// ---------------------------------------------------------------------
// K9: encode
// ---------------------------------------------------------------------
__device__ __forceinline__ bool encode_aligned(const Leaf& L) {
  return al16(L.x) && al16(L.a) && al16(L.r) && al16(L.q) && al16(L.out0);
}

__device__ __forceinline__ int8_t int8_of(float d, float scale) {
  const float v = rintf(__fdiv_rn(d, scale));
  return isnan(v) ? (int8_t)0 : (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
}

// one element's payload and residual
__device__ __forceinline__ float quantize(float d, float scale, int mode,
                                          void* q, long long gi) {
  if (mode == MODE_INT8) {
    const int8_t qi = int8_of(d, scale);
    static_cast<int8_t*>(q)[gi] = qi;
    return __fmaf_rn(-(float)qi, scale, d);
  }
  if (mode == MODE_BF16) {
    const __nv_bfloat16 qb = __float2bfloat16_rn(d);
    static_cast<__nv_bfloat16*>(q)[gi] = qb;
    return __fsub_rn(d, __bfloat162float(qb));
  }
  static_cast<float*>(q)[gi] = d;
  return __fsub_rn(d, d);
}

// four elements' payloads (one 4-, 8- or 16-byte store) and residuals
__device__ __forceinline__ float4 quantize4(float4 d, float scale, int mode,
                                           void* q, long long gi) {
  const float dv[4] = {d.x, d.y, d.z, d.w};
  float e[4];
  if (mode == MODE_INT8) {
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t qi = int8_of(dv[j], scale);
      packed |= (uint32_t)(uint8_t)qi << (8 * j);
      e[j] = __fmaf_rn(-(float)qi, scale, dv[j]);
    }
    *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(q) + gi) = packed;
  } else if (mode == MODE_BF16) {
    uint32_t bits[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16 qb = __float2bfloat16_rn(dv[j]);
      bits[j] = __bfloat16_as_ushort(qb);
      e[j] = __fsub_rn(dv[j], __bfloat162float(qb));
    }
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(q) + gi) =
        make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = __fsub_rn(dv[j], dv[j]);
    *reinterpret_cast<float4*>(static_cast<float*>(q) + gi) = d;
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

// Launch A of an int8 encode: each tile's max |delta|; the slice's last
// tile turns the slice's maxima into its scale.  Blocks of other modes'
// leaves return at once.
__global__ void __launch_bounds__(THREADS)
encode_amax_kernel(const __grid_constant__ LeafTable t, int n_leaves,
                   int workers, float* scratch, unsigned* counters) {
  __shared__ float smem[32];
  Tile k = locate(t, n_leaves);
  const Leaf& L = t.leaf[k.li];
  vectorize(k, encode_aligned(L));
  if (L.mode != MODE_INT8) return;
  const float* x = L.x + k.off;
  const float* a = L.a + k.off;
  const float* r = L.r + k.off;
  float* dout = L.out0 + k.off;  // delta, for launch B
  float m = 0.0f;
  for (int i = threadIdx.x; i < scalar_count(k); i += THREADS) {
    const long long e = scalar_at(k, i);
    const float d = delta_of(x[e], a[e], r[e]);
    dout[e] = d;
    m = nan_max(m, fabsf(d));
  }
  const long long v0 = k.i0 + k.head;
  for (int base = threadIdx.x; base < k.nvec; base += THREADS * UNROLL) {
    float4 xv[UNROLL], av[UNROLL], rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = v0 + 4LL * (base + u * THREADS);
      if (base + u * THREADS < k.nvec) {
        xv[u] = ld4(x + e);
        av[u] = ld4(a + e);
        rv[u] = ld4(r + e);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * THREADS < k.nvec) {
        const long long e = v0 + 4LL * (base + u * THREADS);
        const float4 d = make_float4(delta_of(xv[u].x, av[u].x, rv[u].x),
                                     delta_of(xv[u].y, av[u].y, rv[u].y),
                                     delta_of(xv[u].z, av[u].z, rv[u].z),
                                     delta_of(xv[u].w, av[u].w, rv[u].w));
        *reinterpret_cast<float4*>(dout + e) = d;
        m = nan_max(m, fabsf(d.x));
        m = nan_max(m, fabsf(d.y));
        m = nan_max(m, fabsf(d.z));
        m = nan_max(m, fabsf(d.w));
      }
    }
  }
  const float tile_max[1] = {block_reduce(m, smem, MaxOp())};
  if (publish<1>(scratch, tile_max, counters + (long long)k.li * workers + k.w,
                 L.tiles)) {
    const float amax = reduce_tiles<1>(
        scratch, L.first + (long long)k.w * L.tiles, L.tiles, 0, smem, MaxOp());
    if (threadIdx.x == 0)
      L.scale[k.w] = amax > 0.0f ? __fmul_rn(amax, (float)(1.0 / 127.0)) : 1.0f;
  }
}

// Launch B of an encode (the only one of bf16 and fp32): payload and
// residual of each tile, and with `partials` the readout, each tile's
// reduced by the slice's last tile into partials (W, n_leaves, 3).  An
// int8 leaf's delta is launch A's, read back from the residual's place.
__global__ void __launch_bounds__(THREADS)
encode_kernel(const __grid_constant__ LeafTable t, int n_leaves, int workers,
              float* partials, float* scratch, unsigned* counters) {
  __shared__ float smem[32];
  Tile k = locate(t, n_leaves);
  const Leaf& L = t.leaf[k.li];
  vectorize(k, encode_aligned(L));
  const int mode = L.mode;
  const float* x = L.x + k.off;
  const float* a = L.a + k.off;
  const float* r = L.r + k.off;
  float* nr = L.out0 + k.off;
  const bool staged = mode == MODE_INT8;  // delta is in nr
  float scale = 0.0f;
  if (staged) {
    scale = L.scale[k.w];  // launch A's
  } else if (k.tile == 0 && threadIdx.x == 0) {
    L.scale[k.w] = 0.0f;
  }
  const bool readout = partials != nullptr;
  float mx = 0.0f, dsq = 0.0f, esq = 0.0f;
  for (int i = threadIdx.x; i < scalar_count(k); i += THREADS) {
    const long long e = scalar_at(k, i);
    const float d = staged ? nr[e] : delta_of(x[e], a[e], r[e]);
    const float err = quantize(d, scale, mode, L.q, k.off + e);
    nr[e] = err;
    if (readout) {
      mx = nan_max(mx, fabsf(err));
      dsq = __fmaf_rn(d, d, dsq);
      esq = __fmaf_rn(err, err, esq);
    }
  }
  const long long v0 = k.i0 + k.head;
  for (int base = threadIdx.x; base < k.nvec; base += THREADS * UNROLL) {
    float4 xv[UNROLL], av[UNROLL], rv[UNROLL];  // xv: delta where staged
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = v0 + 4LL * (base + u * THREADS);
      if (base + u * THREADS < k.nvec) {
        if (staged) {
          xv[u] = __ldcs(reinterpret_cast<const float4*>(nr + e));
        } else {
          xv[u] = ld4(x + e);
          av[u] = ld4(a + e);
          rv[u] = ld4(r + e);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * THREADS < k.nvec) {
        const long long e = v0 + 4LL * (base + u * THREADS);
        const float4 d =
            staged ? xv[u]
                   : make_float4(delta_of(xv[u].x, av[u].x, rv[u].x),
                                 delta_of(xv[u].y, av[u].y, rv[u].y),
                                 delta_of(xv[u].z, av[u].z, rv[u].z),
                                 delta_of(xv[u].w, av[u].w, rv[u].w));
        const float4 err = quantize4(d, scale, mode, L.q, k.off + e);
        *reinterpret_cast<float4*>(nr + e) = err;
        if (readout) {
          const float dv[4] = {d.x, d.y, d.z, d.w};
          const float ev[4] = {err.x, err.y, err.z, err.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mx = nan_max(mx, fabsf(ev[j]));
            dsq = __fmaf_rn(dv[j], dv[j], dsq);
            esq = __fmaf_rn(ev[j], ev[j], esq);
          }
        }
      }
    }
  }
  if (!readout) return;
  const float tile_parts[3] = {block_reduce(mx, smem, MaxOp()),
                               block_reduce(dsq, smem, AddOp()),
                               block_reduce(esq, smem, AddOp())};
  // launch A drew from the first n_leaves x W counters
  if (publish<3>(scratch, tile_parts,
                 counters + ((long long)n_leaves + k.li) * workers + k.w,
                 L.tiles)) {
    const long long first = L.first + (long long)k.w * L.tiles;
    const float m0 = reduce_tiles<3>(scratch, first, L.tiles, 0, smem, MaxOp());
    const float s1 = reduce_tiles<3>(scratch, first, L.tiles, 1, smem, AddOp());
    const float s2 = reduce_tiles<3>(scratch, first, L.tiles, 2, smem, AddOp());
    if (threadIdx.x == 0) {
      float* p = partials + ((long long)k.w * n_leaves + k.li) * 3;
      p[0] = m0;
      p[1] = s1;
      p[2] = s2;
    }
  }
}

// ---------------------------------------------------------------------
// K10: barriered apply
// ---------------------------------------------------------------------
__device__ __forceinline__ bool barriered_aligned(const Leaf& L) {
  return al16(L.x) && al16(L.a) && al16(L.r) && al16(L.mean) &&
         al16(L.out0) && al16(L.out1);
}

__global__ void __launch_bounds__(THREADS)
apply_barriered_kernel(const __grid_constant__ LeafTable t, int n_leaves,
                       const float* alive, const float* denom0) {
  Tile k = locate(t, n_leaves);
  const Leaf& L = t.leaf[k.li];
  vectorize(k, barriered_aligned(L));
  const bool have = denom0[0] > 0.0f;
  const bool rejoin = alive[k.w] <= 0.0f && have;
  const float* x = L.x + k.off;
  const float* a = L.a + k.off;
  const float* r = L.r + k.off;
  const float* m = L.mean;  // slice coordinates: one mean for every worker
  float* nx = L.out0 + k.off;
  float* nr = L.out1 + k.off;
  for (int i = threadIdx.x; i < scalar_count(k); i += THREADS) {
    const long long e = scalar_at(k, i);
    nx[e] = have ? __fadd_rn(a[e], m[e]) : x[e];
    nr[e] = rejoin ? 0.0f : r[e];
  }
  // the slice's 16-byte vectors are the mean's only where w * n is a
  // multiple of 4; elsewhere the mean is read one float at a time
  const bool mvec = (k.off & 3) == 0;
  const long long v0 = k.i0 + k.head;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int base = threadIdx.x; base < k.nvec; base += THREADS * UNROLL) {
    float4 pv[UNROLL], mv[UNROLL], rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = v0 + 4LL * (base + u * THREADS);
      if (base + u * THREADS < k.nvec) {
        pv[u] = ld4((have ? a : x) + e);
        if (have) {
          mv[u] = mvec ? ld4(m + e)
                       : make_float4(__ldg(m + e), __ldg(m + e + 1),
                                     __ldg(m + e + 2), __ldg(m + e + 3));
        }
        rv[u] = rejoin ? zero : ld4(r + e);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * THREADS < k.nvec) {
        const long long e = v0 + 4LL * (base + u * THREADS);
        if (have) {
          pv[u] = make_float4(__fadd_rn(pv[u].x, mv[u].x), __fadd_rn(pv[u].y, mv[u].y),
                              __fadd_rn(pv[u].z, mv[u].z), __fadd_rn(pv[u].w, mv[u].w));
        }
        *reinterpret_cast<float4*>(nx + e) = pv[u];
        *reinterpret_cast<float4*>(nr + e) = rv[u];
      }
    }
  }
}

// ---------------------------------------------------------------------
// K11: overlap correction
// ---------------------------------------------------------------------
__device__ __forceinline__ bool correction_aligned(const Leaf& L) {
  return al16(L.x) && al16(L.a) && al16(L.q) && al16(L.mean) &&
         al16(L.out0) && al16(L.out1);
}

// element gi of the payload as a float (exact: int8 and bf16 values are
// floats)
__device__ __forceinline__ float payload_at(const void* q, long long gi,
                                            int mode) {
  if (mode == MODE_INT8) return (float)__ldg(static_cast<const int8_t*>(q) + gi);
  if (mode == MODE_BF16) {
    return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(q) + gi));
  }
  return __ldg(static_cast<const float*>(q) + gi);
}

// elements gi .. gi + 3 of the payload in one 4-, 8- or 16-byte load
__device__ __forceinline__ float4 payload4_at(const void* q, long long gi,
                                              int mode) {
  if (mode == MODE_INT8) {
    const uint32_t p =
        __ldg(reinterpret_cast<const unsigned*>(static_cast<const int8_t*>(q) + gi));
    return make_float4((float)(int8_t)(p & 0xffu), (float)(int8_t)((p >> 8) & 0xffu),
                       (float)(int8_t)((p >> 16) & 0xffu), (float)(int8_t)(p >> 24));
  }
  if (mode == MODE_BF16) {  // a bf16's bits are the top half of its float's
    const uint2 p = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(q) + gi));
    return make_float4(__uint_as_float(p.x << 16), __uint_as_float(p.x & 0xffff0000u),
                       __uint_as_float(p.y << 16), __uint_as_float(p.y & 0xffff0000u));
  }
  return ld4(static_cast<const float*>(q) + gi);
}

// mean - dequant(q): int8 contracts mean - q * scale into one FMA, as XLA
__device__ __forceinline__ float correction(float m, float qv, float s,
                                            int mode) {
  return mode == MODE_INT8 ? __fmaf_rn(-qv, s, m) : __fsub_rn(m, qv);
}

__global__ void __launch_bounds__(THREADS)
apply_correction_kernel(const __grid_constant__ LeafTable t, int n_leaves) {
  Tile k = locate(t, n_leaves);
  const Leaf& L = t.leaf[k.li];
  vectorize(k, correction_aligned(L));
  const int mode = L.mode;
  const float s = L.scale[k.w];
  const float* x = L.x + k.off;
  const float* a = L.a + k.off;
  const float* m = L.mean;  // slice coordinates: one mean for every worker
  float* nx = L.out0 + k.off;
  float* na = L.out1 + k.off;
  for (int i = threadIdx.x; i < scalar_count(k); i += THREADS) {
    const long long e = scalar_at(k, i);
    const float corr = correction(m[e], payload_at(L.q, k.off + e, mode), s, mode);
    nx[e] = __fadd_rn(x[e], corr);
    na[e] = __fadd_rn(a[e], corr);
  }
  // the mean's 16-byte vectors are the slice's only where w * n is a
  // multiple of 4, as in K10
  const bool mvec = (k.off & 3) == 0;
  const long long v0 = k.i0 + k.head;
  for (int base = threadIdx.x; base < k.nvec; base += THREADS * UNROLL) {
    float4 xv[UNROLL], av[UNROLL], mv[UNROLL], qv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = v0 + 4LL * (base + u * THREADS);
      if (base + u * THREADS < k.nvec) {
        xv[u] = ld4(x + e);
        av[u] = ld4(a + e);
        mv[u] = mvec ? ld4(m + e)
                     : make_float4(__ldg(m + e), __ldg(m + e + 1),
                                   __ldg(m + e + 2), __ldg(m + e + 3));
        qv[u] = payload4_at(L.q, k.off + e, mode);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * THREADS < k.nvec) {
        const long long e = v0 + 4LL * (base + u * THREADS);
        const float4 c = make_float4(correction(mv[u].x, qv[u].x, s, mode),
                                     correction(mv[u].y, qv[u].y, s, mode),
                                     correction(mv[u].z, qv[u].z, s, mode),
                                     correction(mv[u].w, qv[u].w, s, mode));
        *reinterpret_cast<float4*>(nx + e) =
            make_float4(__fadd_rn(xv[u].x, c.x), __fadd_rn(xv[u].y, c.y),
                        __fadd_rn(xv[u].z, c.z), __fadd_rn(xv[u].w, c.w));
        *reinterpret_cast<float4*>(na + e) =
            make_float4(__fadd_rn(av[u].x, c.x), __fadd_rn(av[u].y, c.y),
                        __fadd_rn(av[u].z, c.z), __fadd_rn(av[u].w, c.w));
      }
    }
  }
}

// Copy the chunk's leaves into the table and lay out the tile map; the
// map's blocks, or -1 for a chunk the kernels do not take.
long long fill_table(LeafTable* t, const Leaf* leaves, int n_leaves,
                     int workers) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || workers < 1) return -1;
  long long blocks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    Leaf L = leaves[i];
    if (L.n < 0) return -1;
    L.tiles = (int)((L.n + TILE - 1) / TILE);
    if (L.tiles < 1) L.tiles = 1;  // an empty slice still writes its scale
    L.first = blocks;
    blocks += (long long)L.tiles * workers;
    t->leaf[i] = L;
  }
  return blocks <= 0x7fffffffLL ? blocks : -1;
}

}  // namespace

extern "C" {

// The blocks of a chunk's tile map: the encode's `scratch` holds 3 floats
// a block.  0 for a chunk the kernels do not take.
int sparknet_comm_blocks(const Leaf* leaves, int n_leaves, int workers) {
  LeafTable t;
  const long long blocks = fill_table(&t, leaves, n_leaves, workers);
  return blocks < 0 ? 0 : (int)blocks;
}

// partials: (W, n_leaves, 3) float32, or null for no error readout;
// scratch: 3 floats a block of the tile map; counters: 2 x n_leaves x W
// zeros for each call (launch A's tickets, then the readout's)
int sparknet_comm_encode(const Leaf* leaves, int n_leaves, int workers,
                         float* partials, float* scratch, unsigned* counters,
                         void* stream) {
  LeafTable t;
  const long long blocks = fill_table(&t, leaves, n_leaves, workers);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  bool int8 = false;
  for (int i = 0; i < n_leaves; ++i) int8 = int8 || leaves[i].mode == MODE_INT8;
  if (int8) {
    encode_amax_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(t, n_leaves, workers,
                                                             scratch, counters);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  encode_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(t, n_leaves, workers,
                                                      partials, scratch, counters);
  return (int)cudaGetLastError();
}

// alive: (W,) float32; denom0: one float32, both on the device
int sparknet_comm_apply_barriered(const Leaf* leaves, int n_leaves, int workers,
                                  const float* alive, const float* denom0,
                                  void* stream) {
  LeafTable t;
  const long long blocks = fill_table(&t, leaves, n_leaves, workers);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  apply_barriered_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      t, n_leaves, alive, denom0);
  return (int)cudaGetLastError();
}

int sparknet_comm_apply_correction(const Leaf* leaves, int n_leaves, int workers,
                                   void* stream) {
  LeafTable t;
  const long long blocks = fill_table(&t, leaves, n_leaves, workers);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  apply_correction_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      t, n_leaves);
  return (int)cudaGetLastError();
}

}  // extern "C"
