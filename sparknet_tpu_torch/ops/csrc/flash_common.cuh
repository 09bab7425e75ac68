// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// split-TF32 products on mma.sync m16n8k8 and swizzled shared tiles fed by
// cp.async.
//
// Precision.  Every product runs as mma.sync m16n8k8 with TF32 operands,
// split three ways ("3xTF32"): each float32 operand x becomes hi =
// cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi (the small terms first) into a fresh
// float32 accumulator per 8-deep step, which is then added to the running
// sum.  The dropped a_lo b_lo term is ~2^-22 of the product, so the
// results keep float32 accuracy, where one TF32 pass keeps ~3 decimal
// digits (tests/test_torch_flash_bwd.py and tests/test_torch_flash_fwd.py
// emulate both).
//
// Operand layouts.  The m16n8k8 accumulator (thread (g, t) holds columns
// 2t, 2t+1 of rows g, g+8) is taken as the next product's A operand with
// k slots t and t+4 standing for columns 2t and 2t+1 (acc_as_a), and the B
// operand is read with the same permutation (b_colwise): a score tile
// never goes through shared memory.  Shared tiles are unpadded rows of D
// floats with 16-byte chunks XOR-swizzled by the row (column c of row r at
// c ^ 4(r mod 8) where D is a multiple of 32, so both the row-wise B reads
// and the column-wise ones hit 32 distinct banks; c ^ 4(r mod 4) where D
// is an odd multiple of 16, which keeps the swizzle inside the row at the
// cost of some two-way bank conflicts), and cp.async fills them 16 bytes a
// copy: every row a tile is loaded from must start on 16 bytes (the
// wrappers check).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// an A operand (rows g, g+8 at k slots t, t+4) or B operand (k slots t,
// t+4 at column g) of one m16n8k8, as hi and lo TF32 parts
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.hi[i] = to_tf32(x[i]);
    f.lo[i] = to_tf32(x[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// c += a b at float32 accuracy (3xTF32, one fresh accumulator per step)
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float t[4];
  mma_tf32(t, a.lo, b.hi, zero);
  mma_tf32(t, a.hi, b.lo, t);
  mma_tf32(t, a.hi, b.hi, t);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// The accumulator (rows g, g+8; columns 2t, 2t+1) as an A operand whose k
// slots t, t+4 stand for columns 2t, 2t+1: no data moves between lanes.
__device__ __forceinline__ Frag<4> acc_as_a(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split(x);
}

// Above a head dim of 128 a warp cannot keep a 16 x D accumulator in
// registers: the output's columns are split into halves of D / 2 (80 to
// 128 wide), one a block, each block recomputing the products over the
// full D that its half needs (q k^T, do v^T) in the same order, so both
// halves see the same bits of them.
template <int D>
__host__ __device__ constexpr int out_halves() {
  return D > 128 ? 2 : 1;
}

// ---------------------------------------------------------------------
// shared tiles: rows of D floats, 16-byte chunks swizzled by the row
// ---------------------------------------------------------------------
// the swizzle's period in rows: c ^ 4(r mod P) stays inside the row
template <int D>
__host__ __device__ constexpr int sw_period() {
  static_assert(D % 16 == 0, "the kernels take head dims in multiples of 16");
  return D % 32 == 0 ? 8 : 4;
}

template <int D>
__device__ __forceinline__ int sw(int r, int c) {
  return r * D + (c ^ ((r & (sw_period<D>() - 1)) << 2));
}

// B operand, k along the row: (row n, columns c, c + 4)
template <int D>
__device__ __forceinline__ Frag<2> b_rowwise(const float* tile, int n, int c) {
  const float x[2] = {tile[sw<D>(n, c)], tile[sw<D>(n, c + 4)]};
  return split(x);
}

// B operand, k down the column in the permuted slots: rows r, r + 1
template <int D>
__device__ __forceinline__ Frag<2> b_colwise(const float* tile, int r, int c) {
  const float x[2] = {tile[sw<D>(r, c)], tile[sw<D>(r + 1, c)]};
  return split(x);
}

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

// every group but the newest has landed (for this thread's copies)
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// rows [t0, t0 + R) of a (T, D) slice with row stride st, rows past T
// as zeros
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          long long st, int t0, int T) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool in = t0 + r < T;
    cp_async16(tile + sw<D>(r, c), in ? base + (t0 + r) * st + c : base, in);
  }
}

// this thread's A fragments of rows ra, rb of a (T, D) slice
__device__ __forceinline__ float4 a_from_global(const float* base,
                                                long long st, int ra, int rb,
                                                bool ina, bool inb, int c) {
  float4 x;
  x.x = ina ? base[ra * st + c] : 0.f;
  x.y = inb ? base[rb * st + c] : 0.f;
  x.z = ina ? base[ra * st + c + 4] : 0.f;
  x.w = inb ? base[rb * st + c + 4] : 0.f;
  return x;
}

__device__ __forceinline__ Frag<4> split4(float4 v) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  return split(x);
}

// a presplit A operand in shared memory: hi and lo parts, one uint4 each
// per lane, [KS][32] for each group of 16 rows
__device__ __forceinline__ void store_a(uint4* hi, uint4* lo, float4 v) {
  const Frag<4> f = split4(v);
  *hi = make_uint4(f.hi[0], f.hi[1], f.hi[2], f.hi[3]);
  *lo = make_uint4(f.lo[0], f.lo[1], f.lo[2], f.lo[3]);
}

__device__ __forceinline__ Frag<4> load_a(const uint4* hi, const uint4* lo) {
  const uint4 h = *hi, l = *lo;
  return {{h.x, h.y, h.z, h.w}, {l.x, l.y, l.z, l.w}};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;  // above 48 KB a block needs the opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) *configured = true;
  return e;
}

}  // namespace
