// The bfloat16 entries of the fused LRN + 3x3/2 max pool (K7, K8):
// lrn_pool.cu's kernels instantiated for __nv_bfloat16, built as a library
// of their own so that nvcc compiles the two element types in parallel.
#define LRN_POOL_BF16
#include "lrn_pool.cu"
