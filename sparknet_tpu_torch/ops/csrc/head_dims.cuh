// The head dims the attention kernels (flash_fwd.cu, flash_bwd.cu,
// decode_attention.cu) are built for: every multiple of 16 up to 128,
// then every multiple of 32 up to 256.
// ops/cuda_attention.py's KERNEL_HEAD_DIMS lists the same.
// FLASH_HEAD_DIMS(X) expands X(d) for each of them.

#pragma once

#define FLASH_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(160) X(192) X(224) X(256)
