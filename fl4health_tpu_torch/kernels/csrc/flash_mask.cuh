// The key-padding mask of the flash-attention kernels (flash_attention.cu,
// flash_attention_wgmma.cu): batch element b reads row b % rows of block
// b / rows, blocks `stride` floats apart, each row T floats. A [B, T] mask is
// one block of B rows. Under the simulation's vmap over clients the wrapper
// folds the clients into the batch axis; a mask that was not batched over the
// clients is then one block repeated (stride 0), with nothing copied.

#pragma once

#include <cstddef>

struct MaskRows {
  const float* base;
  int rows;
  long long stride;
};

__device__ __forceinline__ const float* mask_row(const MaskRows& m, int b, int T) {
  return m.base + (size_t)(b / m.rows) * m.stride + (size_t)(b % m.rows) * T;
}
