// Dropout masks of the fused kernels (the transformer block and the conv
// block), drawn in-kernel.
//
// The counter hash of transformer_clip_eeg_tpu_torch/ops/dropout.py (and of
// the JAX block kernel's interpret mode, _dropout_mask(use_prng=False) in
// transformer_clip_eeg_tpu/ops/pallas_block.py): the bits of element `idx`
// of the mask keyed by `key` = seed_base + mask_id, in uint32 arithmetic.
// An element is kept when its bits are >= `thr` = uint32(p * 2^32) and then
// scaled by `keep` = float32(1 / (1 - p)).  Each forward kernel and its
// backward regenerate the same masks from the seed, so no mask is ever
// stored.
#pragma once

#include <stdint.h>

struct DropCfg {
  int on;            // training mode with a non-zero rate
  uint32_t seed;     // the call's seed, mod 2^32
  int tb;            // the JAX kernel's batch tile (pick_tile): masks index per tile
  uint32_t thr;      // drop_p: threshold and keep scale
  float keep;
  uint32_t thr_ffn;  // ffn_drop_p (the FFN inner mask)
  float keep_ffn;
};

// each JAX kernel's per-tile seed multiplier: pallas_block.py _fwd_kernel
// (8191) and pallas_conv.py _fwd_kernel (7577)
constexpr uint32_t BLOCK_TILE_MULT = 8191u;
constexpr uint32_t CONV_TILE_MULT = 7577u;

// per sample: the tile's seed_base = (seed + b / tb) * mult and the sample's
// place inside its tile
struct DropSample {
  uint32_t seed_base;
  int local;
};

__device__ __forceinline__ DropSample drop_sample(const DropCfg& d, int b, uint32_t mult) {
  return DropSample{(d.seed + (uint32_t)(b / d.tb)) * mult, b % d.tb};
}

__device__ __forceinline__ uint32_t drop_bits(uint32_t key, uint32_t idx) {
  uint32_t h = idx + key * 0x9E3779B9u;
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// the mask's multiplier: keep scale or 0
__device__ __forceinline__ float drop_mult(uint32_t key, uint32_t idx,
                                           uint32_t thr, float keep) {
  return drop_bits(key, idx) >= thr ? keep : 0.f;
}

// The block's row-wise masks (ids H .. H + 2, shape [tb T, width]): the
// tile's key base and the row of the tile's mask for row `row` of the B*T;
// element e of a mask of width w is at row * w + e
struct RowDrop {
  uint32_t seed_base, row;
};

__device__ __forceinline__ RowDrop row_drop(const DropCfg& drop, int row, int T) {
  const int b = row / T;
  const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
  return RowDrop{ds.seed_base, (uint32_t)(ds.local * T + (row - b * T))};
}
