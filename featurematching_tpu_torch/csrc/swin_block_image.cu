// K12: the Swin block over a padded image-layout map (kernel in swin_block.cuh).
//
// Replaces featurematching_tpu/ops/pallas_swin_block.py · swin_block_fused_image
// (_image_kernel, pad_region_masks), reached through swin_block_image. It is
// K2's block with the window partition, reverse and shifted roll absorbed
// into the addressing: the block of window (b, r, c) reads its 64 tokens
// straight from rows 8r.. and columns 8c.. of image b with 16-byte loads and
// writes its output to the same coordinates, so no partitioned or rolled
// copy of the map exists. With a shift the caller pads the map as the pad
// formulation does, and the kernel derives each token's region label from
// its coordinates (swin_block.cuh · region_band) rather than reading masks:
// the same -100 / 0 mask as pad_region_masks. Bound on the H100 by
// tensor-core operations, as K2.

#include "swin_block.cuh"

FM_ERROR_STRING_ENTRY

// x, out: [B, Hp2, Wp2, C] bf16, Hp2 and Wp2 multiples of 8; shift 0 (no
// mask) or in (0, 8). Weights as fm_swin_block: bf16 in [in, out] layout,
// LN scales and biases and dense biases f32, rel_bias [C/D, 64, 64] f32;
// D the head dim, 16, 32 or 64.
extern "C" int fm_swin_block_image(const void* x, int B, int Hp2, int Wp2, int shift,
                                   const void* ln1s, const void* ln1b, const void* wqkv,
                                   const void* bqkv, const void* rel_bias, const void* wproj,
                                   const void* bproj, const void* ln2s, const void* ln2b,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* out, int C, int D, void* stream) {
  if (B <= 0 || Hp2 <= 0 || Wp2 <= 0 || Hp2 % 8 || Wp2 % 8 || shift < 0 || shift >= 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* p[13] = {ln1s, ln1b, wqkv, bqkv, rel_bias, wproj, bproj,
                       ln2s, ln2b, w1,   b1,   w2,    b2};
  const swin::ImageIO img{Hp2, Wp2, shift};
  const int windows = B * (Hp2 / 8) * (Wp2 / 8);
  return static_cast<int>(swin::launch_block_at<16, 32, 64>(
      C, D, {}, x, nullptr, 0, p, out, windows, static_cast<cudaStream_t>(stream), img));
}
