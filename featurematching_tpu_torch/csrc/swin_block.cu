// K2: the serving forward of the Swin block (kernel in swin_block.cuh).
//
// Replaces featurematching_tpu/ops/pallas_swin_block.py · swin_block_fused
// (_block_kernel / _block_math); the design notes are in swin_block.cuh.

#include "swin_block.cuh"

FM_ERROR_STRING_ENTRY

// x, out: [num_windows, 64, C] bf16. mask: [nW, 64, 64] f32 additive, window
// w uses mask[w % nW]; nW = 0 means no mask. Weights bf16 in [in, out]
// layout: w_qkv [C, 3C], w_proj [C, C], w1 [C, 4C], w2 [4C, C]. LN scales,
// biases and dense biases f32; rel_bias [C/D, 64, 64] f32. D: the head dim, 16, 32 or 64.
extern "C" int fm_swin_block(const void* x, const void* mask, int nW, const void* ln1s,
                             const void* ln1b, const void* wqkv, const void* bqkv,
                             const void* rel_bias, const void* wproj, const void* bproj,
                             const void* ln2s, const void* ln2b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* out,
                             int num_windows, int C, int D, void* stream) {
  const void* p[13] = {ln1s, ln1b, wqkv, bqkv, rel_bias, wproj, bproj,
                       ln2s, ln2b, w1,   b1,   w2,    b2};
  return static_cast<int>(swin::launch_block_at<16, 32, 64>(
      C, D, {}, x, mask, nW, p, out, num_windows, static_cast<cudaStream_t>(stream)));
}
