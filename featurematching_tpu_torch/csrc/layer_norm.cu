// LayerNorm chain: LN(x) or LN2(LN1(x)) over the last axis in one pass.
//
// Replaces featurematching_tpu/ops/pallas_ln.py · layer_norm_chain
// (_ln_kernel). Bound on the H100: device-memory bytes (one bf16 read and one
// bf16 write of the map, no reuse; a handful of f32 operations per byte).
// Design: one warp per row, the row held in registers (C/32 values a lane,
// loaded and stored as bf16 pairs), f32 statistics by warp shuffles, and the
// second LN applied to the f32 result of the first without a round trip.

#include "common.cuh"

namespace {

template <int C>
__global__ void ln_chain_kernel(const fm::bf16* __restrict__ x,
                                const float* __restrict__ s1,
                                const float* __restrict__ b1,
                                const float* __restrict__ s2,
                                const float* __restrict__ b2,
                                fm::bf16* __restrict__ y, int rows, int two) {
  constexpr int V = C / 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float v[V];
  fm::load_bf16<V>(x + (size_t)row * C + lane * V, v);
  fm::warp_layer_norm<V, C>(v, s1 + lane * V, b1 + lane * V);
  if (two) fm::warp_layer_norm<V, C>(v, s2 + lane * V, b2 + lane * V);
  fm::store_bf16<V>(y + (size_t)row * C + lane * V, v);
}

template <int C>
void launch(const void* x, const void* s1, const void* b1, const void* s2,
            const void* b2, void* y, int rows, int two, cudaStream_t st) {
  constexpr int kRowsPerBlock = 8;
  const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_chain_kernel<C><<<grid, 32 * kRowsPerBlock, 0, st>>>(
      static_cast<const fm::bf16*>(x), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<fm::bf16*>(y), rows, two);
}

}  // namespace

FM_ERROR_STRING_ENTRY

// x, y: [rows, C] bf16; s1, b1, s2, b2: [C] f32 (s2/b2 read only if two).
extern "C" int fm_layer_norm_chain(const void* x, const void* s1, const void* b1,
                                   const void* s2, const void* b2, void* y,
                                   int rows, int C, int two, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: launch<64>(x, s1, b1, s2, b2, y, rows, two, st); break;
    case 128: launch<128>(x, s1, b1, s2, b2, y, rows, two, st); break;
    case 256: launch<256>(x, s1, b1, s2, b2, y, rows, two, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
