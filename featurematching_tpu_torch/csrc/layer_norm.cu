// LayerNorm chain: LN(x) or LN2(LN1(x)) over the last axis in one pass.
//
// Replaces featurematching_tpu/ops/pallas_ln.py · layer_norm_chain
// (_ln_kernel). Bound on the H100: device-memory bytes (one bf16 read and one
// bf16 write of the map, no reuse; a handful of f32 operations per byte).
// Design, for the memory system: a row of C channels lies on C / 8 lanes,
// 8 channels (one 16-byte load) a lane (`fm::RowLn`, shared with K4), so a
// warp load reads 512 contiguous bytes; each warp takes units of kRows
// such loads of consecutive rows and issues all of a unit's loads before
// it reduces any row, so each thread keeps kRows x 16 bytes in flight;
// scales and biases stay in registers; the grid is what the card holds at
// once (ops/layer_norm.plan) and walks the units in a grid-stride loop.
// The second LN runs on the f32 result of the first, with one rounding.

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kRows = 4;        // warp loads a unit: rows in flight a thread
constexpr int kMinBlocks = 2;   // blocks an SM the registers must allow

template <int C, bool TWO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ln_chain_kernel(const fm::bf16* __restrict__ x, const float* __restrict__ s1,
                const float* __restrict__ b1, const float* __restrict__ s2,
                const float* __restrict__ b2, fm::bf16* __restrict__ y, int rows) {
  using Ln = fm::RowLn<C, TWO>;
  constexpr int kUnit = Ln::RW * kRows;  // rows a unit
  const int lane = threadIdx.x % 32;
  const Ln ln(s1, b1, s2, b2, lane);
  const int units = (rows + kUnit - 1) / kUnit;
  const int col = Ln::channel(lane);
  for (int u = blockIdx.x * kWarps + threadIdx.x / 32; u < units; u += gridDim.x * kWarps) {
    const int row0 = u * kUnit + Ln::row_of(lane);
    uint4 raw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r * Ln::RW;
      raw[r] = row < rows ? fm::load16_stream(x + (size_t)row * C + col) : make_uint4(0, 0, 0, 0);
    }
    float v[kRows][8];
#pragma unroll
    for (int r = 0; r < kRows; ++r) fm::unpack8(raw[r], v[r]);
    ln(v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r * Ln::RW;
      if (row < rows) *reinterpret_cast<uint4*>(y + (size_t)row * C + col) = fm::pack8(v[r]);
    }
  }
}

template <int C>
cudaError_t launch(const void* x, const void* s1, const void* b1, const void* s2,
                   const void* b2, void* y, int rows, int two, int grid, cudaStream_t st) {
  auto kernel = two ? ln_chain_kernel<C, true> : ln_chain_kernel<C, false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const fm::bf16*>(x), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<fm::bf16*>(y), rows);
  return cudaGetLastError();
}

// the fewer of the two forms' resident blocks an SM
template <int C>
cudaError_t blocks_per_sm(int* n) {
  int one, two;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&one, ln_chain_kernel<C, false>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&two, ln_chain_kernel<C, true>, kThreads, 0);
  *n = one < two ? one : two;
  return e;
}

}  // namespace

FM_ERROR_STRING_ENTRY

// x, y: [rows, C] bf16 (16-byte aligned); s1, b1, s2, b2: [C] f32 (s2/b2
// read only if two). grid: blocks (ops/layer_norm.plan), at least 1.
extern "C" int fm_layer_norm_chain(const void* x, const void* s1, const void* b1,
                                   const void* s2, const void* b2, void* y,
                                   int rows, int C, int two, int grid, void* stream) {
  if (rows < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return static_cast<int>(launch<64>(x, s1, b1, s2, b2, y, rows, two, grid, st));
    case 128: return static_cast<int>(launch<128>(x, s1, b1, s2, b2, y, rows, two, grid, st));
    case 256: return static_cast<int>(launch<256>(x, s1, b1, s2, b2, y, rows, two, grid, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel's resident blocks an SM at width C (for the grid).
extern "C" int fm_layer_norm_blocks_per_sm(int C, int* n) {
  switch (C) {
    case 64: return static_cast<int>(blocks_per_sm<64>(n));
    case 128: return static_cast<int>(blocks_per_sm<128>(n));
    case 256: return static_cast<int>(blocks_per_sm<256>(n));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
