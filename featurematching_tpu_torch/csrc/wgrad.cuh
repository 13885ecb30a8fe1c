// Weight gradients dW = Aᵀ B over the tokens of a batch, shared by the
// training kernels (K8 in swin_block_train.cu, K9 in coarse_transformer_train.cu).
//
// wgrad_kernel forms each 64x64 tile of dW over a run of tokens into a
// per-split partial (raw mma.sync on ldmatrix fragments, double-buffered
// cp.async stages of 64 tokens); sum_parts adds the partials in a fixed
// order, so the gradient is deterministic and no float atomics are used.
#pragma once

#include "tiles.cuh"

namespace fm {

constexpr int WG_T = 64;  // tokens a stage
constexpr int WG_LD = 64 + 8;
constexpr int WG_THREADS = 128;  // 4 warps, each a 32x32 quarter of the 64x64 tile

// part[split][M][N] = sum over the split's tokens t < T of A[t][m] B[t][n].
// A [T][M] (row stride lda), B [T][Nn] (row stride ldb), bf16. Grid (M/64,
// Nn/64, splits); tokens_per_split is a multiple of 64. Stages of 64 tokens
// of A and B are double-buffered with cp.async; a stage's rows at or past T
// are zero-filled. Aᵀ and B fragments come from shared memory through
// ldmatrix (tiles.cuh) into raw mma.sync.
__global__ void __launch_bounds__(WG_THREADS)
wgrad_kernel(const bf16* __restrict__ a, int lda, const bf16* __restrict__ b, int ldb, int T,
             int tokens_per_split, int M, int Nn, float* __restrict__ part) {
  __shared__ __align__(128) bf16 as[2][WG_T * WG_LD];
  __shared__ __align__(128) bf16 bs[2][WG_T * WG_LD];
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 64, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  Acc16 acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) zero(acc[i][j]);
  const int t_begin = split * tokens_per_split;
  const int steps = max(0, (min(T, t_begin + tokens_per_split) - t_begin + WG_T - 1) / WG_T);
  auto load = [&](int stage, int t0) {
    for (int e = threadIdx.x; e < WG_T * 8; e += WG_THREADS) {
      const int r = e / 8, c = (e % 8) * 8;
      if (t0 + r < T) {
        cp_async16(as[stage] + r * WG_LD + c, a + (size_t)(t0 + r) * lda + m0 + c);
        cp_async16(bs[stage] + r * WG_LD + c, b + (size_t)(t0 + r) * ldb + n0 + c);
      } else {
        *reinterpret_cast<uint4*>(as[stage] + r * WG_LD + c) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(bs[stage] + r * WG_LD + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };
  if (steps > 0) load(0, t_begin);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load((s + 1) & 1, t_begin + (s + 1) * WG_T);  // its buffer was freed by the last sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* A = as[s & 1];
    const bf16* B = bs[s & 1];
#pragma unroll
    for (int k = 0; k < WG_T / 16; ++k) {
      uint32_t fa[2][4], fb[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a_trans(fa[i], A + k * 16 * WG_LD + wm + i * 16, WG_LD, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) load_b(fb[j], B + k * 16 * WG_LD + wn + j * 16, WG_LD, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma16(acc[i][j], fa[i], fb[j]);
    }
    __syncthreads();  // every warp is done with this stage before it is loaded again
  }
  float* out = part + ((size_t)split * M + m0) * Nn + n0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      tile_epilogue(acc[i][j], wm + i * 16, wn + j * 16, lane,
                    [&](int r, int c, float v) { out[(size_t)r * Nn + c] = v; });
}

// out[j] = sum over p < nparts of part[p * stride + j], in order of p
__global__ void sum_parts_kernel(const float* __restrict__ part, int nparts, size_t stride,
                                 int len, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[(size_t)p * stride + j];
  out[j] = s;
}

inline cudaError_t sum_parts(const float* part, int nparts, size_t stride, int len, void* out,
                             cudaStream_t st) {
  sum_parts_kernel<<<(len + 255) / 256, 256, 0, st>>>(part, nparts, stride, len,
                                                       static_cast<float*>(out));
  return cudaGetLastError();
}

// out [M][Nn] f32 = Aᵀ B over T tokens, through `splits` partials in part
// (f32 [splits][M][Nn] scratch). M and Nn are multiples of 64.
inline cudaError_t wgrad(const bf16* a, int lda, const bf16* b, int ldb, int T, int splits, int M,
                         int Nn, float* part, void* out, cudaStream_t st) {
  const int tps = ((T + splits - 1) / splits + WG_T - 1) / WG_T * WG_T;
  wgrad_kernel<<<dim3(M / 64, Nn / 64, splits), WG_THREADS, 0, st>>>(a, lda, b, ldb, T, tps, M,
                                                                      Nn, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_parts(part, splits, (size_t)M * Nn, M * Nn, out, st);
}

}  // namespace fm
