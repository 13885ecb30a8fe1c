// Tensor-core tiles for kernels that work on 64-row tiles of tokens:
// bf16 mma.sync.m16n8k16 with f32 accumulation, in the fragment layouts the
// PTX ISA documents, so accumulators are read straight from registers.
//
// A 16x16 output tile is two m16n8k16 products. Its accumulator holds
// c[j], j < 8, at row g + 8 ((j >> 1) & 1), column 8 (j >> 2) + 2 t + (j & 1),
// where g = lane / 4 and t = lane % 4.
//
// Weights (the B operands of the products) are stored in fragment order
// ("packed", ops/coarse_transformer.frag_pack): for each 16-column strip and
// 16-row step, 32 lanes x 8 bf16, so a warp loads a 16x16 tile of B with one
// coalesced 16-byte load a lane. A operands come from shared memory through
// ldmatrix; row strides are multiples of 8 elements (16 bytes).
#pragma once

#include "common.cuh"

namespace fm {

struct Acc16 {
  float c[8];
};

__device__ __forceinline__ void zero(Acc16& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a.c[j] = 0.f;
}

// c[0..4) += A (16x16, 4 regs) . B (16x8, 2 regs)
__device__ __forceinline__ void mma16x8(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A . B for one 16x16x16 step; b: the tile's B fragment (4 regs)
__device__ __forceinline__ void mma16(Acc16& acc, const uint32_t* a, const uint32_t* b) {
  mma16x8(acc.c, a, b[0], b[1]);
  mma16x8(acc.c + 4, a, b[2], b[3]);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared, asynchronously (cp.async, bypassing L1)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's committed groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// A fragment of the 16x16 tile at a (shared, row-major, row stride lda)
__device__ __forceinline__ void load_a(uint32_t* r, const bf16* a, int lda, int lane) {
  ldsm_x4(r, a + (lane & 15) * lda + (lane >> 4) * 8);
}

// A fragment of the transpose of the 16x16 tile at s: A[i][k] = s[k][i]
__device__ __forceinline__ void load_a_trans(uint32_t* r, const bf16* s, int lds, int lane) {
  const int m = lane >> 3;
  ldsm_x4_trans(r, s + ((lane & 7) + (m >> 1) * 8) * lds + (m & 1) * 8);
}

// B fragment of the 16x16 tile at s (shared, row-major [k][n], row stride lds)
__device__ __forceinline__ void load_b(uint32_t* r, const bf16* s, int lds, int lane) {
  const int m = lane >> 3;
  ldsm_x4_trans(r, s + ((lane & 7) + (m & 1) * 8) * lds + (m >> 1) * 8);
}

// The packed tile (k-step kt, strip nt) of a [K, N] weight: strips are
// contiguous runs of K / 16 tiles of 256 bf16
__device__ __forceinline__ const bf16* packed_tile(const bf16* w, int K, int kt, int nt) {
  return w + ((size_t)nt * (K / 16) + kt) * 256;
}

// hand each of the tile's 256 values to epi(row, col, value)
template <typename Epi>
__device__ __forceinline__ void tile_epilogue(const Acc16& acc, int row0, int col0, int lane,
                                              Epi epi) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    epi(row0 + g + 8 * ((j >> 1) & 1), col0 + 8 * (j >> 2) + 2 * t + (j & 1), acc.c[j]);
}

__device__ __forceinline__ float elu1(float v) { return v > 0.f ? v + 1.f : expf(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace fm
