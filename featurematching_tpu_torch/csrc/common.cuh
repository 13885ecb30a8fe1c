// Helpers shared by the port's kernels: bf16 conversion, warp reductions,
// row LayerNorms and the error-string entry every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fm {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (value, index) argmax across a warp; equal values keep the lower index
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// V consecutive bf16 <-> f32 (V even, pointer 4-byte aligned)
template <int V>
__device__ __forceinline__ void load_bf16(const bf16* p, float* v) {
#pragma unroll
  for (int i = 0; i < V; i += 2) {
    __nv_bfloat162 t = reinterpret_cast<const __nv_bfloat162*>(p)[i / 2];
    v[i] = __low2float(t);
    v[i + 1] = __high2float(t);
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(bf16* p, const float* v) {
#pragma unroll
  for (int i = 0; i < V; i += 2)
    reinterpret_cast<__nv_bfloat162*>(p)[i / 2] = __floats2bfloat162_rn(v[i], v[i + 1]);
}

// LayerNorm over a row spread across one warp, V values per lane, stats in
// f32 (two passes: mean, then mean squared deviation), in place.
template <int V, int C>
__device__ __forceinline__ void warp_layer_norm(float* v, const float* scale,
                                                const float* bias) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s += v[i];
  const float mu = warp_sum(s) * (1.0f / C);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] -= mu;
    q += v[i] * v[i];
  }
  const float r = rsqrtf(warp_sum(q) * (1.0f / C) + kLnEps);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = v[i] * r * scale[i] + bias[i];
}

// 16 bytes of a stream read once, through the non-coherent path without
// keeping them in L1 (the pointer 16-byte aligned)
__device__ __forceinline__ uint4 load16_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// 8 bf16 (16 bytes) <-> 8 f32
__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&t);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The row LayerNorm of the streaming kernels (K3 `layer_norm_chain`, K4
// `patch_expand_ln`): a row of C channels lies on G = C / 8 consecutive
// lanes, 8 channels (16 bytes) a lane, so a warp load covers 32 / G whole
// rows. Statistics in f32 by shuffles within the G lanes, in two passes
// (mean, then mean squared deviation); with TWO, LN2 runs on LN1's f32
// output. Each lane keeps the scales and biases of its 8 channels in
// registers for every row it takes.
template <int C, bool TWO>
struct RowLn {
  static constexpr int G = C / 8;        // lanes a row
  static constexpr int RW = 32 / G;      // rows a warp load
  static_assert(C % 8 == 0 && G >= 1 && G <= 32 && 32 % G == 0, "C: 8 to 256, 32 / G whole");
  float s1[8], b1[8], s2[TWO ? 8 : 1], b2[TWO ? 8 : 1];

  __device__ __forceinline__ RowLn(const float* S1, const float* B1, const float* S2,
                                   const float* B2, int lane) {
    const int c = channel(lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1[i] = __ldg(S1 + c + i);
      b1[i] = __ldg(B1 + c + i);
      if constexpr (TWO) {
        s2[i] = __ldg(S2 + c + i);
        b2[i] = __ldg(B2 + c + i);
      }
    }
  }

  // the first of this lane's 8 channels, and its row within a warp load
  __device__ static __forceinline__ int channel(int lane) { return (lane % G) * 8; }
  __device__ static __forceinline__ int row_of(int lane) { return lane / G; }

  __device__ static __forceinline__ float row_sum(float v) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }

  __device__ static __forceinline__ void norm(float (&v)[8], const float* scale,
                                              const float* bias) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[i];
    const float mu = row_sum(s) * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] -= mu;
      q += v[i] * v[i];
    }
    const float r = rsqrtf(row_sum(q) * (1.0f / C) + kLnEps);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] * r * scale[i] + bias[i];
  }

  // LN1 (and LN2) of R rows in place, one a warp load; every lane of the
  // warp calls this (rows past the end hold zeros)
  template <int R>
  __device__ __forceinline__ void operator()(float (&v)[R][8]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) norm(v[r], s1, b1);
    if constexpr (TWO) {
#pragma unroll
      for (int r = 0; r < R; ++r) norm(v[r], s2, b2);
    }
  }
};

// Copy `rows` rows of `cols` bf16 (cols % 8 == 0) from global (row stride
// `gld`) into shared memory (row stride `sld`) with 16-byte accesses; rows at
// or past `valid` are zero-filled.
__device__ __forceinline__ void copy_rows_to_smem(bf16* dst, int sld, const bf16* src,
                                                  int gld, int rows, int cols,
                                                  int valid) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e % per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * gld + c);
    *reinterpret_cast<uint4*>(dst + r * sld + c) = val;
  }
}

// Copy `rows` rows of `cols` bf16 (cols % 8 == 0) from shared memory (row
// stride `sld`) to global (row stride `gld`) with 16-byte accesses.
__device__ __forceinline__ void copy_rows_from_smem(bf16* dst, int gld, const bf16* src,
                                                    int sld, int rows, int cols) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e % per_row) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * gld + c) =
        *reinterpret_cast<const uint4*>(src + r * sld + c);
  }
}

// two f32 as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace fm

#define FM_ERROR_STRING_ENTRY                                   \
  extern "C" const char* fm_error_string(int e) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(e));     \
  }
