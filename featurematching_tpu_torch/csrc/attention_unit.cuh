// The window attention unit of the Swin block body (swin_block.cuh: K2, K8's
// forward, K12; K11, window_attention.cu, runs a copy of its arithmetic on
// swizzled tensor-copy boxes): one warp computes
//   softmax(q_h k_h^T * scale + rel_bias[h] + mask) v_h
// for 16 query rows of one head of an 8x8 window whose q|k|v rows lie in
// shared memory ([q | k | v] blocks of C columns, heads d-contiguous within
// each), and writes the result over the unit's own q columns.
//
// Q.K^T runs on mma.sync bf16 tiles (tiles.cuh) into 64 f32 scores a row held
// in registers; the scale, the relative-position bias and the mask are added
// there, the softmax runs across the four lanes that share a row, and P,
// rounded to bf16, goes straight into the A fragments of P.V (the m16n8k16
// accumulator and A layouts line up). No score or probability touches shared
// memory. p = e * (1 / z): dividing each e by z would take the division's
// slow path for the subnormal e^-100 of every masked key.
//
// Rounding follows the TPU kernels: s = q.k in f32, then s * scale + bias in
// f32, then + mask, softmax in f32, p rounded to bf16, p.v summed in f32 and
// rounded to bf16.
#pragma once

#include "tiles.cuh"

namespace fm {

constexpr int kWin = 64;  // tokens of an 8x8 window

// B fragment of the 16x16 tile whose transpose lies row-major at s (s[n][k],
// row stride lds): the keys' rows for Q.K^T
__device__ __forceinline__ void load_bt(uint32_t* r, const bf16* s, int lds, int lane) {
  const int m = lane >> 3;
  ldsm_x4(r, s + ((lane & 7) + (m >> 1) * 8) * lds + (m & 1) * 8);
}

// The accumulator pairs (c[2 jp], c[2 jp + 1]) of key tile kt: their row of
// the unit's 16 and their first key
__device__ __forceinline__ int pair_row(int jp, int lane) { return (lane >> 2) + 8 * (jp & 1); }
__device__ __forceinline__ int pair_col(int kt, int jp, int lane) {
  return 16 * kt + 8 * (jp >> 1) + 2 * (lane & 3);
}

// This lane's mask entries of query rows 16 tm .. 16 tm + 16, from an
// additive [64][64] f32 mask
__device__ __forceinline__ void load_unit_mask(float (&mv)[kWin / 16][8], const float* mask,
                                               int tm, int lane) {
  const float* mr = mask + tm * 16 * kWin;
#pragma unroll
  for (int kt = 0; kt < kWin / 16; ++kt)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const float2 m =
          *reinterpret_cast<const float2*>(mr + pair_row(jp, lane) * kWin + pair_col(kt, jp, lane));
      mv[kt][2 * jp] = m.x;
      mv[kt][2 * jp + 1] = m.y;
    }
}

// One (head hd, query rows 16 tm ..) unit; qkv in shared memory, row stride
// ldq; mv: this lane's mask entries of the unit's rows (MASKED). probs, when
// not null, receives the unit's bf16 probabilities at probs[hd][row][key]
// ([heads][64][64] of the window).
template <int D, bool MASKED>
__device__ __forceinline__ void attention_unit(bf16* qkv, int ldq, int C, int hd, int tm,
                                               float scale, const float* __restrict__ bias,
                                               const float (&mv)[kWin / 16][8], int lane,
                                               bf16* probs = nullptr) {
  constexpr int N = kWin;
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    load_a(qa[kc], qkv + tm * 16 * ldq + hd * D + kc * 16, ldq, lane);
  Acc16 s[N / 16];
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    zero(s[kt]);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t kb[4];
      load_bt(kb, qkv + kt * 16 * ldq + C + hd * D + kc * 16, ldq, lane);
      mma16(s[kt], qa[kc], kb);
    }
  }
  // s[kt].c[j] is the score of row g + 8 ((j >> 1) & 1), key 16 kt + 8 (j >> 2) + 2 t + (j & 1)
  const float* rb = bias + ((size_t)hd * N + tm * 16) * N;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const float2 b = *reinterpret_cast<const float2*>(rb + pair_row(jp, lane) * N +
                                                        pair_col(kt, jp, lane));
      float v0 = __fadd_rn(__fmul_rn(s[kt].c[2 * jp], scale), b.x);
      float v1 = __fadd_rn(__fmul_rn(s[kt].c[2 * jp + 1], scale), b.y);
      if (MASKED) {
        v0 += mv[kt][2 * jp];
        v1 += mv[kt][2 * jp + 1];
      }
      s[kt].c[2 * jp] = v0;
      s[kt].c[2 * jp + 1] = v1;
      mx[jp & 1] = fmaxf(mx[jp & 1], fmaxf(v0, v1));
    }
  float z[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the four lanes of a row hold its 64 keys
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = (j >> 1) & 1;
      s[kt].c[j] = expf(s[kt].c[j] - mx[i]);
      z[i] += s[kt].c[j];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 1);
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 2);
  }
  // P.V: the probabilities of key tile kt are the A fragment of k-step kt
  const float rz[2] = {1.f / z[0], 1.f / z[1]};
  Acc16 o[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) zero(o[nt]);
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    const float* c = s[kt].c;
    uint32_t pa[4] = {pack_bf16(c[0] * rz[0], c[1] * rz[0]), pack_bf16(c[2] * rz[1], c[3] * rz[1]),
                      pack_bf16(c[4] * rz[0], c[5] * rz[0]), pack_bf16(c[6] * rz[1], c[7] * rz[1])};
    if (probs) {  // pa[i]: row g + 8 (i & 1), keys 16 kt + 8 (i >> 1) + 2 t and the next
      uint32_t* pg = reinterpret_cast<uint32_t*>(probs + ((size_t)hd * N + tm * 16 + g) * N +
                                                 16 * kt + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) pg[(i & 1) * 4 * N + (i >> 1) * 4] = pa[i];
    }
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      uint32_t vb[4];
      load_b(vb, qkv + kt * 16 * ldq + 2 * C + hd * D + nt * 16, ldq, lane);
      mma16(o[nt], pa, vb);
    }
  }
  // only this unit reads its q rows and columns: the output goes there
  bf16* dst = qkv + tm * 16 * ldq + hd * D;
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int row = g + 8 * (jp & 1), col = nt * 16 + 8 * (jp >> 1) + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dst + row * ldq + col) =
          __floats2bfloat162_rn(o[nt].c[2 * jp], o[nt].c[2 * jp + 1]);
    }
}

}  // namespace fm
