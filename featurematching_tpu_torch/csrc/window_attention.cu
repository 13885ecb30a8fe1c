// K11: window multi-head attention over 8x8 windows,
//   out[b, :, head] = softmax(q_h k_h^T * scale + rel_bias[h] + mask[b % nW]) v_h
// with qkv [B_, 64, 3C] in the qkv Dense's layout ([q | k | v] blocks, heads
// d-contiguous within each) and out [B_, 64, C].
//
// Replaces featurematching_tpu/ops/pallas_window_attention.py ·
// window_attention_pallas (_wmsa_kernel / _wmsa_masked_kernel). Bound on the
// H100 by device-memory bytes: a window moves 8 * 64 * C bytes of q, k, v
// and out for 4 * 64 * 64 * C operations, 32 operations a byte, far under
// the tensor cores' 295. Design:
//   - One block a window. Its q|k|v rows are read once from device memory
//     with 16-byte loads into shared memory (24.6-97 KB at C = 64-256).
//   - A warp takes whole (head, 16 query rows) units: Q.K^T on mma.sync
//     bf16 tiles (tiles.cuh) into 64 f32 scores a row held in registers,
//     the scale, the relative-position bias and the shift mask added there,
//     the softmax across the four lanes that share a row, and P rounded to
//     bf16 straight into the A fragments of P.V (the accumulator and A
//     layouts of m16n8k16 line up), so no score or probability touches
//     shared memory. A unit's output overwrites the q columns only it reads;
//     the block then writes its [64, C] output with 16-byte stores.
//   - The mask of window b is mask[b % nW], indexed here: no per-window
//     copy of the mask is made. A warp's units share their 16 query rows
//     (kWarps is a multiple of the four row tiles), so each lane reads its
//     32 mask entries once into registers for all the warp's heads.
//
// Rounding follows the TPU kernel: s = q.k in f32, then s * scale + bias in
// f32, then + mask, softmax in f32, p rounded to bf16, p.v summed in f32 and
// rounded to bf16.

#include "tiles.cuh"

FM_ERROR_STRING_ENTRY

namespace {

using fm::bf16;

constexpr int N = 64;  // tokens of an 8x8 window
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// B fragment of the 16x16 tile whose transpose lies row-major at s (s[n][k],
// row stride lds): the keys' rows for Q.K^T
__device__ __forceinline__ void load_bt(uint32_t* r, const bf16* s, int lds, int lane) {
  const int m = lane >> 3;
  fm::ldsm_x4(r, s + ((lane & 7) + (m >> 1) * 8) * lds + (m & 1) * 8);
}

// The accumulator pairs (c[2 jp], c[2 jp + 1]) of key tile kt: their row of
// the unit's 16 and their first key
__device__ __forceinline__ int pair_row(int jp, int lane) { return (lane >> 2) + 8 * (jp & 1); }
__device__ __forceinline__ int pair_col(int kt, int jp, int lane) {
  return 16 * kt + 8 * (jp >> 1) + 2 * (lane & 3);
}

// One (head hd, query rows 16 tm ..) unit; qkv in shared memory, row stride
// ldq; mv: this lane's mask entries of the unit's rows (MASKED).
template <int D, bool MASKED>
__device__ __forceinline__ void attention_unit(bf16* qkv, int ldq, int C, int hd, int tm,
                                               float scale, const float* __restrict__ bias,
                                               const float (&mv)[N / 16][8], int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    fm::load_a(qa[kc], qkv + tm * 16 * ldq + hd * D + kc * 16, ldq, lane);
  fm::Acc16 s[N / 16];
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    fm::zero(s[kt]);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t kb[4];
      load_bt(kb, qkv + kt * 16 * ldq + C + hd * D + kc * 16, ldq, lane);
      fm::mma16(s[kt], qa[kc], kb);
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
  // P.V: the scores of key tile kt are the A fragment of k-step kt. p = e *
  // (1 / z): dividing each e by z would take the division's slow path for
  // the subnormal e^-100 of every masked key
  const float rz[2] = {1.f / z[0], 1.f / z[1]};
  fm::Acc16 o[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) fm::zero(o[nt]);
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    const float* c = s[kt].c;
    uint32_t pa[4] = {pack_bf16(c[0] * rz[0], c[1] * rz[0]), pack_bf16(c[2] * rz[1], c[3] * rz[1]),
                      pack_bf16(c[4] * rz[0], c[5] * rz[0]), pack_bf16(c[6] * rz[1], c[7] * rz[1])};
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      uint32_t vb[4];
      fm::load_b(vb, qkv + kt * 16 * ldq + 2 * C + hd * D + nt * 16, ldq, lane);
      fm::mma16(o[nt], pa, vb);
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

template <int D, bool MASKED>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, int nW, bf16* __restrict__ out, int C,
                        float scale) {
  static_assert(kWarps % (N / 16) == 0, "a warp's units must share their row tile");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  const int ldq = 3 * C + 8;
  const int win = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = warp % (N / 16);
  float mv[N / 16][8];
  if (MASKED) {
    const float* mr = mask + ((size_t)(win % nW) * N + tm * 16) * N;
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const float2 m = *reinterpret_cast<const float2*>(mr + pair_row(jp, lane) * N +
                                                          pair_col(kt, jp, lane));
        mv[kt][2 * jp] = m.x;
        mv[kt][2 * jp + 1] = m.y;
      }
  }
  fm::copy_rows_to_smem(qs, ldq, qkv + (size_t)win * N * 3 * C, 3 * C, N, 3 * C, N);
  __syncthreads();
  const int units = (C / D) * (N / 16);
  for (int u = warp; u < units; u += kWarps)  // u % (N / 16) == tm
    attention_unit<D, MASKED>(qs, ldq, C, u / (N / 16), tm, scale, bias, mv, lane);
  __syncthreads();
  fm::copy_rows_from_smem(out + (size_t)win * N * C, C, qs, ldq, N, C);
}

template <int D, bool MASKED>
cudaError_t launch_as(const void* qkv, const void* bias, const void* mask, int nW, void* out,
                      int windows, int C, float scale, cudaStream_t st) {
  const int smem = N * (3 * C + 8) * 2;
  cudaError_t e = cudaFuncSetAttribute(window_attention_kernel<D, MASKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  window_attention_kernel<D, MASKED><<<windows, kThreads, smem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), nW, static_cast<bf16*>(out), C, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* qkv, const void* bias, const void* mask, int nW, void* out,
                   int windows, int C, float scale, cudaStream_t st) {
  return nW > 0 ? launch_as<D, true>(qkv, bias, mask, nW, out, windows, C, scale, st)
                : launch_as<D, false>(qkv, bias, mask, nW, out, windows, C, scale, st);
}

}  // namespace

// qkv: [windows, 64, 3C] bf16; bias: [C / D, 64, 64] f32; mask: [nW, 64, 64]
// f32 additive, window b uses mask[b % nW] (nW = 0: no mask); out: [windows,
// 64, C] bf16. Head dim D in (16, 32, 64), C a multiple of D up to 256.
extern "C" int fm_window_attention(const void* qkv, const void* bias, const void* mask, int nW,
                                   void* out, int windows, int C, int heads, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || C % heads || C > 256 || windows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C / heads) {
    case 16: return static_cast<int>(launch<16>(qkv, bias, mask, nW, out, windows, C, scale, st));
    case 32: return static_cast<int>(launch<32>(qkv, bias, mask, nW, out, windows, C, scale, st));
    case 64: return static_cast<int>(launch<64>(qkv, bias, mask, nW, out, windows, C, scale, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
