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
//   - A warp takes whole (head, 16 query rows) units (attention_unit.cuh,
//     the unit the Swin block body shares): scores, softmax and P in
//     registers, so no score or probability touches shared memory. A
//     unit's output overwrites the q columns only it reads; the block then
//     writes its [64, C] output with 16-byte stores.
//   - The mask of window b is mask[b % nW], indexed here: no per-window
//     copy of the mask is made. A warp's units share their 16 query rows
//     (kWarps is a multiple of the four row tiles), so each lane reads its
//     32 mask entries once into registers for all the warp's heads.
//
// Rounding follows the TPU kernel: s = q.k in f32, then s * scale + bias in
// f32, then + mask, softmax in f32, p rounded to bf16, p.v summed in f32 and
// rounded to bf16.

#include "attention_unit.cuh"

FM_ERROR_STRING_ENTRY

namespace {

using fm::bf16;

constexpr int N = fm::kWin;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

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
  if (MASKED) fm::load_unit_mask(mv, mask + (size_t)(win % nW) * N * N, tm, lane);
  fm::copy_rows_to_smem(qs, ldq, qkv + (size_t)win * N * 3 * C, 3 * C, N, 3 * C, N);
  __syncthreads();
  const int units = (C / D) * (N / 16);
  for (int u = warp; u < units; u += kWarps)  // u % (N / 16) == tm
    fm::attention_unit<D, MASKED>(qs, ldq, C, u / (N / 16), tm, scale, bias, mv, lane);
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
