// The weight-gradient products dW = Aᵀ B (wgrad.cuh) as an entry of their
// own, for ops/wgrad.py: the card tests, chip_smoke.py and tools/wgrad_ab.py
// call it alone. K8's, K9's and K10's backwards call fm::wgrad_group from
// their own libraries.

#include "wgrad.cuh"

FM_ERROR_STRING_ENTRY

// out[q] [M][N] f32 = a[q]ᵀ b[q] for q < n (at most 6) in one launch: a[q]
// [T][M], b[q] [T][N] bf16 (contiguous, 16-byte aligned), tmn = {T, M, N}
// of each, M and N multiples of 64, T >= 1; `sms`: the card's SMs; part:
// f32 scratch of ops/wgrad.partial_floats.
extern "C" int fm_wgrad(const void* const* a, const void* const* b, void* const* out,
                        const int* tmn, int n, int sms, void* part, void* stream) {
  if (n < 1 || n > fm::wgrad_detail::kMaxProducts) return static_cast<int>(cudaErrorInvalidValue);
  fm::WgradCall calls[fm::wgrad_detail::kMaxProducts];
  for (int q = 0; q < n; ++q) {
    const int T = tmn[3 * q], M = tmn[3 * q + 1], N = tmn[3 * q + 2];
    calls[q] = {static_cast<const fm::bf16*>(a[q]), M, static_cast<const fm::bf16*>(b[q]), N,
                T, M, N, out[q]};
  }
  return static_cast<int>(fm::wgrad_group(calls, n, sms, static_cast<float*>(part),
                                          static_cast<cudaStream_t>(stream)));
}
