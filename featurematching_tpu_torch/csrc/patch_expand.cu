// PatchExpand tail: 2x2 depth-to-space of the expand output, the PatchExpand
// LN, the stage norm_up LN, and an optional per-token dense head.
//
// Replaces featurematching_tpu/ops/pallas_patch_expand.py · patch_expand_ln
// (_kernel). Bound on the H100: device-memory bytes (the expand output is
// read once, the LN and head outputs written once; the head's 2*C4*Chead
// operations per token stay well under the card's ratio of ~295 operations a
// byte). Design: a block takes 64 consecutive output tokens; each warp reads
// a token's (i, j) lane block straight from the expand output (the
// depth-to-space is only an address), runs both LNs in f32 registers, writes
// the LN output when asked, and stages the bf16 LN rows in shared memory for
// the head product on bf16 tensor cores (WMMA, f32 accumulation).

#include "common.cuh"

namespace {

using fm::bf16;
namespace wmma = fm::wmma;

constexpr int TT = 64;  // output tokens per block
constexpr int kWarps = 8;

template <int C4, int CH>
__global__ void __launch_bounds__(32 * kWarps)
patch_expand_kernel(const bf16* __restrict__ y, int H, int W, int total,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const float* __restrict__ s2, const float* __restrict__ b2, int two,
                    const bf16* __restrict__ wh, const float* __restrict__ bh,
                    bf16* __restrict__ ln_out, bf16* __restrict__ head_out) {
  constexpr int V = C4 / 32, LDA = C4 + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);  // [TT][LDA] bf16 LN rows for the head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scr = reinterpret_cast<float*>(smem + TT * LDA * 2) + warp * 256;
  const int t0 = blockIdx.x * TT;
  const int W2 = 2 * W, HW4 = 4 * H * W;

  for (int r = warp * (TT / kWarps); r < (warp + 1) * (TT / kWarps); ++r) {
    const int t = t0 + r;
    float v[V];
    if (t < total) {
      const int b = t / HW4, rem = t % HW4, oy = rem / W2, ox = rem % W2;
      const int h = oy >> 1, i = oy & 1, w = ox >> 1, j = ox & 1;
      const bf16* src = y + ((size_t)(b * H * W + h * W + w) * 4 + (i * 2 + j)) * C4;
      fm::load_bf16<V>(src + lane * V, v);
      fm::warp_layer_norm<V, C4>(v, s1 + lane * V, b1 + lane * V);
      if (two) fm::warp_layer_norm<V, C4>(v, s2 + lane * V, b2 + lane * V);
      if (ln_out) fm::store_bf16<V>(ln_out + (size_t)t * C4 + lane * V, v);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = 0.f;
    }
    if constexpr (CH > 0) fm::store_bf16<V>(a + r * LDA + lane * V, v);
  }

  if constexpr (CH > 0) {
    __syncthreads();
    for (int t = warp; t < 4 * (CH / 16); t += kWarps) {
      const int tm = t % 4, tn = t / 4;
      fm::FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < C4 / 16; ++k) {
        fm::FragA fa;
        fm::FragBRow fb;
        wmma::load_matrix_sync(fa, a + tm * 16 * LDA + k * 16, LDA);
        wmma::load_matrix_sync(fb, wh + (size_t)k * 16 * CH + tn * 16, CH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = t0 + tm * 16 + e / 16, col = tn * 16 + e % 16;
        if (row < total)
          head_out[(size_t)row * CH + col] = __float2bfloat16(scr[e] + bh[col]);
      }
      __syncwarp();
    }
  }
}

template <int C4, int CH>
cudaError_t launch(const void* y, int B, int H, int W, const void* s1, const void* b1,
                   const void* s2, const void* b2, int two, const void* wh,
                   const void* bh, void* ln_out, void* head_out, cudaStream_t st) {
  const int total = B * 4 * H * W;
  const size_t smem = TT * (C4 + 8) * 2 + kWarps * 256 * 4;
  patch_expand_kernel<C4, CH><<<(total + TT - 1) / TT, 32 * kWarps, smem, st>>>(
      static_cast<const bf16*>(y), H, W, total, static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), two, static_cast<const bf16*>(wh),
      static_cast<const float*>(bh), static_cast<bf16*>(ln_out),
      static_cast<bf16*>(head_out));
  return cudaGetLastError();
}

template <int C4>
cudaError_t dispatch_head(int CH, const void* y, int B, int H, int W, const void* s1,
                          const void* b1, const void* s2, const void* b2, int two,
                          const void* wh, const void* bh, void* ln_out, void* head_out,
                          cudaStream_t st) {
  switch (CH) {
    case 0: return launch<C4, 0>(y, B, H, W, s1, b1, s2, b2, two, wh, bh, ln_out, head_out, st);
    case 64: return launch<C4, 64>(y, B, H, W, s1, b1, s2, b2, two, wh, bh, ln_out, head_out, st);
    case 256: return launch<C4, 256>(y, B, H, W, s1, b1, s2, b2, two, wh, bh, ln_out, head_out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

FM_ERROR_STRING_ENTRY

// y: [B, H*W, 4*C4] bf16, lanes ordered (i, j, c). ln_out (or null):
// [B, 4*H*W, C4] bf16. head (CH > 0): wh [C4, CH] bf16, bh [CH] f32, head_out
// [B, 4*H*W, CH] bf16. s1, b1, s2, b2: [C4] f32 (s2/b2 read only if two).
extern "C" int fm_patch_expand_ln(const void* y, int B, int H, int W, int C4, const void* s1,
                                  const void* b1, const void* s2, const void* b2, int two,
                                  const void* wh, const void* bh, int CH, void* ln_out,
                                  void* head_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (C4) {
    case 64: e = dispatch_head<64>(CH, y, B, H, W, s1, b1, s2, b2, two, wh, bh, ln_out, head_out, st); break;
    case 128: e = dispatch_head<128>(CH, y, B, H, W, s1, b1, s2, b2, two, wh, bh, ln_out, head_out, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
