// K7: the softmax terms of the sparse focal loss's backward,
//   dsim = -(a_r[i] exp(sim - lse_r[i]) + a_c[j] exp(sim - lse_c[j]))
//   df0 = inv_temp * dsim f1,   df1 = dsimᵀ f0s,   sim = f0s f1ᵀ
// without storing the [L, S] sim.
//
// Replaces featurematching_tpu/ops/sparse_focal_loss.py · _sfl_bwd_pallas
// (_sfl_bwd_kernel). Bound on the H100: tensor-core operations (three
// products of 2*L*S*C a pair against (L + S)*C bf16 features in and f32
// gradients out). The TPU kernel walks row tiles in order and adds each
// tile's df1 contribution into one output block. On the H100 row tiles run
// in parallel, so df1 gets its own pass over column tiles that recomputes
// simᵀ (a fourth product) instead of per-tile [S, C] partials (1.5 GB at
// 640x480, batch 4): both passes keep their output tile in registers across
// the whole loop, write it once, and need neither atomics nor a second
// reduction, so the result is deterministic.
//   df0 pass: a block owns 64 rows of f0s and loops over 64-column tiles of
//             f1: sim tile (bf16 tensor cores, WMMA, f32), dsim rounded to
//             bf16 as the TPU kernel does, df0 += dsim f1_tile;
//   df1 pass: a block owns 64 rows of f1 and loops over 64-row tiles of f0s:
//             simᵀ tile, dsimᵀ, df1 += dsimᵀ f0s_tile.
// f0s is f0 pre-scaled by inv_temp and rounded to bf16 (the wrapper does it,
// as the TPU kernel's caller does).

#include "common.cuh"

namespace {

using fm::bf16;
namespace wmma = fm::wmma;

constexpr int TM = 64;  // rows a block owns / rows of the other side a step
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int LDS = TM + 4;  // f32 sim tile row stride
constexpr int LDG = TM + 8;  // bf16 dsim tile row stride

template <int C>
struct Smem {
  static constexpr int LDF = C + 8;
  static constexpr size_t own_off = 0;                       // bf16 [64][LDF] the block's rows
  static constexpr size_t oth_off = own_off + TM * LDF * 2;  // bf16 [64][LDF] the other side's tile
  static constexpr size_t s_off = oth_off + TM * LDF * 2;    // f32 [64][LDS] sim tile
  static constexpr size_t g_off = s_off + TM * LDS * 4;      // bf16 [64][LDG] dsim tile
  static constexpr size_t v_off = g_off + TM * LDG * 2;      // f32 a/lse of own and other
  static constexpr size_t bytes = v_off + 4 * TM * 4;
};

// Either pass: the block owns rows of f0s (df0 pass) or of f1 (df1 pass).
// own [n_own][C], oth [n_oth][C]; a_own/lse_own index the owned side,
// a_oth/lse_oth the other. dsim[i][j] (i: f0 row, j: f1 row) is
// -(a_r[i] exp(sim - lse_r[i]) + a_c[j] exp(sim - lse_c[j])) either way.
template <int C>
__global__ void __launch_bounds__(kThreads)
sfl_bwd_kernel(const bf16* __restrict__ own, const bf16* __restrict__ oth,
               const float* __restrict__ a_own, const float* __restrict__ lse_own,
               const float* __restrict__ a_oth, const float* __restrict__ lse_oth, int n_own,
               int n_oth, float out_scale, float* __restrict__ out) {
  using Sm = Smem<C>;
  constexpr int LDF = Sm::LDF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem + Sm::own_off);
  bf16* bs = reinterpret_cast<bf16*>(smem + Sm::oth_off);
  float* ss = reinterpret_cast<float*>(smem + Sm::s_off);
  bf16* gs = reinterpret_cast<bf16*>(smem + Sm::g_off);
  float* av = reinterpret_cast<float*>(smem + Sm::v_off);  // a_own, lse_own, a_oth, lse_oth
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.y, i0 = blockIdx.x * TM, vi = min(TM, n_own - i0);
  own += (size_t)b * n_own * C;
  oth += (size_t)b * n_oth * C;
  fm::copy_rows_to_smem(as, LDF, own + (size_t)i0 * C, C, TM, C, vi);
  for (int r = threadIdx.x; r < TM; r += blockDim.x) {
    av[r] = r < vi ? a_own[(size_t)b * n_own + i0 + r] : 0.f;
    av[TM + r] = r < vi ? lse_own[(size_t)b * n_own + i0 + r] : 0.f;
  }
  // out tile [64][C] in registers: a warp owns (C / 16) * 4 / 8 tiles
  constexpr int TILES = (C / 16) * (TM / 16) / kWarps;
  fm::FragC acc[TILES];
#pragma unroll
  for (int t = 0; t < TILES; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int j0 = 0; j0 < n_oth; j0 += TM) {
    const int vj = min(TM, n_oth - j0);
    __syncthreads();
    fm::copy_rows_to_smem(bs, LDF, oth + (size_t)j0 * C, C, TM, C, vj);
    for (int r = threadIdx.x; r < TM; r += blockDim.x) {
      av[2 * TM + r] = r < vj ? a_oth[(size_t)b * n_oth + j0 + r] : 0.f;
      av[3 * TM + r] = r < vj ? lse_oth[(size_t)b * n_oth + j0 + r] : 0.f;
    }
    __syncthreads();
    // s[ii][jj] = own[ii] . oth[jj]
    for (int t = warp; t < (TM / 16) * (TM / 16); t += kWarps) {
      const int tm = t % (TM / 16), tn = t / (TM / 16);
      fm::FragC s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll 4
      for (int k = 0; k < C / 16; ++k) {
        fm::FragA fa;
        fm::FragBCol fb;
        wmma::load_matrix_sync(fa, as + tm * 16 * LDF + k * 16, LDF);
        wmma::load_matrix_sync(fb, bs + tn * 16 * LDF + k * 16, LDF);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(ss + tm * 16 * LDS + tn * 16, s, LDS, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TM * TM; e += blockDim.x) {
      const int ii = e / TM, jj = e % TM;
      float d = 0.f;
      if (ii < vi && jj < vj) {
        const float s = ss[ii * LDS + jj];
        d = -(av[ii] * expf(s - av[TM + ii]) + av[2 * TM + jj] * expf(s - av[3 * TM + jj]));
      }
      gs[ii * LDG + jj] = __float2bfloat16(d);
    }
    __syncthreads();
    // acc[ii][c] += sum_jj g[ii][jj] oth[jj][c]
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      const int u = warp + t * kWarps, tm = u % (TM / 16), tn = u / (TM / 16);
#pragma unroll
      for (int k = 0; k < TM / 16; ++k) {
        fm::FragA fa;
        fm::FragBRow fb;
        wmma::load_matrix_sync(fa, gs + tm * 16 * LDG + k * 16, LDG);
        wmma::load_matrix_sync(fb, bs + k * 16 * LDF + tn * 16, LDF);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
  }
  __syncthreads();
  // through shared memory (all of it is free now) to the valid rows
  float* stage = reinterpret_cast<float*>(smem);  // f32 [64][C + 4]
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const int u = warp + t * kWarps, tm = u % (TM / 16), tn = u / (TM / 16);
    for (int i = 0; i < acc[t].num_elements; ++i) acc[t].x[i] *= out_scale;
    wmma::store_matrix_sync(stage + tm * 16 * (C + 4) + tn * 16, acc[t], C + 4,
                            wmma::mem_row_major);
  }
  __syncthreads();
  float* o = out + ((size_t)b * n_own + i0) * C;
  for (int e = threadIdx.x; e < vi * C; e += blockDim.x)
    o[e] = stage[(e / C) * (C + 4) + e % C];
}

template <int C>
cudaError_t launch(const void* f0s, const void* f1, const float* const* v, float inv_temp, int B,
                   int L, int S, void* df0, void* df1, cudaStream_t st) {
  using Sm = Smem<C>;
  static_assert(TM * (C + 4) * 4 <= Sm::bytes, "the out stage must fit");
  auto* A = static_cast<const bf16*>(f0s);
  auto* F1 = static_cast<const bf16*>(f1);
  cudaError_t e = cudaFuncSetAttribute(sfl_bwd_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sm::bytes);
  if (e != cudaSuccess) return e;
  // v: a_r, lse_r, a_c, lse_c
  sfl_bwd_kernel<C><<<dim3((L + TM - 1) / TM, B), kThreads, Sm::bytes, st>>>(
      A, F1, v[0], v[1], v[2], v[3], L, S, inv_temp, static_cast<float*>(df0));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sfl_bwd_kernel<C><<<dim3((S + TM - 1) / TM, B), kThreads, Sm::bytes, st>>>(
      F1, A, v[2], v[3], v[0], v[1], S, L, 1.0f, static_cast<float*>(df1));
  return cudaGetLastError();
}

}  // namespace

FM_ERROR_STRING_ENTRY

// f0s: [B, L, C] bf16, f0 * inv_temp rounded; f1: [B, S, C] bf16; a_r,
// lse_r: [B, L] f32; a_c, lse_c: [B, S] f32. df0: [B, L, C] f32 (d/d f0,
// inv_temp applied); df1: [B, S, C] f32.
extern "C" int fm_sparse_focal_backward(const void* f0s, const void* f1, const void* a_r,
                                        const void* lse_r, const void* a_c, const void* lse_c,
                                        float inv_temp, int B, int L, int S, int C, void* df0,
                                        void* df1, void* stream) {
  const float* v[4] = {static_cast<const float*>(a_r), static_cast<const float*>(lse_r),
                       static_cast<const float*>(a_c), static_cast<const float*>(lse_c)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (C) {
    case 64: e = launch<64>(f0s, f1, v, inv_temp, B, L, S, df0, df1, st); break;
    case 128: e = launch<128>(f0s, f1, v, inv_temp, B, L, S, df0, df1, st); break;
    case 256: e = launch<256>(f0s, f1, v, inv_temp, B, L, S, df0, df1, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
