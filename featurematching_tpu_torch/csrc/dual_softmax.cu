// Dual-softmax mutual-NN statistics: row and column max/argmax of
//   conf = softmax_rows(sim) * softmax_cols(sim),  sim = (f0 * inv_temp) f1^T
// without storing the [L, S] matrix.
//
// Replaces featurematching_tpu/ops/pallas_dual_softmax.py ·
// dual_softmax_match_stats (_pass1_stats/_stats_kernel and
// _pass2_conf/_conf_kernel); fm_dual_softmax_lse runs pass 1 and its
// combines alone, as featurematching_tpu/ops/sparse_focal_loss.py ·
// _lses_pallas runs _pass1_stats. Bound on the H100: tensor-core operations (two
// passes of 2*L*S*C, against (L + S)*C bf16 inputs). Design: a block owns 64
// rows of f0 (scaled by inv_temp and rounded to bf16 on load, as the TPU
// kernel does before its product) and loops over 64-column tiles of f1,
// computing each 64x64 sim tile on bf16 tensor cores (WMMA, f32 accumulation)
// into shared memory.
//   pass 1: online row max / sum-exp, and the tile's column max / sum-exp
//           written as per-row-tile partials;
//   combine: column log-sum-exp from the partials (blocks cannot carry a sum
//           between them, so this is a second small kernel);
//   pass 2: conf = exp(2*sim - lse_r - lse_c) per tile, row max/argmax carried
//           across tiles, column max/argmax written per row tile;
//   combine: column max/argmax across row tiles.
// Ties keep the lowest index everywhere (jnp.argmax's rule): within a tile by
// the shuffle comparator, across tiles by strict comparison in index order.

#include "common.cuh"

#include <cfloat>

namespace {

using fm::bf16;
namespace wmma = fm::wmma;

constexpr int TM = 64, TN = 64;  // rows of f0 per block, columns of f1 per tile
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int LDS = TN + 4;

template <int C>
struct Smem {
  static constexpr int LDF = C + 8;
  static constexpr size_t a_off = 0;                   // bf16 [TM][LDF] scaled f0 rows
  static constexpr size_t b_off = a_off + TM * LDF * 2;  // bf16 [TN][LDF] f1 tile
  static constexpr size_t s_off = b_off + TN * LDF * 2;  // f32 [TM][LDS] sim / conf tile
  static constexpr size_t l_off = s_off + TM * LDS * 4;  // f32 [TM] row lse (pass 2)
  static constexpr size_t bytes = l_off + TM * 4;
};

template <int C>
__device__ __forceinline__ void load_scaled_rows(bf16* dst, const bf16* src, int valid,
                                                 float scale) {
  constexpr int LDF = Smem<C>::LDF, per_row = C / 8;
  for (int e = threadIdx.x; e < TM * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e % per_row) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) raw = *reinterpret_cast<const uint4*>(src + (size_t)r * C + c);
    bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = __float2bfloat16(__bfloat162float(v[q]) * scale);
    *reinterpret_cast<uint4*>(dst + r * LDF + c) = raw;
  }
}

// sim tile [TM][TN] = A [TM][C] . B[TN][C]^T into s (f32, row stride LDS)
template <int C>
__device__ __forceinline__ void sim_tile(const bf16* a, const bf16* b, float* s, int warp) {
  constexpr int LDF = Smem<C>::LDF;
  for (int t = warp; t < (TM / 16) * (TN / 16); t += kWarps) {
    const int tm = t % (TM / 16), tn = t / (TM / 16);
    fm::FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
    for (int k = 0; k < C / 16; ++k) {
      fm::FragA fa;
      fm::FragBCol fb;
      wmma::load_matrix_sync(fa, a + tm * 16 * LDF + k * 16, LDF);
      wmma::load_matrix_sync(fb, b + tn * 16 * LDF + k * 16, LDF);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(s + tm * 16 * LDS + tn * 16, acc, LDS, wmma::mem_row_major);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
pass1_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1, float inv_temp, int L,
             int S, float* __restrict__ rowm, float* __restrict__ rowz,
             float* __restrict__ colm_p, float* __restrict__ colz_p) {
  using Sm = Smem<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem + Sm::a_off);
  bf16* bt = reinterpret_cast<bf16*>(smem + Sm::b_off);
  float* s = reinterpret_cast<float*>(smem + Sm::s_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, it = blockIdx.x, nT = gridDim.x, i0 = it * TM;
  const int vr = min(TM, L - i0);
  load_scaled_rows<C>(a, f0 + ((size_t)b * L + i0) * C, vr, inv_temp);

  float m[8], z[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    m[q] = -INFINITY;
    z[q] = 0.f;
  }
  const int col = threadIdx.x >> 2, part = threadIdx.x & 3;
  for (int j0 = 0; j0 < S; j0 += TN) {
    const int vc = min(TN, S - j0);
    __syncthreads();
    fm::copy_rows_to_smem(bt, Sm::LDF, f1 + ((size_t)b * S + j0) * C, C, TN, C, vc);
    __syncthreads();
    sim_tile<C>(a, bt, s, warp);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q;
      const float s0 = lane < vc ? s[r * LDS + lane] : -INFINITY;
      const float s1 = lane + 32 < vc ? s[r * LDS + lane + 32] : -INFINITY;
      const float mn = fmaxf(m[q], fm::warp_max(fmaxf(s0, s1)));
      const float e = (lane < vc ? expf(s0 - mn) : 0.f) + (lane + 32 < vc ? expf(s1 - mn) : 0.f);
      z[q] = z[q] * expf(m[q] - mn) + fm::warp_sum(e);
      m[q] = mn;
    }
    // column partials over this block's rows: 4 threads a column, rows interleaved
    float cm = -INFINITY;
    for (int r = part; r < vr; r += 4) cm = fmaxf(cm, s[r * LDS + col]);
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
    float cz = 0.f;
    for (int r = part; r < vr; r += 4) cz += expf(s[r * LDS + col] - cm);
    cz += __shfl_xor_sync(0xffffffffu, cz, 1);
    cz += __shfl_xor_sync(0xffffffffu, cz, 2);
    if (part == 0 && col < vc) {
      const size_t o = ((size_t)b * nT + it) * S + j0 + col;
      colm_p[o] = cm;
      colz_p[o] = cz;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q;
      if (r < vr) {
        rowm[(size_t)b * L + i0 + r] = m[q];
        rowz[(size_t)b * L + i0 + r] = z[q];
      }
    }
  }
}

__global__ void col_lse_kernel(const float* __restrict__ colm_p,
                               const float* __restrict__ colz_p, int nT, int S, int BS,
                               float* __restrict__ col_lse) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BS) return;
  const int b = idx / S, j = idx % S;
  const float* cm = colm_p + (size_t)b * nT * S + j;
  const float* cz = colz_p + (size_t)b * nT * S + j;
  float m = -INFINITY;
  for (int t = 0; t < nT; ++t) m = fmaxf(m, cm[(size_t)t * S]);
  float z = 0.f;
  for (int t = 0; t < nT; ++t) z += cz[(size_t)t * S] * expf(cm[(size_t)t * S] - m);
  col_lse[idx] = m + logf(z);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
pass2_kernel(const bf16* __restrict__ f0, const bf16* __restrict__ f1, float inv_temp, int L,
             int S, const float* __restrict__ rowm, const float* __restrict__ rowz,
             const float* __restrict__ col_lse, float* __restrict__ row_max,
             int* __restrict__ row_arg, float* __restrict__ colmax_p,
             int* __restrict__ colarg_p) {
  using Sm = Smem<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem + Sm::a_off);
  bf16* bt = reinterpret_cast<bf16*>(smem + Sm::b_off);
  float* s = reinterpret_cast<float*>(smem + Sm::s_off);
  float* lse_r = reinterpret_cast<float*>(smem + Sm::l_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, it = blockIdx.x, nT = gridDim.x, i0 = it * TM;
  const int vr = min(TM, L - i0);
  load_scaled_rows<C>(a, f0 + ((size_t)b * L + i0) * C, vr, inv_temp);
  for (int r = threadIdx.x; r < TM; r += blockDim.x)
    lse_r[r] = r < vr ? rowm[(size_t)b * L + i0 + r] + logf(rowz[(size_t)b * L + i0 + r]) : 0.f;

  float best_v[8];
  int best_i[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    best_v[q] = -1.f;  // conf >= 0, so the first tile always replaces it
    best_i[q] = 0;
  }
  const int col = threadIdx.x >> 2, part = threadIdx.x & 3;
  const float* lse_c = col_lse + (size_t)b * S;
  for (int j0 = 0; j0 < S; j0 += TN) {
    const int vc = min(TN, S - j0);
    __syncthreads();
    fm::copy_rows_to_smem(bt, Sm::LDF, f1 + ((size_t)b * S + j0) * C, C, TN, C, vc);
    __syncthreads();
    sim_tile<C>(a, bt, s, warp);
    __syncthreads();
    for (int e = threadIdx.x; e < TM * TN; e += blockDim.x) {
      const int r = e / TN, c = e % TN;
      float* p = s + r * LDS + c;
      *p = (r < vr && c < vc) ? expf(2.0f * *p - lse_r[r] - lse_c[j0 + c]) : -1.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q;
      const float v0 = s[r * LDS + lane], v1 = s[r * LDS + lane + 32];
      float v = v1 > v0 ? v1 : v0;
      int i = v1 > v0 ? lane + 32 : lane;
      fm::warp_argmax(v, i);
      if (v > best_v[q]) {
        best_v[q] = v;
        best_i[q] = j0 + i;
      }
    }
    float cv = -1.f;
    int ci = 0;
    for (int r = part; r < vr; r += 4) {
      const float v = s[r * LDS + col];
      if (v > cv) {
        cv = v;
        ci = r;
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, cv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, ci, o);
      if (ov > cv || (ov == cv && oi < ci)) {
        cv = ov;
        ci = oi;
      }
    }
    if (part == 0 && col < vc) {
      const size_t o = ((size_t)b * nT + it) * S + j0 + col;
      colmax_p[o] = cv;
      colarg_p[o] = i0 + ci;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q;
      if (r < vr) {
        row_max[(size_t)b * L + i0 + r] = best_v[q];
        row_arg[(size_t)b * L + i0 + r] = best_i[q];
      }
    }
  }
}

__global__ void col_argmax_kernel(const float* __restrict__ colmax_p,
                                  const int* __restrict__ colarg_p, int nT, int S, int BS,
                                  float* __restrict__ col_max, int* __restrict__ col_arg) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BS) return;
  const int b = idx / S, j = idx % S;
  float best = -1.f;
  int arg = 0;
  for (int t = 0; t < nT; ++t) {
    const size_t o = ((size_t)b * nT + t) * S + j;
    if (colmax_p[o] > best) {
      best = colmax_p[o];
      arg = colarg_p[o];
    }
  }
  col_max[idx] = best;
  col_arg[idx] = arg;
}

__global__ void row_lse_kernel(const float* __restrict__ rowm, const float* __restrict__ rowz,
                               int n, float* __restrict__ lse_r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) lse_r[i] = rowm[i] + logf(rowz[i]);
}

// Pass 1 and the combines alone: the row and column log-sum-exps of sim
// (the sparse focal loss's forward). w: rowm, rowz, colm_p, colz_p, lse_r, lse_c.
template <int C>
cudaError_t launch_lse(const void* f0, const void* f1, float inv_temp, int B, int L, int S,
                       void* const* w, cudaStream_t st) {
  const size_t smem = Smem<C>::bytes;
  cudaError_t e = cudaFuncSetAttribute(pass1_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int nT = (L + TM - 1) / TM, BS = B * S, BL = B * L;
  float* rowm = static_cast<float*>(w[0]);
  float* rowz = static_cast<float*>(w[1]);
  float* colm_p = static_cast<float*>(w[2]);
  float* colz_p = static_cast<float*>(w[3]);
  pass1_kernel<C><<<dim3(nT, B), kThreads, smem, st>>>(static_cast<const bf16*>(f0),
                                                       static_cast<const bf16*>(f1), inv_temp,
                                                       L, S, rowm, rowz, colm_p, colz_p);
  col_lse_kernel<<<(BS + 255) / 256, 256, 0, st>>>(colm_p, colz_p, nT, S, BS,
                                                    static_cast<float*>(w[5]));
  row_lse_kernel<<<(BL + 255) / 256, 256, 0, st>>>(rowm, rowz, BL, static_cast<float*>(w[4]));
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const void* f0, const void* f1, float inv_temp, int B, int L, int S,
                   void* const* w, cudaStream_t st) {
  const size_t smem = Smem<C>::bytes;
  cudaError_t e = cudaFuncSetAttribute(pass1_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(pass2_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const int nT = (L + TM - 1) / TM, BS = B * S;
  const dim3 grid(nT, B);
  const auto* A = static_cast<const bf16*>(f0);
  const auto* Bm = static_cast<const bf16*>(f1);
  float* rowm = static_cast<float*>(w[0]);
  float* rowz = static_cast<float*>(w[1]);
  float* colm_p = static_cast<float*>(w[2]);
  float* colz_p = static_cast<float*>(w[3]);
  float* col_lse = static_cast<float*>(w[4]);
  float* colmax_p = static_cast<float*>(w[5]);
  int* colarg_p = static_cast<int*>(w[6]);
  pass1_kernel<C><<<grid, kThreads, smem, st>>>(A, Bm, inv_temp, L, S, rowm, rowz, colm_p,
                                                colz_p);
  col_lse_kernel<<<(BS + 255) / 256, 256, 0, st>>>(colm_p, colz_p, nT, S, BS, col_lse);
  pass2_kernel<C><<<grid, kThreads, smem, st>>>(
      A, Bm, inv_temp, L, S, rowm, rowz, col_lse, static_cast<float*>(w[7]),
      static_cast<int*>(w[8]), colmax_p, colarg_p);
  col_argmax_kernel<<<(BS + 255) / 256, 256, 0, st>>>(
      colmax_p, colarg_p, nT, S, BS, static_cast<float*>(w[9]), static_cast<int*>(w[10]));
  return cudaGetLastError();
}

}  // namespace

FM_ERROR_STRING_ENTRY

// f0: [B, L, C], f1: [B, S, C] bf16 (f0 unscaled; inv_temp = 1 / (C * T)).
// Scratch (f32 unless noted; nT = ceil(L / 64)): rowm, rowz [B, L]; colm_p,
// colz_p [B, nT, S]; col_lse [B, S]; colmax_p [B, nT, S]; colarg_p [B, nT, S]
// int32. Outputs: row_max f32 / row_arg int32 [B, L]; col_max f32 / col_arg
// int32 [B, S] (col_arg in global row ids).
extern "C" int fm_dual_softmax_stats(const void* f0, const void* f1, float inv_temp, int B,
                                     int L, int S, int C, void* rowm, void* rowz,
                                     void* colm_p, void* colz_p, void* col_lse,
                                     void* colmax_p, void* colarg_p, void* row_max,
                                     void* row_arg, void* col_max, void* col_arg,
                                     void* stream) {
  void* w[11] = {rowm, rowz, colm_p, colz_p, col_lse, colmax_p,
                 colarg_p, row_max, row_arg, col_max, col_arg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (C) {
    case 64: e = launch<64>(f0, f1, inv_temp, B, L, S, w, st); break;
    case 128: e = launch<128>(f0, f1, inv_temp, B, L, S, w, st); break;
    case 256: e = launch<256>(f0, f1, inv_temp, B, L, S, w, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// The row and column log-sum-exps alone: f0, f1, inv_temp as above;
// scratch rowm, rowz [B, L], colm_p, colz_p [B, nT, S]; out lse_r [B, L],
// lse_c [B, S] f32.
extern "C" int fm_dual_softmax_lse(const void* f0, const void* f1, float inv_temp, int B, int L,
                                   int S, int C, void* rowm, void* rowz, void* colm_p,
                                   void* colz_p, void* lse_r, void* lse_c, void* stream) {
  void* w[6] = {rowm, rowz, colm_p, colz_p, lse_r, lse_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (C) {
    case 64: e = launch_lse<64>(f0, f1, inv_temp, B, L, S, w, st); break;
    case 128: e = launch_lse<128>(f0, f1, inv_temp, B, L, S, w, st); break;
    case 256: e = launch_lse<256>(f0, f1, inv_temp, B, L, S, w, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
