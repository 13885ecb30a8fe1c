// One LoFTR linear-attention encoder layer as two kernels, stats and apply:
//   stats: K = elu(src.wk)+1, V = src.wv / S; each head's K^T V [D, D] and
//          K_sum [C] over the source tokens
//   apply: Q = elu(x.wq)+1; o = Q_h.KV_h * S / (Q_h.Ksum_h + eps);
//          msg = LN1(o.wmerge); y = LN2(relu([x | msg].wmlp1).wmlp2); x + y
//
// Replaces featurematching_tpu/ops/pallas_coarse_transformer.py ·
// coarse_transformer_fused (_stats_kernel / _apply_kernel). Bound on the
// H100 by tensor-core operations (20 C^2 multiply-adds x2 per token and
// layer against 4 C bytes of activations in and out; the 1.25 MB of bf16
// weights of a layer stay in L2). Design:
//   - The TPU grid carries K^T V and K^T 1 across token chunks in one output
//     block; CUDA blocks cannot share one. A stats block reduces a run of
//     64-token tiles of one image into registers and writes one partial; a
//     merge kernel adds the partials in a fixed order and rounds them to
//     bf16 (the activation dtype the apply kernel's products take).
//   - Only the H diagonal [D, D] blocks of K^T V are ever read, so only they
//     are formed (the TPU kernel forms [C, C] and masks it): 1/H of the
//     operations. K^T 1 is K_sum repeated across columns: stored once.
//   - An apply block keeps a 64-token row tile on chip from the Q product to
//     the residual: [x | msg] and one more [64, C] buffer in shared memory,
//     the FFN hidden in 128-column chunks with the wmlp2 partial products in
//     registers. 103 KB of shared memory at C = 256 lets two blocks share an
//     SM. The weights, and the merged K^T V, are stored in tensor-core
//     fragment order (tiles.cuh) and stream from L2 with one 16-byte load a
//     lane for each 16x16 tile.
//
// Rounding follows the TPU kernel: K and V/S rounded after the f32 product
// and feature map; K_sum rounded to bf16; o * (S / (Z + eps)) in f32,
// rounded once; each product rounded to bf16 before its LayerNorm; the
// residual add is bf16 + bf16.

#include "tiles.cuh"

namespace {

using fm::bf16;

constexpr int T = 64;  // token rows of a tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int HC = 128;  // FFN hidden columns per chunk
constexpr float kEps = 1e-6f;

template <int C>
struct StatsSmem {
  static constexpr int LDS = C + 8;       // source rows
  static constexpr int LDKV = 2 * C + 8;  // K | V rows
  static constexpr size_t src_off = 0;
  static constexpr size_t kv_off = src_off + T * LDS * 2;
  static constexpr size_t bytes = kv_off + T * LDKV * 2;
};

// grid (chunks, G): block (c, g) reduces the source tiles
// [c * per_chunk, (c + 1) * per_chunk) of image g into one partial:
// part_kv[g][c] = the H diagonal blocks [H][D][D], part_ks[g][c] = K_sum [C]
template <int C, int D>
__global__ void __launch_bounds__(kThreads, 2)
stats_kernel(const bf16* __restrict__ src, const bf16* __restrict__ wkv,
             float* __restrict__ part_kv, float* __restrict__ part_ks, int S, int per_chunk) {
  using L = StatsSmem<C>;
  constexpr int H = C / D, DT = D / 16, UNITS = H * DT * DT;
  constexpr int UPW = (UNITS + kWarps - 1) / kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ss = reinterpret_cast<bf16*>(smem + L::src_off);
  bf16* kvs = reinterpret_cast<bf16*>(smem + L::kv_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.y, chunk = blockIdx.x;
  const int tiles = (S + T - 1) / T;
  const int t1 = min(tiles, (chunk + 1) * per_chunk);
  const float inv_s = 1.0f / (float)S;

  fm::Acc16 acc[UPW];
#pragma unroll
  for (int j = 0; j < UPW; ++j) fm::zero(acc[j]);
  float ksum = 0.f;  // column threadIdx.x of K (threads < C)

  for (int t = chunk * per_chunk; t < t1; ++t) {
    const int r0 = t * T, valid = min(T, S - r0);
    fm::copy_rows_to_smem(ss, L::LDS, src + ((size_t)g * S + r0) * C, C, T, C, valid);
    __syncthreads();
    // [K | V] = src . [wk | wv]; rows past the source carry no mass
    fm::gemm_rows64<kWarps, C, 2 * C / 16>(
        ss, L::LDS, wkv, 0, warp, lane, [&](int r, int c, float v) {
          float o = 0.f;
          if (r < valid) o = c < C ? fm::elu1(v) : v * inv_s;
          kvs[r * L::LDKV + c] = __float2bfloat16(o);
        });
    __syncthreads();
    // K_h^T V_h, 16x16 tiles; A = K^T loaded transposed straight from K
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = warp + j * kWarps;
      if (u < UNITS) {
        const int h = u / (DT * DT), i = (u / DT) % DT, jj = u % DT;
        const bf16* kp = kvs + h * D + i * 16;
        const bf16* vp = kvs + C + h * D + jj * 16;
#pragma unroll
        for (int k = 0; k < T / 16; ++k) {
          uint32_t fa[4], fb[4];
          fm::load_a_trans(fa, kp + k * 16 * L::LDKV, L::LDKV, lane);
          fm::load_b(fb, vp + k * 16 * L::LDKV, L::LDKV, lane);
          fm::mma16(acc[j], fa, fb);
        }
      }
    }
    if (threadIdx.x < C)
      for (int r = 0; r < valid; ++r) ksum += __bfloat162float(kvs[r * L::LDKV + threadIdx.x]);
    __syncthreads();
  }
  const size_t part = (size_t)g * gridDim.x + chunk;
  float* pk = part_kv + part * C * D;
#pragma unroll
  for (int j = 0; j < UPW; ++j) {
    const int u = warp + j * kWarps;
    if (u < UNITS) {
      const int h = u / (DT * DT), i = (u / DT) % DT, jj = u % DT;
      fm::tile_epilogue(acc[j], i * 16, jj * 16, lane,
                        [&](int r, int c, float v) { pk[h * D * D + r * D + c] = v; });
    }
  }
  if (threadIdx.x < C) part_ks[part * C + threadIdx.x] = ksum;
}

// kv[g] = bf16(sum over chunks of part_kv[g]) in fragment order (each head's
// [D, D] block packed as a B operand, tiles.cuh); ks[g] likewise, plain;
// chunks added in order
__global__ void merge_kernel(const float* __restrict__ part_kv, const float* __restrict__ part_ks,
                             bf16* __restrict__ kv, bf16* __restrict__ ks, int chunks, int C,
                             int D) {
  const int g = blockIdx.y, CD = C * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < CD) {
    const int DT = D / 16, e8 = e & 7, ln = (e >> 3) & 31, tile = e >> 8;
    const int h = tile / (DT * DT), nt = (tile / DT) % DT, kt = tile % DT;
    const int k = kt * 16 + 2 * (ln & 3) + (e8 & 1) + 8 * ((e8 >> 1) & 1);
    const int n = nt * 16 + (ln >> 2) + 8 * (e8 >> 2);
    const int src = h * D * D + k * D + n;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part_kv[((size_t)g * chunks + c) * CD + src];
    kv[(size_t)g * CD + e] = __float2bfloat16(s);
  } else if (e < CD + C) {
    const int i = e - CD;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part_ks[((size_t)g * chunks + c) * C + i];
    ks[(size_t)g * C + i] = __float2bfloat16(s);
  }
}

template <int C, int D>
struct ApplySmem {
  static constexpr int H = C / D;
  static constexpr int LDXM = 2 * C + 8;  // [x | msg] rows
  static constexpr int LDQ = C + 8;       // Q, then o, then a hidden chunk, then y
  static constexpr int LDH = HC + 8;
  static constexpr size_t xm_off = 0;
  static constexpr size_t q_off = xm_off + T * LDXM * 2;
  static constexpr size_t z_off = q_off + T * LDQ * 2;  // f32 [T][H] normalisers
  static constexpr size_t ks_off = z_off + T * H * 4;   // f32 [C] K_sum (bf16 values)
  static constexpr size_t bytes = ks_off + C * 4;
  static_assert(LDH <= LDQ, "a hidden chunk must fit in the Q buffer");
};

// grid (ceil(L / 64), G): block (b, g) takes query rows [64 b, 64 b + 64) of image g
template <int C, int D>
__global__ void __launch_bounds__(kThreads, 2)
apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kv, const bf16* __restrict__ ks,
             const bf16* __restrict__ wq, const bf16* __restrict__ wmerge,
             const float* __restrict__ n1s, const float* __restrict__ n1b,
             const bf16* __restrict__ w1, const bf16* __restrict__ w2,
             const float* __restrict__ n2s, const float* __restrict__ n2b,
             bf16* __restrict__ out, int L, int S) {
  using Sm = ApplySmem<C, D>;
  constexpr int H = Sm::H, DT = D / 16, LDXM = Sm::LDXM, LDQ = Sm::LDQ, LDH = Sm::LDH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xm = reinterpret_cast<bf16*>(smem + Sm::xm_off);
  bf16* qs = reinterpret_cast<bf16*>(smem + Sm::q_off);
  float* zs = reinterpret_cast<float*>(smem + Sm::z_off);
  float* kss = reinterpret_cast<float*>(smem + Sm::ks_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.y, r0 = blockIdx.x * T, valid = min(T, L - r0);

  fm::copy_rows_to_smem(xm, LDXM, x + ((size_t)g * L + r0) * C, C, T, C, valid);
  for (int c = threadIdx.x; c < C; c += kThreads) kss[c] = __bfloat162float(ks[(size_t)g * C + c]);
  __syncthreads();

  // Q = elu(x . wq) + 1
  fm::gemm_rows64<kWarps, C, C / 16>(xm, LDXM, wq, 0, warp, lane,
                                     [&](int r, int c, float v) {
                                       qs[r * LDQ + c] = __float2bfloat16(fm::elu1(v));
                                     });
  __syncthreads();
  // Z[r][h] = Q[r, head h] . K_sum[head h]
  for (int e = threadIdx.x; e < T * H; e += kThreads) {
    const int r = e / H, h = e % H;
    float z = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) z += __bfloat162float(qs[r * LDQ + h * D + d]) * kss[h * D + d];
    zs[e] = z;
  }
  __syncthreads();
  // o = Q_h . KV_h * (S / (Z + eps)) over Q in place: a warp owns whole
  // (head, 16-row) units and has read all of a unit before it writes it
  const bf16* kvg = kv + (size_t)g * C * D;
  const float s_f = (float)S;
  for (int u = warp; u < H * (T / 16); u += kWarps) {
    const int h = u / (T / 16), tm = u % (T / 16);
    fm::Acc16 acc[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) fm::zero(acc[j]);
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      uint32_t fa[4];
      fm::load_a(fa, qs + tm * 16 * LDQ + h * D + k * 16, LDQ, lane);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t fb[4];
        fm::load_b_packed(fb, fm::packed_tile(kvg + h * D * D, D, k, j), lane);
        fm::mma16(acc[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j)
      fm::tile_epilogue(acc[j], tm * 16, h * D + j * 16, lane, [&](int row, int col, float v) {
        qs[row * LDQ + col] = __float2bfloat16(v * (s_f / (zs[row * H + h] + kEps)));
      });
  }
  __syncthreads();
  // msg = LN1(o . wmerge), beside x
  fm::gemm_rows64<kWarps, C, C / 16>(qs, LDQ, wmerge, 0, warp, lane,
                                     [&](int r, int c, float v) {
                                       xm[r * LDXM + C + c] = __float2bfloat16(v);
                                     });
  __syncthreads();
  fm::layer_norm_rows64<kWarps, C>(xm + C, LDXM, n1s, n1b, warp, lane);
  __syncthreads();

  // FFN: relu([x | msg] . w1) in chunks of HC hidden columns (in the Q
  // buffer); each warp keeps UPW units of RT2 y tiles in registers
  constexpr int S2 = C / 16, RT2 = fm::rows_per_unit(S2, kWarps), G2 = 4 / RT2;
  constexpr int UPW = S2 * G2 / kWarps;
  static_assert(S2 * G2 % kWarps == 0, "wmlp2 units must spread evenly over the warps");
  fm::Acc16 acc2[UPW][RT2];
#pragma unroll
  for (int j = 0; j < UPW; ++j)
#pragma unroll
    for (int i = 0; i < RT2; ++i) fm::zero(acc2[j][i]);
  for (int c0 = 0; c0 < 2 * C; c0 += HC) {
    fm::gemm_rows64<kWarps, 2 * C, HC / 16>(xm, LDXM, w1, c0 / 16, warp, lane,
                                            [&](int r, int c, float v) {
                                              qs[r * LDH + c] = __float2bfloat16(fmaxf(v, 0.f));
                                            });
    __syncthreads();
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = warp + j * kWarps, tn = u / G2, tm0 = (u % G2) * RT2;
      fm::strip_mma<HC, RT2>(acc2[j], qs + tm0 * 16 * LDH, LDH, w2, 2 * C, c0 / 16, tn, lane);
    }
    __syncthreads();
  }
  // y = bf16(hidden . w2) into the Q buffer, then out = x + LN2(y)
#pragma unroll
  for (int j = 0; j < UPW; ++j) {
    const int u = warp + j * kWarps, tn = u / G2, tm0 = (u % G2) * RT2;
#pragma unroll
    for (int i = 0; i < RT2; ++i)
      fm::tile_epilogue(acc2[j][i], (tm0 + i) * 16, tn * 16, lane, [&](int r, int c, float v) {
        qs[r * LDQ + c] = __float2bfloat16(v);
      });
  }
  __syncthreads();
  constexpr int V = C / 32;
  float sv[V], bv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sv[i] = n2s[lane * V + i];
    bv[i] = n2b[lane * V + i];
  }
  bf16* og = out + ((size_t)g * L + r0) * C;
  for (int r = warp; r < valid; r += kWarps) {
    float y[V], xr[V];
    fm::load_bf16<V>(qs + r * LDQ + lane * V, y);
    fm::warp_layer_norm<V, C>(y, sv, bv);
    fm::load_bf16<V>(xm + r * LDXM + lane * V, xr);
#pragma unroll
    for (int i = 0; i < V; ++i) y[i] = xr[i] + fm::round_bf16(y[i]);
    fm::store_bf16<V>(og + r * C + lane * V, y);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int C, int D>
cudaError_t launch_stats(const void* src, const void* wkv, float* part_kv, float* part_ks,
                         void* kv, void* ks, int G, int S, int per_chunk, int chunks,
                         cudaStream_t st) {
  const size_t smem = StatsSmem<C>::bytes;
  cudaError_t e = set_smem(stats_kernel<C, D>, smem);
  if (e != cudaSuccess) return e;
  stats_kernel<C, D><<<dim3(chunks, G), kThreads, smem, st>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(wkv), part_kv, part_ks, S,
      per_chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = C * D + C;
  merge_kernel<<<dim3((n + 255) / 256, G), 256, 0, st>>>(
      part_kv, part_ks, static_cast<bf16*>(kv), static_cast<bf16*>(ks), chunks, C, D);
  return cudaGetLastError();
}

template <int C, int D>
cudaError_t launch_apply(const void* const* p, void* out, int G, int L, int S, cudaStream_t st) {
  const size_t smem = ApplySmem<C, D>::bytes;
  cudaError_t e = set_smem(apply_kernel<C, D>, smem);
  if (e != cudaSuccess) return e;
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  auto Bf = [](const void* q) { return static_cast<const bf16*>(q); };
  apply_kernel<C, D><<<dim3((L + T - 1) / T, G), kThreads, smem, st>>>(
      Bf(p[0]), Bf(p[1]), Bf(p[2]), Bf(p[3]), Bf(p[4]), F(p[5]), F(p[6]), Bf(p[7]), Bf(p[8]),
      F(p[9]), F(p[10]), static_cast<bf16*>(out), L, S);
  return cudaGetLastError();
}

}  // namespace

FM_ERROR_STRING_ENTRY

// src: [G, S, C] bf16; wkv: [C, 2C] bf16 (wk | wv, [in, out]) in fragment
// order. Scratch part_kv [G, chunks, C*D] and part_ks [G, chunks, C] f32.
// Out: kv [G, C/D, D, D] bf16 in fragment order and ks [G, C] bf16.
// chunks * per_chunk >= ceil(S / 64).
extern "C" int fm_coarse_stats(const void* src, const void* wkv, void* part_kv, void* part_ks,
                               void* kv, void* ks, int G, int S, int C, int D, int per_chunk,
                               int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pk = static_cast<float*>(part_kv);
  float* ps = static_cast<float*>(part_ks);
#define FM_STATS(c, d) \
  if (C == c && D == d) return (int)launch_stats<c, d>(src, wkv, pk, ps, kv, ks, G, S, per_chunk, chunks, st);
  FM_STATS(128, 16) FM_STATS(128, 32) FM_STATS(256, 16) FM_STATS(256, 32)
#undef FM_STATS
  return (int)cudaErrorInvalidValue;
}

// x, out: [G, L, C] bf16; kv, ks from fm_coarse_stats over S source tokens;
// weights bf16 [in, out] in fragment order: wq, wmerge [C, C], w1 [2C, 2C],
// w2 [2C, C]; LN scales and biases f32 [C].
extern "C" int fm_coarse_apply(const void* x, const void* kv, const void* ks, const void* wq,
                               const void* wmerge, const void* n1s, const void* n1b,
                               const void* w1, const void* w2, const void* n2s, const void* n2b,
                               void* out, int G, int L, int S, int C, int D, void* stream) {
  const void* p[11] = {x, kv, ks, wq, wmerge, n1s, n1b, w1, w2, n2s, n2b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FM_APPLY(c, d) \
  if (C == c && D == d) return (int)launch_apply<c, d>(p, out, G, L, S, st);
  FM_APPLY(128, 16) FM_APPLY(128, 32) FM_APPLY(256, 16) FM_APPLY(256, 32)
#undef FM_APPLY
  return (int)cudaErrorInvalidValue;
}
