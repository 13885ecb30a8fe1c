#pragma once

// Whole Swin block on 8x8 windows, shared by the serving and training forwards:
//   h = LN1(x); x += proj(W-MSA(qkv(h), rel_bias, shift mask)); x += mlp2(gelu(mlp1(LN2(x))))
//
// Replaces featurematching_tpu/ops/pallas_swin_block.py · swin_block_fused
// (_block_kernel / _block_math). Bound on the H100: tensor-core operations
// (24*C^2 + 256*C multiply-adds x2 per token against 4*C bytes of
// activations in and out; the weights stay in L2), so the design keeps every
// intermediate of a window on chip: one thread block per window holds the
// window's activations, its LN output and its q/k/v in shared memory, and
// runs every product on bf16 tensor cores (WMMA 16x16x16, f32 accumulation).
//   - Products: a warp computes a strip of 2 or 4 row tiles against one
//     16-column strip of the weight, so each weight fragment it loads from
//     L2 feeds 2-4 independent products.
//   - Attention: a warp takes whole (head, 16 query rows) units in its own
//     slice of shared memory (scores, softmax, P.V), so heads need no block
//     barriers; a unit's output overwrites the q columns it alone reads.
//   - MLP: the hidden width runs in chunks of 128 columns and the mlp2
//     partial products accumulate in registers, so the [64, 4C] hidden never
//     exists at once (at C = 256 it alone would be 256 KB in f32, more than a
//     block's shared memory).
//
// Rounding follows the TPU kernel: products accumulate in f32, the bias is
// added in f32 (and, in training, the branch scale applied) and the sum is
// rounded to bf16; residual adds are bf16 + bf16.
//
// The same kernel serves the training forward (swin_block_train.cu, K8):
// TrainIO carries the drop-path branch scales and the outputs the backward
// reads; the serving forward (swin_block.cu, K2) passes nulls. It also
// serves the image-layout block (swin_block_image.cu, K12): ImageIO has it
// read each window straight from a padded [B, Hp2, Wp2, C] map and write it
// back to the same place, with the shift mask derived from each token's
// region label instead of read.

#include "common.cuh"

namespace swin {

using fm::bf16;
namespace wmma = fm::wmma;

constexpr int N = 64;  // tokens of an 8x8 window
constexpr int D = 16;  // head dim
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int HC = 128;      // MLP hidden columns per chunk
constexpr int LDS = N + 4;   // f32 score row stride (padded against bank conflicts)
constexpr int LDP = N + 8;   // bf16 probability row stride
constexpr int LDH = HC + 8;  // bf16 hidden-chunk row stride
// per-warp slice: 16 score rows (f32), then 16 probability rows (bf16); the
// first 1 KB doubles as the warp's 16x16 f32 epilogue scratch
constexpr int kWarpBytes = 16 * LDS * 4 + 16 * LDP * 2;

template <int C>
struct Smem {
  static constexpr int LDX = C + 8;      // x / LN rows
  static constexpr int LDQ = 3 * C + 8;  // q|k|v rows
  static constexpr size_t x_off = 0;                    // bf16 [N][LDX] residual stream
  static constexpr size_t h_off = x_off + N * LDX * 2;  // bf16 [N][LDX] LN output
  static constexpr size_t q_off = h_off + N * LDX * 2;  // bf16 [N][LDQ] q|k|v, then MLP hidden chunk
  static constexpr size_t w_off = q_off + N * LDQ * 2;  // per-warp slices
  static constexpr size_t o_off = w_off + kWarps * kWarpBytes;  // int64 [N] token offsets
  static constexpr size_t l_off = o_off + N * 8;                // uint8 [N] region labels
  static constexpr size_t bytes = l_off + N;
  static_assert(N * LDH * 2 <= N * LDQ * 2, "hidden chunk must fit in the qkv region");
};

// Store an accumulator tile through the warp's scratch and hand each of its
// 256 values to epi(row, col, value).
template <typename Epi>
__device__ __forceinline__ void tile_epilogue(const fm::FragC& acc, float* scr, int lane,
                                              Epi epi) {
  wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 256; e += 32) epi(e / 16, e % 16, scr[e]);
  __syncwarp();
}

// acc[i] += A[16i .. 16i+16, 0..K) . B[0..K, 16 columns] for RT row tiles;
// A in shared memory (row stride lda), B row-major in global (row stride ldb)
template <int K, int RT>
__device__ __forceinline__ void strip_mma(fm::FragC* acc, const bf16* a, int lda,
                                          const bf16* b, int ldb) {
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    fm::FragBRow fb;
    wmma::load_matrix_sync(fb, b + (size_t)k * 16 * ldb, ldb);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      fm::FragA fa;
      wmma::load_matrix_sync(fa, a + i * 16 * lda + k * 16, lda);
      wmma::mma_sync(acc[i], fa, fb, acc[i]);
    }
  }
}

// row tiles per work unit: 4 when the strips alone keep all warps busy
__host__ __device__ constexpr int rows_per_unit(int strips) { return strips % kWarps == 0 ? 4 : 2; }

// out[64][16 * STRIPS] = A[64][K] . B[K][16 * STRIPS], handed to epi(row, col, v)
template <int K, int STRIPS, typename Epi>
__device__ __forceinline__ void gemm_rows64(const bf16* a, int lda, const bf16* b, int ldb,
                                            float* scr, int warp, int lane, Epi epi) {
  constexpr int RT = rows_per_unit(STRIPS), GROUPS = 4 / RT;
  for (int u = warp; u < STRIPS * GROUPS; u += kWarps) {
    const int tn = u / GROUPS, tm0 = (u % GROUPS) * RT;
    fm::FragC acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) wmma::fill_fragment(acc[i], 0.f);
    strip_mma<K, RT>(acc, a + tm0 * 16 * lda, lda, b + tn * 16, ldb);
#pragma unroll
    for (int i = 0; i < RT; ++i)
      tile_epilogue(acc[i], scr, lane,
                    [&](int r, int c, float v) { epi((tm0 + i) * 16 + r, tn * 16 + c, v); });
  }
}

// LN over the window's 64 rows of `src` into `dst` (bf16), 8 rows a warp.
template <int C>
__device__ __forceinline__ void layer_norm_rows(const bf16* src, bf16* dst, const float* s,
                                                const float* b, int warp, int lane) {
  constexpr int V = C / 32, LDX = Smem<C>::LDX;
#pragma unroll  // independent rows: their shuffle reductions overlap
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float v[V];
    fm::load_bf16<V>(src + r * LDX + lane * V, v);
    fm::warp_layer_norm<V, C>(v, s + lane * V, b + lane * V);
    fm::store_bf16<V>(dst + r * LDX + lane * V, v);
  }
}

// One (head, 16 query rows) attention unit in the warp's slice: scores with
// the relative-position bias and the shift mask (read from mk, or -100
// between tokens of different region labels lab), softmax, then P.V written
// over the unit's q columns.
template <int C>
__device__ __forceinline__ void attention_unit(bf16* qkv, int hd, int tm,
                                               const float* rel_bias, const float* mk,
                                               const unsigned char* lab,
                                               unsigned char* slice, int lane,
                                               bf16* probs) {
  constexpr int LDQ = Smem<C>::LDQ;
  float* sc = reinterpret_cast<float*>(slice);
  bf16* pr = reinterpret_cast<bf16*>(slice + 16 * LDS * 4);
  fm::FragA fq;
  wmma::load_matrix_sync(fq, qkv + tm * 16 * LDQ + hd * D, LDQ);
#pragma unroll
  for (int tn = 0; tn < N / 16; ++tn) {
    fm::FragBCol fk;
    fm::FragC s;
    wmma::fill_fragment(s, 0.f);
    wmma::load_matrix_sync(fk, qkv + tn * 16 * LDQ + C + hd * D, LDQ);
    wmma::mma_sync(s, fq, fk, s);
    wmma::store_matrix_sync(sc + tn * 16, s, LDS, wmma::mem_row_major);
  }
  __syncwarp();
  const float* rb = rel_bias + ((size_t)hd * N + tm * 16) * N;
  const float* mr = mk ? mk + (size_t)tm * 16 * N : nullptr;
#pragma unroll  // independent rows: their shuffle reductions overlap
  for (int r = 0; r < 16; ++r) {
    float s0 = sc[r * LDS + lane] * 0.25f + rb[r * N + lane];
    float s1 = sc[r * LDS + lane + 32] * 0.25f + rb[r * N + lane + 32];
    if (mr) {
      s0 += mr[r * N + lane];
      s1 += mr[r * N + lane + 32];
    }
    if (lab) {
      const unsigned char lq = lab[tm * 16 + r];
      s0 += lab[lane] == lq ? 0.f : -100.f;
      s1 += lab[lane + 32] == lq ? 0.f : -100.f;
    }
    const float m = fm::warp_max(fmaxf(s0, s1));
    const float e0 = expf(s0 - m), e1 = expf(s1 - m);
    const float z = fm::warp_sum(e0 + e1);
    pr[r * LDP + lane] = __float2bfloat16(e0 / z);
    pr[r * LDP + lane + 32] = __float2bfloat16(e1 / z);
    if (probs) {  // training: the probabilities, [head][row][key] per window
      bf16* pg = probs + ((size_t)hd * N + tm * 16 + r) * N;
      pg[lane] = pr[r * LDP + lane];
      pg[lane + 32] = pr[r * LDP + lane + 32];
    }
  }
  __syncwarp();
  fm::FragC o;
  wmma::fill_fragment(o, 0.f);
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    fm::FragA fp;
    fm::FragBRow fv;
    wmma::load_matrix_sync(fp, pr + k * 16, LDP);
    wmma::load_matrix_sync(fv, qkv + k * 16 * LDQ + 2 * C + hd * D, LDQ);
    wmma::mma_sync(o, fp, fv, o);
  }
  tile_epilogue(o, sc, lane, [&](int r, int c, float v) {
    qkv[(tm * 16 + r) * LDQ + hd * D + c] = __float2bfloat16(v);
  });
}

// What the training forward adds: per-window branch scales (null: none) and
// the two tensors it keeps for the backward (null in the serving forward).
struct TrainIO {
  const float* s1;  // [num_windows] attention-branch scale
  const float* s2;  // [num_windows] MLP-branch scale
  bf16* probs;      // [num_windows][C/16][64][64] attention probabilities
  bf16* x1;         // [num_windows][64][C] residual stream after the attention branch
};

// Where the block's tokens live. hp2 = 0: the window layout [windows, 64,
// C]. Otherwise the padded map [B, hp2, wp2, C] (hp2, wp2 multiples of 8),
// windows numbered image by image in row-major order; with shift > 0 the
// map is padded as ops/swin_block_image.py pads it ((8 - shift) rows and
// columns before the content, the content to a multiple of 8, shift after)
// and the mask is -100 between tokens of different regions.
struct ImageIO {
  int hp2 = 0, wp2 = 0, shift = 0;
};

// Region band of padded coordinate p along an axis of padded length p2
// (pad_region_masks): 3 in the added pad, else 2, 0 or 1 as the rolled
// map's shift mask labels the content coordinate.
__device__ __forceinline__ int region_band(int p, int p2, int shift) {
  const int y = p - (8 - shift), hp = p2 - 8;
  if (y < 0 || y >= hp) return 3;
  return y < shift ? 2 : (y < hp - 8 + shift ? 0 : 1);
}

// Each token's element offset in x and out, and its region label (shift
// mask of the image layout only), into shared memory.
__device__ __forceinline__ void window_tokens(const ImageIO& img, int win, int C,
                                              long long* off, unsigned char* lab) {
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    if (img.hp2 == 0) {
      off[t] = ((long long)win * N + t) * C;
      continue;
    }
    const int nww = img.wp2 / 8, nwh = img.hp2 / 8;
    const int b = win / (nwh * nww), y = (win / nww) % nwh * 8 + t / 8,
              xx = win % nww * 8 + t % 8;
    off[t] = (((long long)b * img.hp2 + y) * img.wp2 + xx) * C;
    if (img.shift > 0)
      lab[t] = region_band(y, img.hp2, img.shift) * 4 + region_band(xx, img.wp2, img.shift);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
swin_block_kernel(TrainIO io, ImageIO img, const bf16* __restrict__ x,
                  const float* __restrict__ mask, int nW,
                  const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                  const bf16* __restrict__ wqkv, const float* __restrict__ bqkv,
                  const float* __restrict__ rel_bias, const bf16* __restrict__ wproj,
                  const float* __restrict__ bproj, const float* __restrict__ ln2s,
                  const float* __restrict__ ln2b, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, bf16* __restrict__ out) {
  using S = Smem<C>;
  constexpr int H = C / D, HID = 4 * C, LDX = S::LDX, LDQ = S::LDQ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + S::x_off);
  bf16* hs = reinterpret_cast<bf16*>(smem + S::h_off);
  bf16* qkv = reinterpret_cast<bf16*>(smem + S::q_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* slice = smem + S::w_off + warp * kWarpBytes;
  float* scr = reinterpret_cast<float*>(slice);
  const int win = blockIdx.x;

  long long* toff = reinterpret_cast<long long*>(smem + S::o_off);
  unsigned char* lab = smem + S::l_off;
  window_tokens(img, win, C, toff, lab);
  __syncthreads();
  for (int e = threadIdx.x; e < N * (C / 8); e += kThreads) {  // 16-byte loads
    const int r = e / (C / 8), c = e % (C / 8) * 8;
    *reinterpret_cast<uint4*>(xs + r * LDX + c) =
        *reinterpret_cast<const uint4*>(x + toff[r] + c);
  }
  __syncthreads();
  layer_norm_rows<C>(xs, hs, ln1s, ln1b, warp, lane);
  __syncthreads();

  // qkv = LN1(x) @ w_qkv + b_qkv   ([64, C] x [C, 3C])
  gemm_rows64<C, 3 * C / 16>(hs, LDX, wqkv, 3 * C, scr, warp, lane,
                             [&](int row, int col, float v) {
                               qkv[row * LDQ + col] = __float2bfloat16(v + bqkv[col]);
                             });
  __syncthreads();

  const float* mk = nW > 0 ? mask + (size_t)(win % nW) * N * N : nullptr;
  bf16* probs = io.probs ? io.probs + (size_t)win * H * N * N : nullptr;
  for (int u = warp; u < H * (N / 16); u += kWarps)
    attention_unit<C>(qkv, u / (N / 16), u % (N / 16), rel_bias, mk,
                      img.shift > 0 ? lab : nullptr, slice, lane, probs);
  __syncthreads();

  // x = x + s1 * (attn @ w_proj + b_proj)
  const float sc1 = io.s1 ? io.s1[win] : 1.0f, sc2 = io.s2 ? io.s2[win] : 1.0f;
  gemm_rows64<C, C / 16>(qkv, LDQ, wproj, C, scr, warp, lane, [&](int row, int col, float v) {
    const float o = __bfloat162float(__float2bfloat16((v + bproj[col]) * sc1));
    bf16& xr = xs[row * LDX + col];
    xr = __float2bfloat16(__bfloat162float(xr) + o);
  });
  __syncthreads();
  if (io.x1) fm::copy_rows_from_smem(io.x1 + (size_t)win * N * C, C, xs, LDX, N, C);
  layer_norm_rows<C>(xs, hs, ln2s, ln2b, warp, lane);
  __syncthreads();

  // out = x + mlp2(gelu(mlp1(LN2(x)))), hidden in chunks of HC columns; each
  // warp keeps UPW units of RT2 output tiles in registers across the chunks
  constexpr int S2 = C / 16, RT2 = rows_per_unit(S2), G2 = 4 / RT2;
  constexpr int UPW = S2 * G2 / kWarps;
  static_assert(S2 * G2 % kWarps == 0, "mlp2 units must spread evenly over the warps");
  fm::FragC acc[UPW][RT2];
#pragma unroll
  for (int j = 0; j < UPW; ++j)
#pragma unroll
    for (int i = 0; i < RT2; ++i) wmma::fill_fragment(acc[j][i], 0.f);
  bf16* hid = qkv;
  for (int c0 = 0; c0 < HID; c0 += HC) {
    gemm_rows64<C, HC / 16>(hs, LDX, w1 + c0, HID, scr, warp, lane,
                            [&](int row, int col, float v) {
                              v += b1[c0 + col];
                              const float g = 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
                              hid[row * LDH + col] = __float2bfloat16(g);
                            });
    __syncthreads();
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = warp + j * kWarps, tn = u / G2, tm0 = (u % G2) * RT2;
      strip_mma<HC, RT2>(acc[j], hid + tm0 * 16 * LDH, LDH, w2 + (size_t)c0 * C + tn * 16, C);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < UPW; ++j) {
    const int u = warp + j * kWarps, tn = u / G2, tm0 = (u % G2) * RT2;
#pragma unroll
    for (int i = 0; i < RT2; ++i)
      tile_epilogue(acc[j][i], scr, lane, [&](int r, int c, float v) {
        const int row = (tm0 + i) * 16 + r, col = tn * 16 + c;
        const float y = __bfloat162float(__float2bfloat16((v + b2[col]) * sc2));
        out[toff[row] + col] = __float2bfloat16(__bfloat162float(xs[row * LDX + col]) + y);
      });
  }
}

template <int C>
cudaError_t launch_block(TrainIO io, const void* x, const void* mask, int nW,
                         const void* const* p, void* out, int num_windows, cudaStream_t st,
                         ImageIO img = {}) {
  const size_t smem = Smem<C>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      swin_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  auto Bf = [](const void* q) { return static_cast<const bf16*>(q); };
  swin_block_kernel<C><<<num_windows, kThreads, smem, st>>>(
      io, img, Bf(x), F(mask), nW, F(p[0]), F(p[1]), Bf(p[2]), F(p[3]), F(p[4]), Bf(p[5]),
      F(p[6]), F(p[7]), F(p[8]), Bf(p[9]), F(p[10]), Bf(p[11]), F(p[12]),
      static_cast<bf16*>(out));
  return cudaGetLastError();
}

}  // namespace swin
