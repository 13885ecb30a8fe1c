// K8: the differentiable Swin block with drop-path branch scales.
//
// Replaces featurematching_tpu/ops/pallas_swin_block_grad.py · swin_block_train
// (_train_fwd_kernel through _fwd_impl, _train_bwd_kernel through _bwd_impl).
//
// Forward: K2's kernel (swin_block.cuh) with the branch scales s1/s2 applied
// in f32 before each residual add, writing the attention probabilities
// [win][head][64][64] (bf16, as the TPU kernel saves them) and the residual
// stream after the attention branch, x1 (bf16), for the backward.
//
// Backward. Bound on the H100: tensor-core operations (about twice the
// forward's products, 48*C^2 + 512*C multiply-adds x2 a token, against about
// 10*C bytes a token of activations, probabilities and gradients). The TPU
// kernel keeps everything of a chunk of windows in VMEM and accumulates the
// weight gradients across its sequential grid. On the H100 blocks run in
// parallel and a block has 227 KB of shared memory (the forward alone needs
// 213 KB at C = 256), so the backward is split where the gradient of the residual
// stream crosses between the two branches:
//   1. mlp_bwd: per window (a persistent block walks a fixed set of windows)
//      LN2 is recomputed from x1, the hidden width is streamed in chunks of
//      128 columns (y1 = h2 W1 + b1, gelu, dge = dm W2ᵀ, dy1), dh2 = dy1 W1ᵀ
//      accumulates in registers, and the LN2 backward gives dx1 = g + ...
//      (f32, to device memory);
//   2. attn_bwd: per window LN1 and qkv are recomputed, o = P v from the
//      saved P, do = dx1 s1, da = do Wprojᵀ, then two heads at a time dP,
//      dS = P (dP - rowsum(dP P)), dq, dk, dv on register-resident units,
//      then dh1 = dqkv Wqkvᵀ and the LN1 backward give dx (section 2 says
//      how: mma.sync tiles with register epilogues, the weights through a
//      cp.async ring, as the forward's body);
//   3. the weight gradients are products over all tokens, dW = Aᵀ B: both
//      kernels write their bf16 operands (h1, dqkv, o, do, h2, dy1, gelu(y1),
//      dm; exactly the operands the TPU kernel feeds its bf16 products), and
//      wgrad_kernel (wgrad.cuh, shared with K9 and K10) forms the four in
//      one launch, each tile of up to 128x256 over a run of tokens sized to
//      the card into a per-split partial (wgmma from a ring of
//      tensor-copied token stages);
//   4. every reduction across blocks (the weight-gradient splits, the
//      per-block sums of the bias, LN and rel_bias gradients) is a second
//      pass that adds the partials in a fixed order: the gradients are
//      deterministic, and no float atomics are used.
// Rounding follows the TPU kernel: bf16 operands, f32 accumulation; the
// bias, LN and rel_bias gradients sum f32 values.

#include "swin_block.cuh"
#include "tiles.cuh"
#include "wgrad.cuh"

namespace {

using fm::Acc16;
using fm::bf16;
namespace wmma = fm::wmma;
using swin::D;
using swin::N;
constexpr int kWarps = 8;  // the backward's blocks
constexpr int kThreads = 32 * kWarps;
using fm::sum_parts;

constexpr int HC = 128;        // hidden columns per chunk in mlp_bwd
constexpr int LDY = HC + 4;    // f32 hidden-chunk row stride
constexpr int LDYB = HC + 8;   // bf16 hidden-chunk row stride
constexpr int LDP = N + 8;     // bf16 [64][64] tile row stride
constexpr int kScratch = kWarps * 256 * 4;  // a 16x16 f32 epilogue tile a warp
constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
constexpr float kScale = 0.25f;  // head_dim ** -0.5

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// mlp_bwd's products: WMMA 16x16x16 tiles, each accumulator handed to its
// epilogue through a per-warp 16x16 f32 scratch in shared memory.

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

// acc[i] += A[16i .., 0..K) . Wᵀ for RT row tiles, W row-major [n][k] (row
// stride ldw) read as a col-major B: element (k, n) at w[n * ldw + k]
template <int K, int RT>
__device__ __forceinline__ void strip_mma_wt(fm::FragC* acc, const bf16* a, int lda,
                                             const bf16* w, int ldw) {
#pragma unroll 4
  for (int k = 0; k < K / 16; ++k) {
    fm::FragBCol fb;
    wmma::load_matrix_sync(fb, w + k * 16, ldw);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      fm::FragA fa;
      wmma::load_matrix_sync(fa, a + i * 16 * lda + k * 16, lda);
      wmma::mma_sync(acc[i], fa, fb, acc[i]);
    }
  }
}

// out[64][16 * STRIPS] = A[64][K] . Wᵀ, W row-major [16 * STRIPS][K] (row
// stride ldw), handed to epi(row, col, v)
template <int K, int STRIPS, typename Epi>
__device__ __forceinline__ void gemm_rows64_wt(const bf16* a, int lda, const bf16* w, int ldw,
                                               float* scr, int warp, int lane, Epi epi) {
  constexpr int RT = rows_per_unit(STRIPS), GROUPS = 4 / RT;
  for (int u = warp; u < STRIPS * GROUPS; u += kWarps) {
    const int tn = u / GROUPS, tm0 = (u % GROUPS) * RT;
    fm::FragC acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) wmma::fill_fragment(acc[i], 0.f);
    strip_mma_wt<K, RT>(acc, a + tm0 * 16 * lda, lda, w + (size_t)tn * 16 * ldw, ldw);
#pragma unroll
    for (int i = 0; i < RT; ++i)
      tile_epilogue(acc[i], scr, lane,
                    [&](int r, int c, float v) { epi((tm0 + i) * 16 + r, tn * 16 + c, v); });
  }
}

// LN statistics and output of 64 rows, 8 rows a warp, as the forward
// computes them (fm::warp_layer_norm): rows from `src` (row stride lds),
// mean and rstd to mu/rs, the bf16 output to dst (row stride ldd).
template <int C>
__device__ __forceinline__ void ln_rows(const bf16* src, int lds, const float* s, const float* b,
                                        float* mu, float* rs, bf16* dst, int ldd, int warp,
                                        int lane) {
  constexpr int V = C / 32;
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float v[V];
    fm::load_bf16<V>(src + (size_t)r * lds + lane * V, v);
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) t += v[i];
    const float m = fm::warp_sum(t) * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] -= m;
      q += v[i] * v[i];
    }
    const float rr = rsqrtf(fm::warp_sum(q) * (1.0f / C) + fm::kLnEps);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = v[i] * rr * s[lane * V + i] + b[lane * V + i];
    fm::store_bf16<V>(dst + r * ldd + lane * V, v);
    if (lane == 0) {
      mu[r] = m;
      rs[r] = rr;
    }
  }
}

// LN backward of one window. dh [64][ldh] f32 (gradient of the LN output),
// the LN input xin (bf16, row stride ldx) with its mu/rs; adds
// sum dh * xhat and sum dh into the block's accumulators acc_s / acc_b
// (column-owned), and writes out = base + rs (dxhat - mean(dxhat) -
// xhat mean(dxhat xhat)), dxhat = dh * scale, through store(row, col, v).
template <int C, typename Base, typename Store>
__device__ __forceinline__ void ln_backward(const float* dh, int ldh, const bf16* xin, int ldx,
                                            const float* mu, const float* rs, const float* scale,
                                            float* acc_s, float* acc_b, int warp, int lane,
                                            Base base, Store store) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float ss = 0.f, sb = 0.f;
    for (int r = 0; r < N; ++r) {
      const float d = dh[r * ldh + c];
      ss += d * ((bf(xin[(size_t)r * ldx + c]) - mu[r]) * rs[r]);
      sb += d;
    }
    acc_s[c] += ss;
    acc_b[c] += sb;
  }
  constexpr int V = C / 32;
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float xh[V], dxh[V];
    fm::load_bf16<V>(xin + (size_t)r * ldx + lane * V, xh);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane * V + i;
      xh[i] = (xh[i] - mu[r]) * rs[r];
      dxh[i] = dh[r * ldh + c] * scale[c];
      m1 += dxh[i];
      m2 += dxh[i] * xh[i];
    }
    m1 = fm::warp_sum(m1) * (1.0f / C);
    m2 = fm::warp_sum(m2) * (1.0f / C);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane * V + i;
      store(r, c, base(r, c) + rs[r] * (dxh[i] - m1 - xh[i] * m2));
    }
  }
}

// ---------------------------------------------------------------------------
// 1. the MLP branch
// ---------------------------------------------------------------------------

template <int C>
struct MlpSmem {
  static constexpr int LDX = C + 8, LDD = C + 4;
  static constexpr size_t x_off = 0;                                  // bf16 [64][LDX] x1
  static constexpr size_t h_off = x_off + N * LDX * 2;                // bf16 [64][LDX] h2
  static constexpr size_t m_off = h_off + N * LDX * 2;                // bf16 [64][LDX] dm
  static constexpr size_t y_off = m_off + N * LDX * 2;                // f32 [64][LDY] y1 / dy1
  static constexpr size_t yb_off = y_off + N * LDY * 4;               // bf16 [64][LDYB] dy1
  static constexpr size_t st_off = yb_off + N * LDYB * 2;             // f32 mu[64], rs[64]
  static constexpr size_t acc_off = st_off + 2 * N * 4;               // f32 [7C] sums
  static constexpr size_t scr_off = acc_off + 7 * C * 4;              // epilogue scratch
  static constexpr size_t bytes = scr_off + kScratch;
  // after the hidden loop dh2 (f32 [64][LDD]) lives over h2 and dm
  static_assert(N * LDD * 4 <= 2 * N * LDX * 2, "dh2 must fit over h2 and dm");
};

// Partial sums a block writes, 13*C floats: the MLP kernel's db2 [C],
// db1 [4C], dln2_scale [C], dln2_bias [C]; the attention kernel's
// dbqkv [3C], dbproj [C], dln1_scale [C], dln1_bias [C].
template <int C>
struct Part {
  static constexpr int db2 = 0, db1 = C, dl2s = 5 * C, dl2b = 6 * C;
  static constexpr int dbqkv = 7 * C, dbproj = 10 * C, dl1s = 11 * C, dl1b = 12 * C;
  static constexpr int stride = 13 * C;
};

// Stash of the weight-gradient operands, bf16 [T][width] each.
template <int C>
struct Stash {
  bf16 *h1, *dqkv, *o, *dout, *h2, *dm, *dy1, *ge;
  __host__ __device__ explicit Stash(bf16* base, size_t T)
      : h1(base), dqkv(base + C * T), o(base + 4 * C * T), dout(base + 5 * C * T),
        h2(base + 6 * C * T), dm(base + 7 * C * T), dy1(base + 8 * C * T),
        ge(base + 12 * C * T) {}
};

template <int C>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(const bf16* __restrict__ x1g, const bf16* __restrict__ g, const float* s2,
               const float* __restrict__ ln2s, const float* __restrict__ ln2b,
               const bf16* __restrict__ w1, const float* __restrict__ b1,
               const bf16* __restrict__ w2, int num_windows, bf16* stash_base,
               float* __restrict__ dx1, float* __restrict__ part) {
  using S = MlpSmem<C>;
  using P = Part<C>;
  constexpr int HID = 4 * C, LDX = S::LDX, LDD = S::LDD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + S::x_off);
  bf16* hs = reinterpret_cast<bf16*>(smem + S::h_off);
  bf16* dms = reinterpret_cast<bf16*>(smem + S::m_off);
  float* ys = reinterpret_cast<float*>(smem + S::y_off);
  bf16* dys = reinterpret_cast<bf16*>(smem + S::yb_off);
  float* mu = reinterpret_cast<float*>(smem + S::st_off);
  float* rs = mu + N;
  float* acc = reinterpret_cast<float*>(smem + S::acc_off);  // db2 | db1 | dl2s | dl2b
  float* dh2 = reinterpret_cast<float*>(smem + S::h_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scr = reinterpret_cast<float*>(smem + S::scr_off) + warp * 256;
  const size_t T = (size_t)num_windows * N;
  Stash<C> st(stash_base, T);

  for (int i = threadIdx.x; i < 7 * C; i += blockDim.x) acc[i] = 0.f;
  constexpr int S2 = C / 16, RT2 = rows_per_unit(S2), G2 = 4 / RT2, UPW = S2 * G2 / kWarps;
  static_assert(S2 * G2 % kWarps == 0, "dh2 units must spread evenly over the warps");

  for (int win = blockIdx.x; win < num_windows; win += gridDim.x) {
    const size_t row0 = (size_t)win * N;
    const float sc2 = s2 ? s2[win] : 1.0f;
    __syncthreads();  // the previous window is done with shared memory
    fm::copy_rows_to_smem(xs, LDX, x1g + row0 * C, C, N, C, N);
    // dm = g * s2 (f32 column sums into db2), bf16 for the products
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float sum = 0.f;
      for (int r = 0; r < N; ++r) {
        const float v = bf(g[(row0 + r) * C + c]) * sc2;
        dms[r * LDX + c] = __float2bfloat16(v);
        sum += v;
      }
      acc[P::db2 + c] += sum;
    }
    __syncthreads();
    ln_rows<C>(xs, LDX, ln2s, ln2b, mu, rs, hs, LDX, warp, lane);
    __syncthreads();
    fm::copy_rows_from_smem(st.h2 + row0 * C, C, hs, LDX, N, C);
    fm::copy_rows_from_smem(st.dm + row0 * C, C, dms, LDX, N, C);

    fm::FragC dacc[UPW][RT2];
#pragma unroll
    for (int j = 0; j < UPW; ++j)
#pragma unroll
      for (int i = 0; i < RT2; ++i) wmma::fill_fragment(dacc[j][i], 0.f);
    for (int c0 = 0; c0 < HID; c0 += HC) {
      // y1 = h2 W1[:, chunk] + b1 (f32)
      gemm_rows64<C, HC / 16>(hs, LDX, w1 + c0, HID, scr, warp, lane,
                                    [&](int r, int c, float v) { ys[r * LDY + c] = v + b1[c0 + c]; });
      __syncthreads();
      // dge = dm W2[chunk, :]ᵀ; ge = gelu(y1) to the stash; dy1 = dge gelu'(y1)
      gemm_rows64_wt<C, HC / 16>(dms, LDX, w2 + (size_t)c0 * C, C, scr, warp, lane,
                                 [&](int r, int c, float v) {
                                   const float y = ys[r * LDY + c];
                                   const float cdf = 0.5f * (1.0f + erff(y * kSqrtHalf));
                                   st.ge[(row0 + r) * HID + c0 + c] = __float2bfloat16(y * cdf);
                                   const float dy = v * (cdf + y * kInvSqrt2Pi * expf(-0.5f * y * y));
                                   ys[r * LDY + c] = dy;
                                   dys[r * LDYB + c] = __float2bfloat16(dy);
                                 });
      __syncthreads();
      for (int c = threadIdx.x; c < HC; c += blockDim.x) {
        float sum = 0.f;
        for (int r = 0; r < N; ++r) sum += ys[r * LDY + c];
        acc[P::db1 + c0 + c] += sum;
      }
      fm::copy_rows_from_smem(st.dy1 + row0 * HID + c0, HID, dys, LDYB, N, HC);
      // dh2 += dy1 W1[:, chunk]ᵀ
#pragma unroll
      for (int j = 0; j < UPW; ++j) {
        const int u = warp + j * kWarps, tn = u / G2, tm0 = (u % G2) * RT2;
        strip_mma_wt<HC, RT2>(dacc[j], dys + tm0 * 16 * LDYB, LDYB,
                              w1 + (size_t)tn * 16 * HID + c0, HID);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = warp + j * kWarps, tn = u / G2, tm0 = (u % G2) * RT2;
#pragma unroll
      for (int i = 0; i < RT2; ++i)
        wmma::store_matrix_sync(dh2 + (tm0 + i) * 16 * LDD + tn * 16, dacc[j][i], LDD,
                                wmma::mem_row_major);
    }
    __syncthreads();
    // LN2 backward: dx1 = g + LN2ᵀ(dh2)
    ln_backward<C>(dh2, LDD, xs, LDX, mu, rs, ln2s, acc + P::dl2s, acc + P::dl2b, warp, lane,
                   [&](int r, int c) { return bf(g[(row0 + r) * C + c]); },
                   [&](int r, int c, float v) { dx1[(row0 + r) * C + c] = v; });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 7 * C; i += blockDim.x)
    part[(size_t)blockIdx.x * P::stride + i] = acc[i];
}

// ---------------------------------------------------------------------------
// 2. the attention branch
// ---------------------------------------------------------------------------
//
// Per window, every product on tiles.cuh's mma.sync tiles with register
// epilogues (no WMMA and no f32 scratch):
//   - h1 = LN1(x), qkv = h1 Wqkv + bqkv, da = do Wprojᵀ and dh1 = dqkv Wqkvᵀ
//     as [64, C] products, the block's 8 warps as 2 x 4 over each, a warp on
//     a 32 x C/4 tile. The weights stream through a cp.async ring of slices
//     (AttnStream), each window the same stream: Wqkv's q, k and v column
//     blocks as [KS][C] row slices, then Wproj and Wqkv as [C][KS] column
//     slices, which ldmatrix without .trans (load_bt) reads as Wᵀ;
//   - the heads two at a time (a pair), on register-resident units, with two
//     barriers a pair. Phase A: warp w takes (head 2 pair + w / 4, query rows
//     16 (w % 4) ..): its strip of the saved P as A fragments, o = P v,
//     dP = da_h v_hᵀ in 32 f32 registers, the row sums across the four lanes
//     of a row, dS = P (dP - rowsum(dP P)) in registers (f32 into the block's
//     rel_bias partial; bf16 as the A fragments of dq = dS k_h, which the
//     m16n8k16 accumulator layout gives directly). Only the bf16 P and dS
//     strips reach shared memory. Phase B: the same warp takes (its head, key
//     rows 16 (w % 4) ..): dk = dSᵀ q_h and dv = Pᵀ da_h through
//     ldmatrix.trans, written over k_h and v_h; dq goes over q_h after the
//     next barrier, when no unit reads q_h any more;
//   - the rel_bias partial of a block: at C = 64 in its warps' registers over
//     the block's windows, written once at its end; at C = 128 and 256 in
//     device memory, written by the block's first window, added to by the
//     others (a block takes one window at C = 256);
//   - the f32 column sums of dq, dk and dv (dbqkv) leave the units'
//     registers by shuffles across the rows into accumulators [row tile][3C]
//     that one warp owns each; dbproj and the LN1 gradients sum in each
//     thread's registers over a fixed set of (row, column) elements; at the
//     block's end all of them add up in a fixed order.

constexpr int kWN = kWarps / 2;  // the attention kernel's products: warps as 2 x kWN

// The attention kernel's weights as one stream of slices through a ring of
// STAGES slots, in the order of use, the same for every window: Wqkv's q, k
// and v column blocks in [KS][C] row slices (qkv = h1 Wqkv), Wproj in [C][KS]
// column slices (da = do Wprojᵀ), then Wqkv in [C][KS] column slices over its
// 3C columns (dh1 = dqkv Wqkvᵀ).
template <int C>
struct AttnStream {
  static constexpr int KS = C == 256 ? 16 : (C == 128 ? 32 : 64);
  static constexpr int STAGES = 3;
  static constexpr int LDN = C + 8;   // a row slice [KS][LDN]
  static constexpr int LDT = KS + 8;  // a column slice [C][LDT]
  static constexpr int SLOT = KS * LDN > C * LDT ? KS * LDN : C * LDT;  // bf16 a slot
  static constexpr int QKV = 3 * C / KS, PROJ = C / KS, PER_WINDOW = 7 * C / KS;
  const bf16 *wqkv, *wproj;
  bf16* ring;
  int issued, taken, total;

  template <int ROWS, int COLS>
  __device__ __forceinline__ static void copy(bf16* dst, int ldd, const bf16* src, int ld) {
    for (int e = threadIdx.x; e < ROWS * COLS / 8; e += kThreads) {
      const int r = e / (COLS / 8), c = e % (COLS / 8) * 8;
      fm::cp_async16(dst + r * ldd + c, src + (size_t)r * ld + c);
    }
  }

  // start copying the next slice into its slot; past the block's last window
  // an empty group, so that every wait counts the same groups
  __device__ __forceinline__ void issue() {
    if (issued < total) {
      const int j = issued % PER_WINDOW;
      bf16* dst = ring + (issued % STAGES) * SLOT;
      if (j < QKV)
        copy<KS, C>(dst, LDN, wqkv + (size_t)(j % (C / KS)) * KS * 3 * C + j / (C / KS) * C,
                    3 * C);
      else if (j < QKV + PROJ)
        copy<C, KS>(dst, LDT, wproj + (j - QKV) * KS, C);
      else
        copy<C, KS>(dst, LDT, wqkv + (j - QKV - PROJ) * KS, 3 * C);
    }
    fm::cp_async_commit();
    ++issued;
  }

  __device__ __forceinline__ void start(int slices) {
    issued = taken = 0;
    total = slices;
    for (int s = 0; s < STAGES - 1; ++s) issue();
  }

  // The next slice, once every thread's copies of it have landed; the
  // barrier also orders the block's shared-memory writes before it against
  // the reads after it, and frees the previous slice's slot for the next copy.
  __device__ __forceinline__ const bf16* next() {
    fm::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const bf16* s = ring + (taken % STAGES) * SLOT;
    ++taken;
    issue();
    return s;
  }
};

template <int C>
using AttnAcc = Acc16[2][C / (16 * kWN)];

template <int C>
__device__ __forceinline__ void zero(AttnAcc<C>& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < C / (16 * kWN); ++j) fm::zero(acc[i][j]);
}

// acc += A[64][K] . B over the warp's tile, B from the stream's next K / KS
// slices: row slices of W (B = W) or, TRANS, column slices of W (B = Wᵀ).
// A in shared memory (row stride lda).
template <int C, int K, bool TRANS>
__device__ __forceinline__ void attn_product(AttnAcc<C>& acc, const bf16* a, int lda,
                                             AttnStream<C>& ws, int warp, int lane) {
  using WS = AttnStream<C>;
  constexpr int KS = WS::KS, NT = C / (16 * kWN);
  const int m0 = warp / kWN * 32, n0 = warp % kWN * (C / kWN);
  for (int r = 0; r < K / KS; ++r) {
    const bf16* w = ws.next();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t fa[2][4], fb[NT][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        fm::load_a(fa[i], a + (m0 + 16 * i) * lda + r * KS + 16 * kk, lda, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (TRANS)
          fm::load_bt(fb[j], w + (n0 + 16 * j) * WS::LDT + 16 * kk, WS::LDT, lane);
        else
          fm::load_b(fb[j], w + 16 * kk * WS::LDN + n0 + 16 * j, WS::LDN, lane);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) fm::mma16(acc[i][j], fa[i], fb[j]);
    }
  }
}

// Hand the warp's tile to epi(row, col, v0, v1), v0 and v1 at columns col
// and col + 1, straight from the accumulator registers.
template <int C, typename Epi>
__device__ __forceinline__ void attn_epilogue(const AttnAcc<C>& acc, int warp, int lane, Epi epi) {
  const int m0 = warp / kWN * 32, n0 = warp % kWN * (C / kWN), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < C / (16 * kWN); ++j)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
        epi(m0 + 16 * i + g + 8 * (jp & 1), n0 + 16 * j + 8 * (jp >> 1) + 2 * t,
            acc[i][j].c[2 * jp], acc[i][j].c[2 * jp + 1]);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Add the 16 column sums of a unit's 16x16 tile (c in the accumulator
// layout) to dst[0..16): sums across the tile's rows by shuffles, then
// lanes 0..15 add one column each.
__device__ __forceinline__ void add_col_sums(const float (&c)[8], float* dst, int lane) {
  float cs[4];  // columns 2t, 2t + 1, 8 + 2t, 9 + 2t over rows g and g + 8
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = (q >> 1) * 4 + (q & 1);
    cs[q] = c[j] + c[j + 2];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) cs[q] += __shfl_xor_sync(0xffffffffu, cs[q], o);
  const int g = lane >> 2, t = lane & 3;
  const float v = g == 0 ? cs[0] : g == 1 ? cs[1] : g == 2 ? cs[2] : cs[3];
  if (g < 4) dst[8 * (g >> 1) + 2 * t + (g & 1)] += v;
}

// Store a unit's 16x16 tile (accumulator layout) as bf16 at dst (row stride ld).
__device__ __forceinline__ void store_tile_bf16(const float (&c)[8], bf16* dst, int ld,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp)
    *reinterpret_cast<__nv_bfloat162*>(dst + (g + 8 * (jp & 1)) * ld + 8 * (jp >> 1) + 2 * t) =
        __floats2bfloat162_rn(c[2 * jp], c[2 * jp + 1]);
}

template <int C>
struct AttnSmem {
  using WS = AttnStream<C>;
  static constexpr int LDX = C + 8, LDQ = 3 * C + 8, LDD = C + 4;
  // the P and dS strips of a pair of heads, bf16 [2][64][LDP] each
  static constexpr size_t pair_bytes = 2 * 2 * N * LDP * 2;
  static constexpr size_t h_bytes = N * LDX * 2 > pair_bytes ? N * LDX * 2 : pair_bytes;
  static constexpr size_t q_off = 0;                          // bf16 [64][LDQ] qkv, then dqkv
  static constexpr size_t h_off = q_off + N * LDQ * 2;        // h1, then do, then P | dS
  static constexpr size_t a_off = h_off + h_bytes;            // bf16 [64][LDX] da
  static constexpr size_t w_off = a_off + N * LDX * 2;        // weight ring
  static constexpr size_t st_off = w_off + WS::STAGES * WS::SLOT * 2;  // f32 mu[64], rs[64]
  static constexpr size_t acc_off = st_off + 2 * N * 4;       // f32 [4][3C] dbqkv by row tile
  static constexpr size_t bytes = acc_off + 4 * 3 * C * 4;
  static_assert(N * LDD * 4 <= h_bytes + N * LDX * 2, "dh1 must fit over h and da");
  static_assert(3 * kThreads * 4 <= h_bytes, "the per-thread sums must fit over h");
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// The strip of the saved P that the unit (head hd, query rows 16 tile ..)
// takes: 16 rows x 64 keys, four 16-byte loads a lane; pw: the window's
// probabilities [heads][64][64].
__device__ __forceinline__ void load_p_strip(const bf16* pw, int hd, int tile, int lane,
                                             uint4 (&pv)[4]) {
  const bf16* pg = pw + ((size_t)hd * N + tile * 16) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = lane + 32 * i;
    pv[i] = *reinterpret_cast<const uint4*>(pg + (e >> 3) * N + (e & 7) * 8);
  }
}

// Phase A of the unit (head hd, query rows 16 tile ..): see the section's
// comment. pv: the unit's strip of P (load_p_strip); ps / ss: the head's P
// and dS strips [64][LDP]; o_out: the window's rows of the o stash; colq:
// this row tile's dbqkv accumulator.
// The unit's f32 dS goes to the block's rel_bias partial: REG, into dbr
// (the unit's 32 values a lane, kept in registers over the block's
// windows); otherwise into dbias in device memory, which the block's first
// window writes and the others add to. Leaves dq (x head_dim^-0.5) in dq.
template <int C, bool REG>
__device__ __forceinline__ void grad_unit_rows(const bf16* qkv, const bf16* das,
                                               const uint4 (&pv)[4], bf16* ps, bf16* ss,
                                               bf16* o_out, float* dbias,
                                               float (&dbr)[32], float* colq, bool first, int hd,
                                               int tile, int lane, float (&dq)[8]) {
  constexpr int LDQ = 3 * C + 8, LDX = C + 8;
  const int g = lane >> 2, t = lane & 3;
  // the unit's strip of P into its rows of ps, then A fragments
  bf16* pr = ps + tile * 16 * LDP;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = lane + 32 * i;
    *reinterpret_cast<uint4*>(pr + (e >> 3) * LDP + (e & 7) * 8) = pv[i];
  }
  __syncwarp();
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) fm::load_a(pa[kt], pr + kt * 16, LDP, lane);
  // o = P v_h, rounded to bf16, to the stash
  const bf16* vh = qkv + 2 * C + hd * D;
  {
    Acc16 o;
    fm::zero(o);
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt) {
      uint32_t vb[4];
      fm::load_b(vb, vh + kt * 16 * LDQ, LDQ, lane);
      fm::mma16(o, pa[kt], vb);
    }
    store_tile_bf16(o.c, o_out + (size_t)tile * 16 * C + hd * D, C, lane);
  }
  // dP = da_h v_hᵀ: 16 rows x 64 keys
  Acc16 dp[N / 16];
  {
    uint32_t aa[4];
    fm::load_a(aa, das + tile * 16 * LDX + hd * D, LDX, lane);
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt) {
      uint32_t vb[4];
      fm::load_bt(vb, vh + kt * 16 * LDQ, LDQ, lane);
      fm::zero(dp[kt]);
      fm::mma16(dp[kt], aa, vb);
    }
  }
  // rowsum(dP P): pair jp of key tile kt is row g + 8 (jp & 1), in P's A fragment pa[kt][jp]
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const float2 p = unpack_bf16(pa[kt][jp]);
      rsum[jp & 1] += dp[kt].c[2 * jp] * p.x + dp[kt].c[2 * jp + 1] * p.y;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
  }
  // dS = P (dP - rowsum): f32 into the rel_bias partial, bf16 to ss and as A fragments
  uint32_t sa[N / 16][4];
  float* db = dbias + ((size_t)hd * N + tile * 16) * N;
  bf16* sr = ss + tile * 16 * LDP;
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const float2 p = unpack_bf16(pa[kt][jp]);
      const float r = rsum[jp & 1];
      const float s0 = p.x * (dp[kt].c[2 * jp] - r), s1 = p.y * (dp[kt].c[2 * jp + 1] - r);
      const int row = g + 8 * (jp & 1), col = 16 * kt + 8 * (jp >> 1) + 2 * t;
      float2* d2 = reinterpret_cast<float2*>(db + row * N + col);
      if (REG) {
        dbr[kt * 8 + 2 * jp] += s0;
        dbr[kt * 8 + 2 * jp + 1] += s1;
      } else if (first) {
        *d2 = make_float2(s0, s1);
      } else {
        const float2 acc = *d2;
        *d2 = make_float2(acc.x + s0, acc.y + s1);
      }
      sa[kt][jp] = fm::pack_bf16(s0, s1);
      *reinterpret_cast<uint32_t*>(sr + row * LDP + col) = sa[kt][jp];
    }
  // dq = dS k_h x head_dim^-0.5
  Acc16 a;
  fm::zero(a);
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    uint32_t kb[4];
    fm::load_b(kb, qkv + kt * 16 * LDQ + C + hd * D, LDQ, lane);
    fm::mma16(a, sa[kt], kb);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) dq[j] = a.c[j] * kScale;
  add_col_sums(dq, colq + hd * D, lane);
}

// Phase B of the unit (head hd, key rows 16 tile ..): dk = dSᵀ q_h x
// head_dim^-0.5 and dv = Pᵀ da_h, their column sums into colq, bf16 over
// the unit's rows of k_h and v_h.
template <int C>
__device__ __forceinline__ void grad_unit_keys(bf16* qkv, const bf16* das, const bf16* ps,
                                               const bf16* ss, float* colq, int hd, int tile,
                                               int lane) {
  constexpr int LDQ = 3 * C + 8, LDX = C + 8;
  Acc16 dk, dv;
  fm::zero(dk);
  fm::zero(dv);
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq) {
    uint32_t fa[4], fb[4];
    fm::load_a_trans(fa, ss + kq * 16 * LDP + tile * 16, LDP, lane);
    fm::load_b(fb, qkv + kq * 16 * LDQ + hd * D, LDQ, lane);
    fm::mma16(dk, fa, fb);
    fm::load_a_trans(fa, ps + kq * 16 * LDP + tile * 16, LDP, lane);
    fm::load_b(fb, das + kq * 16 * LDX + hd * D, LDX, lane);
    fm::mma16(dv, fa, fb);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) dk.c[j] *= kScale;
  add_col_sums(dk.c, colq + C + hd * D, lane);
  add_col_sums(dv.c, colq + 2 * C + hd * D, lane);
  bf16* rows = qkv + tile * 16 * LDQ + hd * D;
  store_tile_bf16(dk.c, rows + C, LDQ, lane);
  store_tile_bf16(dv.c, rows + 2 * C, LDQ, lane);
}

// h1 = LN1(x) for the window's 64 rows (x in device memory, row stride C),
// 8 rows a warp, with ln_rows's arithmetic; all of a warp's rows are loaded
// before the first reduction, so their loads are in flight together.
template <int C>
__device__ __forceinline__ void ln1_rows(const bf16* src, const float* s, const float* b,
                                         float* mu, float* rs, bf16* dst, int ldd, int warp,
                                         int lane) {
  constexpr int V = C / 32;
  float v[8][V];
#pragma unroll
  for (int i = 0; i < 8; ++i) fm::load_bf16<V>(src + (size_t)(warp * 8 + i) * C + lane * V, v[i]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) t += v[i][j];
    const float m = fm::warp_sum(t) * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[i][j] -= m;
      q += v[i][j] * v[i][j];
    }
    const float rr = rsqrtf(fm::warp_sum(q) * (1.0f / C) + fm::kLnEps);
#pragma unroll
    for (int j = 0; j < V; ++j) v[i][j] = v[i][j] * rr * s[lane * V + j] + b[lane * V + j];
    fm::store_bf16<V>(dst + r * ldd + lane * V, v[i]);
    if (lane == 0) {
      mu[r] = m;
      rs[r] = rr;
    }
  }
}

// The rows of the LN1 backward of one window, with ln_backward's
// arithmetic: dx = dx1 + rs (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
// dxhat = dh1 * scale; 8 rows a warp, G at a time, the rows' x and dx1
// loaded before the first reduction.
template <int C>
__device__ __forceinline__ void ln1_backward_rows(const float* dh, int ldh, const bf16* x,
                                                  const float* dx1, const float* mu,
                                                  const float* rs, const float* scale, bf16* dx,
                                                  int warp, int lane) {
  constexpr int V = C / 32, G = C == 256 ? 4 : 8;
  for (int r0 = warp * 8; r0 < warp * 8 + 8; r0 += G) {
    float xh[G][V], base[G][V];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      fm::load_bf16<V>(x + (size_t)(r0 + i) * C + lane * V, xh[i]);
#pragma unroll
      for (int j = 0; j < V; j += 2) {
        const float2 d =
            *reinterpret_cast<const float2*>(dx1 + (size_t)(r0 + i) * C + lane * V + j);
        base[i][j] = d.x;
        base[i][j + 1] = d.y;
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = r0 + i;
      float dxh[V], m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = lane * V + j;
        xh[i][j] = (xh[i][j] - mu[r]) * rs[r];
        dxh[j] = dh[r * ldh + c] * scale[c];
        m1 += dxh[j];
        m2 += dxh[j] * xh[i][j];
      }
      m1 = fm::warp_sum(m1) * (1.0f / C);
      m2 = fm::warp_sum(m2) * (1.0f / C);
      float out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = base[i][j] + rs[r] * (dxh[j] - m1 - xh[i][j] * m2);
      fm::store_bf16<V>(dx + (size_t)r * C + lane * V, out);
    }
  }
}

// One block an SM at every width: at C = 64 the rel_bias partial in
// registers (REG below) takes the registers a second block would need.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const bf16* __restrict__ x, const float* s1, const bf16* __restrict__ probs,
                const float* __restrict__ dx1, const float* __restrict__ ln1s,
                const float* __restrict__ ln1b, const bf16* __restrict__ wqkv,
                const float* __restrict__ bqkv, const bf16* __restrict__ wproj, int num_windows,
                bf16* stash_base, bf16* __restrict__ dx, float* __restrict__ part,
                float* __restrict__ dbias_part) {
  using S = AttnSmem<C>;
  using P = Part<C>;
  constexpr int H = C / D, LDX = S::LDX, LDQ = S::LDQ, LDD = S::LDD;
  constexpr int R = kThreads / C;  // a thread's column sums take every R-th row
  static_assert(kWarps == 8 && H % 2 == 0, "a pair's units: 2 heads x 4 row tiles, one a warp");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qkv = reinterpret_cast<bf16*>(smem + S::q_off);
  bf16* hs = reinterpret_cast<bf16*>(smem + S::h_off);  // h1, then do
  bf16* das = reinterpret_cast<bf16*>(smem + S::a_off);
  float* dh1 = reinterpret_cast<float*>(smem + S::h_off);  // [64][LDD] over h and da
  float* mu = reinterpret_cast<float*>(smem + S::st_off);
  float* rs = mu + N;
  float* colacc = reinterpret_cast<float*>(smem + S::acc_off);  // [4][3C]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t T = (size_t)num_windows * N;
  Stash<C> st(stash_base, T);
  float* dbias = dbias_part + (size_t)blockIdx.x * H * N * N;

  for (int i = threadIdx.x; i < 4 * 3 * C; i += blockDim.x) colacc[i] = 0.f;
  // this thread's column and first row of the column sums: dbproj, LN1's scale and bias
  const int cc = threadIdx.x % C, rg = threadIdx.x / C;
  float sum_proj = 0.f, sum_l1s = 0.f, sum_l1b = 0.f;
  // the attention units: warp w takes head 2 pair + w / 4, row tile w % 4
  const int slot = warp / 4, tile = warp % 4;
  bf16* ps = hs + slot * N * LDP;
  bf16* ss = hs + (2 + slot) * N * LDP;
  float* colq = colacc + tile * 3 * C;
  // REG: the warp's rel_bias partial stays in registers over the block's
  // windows, which pays at C = 64 (two units a warp, 64 registers a lane,
  // some nine windows a block); at C = 128 it would take 128 registers, and
  // at C = 256 a block takes one window
  constexpr bool REG = C == 64;
  constexpr int NREG = REG ? H / 2 : 1;
  float dbr[NREG][32];  // REG: the rel_bias partial of the warp's unit in each pair
#pragma unroll
  for (int i = 0; i < NREG; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) dbr[i][j] = 0.f;

  AttnStream<C> ws{wqkv, wproj, reinterpret_cast<bf16*>(smem + S::w_off)};
  ws.start((num_windows - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
           AttnStream<C>::PER_WINDOW);

  for (int win = blockIdx.x; win < num_windows; win += gridDim.x) {
    const size_t row0 = (size_t)win * N;
    const float sc1 = s1 ? s1[win] : 1.0f;
    const bf16* pw = probs + (size_t)win * H * N * N;
    __syncthreads();  // the previous window is done with shared memory
    // h1 = LN1(x); qkv = h1 Wqkv + bqkv, its q, k and v blocks in turn
    ln1_rows<C>(x + row0 * C, ln1s, ln1b, mu, rs, hs, LDX, warp, lane);
    AttnAcc<C> acc;
    for (int b = 0; b < 3; ++b) {
      zero<C>(acc);
      attn_product<C, C, false>(acc, hs, LDX, ws, warp, lane);
      attn_epilogue<C>(acc, warp, lane, [&](int r, int c, float v0, float v1) {
        const float2 bb = *reinterpret_cast<const float2*>(bqkv + b * C + c);
        *reinterpret_cast<__nv_bfloat162*>(qkv + r * LDQ + b * C + c) =
            __floats2bfloat162_rn(v0 + bb.x, v1 + bb.y);
      });
    }
    fm::copy_rows_from_smem(st.h1 + row0 * C, C, hs, LDX, N, C);
    __syncthreads();  // h1 is read; do goes over it
    uint4 pv[4];  // the first pair's P strip, in flight during the da product
    load_p_strip(pw, slot, tile, lane, pv);
    // do = dx1 s1 (f32 column sums into dbproj); da = do Wprojᵀ
#pragma unroll 16
    for (int i = 0; i < N / R; ++i) {  // independent loads: all in flight
      const int r = rg + i * R;
      const float v = dx1[(row0 + r) * C + cc] * sc1;
      hs[r * LDX + cc] = __float2bfloat16(v);
      sum_proj += v;
    }
    zero<C>(acc);
    attn_product<C, C, true>(acc, hs, LDX, ws, warp, lane);
    attn_epilogue<C>(acc, warp, lane, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<__nv_bfloat162*>(das + r * LDX + c) = __floats2bfloat162_rn(v0, v1);
    });
    fm::copy_rows_from_smem(st.dout + row0 * C, C, hs, LDX, N, C);

    // the heads, a pair at a time
    float dq[8];
#pragma unroll NREG
    for (int pair = 0; pair < H / 2; ++pair) {
      const int hd = 2 * pair + slot;
      __syncthreads();  // da written; the previous pair's phase B is done
      if (pair > 0) store_tile_bf16(dq, qkv + tile * 16 * LDQ + (hd - 2) * D, LDQ, lane);
      grad_unit_rows<C, REG>(qkv, das, pv, ps, ss, st.o + row0 * C, dbias,
                             dbr[REG ? pair : 0], colq, win == (int)blockIdx.x, hd, tile,
                             lane, dq);
      if (pair + 1 < H / 2) load_p_strip(pw, hd + 2, tile, lane, pv);  // the next pair's
      __syncthreads();  // both heads' P and dS strips are in shared memory
      grad_unit_keys<C>(qkv, das, ps, ss, colq, hd, tile, lane);
    }
    __syncthreads();
    store_tile_bf16(dq, qkv + tile * 16 * LDQ + (H - 2 + slot) * D, LDQ, lane);
    __syncthreads();
    fm::copy_rows_from_smem(st.dqkv + row0 * 3 * C, 3 * C, qkv, LDQ, N, 3 * C);
    // dh1 = dqkv Wqkvᵀ (f32, over h and da)
    zero<C>(acc);
    attn_product<C, 3 * C, true>(acc, qkv, LDQ, ws, warp, lane);
    attn_epilogue<C>(acc, warp, lane, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(dh1 + r * LDD + c) = make_float2(v0, v1);
    });
    __syncthreads();
    // LN1 backward: dx = dx1 + LN1ᵀ(dh1)
#pragma unroll 16
    for (int i = 0; i < N / R; ++i) {
      const int r = rg + i * R;
      const float d = dh1[r * LDD + cc];
      sum_l1s += d * ((bf(x[(row0 + r) * C + cc]) - mu[r]) * rs[r]);
      sum_l1b += d;
    }
    ln1_backward_rows<C>(dh1, LDD, x + row0 * C, dx1 + row0 * C, mu, rs, ln1s, dx + row0 * C,
                         warp, lane);
  }
  // the block's partials: rel_bias's from registers, dbqkv over the four row
  // tiles, the per-thread sums over the R threads of a column, each in a
  // fixed order
  if (REG) {
#pragma unroll
    for (int pair = 0; pair < NREG; ++pair) {
      float* db = dbias + ((size_t)(2 * pair + slot) * N + tile * 16) * N;
#pragma unroll
      for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
        for (int jp = 0; jp < 4; ++jp)
          *reinterpret_cast<float2*>(db + fm::pair_row(jp, lane) * N +
                                     fm::pair_col(kt, jp, lane)) =
              make_float2(dbr[pair][kt * 8 + 2 * jp], dbr[pair][kt * 8 + 2 * jp + 1]);
    }
  }
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem + S::h_off);  // [3][kThreads]
  sums[threadIdx.x] = sum_proj;
  sums[kThreads + threadIdx.x] = sum_l1s;
  sums[2 * kThreads + threadIdx.x] = sum_l1b;
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * P::stride;
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x)
    out[P::dbqkv + i] = colacc[i] + colacc[3 * C + i] + colacc[6 * C + i] + colacc[9 * C + i];
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) {
    const int k = i / C, c = i % C;
    float s = 0.f;
    for (int q = 0; q < R; ++q) s += sums[k * kThreads + q * C + c];
    out[P::dbproj + i] = s;  // dbproj | dl1s | dl1b
  }
}

template <int C>
cudaError_t launch_fwd(const void* const* in, int num_windows, int nW, cudaStream_t st) {
  // in: x, mask, s1, s2, 13 params, out, probs, x1
  swin::TrainIO io{static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
                   static_cast<bf16*>(const_cast<void*>(in[18])),
                   static_cast<bf16*>(const_cast<void*>(in[19]))};
  return swin::launch_block<C>(io, in[0], in[1], nW, in + 4, const_cast<void*>(in[17]),
                               num_windows, st);
}

template <int C>
cudaError_t launch_bwd(const void* const* in, void* const* out, int num_windows, int nb,
                       int sms, cudaStream_t st) {
  // in: x, s1, s2, probs, x1, g, then the 13 params (PARAM_KEYS order)
  // out: dx, the 13 grads, stash, dx1, small partials, rel_bias partials, gemm partials
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  auto Bf = [](const void* q) { return static_cast<const bf16*>(q); };
  const void* const* p = in + 6;
  const int H = C / D, T = num_windows * N;
  bf16* stash = static_cast<bf16*>(out[14]);
  float* dx1 = static_cast<float*>(out[15]);
  float* small = static_cast<float*>(out[16]);
  float* dbias = static_cast<float*>(out[17]);
  float* gemm = static_cast<float*>(out[18]);
  using P = Part<C>;

  cudaError_t e = cudaFuncSetAttribute(mlp_bwd_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)MlpSmem<C>::bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)AttnSmem<C>::bytes);
  if (e != cudaSuccess) return e;
  mlp_bwd_kernel<C><<<nb, kThreads, MlpSmem<C>::bytes, st>>>(
      Bf(in[4]), Bf(in[5]), F(in[2]), F(p[7]), F(p[8]), Bf(p[9]), F(p[10]), Bf(p[11]),
      num_windows, stash, dx1, small);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_kernel<C><<<nb, kThreads, AttnSmem<C>::bytes, st>>>(
      Bf(in[0]), F(in[1]), Bf(in[3]), dx1, F(p[0]), F(p[1]), Bf(p[2]), F(p[3]), Bf(p[5]),
      num_windows, stash, static_cast<bf16*>(out[0]), small, dbias);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  Stash<C> s(stash, (size_t)T);
  // grads in PARAM_KEYS order: ln1_scale, ln1_bias, w_qkv, b_qkv, rel_bias,
  // w_proj, b_proj, ln2_scale, ln2_bias, w_mlp1, b_mlp1, w_mlp2, b_mlp2
  void* const* gr = out + 1;
  const size_t stride = P::stride;
  const struct { int off, len, out; } sums[] = {
      {P::dl1s, C, 0}, {P::dl1b, C, 1}, {P::dbqkv, 3 * C, 3}, {P::dbproj, C, 6},
      {P::dl2s, C, 7}, {P::dl2b, C, 8}, {P::db1, 4 * C, 10}, {P::db2, C, 12}};
  for (const auto& q : sums) {
    e = sum_parts(small + q.off, nb, stride, q.len, gr[q.out], st);
    if (e != cudaSuccess) return e;
  }
  e = sum_parts(dbias, nb, (size_t)H * N * N, H * N * N, gr[4], st);
  if (e != cudaSuccess) return e;
  // the four weight gradients in one launch
  const fm::WgradCall calls[] = {{s.h1, C, s.dqkv, 3 * C, T, C, 3 * C, gr[2]},
                                 {s.o, C, s.dout, C, T, C, C, gr[5]},
                                 {s.h2, C, s.dy1, 4 * C, T, C, 4 * C, gr[9]},
                                 {s.ge, 4 * C, s.dm, C, T, 4 * C, C, gr[11]}};
  return fm::wgrad_group(calls, 4, sms, gemm, st);
}

// Dynamic shared memory and resident blocks an SM of one backward kernel:
// info = {bytes, blocks}.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int bytes, int* info) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  info[0] = bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kernel, kThreads, bytes);
}

template <int C>
cudaError_t bwd_occupancy(int* info) {
  cudaError_t e = occupancy(attn_bwd_kernel<C>, (int)AttnSmem<C>::bytes, info);
  if (e != cudaSuccess) return e;
  return occupancy(mlp_bwd_kernel<C>, (int)MlpSmem<C>::bytes, info + 2);
}

}  // namespace

FM_ERROR_STRING_ENTRY

// Forward: in = {x, mask, s1, s2, ln1s, ln1b, wqkv, bqkv, rel_bias, wproj,
// bproj, ln2s, ln2b, w1, b1, w2, b2, out, probs, x1} (mask, s1, s2 may be
// null; nW = mask windows, 0 for none). Layouts as fm_swin_block; probs
// [num_windows][C/16][64][64] bf16, x1 [num_windows][64][C] bf16.
extern "C" int fm_swin_block_train_fwd(const void* const* in, int num_windows, int C, int nW,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (C) {
    case 64: e = launch_fwd<64>(in, num_windows, nW, st); break;
    case 128: e = launch_fwd<128>(in, num_windows, nW, st); break;
    case 256: e = launch_fwd<256>(in, num_windows, nW, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// Backward: in = {x, s1, s2, probs, x1, g, the 13 params}; out = {dx,
// the 13 gradients (f32, the params' layouts), bf16 stash [16 C T], f32
// dx1 [T C], f32 block partials [nb][13 C], f32 rel_bias partials
// [nb][C/16][64][64], f32 weight-gradient partials (ops/wgrad.partial_floats
// of the four products)}, T = 64 num_windows; sms: the card's SMs. (The
// backward reads the saved probabilities, so no mask.)
extern "C" int fm_swin_block_train_bwd(const void* const* in, void* const* out, int num_windows,
                                       int C, int nb, int sms, void* stream) {
  if (nb <= 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (C) {
    case 64: e = launch_bwd<64>(in, out, num_windows, nb, sms, st); break;
    case 128: e = launch_bwd<128>(in, out, num_windows, nb, sms, st); break;
    case 256: e = launch_bwd<256>(in, out, num_windows, nb, sms, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// The backward's window kernels at width C: info = {attn_bwd's dynamic
// shared memory (bytes), its resident blocks an SM, mlp_bwd's bytes, its
// blocks an SM}.
extern "C" int fm_swin_block_train_bwd_occupancy(int C, int* info) {
  cudaError_t e;
  switch (C) {
    case 64: e = bwd_occupancy<64>(info); break;
    case 128: e = bwd_occupancy<128>(info); break;
    case 256: e = bwd_occupancy<256>(info); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
