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
//      saved P, do = dx1 s1, da = do Wprojᵀ, then head by head dP, dS =
//      P (dP - rowsum(dP P)), dq, dk, dv, then dh1 = dqkv Wqkvᵀ and the LN1
//      backward give dx;
//   3. the weight gradients are products over all tokens, dW = Aᵀ B: both
//      kernels write their bf16 operands (h1, dqkv, o, do, h2, dy1, gelu(y1),
//      dm; exactly the operands the TPU kernel feeds its bf16 products), and
//      wgrad_kernel (wgrad.cuh, shared with K9) forms each 64x64 tile over a
//      run of tokens into a per-split partial (raw mma.sync on ldmatrix
//      fragments, double-buffered cp.async stages);
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

using fm::bf16;
namespace wmma = fm::wmma;
using swin::D;
using swin::N;
constexpr int kWarps = 8;  // the backward's blocks
constexpr int kThreads = 32 * kWarps;
using fm::sum_parts;
using fm::wgrad;

constexpr int HC = 128;        // hidden columns per chunk in mlp_bwd
constexpr int LDY = HC + 4;    // f32 hidden-chunk row stride
constexpr int LDYB = HC + 8;   // bf16 hidden-chunk row stride
constexpr int LDP = N + 8;     // bf16 [64][64] tile row stride
constexpr int LDF = N + 4;     // f32 [64][64] tile row stride
constexpr int kScratch = kWarps * 256 * 4;  // a 16x16 f32 epilogue tile a warp
constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
constexpr float kScale = 0.25f;  // head_dim ** -0.5

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// The backward's products: WMMA 16x16x16 tiles, each accumulator handed to
// its epilogue through a per-warp 16x16 f32 scratch in shared memory.

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

template <int C>
struct AttnSmem {
  static constexpr int LDX = C + 8, LDQ = 3 * C + 8, LDD = C + 4, LDG = 3 * D + 4;
  // one head's P (bf16), dS (bf16) and dP / then [dq | dk | dv] (f32)
  static constexpr size_t head_bytes = N * LDP * 2 * 2 + N * LDF * 4;
  static constexpr size_t h_bytes = N * LDX * 2 > head_bytes ? N * LDX * 2 : head_bytes;
  static constexpr size_t h_off = 0;                          // h1, then o, then head scratch
  static constexpr size_t q_off = h_off + h_bytes;            // bf16 [64][LDQ] qkv, then dqkv
  static constexpr size_t o_off = q_off + N * LDQ * 2;        // bf16 [64][LDX] do
  static constexpr size_t a_off = o_off + N * LDX * 2;        // bf16 [64][LDX] da
  static constexpr size_t st_off = a_off + N * LDX * 2;       // f32 mu[64], rs[64]
  static constexpr size_t acc_off = st_off + 2 * N * 4;       // f32 [6C] sums
  static constexpr size_t scr_off = acc_off + 6 * C * 4;
  static constexpr size_t bytes = scr_off + kScratch;
  static_assert(N * LDG * 4 <= N * LDF * 4, "[dq|dk|dv] must fit over dP");
  static_assert(N * LDD * 4 <= 2 * N * LDX * 2, "dh1 must fit over do and da");
};

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const bf16* __restrict__ x, const float* s1, const bf16* __restrict__ probs,
                const float* __restrict__ dx1, const float* __restrict__ ln1s,
                const float* __restrict__ ln1b, const bf16* __restrict__ wqkv,
                const float* __restrict__ bqkv, const bf16* __restrict__ wproj, int num_windows,
                bf16* stash_base, bf16* __restrict__ dx, float* __restrict__ part,
                float* __restrict__ dbias_part) {
  using S = AttnSmem<C>;
  using P = Part<C>;
  constexpr int H = C / D, LDX = S::LDX, LDQ = S::LDQ, LDD = S::LDD, LDG = S::LDG;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem + S::h_off);
  bf16* ps = hs;                                                     // [64][LDP] P of a head
  bf16* dss = hs + N * LDP;                                          // [64][LDP] dS
  float* dps = reinterpret_cast<float*>(smem + S::h_off + N * LDP * 2 * 2);  // dP, then dq|dk|dv
  bf16* qkv = reinterpret_cast<bf16*>(smem + S::q_off);
  bf16* dos = reinterpret_cast<bf16*>(smem + S::o_off);
  bf16* das = reinterpret_cast<bf16*>(smem + S::a_off);
  float* dh1 = reinterpret_cast<float*>(smem + S::o_off);
  float* mu = reinterpret_cast<float*>(smem + S::st_off);
  float* rs = mu + N;
  // dbqkv [3C] | dbproj [C] | dl1s [C] | dl1b [C], as Part lays them out from P::dbqkv
  float* acc = reinterpret_cast<float*>(smem + S::acc_off);
  constexpr int A_DBQKV = 0, A_DBPROJ = 3 * C, A_DL1S = 4 * C, A_DL1B = 5 * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scr = reinterpret_cast<float*>(smem + S::scr_off) + warp * 256;
  const size_t T = (size_t)num_windows * N;
  Stash<C> st(stash_base, T);
  float* dbias = dbias_part + (size_t)blockIdx.x * H * N * N;

  for (int i = threadIdx.x; i < 6 * C; i += blockDim.x) acc[i] = 0.f;
  for (int i = threadIdx.x; i < H * N * N; i += blockDim.x) dbias[i] = 0.f;

  for (int win = blockIdx.x; win < num_windows; win += gridDim.x) {
    const size_t row0 = (size_t)win * N;
    const float sc1 = s1 ? s1[win] : 1.0f;
    const bf16* pw = probs + (size_t)win * H * N * N;
    __syncthreads();
    // h1 = LN1(x); qkv = h1 Wqkv + bqkv
    ln_rows<C>(x + row0 * C, C, ln1s, ln1b, mu, rs, hs, LDX, warp, lane);
    __syncthreads();
    fm::copy_rows_from_smem(st.h1 + row0 * C, C, hs, LDX, N, C);
    gemm_rows64<C, 3 * C / 16>(hs, LDX, wqkv, 3 * C, scr, warp, lane,
                                     [&](int r, int c, float v) {
                                       qkv[r * LDQ + c] = __float2bfloat16(v + bqkv[c]);
                                     });
    __syncthreads();
    // o = P v per (head, 16 rows), from the saved P, into hs
    for (int u = warp; u < H * (N / 16); u += kWarps) {
      const int hd = u / (N / 16), tm = u % (N / 16);
      fm::FragC o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int k = 0; k < N / 16; ++k) {
        fm::FragA fp;
        fm::FragBRow fv;
        wmma::load_matrix_sync(fp, pw + ((size_t)hd * N + tm * 16) * N + k * 16, N);
        wmma::load_matrix_sync(fv, qkv + k * 16 * LDQ + 2 * C + hd * D, LDQ);
        wmma::mma_sync(o, fp, fv, o);
      }
      tile_epilogue(o, scr, lane, [&](int r, int c, float v) {
        hs[(tm * 16 + r) * LDX + hd * D + c] = __float2bfloat16(v);
      });
    }
    // do = dx1 * s1 (f32 column sums into dbproj)
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float sum = 0.f;
      for (int r = 0; r < N; ++r) {
        const float v = dx1[(row0 + r) * C + c] * sc1;
        dos[r * LDX + c] = __float2bfloat16(v);
        sum += v;
      }
      acc[A_DBPROJ + c] += sum;
    }
    __syncthreads();
    fm::copy_rows_from_smem(st.o + row0 * C, C, hs, LDX, N, C);
    fm::copy_rows_from_smem(st.dout + row0 * C, C, dos, LDX, N, C);
    // da = do Wprojᵀ
    gemm_rows64_wt<C, C / 16>(dos, LDX, wproj, C, scr, warp, lane, [&](int r, int c, float v) {
      das[r * LDX + c] = __float2bfloat16(v);
    });
    __syncthreads();

    for (int hd = 0; hd < H; ++hd) {
      // this head's P
      for (int e = threadIdx.x; e < N * N / 8; e += blockDim.x) {
        const int r = e / (N / 8), c = (e % (N / 8)) * 8;
        *reinterpret_cast<uint4*>(ps + r * LDP + c) =
            *reinterpret_cast<const uint4*>(pw + ((size_t)hd * N + r) * N + c);
      }
      // dP = da_h v_hᵀ [64][64], 16 tiles
      for (int t = warp; t < 16; t += kWarps) {
        const int tm = t / 4, tn = t % 4;
        fm::FragA fa;
        fm::FragBCol fb;
        fm::FragC acc_t;
        wmma::fill_fragment(acc_t, 0.f);
        wmma::load_matrix_sync(fa, das + tm * 16 * LDX + hd * D, LDX);
        wmma::load_matrix_sync(fb, qkv + tn * 16 * LDQ + 2 * C + hd * D, LDQ);
        wmma::mma_sync(acc_t, fa, fb, acc_t);
        wmma::store_matrix_sync(dps + tm * 16 * LDF + tn * 16, acc_t, LDF, wmma::mem_row_major);
      }
      __syncthreads();
      // dS = P (dP - rowsum(dP P)); f32 dS into this block's rel_bias partial
      for (int r = warp * 8; r < warp * 8 + 8; ++r) {
        const float p0 = bf(ps[r * LDP + lane]), p1 = bf(ps[r * LDP + lane + 32]);
        const float d0 = dps[r * LDF + lane], d1 = dps[r * LDF + lane + 32];
        const float row = fm::warp_sum(d0 * p0 + d1 * p1);
        const float s0 = p0 * (d0 - row), s1v = p1 * (d1 - row);
        float* db = dbias + ((size_t)hd * N + r) * N;
        db[lane] += s0;
        db[lane + 32] += s1v;
        dss[r * LDP + lane] = __float2bfloat16(s0);
        dss[r * LDP + lane + 32] = __float2bfloat16(s1v);
      }
      __syncthreads();
      // dq = dS k_h, dk = dSᵀ q_h (both x head_dim^-0.5), dv = Pᵀ da_h: 12 tiles
      fm::FragC res[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int u = warp + j * kWarps, kind = u / 4, tm = u % 4;
        if (u >= 12) continue;
        wmma::fill_fragment(res[j], 0.f);
#pragma unroll
        for (int k = 0; k < N / 16; ++k) {
          fm::FragBRow fb;
          if (kind == 0) {
            fm::FragA fa;
            wmma::load_matrix_sync(fa, dss + tm * 16 * LDP + k * 16, LDP);
            wmma::load_matrix_sync(fb, qkv + k * 16 * LDQ + C + hd * D, LDQ);
            wmma::mma_sync(res[j], fa, fb, res[j]);
          } else {
            fm::FragACol fa;
            wmma::load_matrix_sync(fa, (kind == 1 ? dss : ps) + k * 16 * LDP + tm * 16, LDP);
            if (kind == 1)
              wmma::load_matrix_sync(fb, qkv + k * 16 * LDQ + hd * D, LDQ);
            else
              wmma::load_matrix_sync(fb, das + k * 16 * LDX + hd * D, LDX);
            wmma::mma_sync(res[j], fa, fb, res[j]);
          }
        }
        if (kind < 2)
          for (int i = 0; i < res[j].num_elements; ++i) res[j].x[i] *= kScale;
      }
      __syncthreads();  // every tile is done reading dS, P and the head's q, k, v
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int u = warp + j * kWarps, kind = u / 4, tm = u % 4;
        if (u < 12)
          wmma::store_matrix_sync(dps + tm * 16 * LDG + kind * D, res[j], LDG,
                                  wmma::mem_row_major);
      }
      __syncthreads();
      // f32 column sums into dbqkv; bf16 [dq | dk | dv] over the head's q, k, v
      for (int c = threadIdx.x; c < 3 * D; c += blockDim.x) {
        float sum = 0.f;
        for (int r = 0; r < N; ++r) sum += dps[r * LDG + c];
        acc[A_DBQKV + (c / D) * C + hd * D + c % D] += sum;
      }
      for (int e = threadIdx.x; e < N * 3 * D; e += blockDim.x) {
        const int r = e / (3 * D), c = e % (3 * D);
        qkv[r * LDQ + (c / D) * C + hd * D + c % D] = __float2bfloat16(dps[r * LDG + c]);
      }
      __syncthreads();
    }
    fm::copy_rows_from_smem(st.dqkv + row0 * 3 * C, 3 * C, qkv, LDQ, N, 3 * C);
    // dh1 = dqkv Wqkvᵀ (f32, over do and da)
    gemm_rows64_wt<3 * C, C / 16>(qkv, LDQ, wqkv, 3 * C, scr, warp, lane,
                                  [&](int r, int c, float v) { dh1[r * LDD + c] = v; });
    __syncthreads();
    // LN1 backward: dx = dx1 + LN1ᵀ(dh1)
    ln_backward<C>(dh1, LDD, x + row0 * C, C, mu, rs, ln1s, acc + A_DL1S, acc + A_DL1B, warp,
                   lane, [&](int r, int c) { return dx1[(row0 + r) * C + c]; },
                   [&](int r, int c, float v) { dx[(row0 + r) * C + c] = __float2bfloat16(v); });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * C; i += blockDim.x)
    part[(size_t)blockIdx.x * P::stride + P::dbqkv + i] = acc[i];
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
                       int splits, cudaStream_t st) {
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
  e = wgrad(s.h1, C, s.dqkv, 3 * C, T, splits, C, 3 * C, gemm, gr[2], st);
  if (e != cudaSuccess) return e;
  e = wgrad(s.o, C, s.dout, C, T, splits, C, C, gemm + (size_t)splits * 3 * C * C, gr[5], st);
  if (e != cudaSuccess) return e;
  e = wgrad(s.h2, C, s.dy1, 4 * C, T, splits, C, 4 * C, gemm + (size_t)splits * 4 * C * C, gr[9],
            st);
  if (e != cudaSuccess) return e;
  return wgrad(s.ge, 4 * C, s.dm, C, T, splits, 4 * C, C, gemm + (size_t)splits * 8 * C * C,
               gr[11], st);
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
// [nb][C/16][64][64], f32 weight-gradient partials [splits][12 C^2]}, T =
// 64 num_windows. (The backward reads the saved probabilities, so no mask.)
extern "C" int fm_swin_block_train_bwd(const void* const* in, void* const* out, int num_windows,
                                       int C, int nb, int splits, void* stream) {
  if (nb <= 0 || splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (C) {
    case 64: e = launch_bwd<64>(in, out, num_windows, nb, splits, st); break;
    case 128: e = launch_bwd<128>(in, out, num_windows, nb, splits, st); break;
    case 256: e = launch_bwd<256>(in, out, num_windows, nb, splits, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
