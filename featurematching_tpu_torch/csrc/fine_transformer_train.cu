// K10: the backward of one fine-window encoder call, o = enc(x, src) over G
// windows of N <= 64 taps at C = 64 (the forward is K6's kernel, one layer
// at a time, fine_stage.cu).
//
// Replaces featurematching_tpu/ops/pallas_fine_grad.py ·
// fine_transformer_train (_fine_bwd_kernel through _layer_bwd_call:
// _enc_fwd_stash, then _enc_bwd).
//
// Bound on the H100 by operations: twice the forward's products (about
// 20 C^2 multiply-adds a token) against the function's bytes at the TPU
// kernel's dtypes, x, src and the upstream gradient in and dx and dsrc out
// in bf16, 6-10 C bytes a token (utils/kernel_bounds.fine_train_bwd_work).
// This kernel moves more: the upstream gradient in and dx and dsrc out in
// f32, which keeps a layer's cotangents in f32 between its calls as the TPU
// kernel keeps them inside its one call a layer. The TPU kernel holds a chunk of windows in
// VMEM and adds each chunk's weight gradients into one output block across
// its sequential grid. On the H100 blocks run in parallel, so:
//   1. window_bwd: two blocks an SM, each looping over windows (a window of
//      49 taps is padded to four 16-row tensor-core tiles and masked). For a
//      window it recomputes the forward in shared memory in K6's rounding
//      (Q, K | V, the head-block-diagonal K^T V and K_sum, Z, o, the LN
//      statistics, msg, the ReLU mask as bits, h, y2), then runs the
//      backward on mma.sync tiles with the fragment-ordered weights of
//      tiles.cuh: LN2, the FFN, LN1, the merge, the per-head attention
//      gradients (dKV = Q^T dA and dK_sum on chip, only the heads' diagonal
//      blocks), the Q and K feature maps, and writes dx and dsrc (f32: a
//      layer's cotangents are added in f32, as the TPU kernel adds them; in
//      a self call, where src is x, dsrc is added into dx).
//      It writes, per token in bf16, the operands of the weight products:
//      o, msg, dm1, dqf, dy2, h, dy1 and [dkf | dv]; and per block the
//      partial sums of the LN parameter gradients, over its windows in
//      order. Shared memory is reused phase by phase (x, then dmsg, then
//      dA; src, o, msg, y2 | dy2, dmsg, dqf; h, then dy1; m1, then dm1;
//      K | V, then [dkf | dv]) to 115,200 bytes, so two blocks fit an SM.
//      The attention output before its rounding (A) is recomputed beside
//      the merge gradient instead of kept: one 16-deep product a tile.
//   2. the weight gradients dW = A^T B over the G N tokens (wgrad.cuh,
//      shared with K8 and K9) and the LN gradients' block partials added in
//      a fixed order: no float atomics, so the gradients repeat bit for bit.
// Head dim 8 is below the tensor cores' K of 16, so attention keeps the
// block-diagonal packed [C, C] form of K6: K^T V and dKV are formed on their
// four diagonal 16x16 tiles and masked to the heads' D x D blocks. Only the
// row sums of the TPU kernel's dKOnes are kept (dK_sum [C], as K9 does).

#include "tiles.cuh"
#include "wgrad.cuh"

namespace {

using fm::bf16;

constexpr int C = 64;
constexpr int T = 64;  // taps padded to four 16-row tiles
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeads = 8;
constexpr float kEps = 1e-6f;
constexpr int LDA = C + 8;      // [64, C] bf16 rows
constexpr int LD2 = 2 * C + 8;  // [64, 2C] bf16 rows
constexpr int MW = 2 * C / 32;  // relu mask words a row

// shared memory regions, by the phases that use them
constexpr size_t RA = 0;                      // x; dmsg (f32, over RA and RB); dA
constexpr size_t RB = RA + T * LDA * 2;       // src; o; msg; y2 | dy2; dqf
constexpr size_t RC = RB + T * LDA * 2;       // Q
constexpr size_t RD = RC + T * LDA * 2;       // K | V, then [dkf | dv]
constexpr size_t RE = RD + T * LD2 * 2;       // h, then dy1
constexpr size_t RF = RE + T * LD2 * 2;       // m1, then dm1
constexpr size_t QFAC = RF + T * LDA * 2;     // f32 elu'(x . wq) [64][C]
constexpr size_t KFAC = QFAC + T * C * 4;     // f32 elu'(src . wk) [64][C]
constexpr size_t KVD = KFAC + T * C * 4;      // bf16 K^T V diagonal tiles [4][16][16]
constexpr size_t DKVD = KVD + 4 * 256 * 2;    // bf16 dKV diagonal tiles
constexpr size_t KSUM = DKVD + 4 * 256 * 2;   // f32 K_sum [C] (bf16 values)
constexpr size_t DKS = KSUM + C * 4;          // f32 dK_sum [C] (bf16 values)
constexpr size_t ZS = DKS + C * 4;            // f32 Z [64][kMaxHeads]
constexpr size_t DZH = ZS + T * kMaxHeads * 4;  // f32 head sums of dZ [64][kMaxHeads]
constexpr size_t MASK = DZH + T * kMaxHeads * 4;  // relu(y1) > 0 bits [64][MW]
constexpr size_t STATS = MASK + T * MW * 4;   // f32 mu1, rs1, mu2, rs2 [64]
constexpr size_t kSmemBytes = STATS + 4 * T * 4;
static_assert(T * C * 4 <= 2 * T * LDA * 2, "f32 dmsg must fit regions A and B");
static_assert(2 * (kSmemBytes + 1024) <= 233472, "two blocks an SM");

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// [64][C] f32 tile, columns swizzled by row so fragment-order stores spread
// over the banks
__device__ __forceinline__ int fidx(int r, int c) { return r * C + (c ^ ((r & 7) << 2)); }

// B fragment of the 16x16 tile whose B[k][n] is s[n * lds + k]
__device__ __forceinline__ void load_b_t(uint32_t* r, const bf16* s, int lds, int lane) {
  const int m = lane >> 3;
  fm::ldsm_x4(r, s + ((lane & 7) + (m >> 1) * 8) * lds + (m & 1) * 8);
}

// LayerNorm of 64 rows from src to dst (bf16) as fm::warp_layer_norm
// computes it, keeping each row's mean and reciprocal deviation
__device__ void ln_fwd_rows(const bf16* src, const float* s, const float* b, float* mu,
                            float* rs, bf16* dst, int warp, int lane) {
  constexpr int V = C / 32;
  for (int r = warp; r < T; r += kWarps) {
    float v[V];
    fm::load_bf16<V>(src + r * LDA + lane * V, v);
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
    fm::store_bf16<V>(dst + r * LDA + lane * V, v);
    if (lane == 0) {
      mu[r] = m;
      rs[r] = rr;
    }
  }
}

// the statistics alone
__device__ void ln_stats_rows(const bf16* src, float* mu, float* rs, int warp, int lane) {
  constexpr int V = C / 32;
  for (int r = warp; r < T; r += kWarps) {
    float v[V];
    fm::load_bf16<V>(src + r * LDA + lane * V, v);
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) t += v[i];
    const float m = fm::warp_sum(t) * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) q += (v[i] - m) * (v[i] - m);
    const float rr = rsqrtf(fm::warp_sum(q) * (1.0f / C) + fm::kLnEps);
    if (lane == 0) {
      mu[r] = m;
      rs[r] = rr;
    }
  }
}

// the LN parameter gradients of the window's valid rows, added to the
// column's running sums by the thread owning column c < C
template <typename Dh>
__device__ __forceinline__ void ln_bwd_columns(const bf16* xin, const float* mu, const float* rs,
                                               int valid, Dh dh, float& acc_s, float& acc_b) {
  const int c = threadIdx.x;
  if (c >= C) return;
  float ss = 0.f, sb = 0.f;
  for (int r = 0; r < valid; ++r) {
    const float d = dh(r, c);
    ss += d * ((bf(xin[r * LDA + c]) - mu[r]) * rs[r]);
    sb += d;
  }
  acc_s += ss;
  acc_b += sb;
}

// LN backward of the rows in place: dx = rs (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)), dxhat = dh * scale, rounded to bf16 (rows past valid: 0)
template <typename Dh>
__device__ void ln_bwd_rows(bf16* rows, const float* mu, const float* rs, const float* scale,
                            int valid, Dh dh, int warp, int lane) {
  constexpr int V = C / 32;
  for (int r = warp; r < T; r += kWarps) {
    float out[V];
    if (r < valid) {
      float xh[V], dxh[V];
      fm::load_bf16<V>(rows + r * LDA + lane * V, xh);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = lane * V + i;
        xh[i] = (xh[i] - mu[r]) * rs[r];
        dxh[i] = dh(r, c) * scale[c];
        m1 += dxh[i];
        m2 += dxh[i] * xh[i];
      }
      m1 = fm::warp_sum(m1) * (1.0f / C);
      m2 = fm::warp_sum(m2) * (1.0f / C);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = rs[r] * (dxh[i] - m1 - xh[i] * m2);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = 0.f;
    }
    fm::store_bf16<V>(rows + r * LDA + lane * V, out);
  }
}

struct Io {
  const bf16 *x, *src;
  const float* g;
  const bf16 *wq, *wkv, *wm, *w1, *w2;  // forward operands, packed [in, out]
  const float *n1s, *n1b, *n2s, *n2b;
  const bf16 *w2t, *w1mt, *wmt, *wdxt, *wkvt;  // packed transposes
  float *dx, *dsrc;
  bf16 *o, *msg, *dm1, *dqf, *dy2, *h, *dy1, *dkv3;  // stash [G N][width]
  float* part_ln;  // [blocks][4C]: dn1s | dn1b | dn2s | dn2b
  int G, N, self_call;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2) window_bwd_kernel(Io io) {
  constexpr int H = C / D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + RA);
  bf16* das = xs;
  float* dmsg = reinterpret_cast<float*>(smem + RA);
  bf16* rb = reinterpret_cast<bf16*>(smem + RB);  // src, o, msg, y2 | dy2, dqf
  bf16* ss = io.self_call ? xs : rb;
  bf16* qs = reinterpret_cast<bf16*>(smem + RC);
  bf16* kvs = reinterpret_cast<bf16*>(smem + RD);
  bf16* hs = reinterpret_cast<bf16*>(smem + RE);
  bf16* m1s = reinterpret_cast<bf16*>(smem + RF);
  float* qfac = reinterpret_cast<float*>(smem + QFAC);
  float* kfac = reinterpret_cast<float*>(smem + KFAC);
  bf16* kvd = reinterpret_cast<bf16*>(smem + KVD);
  bf16* dkvd = reinterpret_cast<bf16*>(smem + DKVD);
  float* ksum = reinterpret_cast<float*>(smem + KSUM);
  float* dks = reinterpret_cast<float*>(smem + DKS);
  float* zs = reinterpret_cast<float*>(smem + ZS);
  float* dzh = reinterpret_cast<float*>(smem + DZH);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + MASK);
  float* mu1 = reinterpret_cast<float*>(smem + STATS);
  float* rs1 = mu1 + T;
  float* mu2 = rs1 + T;
  float* rs2 = mu2 + T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int N = io.N;
  const float n_f = (float)N, inv_n = 1.0f / (float)N;
  float acc_n1s = 0.f, acc_n1b = 0.f, acc_n2s = 0.f, acc_n2b = 0.f;

  for (int w = blockIdx.x; w < io.G; w += gridDim.x) {
    const size_t row0 = (size_t)w * N;  // first token of the window
    const float* gg = io.g + row0 * C;
    auto gval = [&](int r, int c) { return gg[(size_t)r * C + c]; };

    // ---- forward recompute, in K6's rounding ----
    fm::copy_rows_to_smem(xs, LDA, io.x + row0 * C, C, T, C, N);
    if (!io.self_call) fm::copy_rows_to_smem(rb, LDA, io.src + row0 * C, C, T, C, N);
    for (int i = threadIdx.x; i < T * MW; i += kThreads) mask[i] = 0u;
    __syncthreads();
    // Q = elu(x . wq) + 1, keeping elu'(x . wq)
    fm::gemm_rows64<kWarps, C, C / 16>(xs, LDA, io.wq, 0, warp, lane, [&](int r, int c, float v) {
      qs[r * LDA + c] = __float2bfloat16(fm::elu1(v));
      qfac[fidx(r, c)] = v > 0.f ? 1.0f : expf(v);
    });
    // [K | V] = [elu(src . wk) + 1 | src . wv / N], no mass past N; elu'(src . wk)
    fm::gemm_rows64<kWarps, C, 2 * C / 16>(ss, LDA, io.wkv, 0, warp, lane,
                                           [&](int r, int c, float v) {
                                             float o = 0.f;
                                             if (r < N) o = c < C ? fm::elu1(v) : v * inv_n;
                                             if (c < C) kfac[fidx(r, c)] = v > 0.f ? 1.0f : expf(v);
                                             kvs[r * LD2 + c] = __float2bfloat16(o);
                                           });
    __syncthreads();
    if (warp < 4) {  // diagonal tile `warp` of K^T V, masked to the heads' blocks
      fm::Acc16 acc;
      fm::zero(acc);
#pragma unroll
      for (int k = 0; k < T / 16; ++k) {
        uint32_t fa[4], fb[4];
        fm::load_a_trans(fa, kvs + k * 16 * LD2 + warp * 16, LD2, lane);
        fm::load_b(fb, kvs + k * 16 * LD2 + C + warp * 16, LD2, lane);
        fm::mma16(acc, fa, fb);
      }
      fm::tile_epilogue(acc, 0, 0, lane, [&](int r, int c, float v) {
        const bool same = (warp * 16 + r) / D == (warp * 16 + c) / D;
        kvd[warp * 256 + r * 16 + c] = __float2bfloat16(same ? v : 0.f);
      });
    } else if (threadIdx.x < 4 * 32 + C) {
      const int c = threadIdx.x - 4 * 32;
      float s = 0.f;
      for (int r = 0; r < N; ++r) s += bf(kvs[r * LD2 + c]);
      ksum[c] = fm::round_bf16(s);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < T * H; e += kThreads) {  // Z[r][h] = Q_h . K_sum_h
      const int r = e / H, hh = e % H;
      float z = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) z += bf(qs[r * LDA + hh * D + d]) * ksum[hh * D + d];
      zs[r * kMaxHeads + hh] = z;
    }
    __syncthreads();
    // o = Q . KV_bd * (N / (Z + eps)) into region B
    for (int u = warp; u < 16; u += kWarps) {
      const int tm = u / 4, j = u % 4;
      uint32_t fa[4], fb[4];
      fm::Acc16 acc;
      fm::zero(acc);
      fm::load_a(fa, qs + tm * 16 * LDA + j * 16, LDA, lane);
      fm::load_b(fb, kvd + j * 256, 16, lane);
      fm::mma16(acc, fa, fb);
      fm::tile_epilogue(acc, tm * 16, j * 16, lane, [&](int row, int col, float v) {
        rb[row * LDA + col] =
            __float2bfloat16(v * (n_f / (zs[row * kMaxHeads + col / D] + kEps)));
      });
    }
    __syncthreads();
    // m1 = bf16(o . wmerge)
    fm::gemm_rows64<kWarps, C, C / 16>(rb, LDA, io.wm, 0, warp, lane, [&](int r, int c, float v) {
      m1s[r * LDA + c] = __float2bfloat16(v);
    });
    fm::copy_rows_from_smem(io.o + row0 * C, C, rb, LDA, N, C);
    __syncthreads();
    ln_fwd_rows(m1s, io.n1s, io.n1b, mu1, rs1, rb, warp, lane);  // msg over o
    __syncthreads();
    fm::copy_rows_from_smem(io.msg + row0 * C, C, rb, LDA, N, C);
    // h = relu(x . w1[:C] + msg . w1[C:]) with its mask bits
    fm::gemm_rows64_split<kWarps, C, C, 2 * C / 16>(
        xs, LDA, rb, LDA, io.w1, 0, warp, lane, [&](int r, int c, float v) {
          hs[r * LD2 + c] = __float2bfloat16(fmaxf(v, 0.f));
          if (v > 0.f) atomicOr(&mask[r * MW + c / 32], 1u << (c % 32));
        });
    __syncthreads();
    fm::copy_rows_from_smem(io.h + row0 * 2 * C, 2 * C, hs, LD2, N, 2 * C);
    // y2 = bf16(h . w2) over msg
    fm::gemm_rows64<kWarps, 2 * C, C / 16>(hs, LD2, io.w2, 0, warp, lane,
                                           [&](int r, int c, float v) {
                                             rb[r * LDA + c] = __float2bfloat16(v);
                                           });
    __syncthreads();

    // ---- backward ----
    ln_stats_rows(rb, mu2, rs2, warp, lane);
    __syncthreads();
    ln_bwd_columns(rb, mu2, rs2, N, gval, acc_n2s, acc_n2b);
    __syncthreads();
    ln_bwd_rows(rb, mu2, rs2, io.n2s, N, gval, warp, lane);  // dy2 over y2
    __syncthreads();
    fm::copy_rows_from_smem(io.dy2 + row0 * C, C, rb, LDA, N, C);
    // dy1 = (dy2 . w2ᵀ) * (y1 > 0) over h
    fm::gemm_rows64<kWarps, C, 2 * C / 16>(rb, LDA, io.w2t, 0, warp, lane,
                                           [&](int r, int c, float v) {
                                             const bool on = (mask[r * MW + c / 32] >> (c % 32)) & 1u;
                                             hs[r * LD2 + c] = __float2bfloat16(on ? v : 0.f);
                                           });
    __syncthreads();
    fm::copy_rows_from_smem(io.dy1 + row0 * 2 * C, 2 * C, hs, LD2, N, 2 * C);
    // dmsg = dy1 . w1[C:]ᵀ (f32, over regions A and B)
    fm::gemm_rows64<kWarps, 2 * C, C / 16>(hs, LD2, io.w1mt, 0, warp, lane,
                                           [&](int r, int c, float v) { dmsg[fidx(r, c)] = v; });
    __syncthreads();
    auto dmsgv = [&](int r, int c) { return dmsg[fidx(r, c)]; };
    ln_bwd_columns(m1s, mu1, rs1, N, dmsgv, acc_n1s, acc_n1b);
    __syncthreads();
    ln_bwd_rows(m1s, mu1, rs1, io.n1s, N, dmsgv, warp, lane);  // dm1 over m1
    __syncthreads();
    fm::copy_rows_from_smem(io.dm1 + row0 * C, C, m1s, LDA, N, C);
    // per (16 rows, 16 columns): do = dm1 . wmergeᵀ beside the recomputed
    // A = Q . KV_bd; dA = do n into region A; head sums of dZ = -(do o) / (Z + eps)
    for (int u = warp; u < 16; u += kWarps) {
      const int tm = u / 4, j = u % 4;
      fm::Acc16 ad, ao;
      fm::zero(ad);
      fm::zero(ao);
#pragma unroll
      for (int k = 0; k < C / 16; ++k) {
        uint32_t fa[4], fb[4];
        fm::load_a(fa, m1s + tm * 16 * LDA + k * 16, LDA, lane);
        fm::load_b_packed(fb, fm::packed_tile(io.wmt, C, k, j), lane);
        fm::mma16(ad, fa, fb);
      }
      {
        uint32_t fa[4], fb[4];
        fm::load_a(fa, qs + tm * 16 * LDA + j * 16, LDA, lane);
        fm::load_b(fb, kvd + j * 256, 16, lane);
        fm::mma16(ao, fa, fb);
      }
      float dz[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [column half][row lane/4, lane/4 + 8]
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = tm * 16 + (lane >> 2) + 8 * ((q >> 1) & 1);
        const int col = j * 16 + 8 * (q >> 2) + 2 * (lane & 3) + (q & 1);
        const float zz = zs[row * kMaxHeads + col / D] + kEps;
        const float nf = n_f / zz;
        const float dov = ad.c[q];
        das[row * LDA + col] = __float2bfloat16(dov * nf);
        dz[q >> 2][(q >> 1) & 1] += fm::round_bf16(-(dov * (ao.c[q] * nf)) / zz);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          dz[a][b] += __shfl_xor_sync(0xffffffffu, dz[a][b], 1);
          dz[a][b] += __shfl_xor_sync(0xffffffffu, dz[a][b], 2);
        }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int row = tm * 16 + (lane >> 2) + 8 * b;
          if (D == 16) {
            dzh[row * kMaxHeads + j] = dz[0][b] + dz[1][b];
          } else {
            dzh[row * kMaxHeads + 2 * j] = dz[0][b];
            dzh[row * kMaxHeads + 2 * j + 1] = dz[1][b];
          }
        }
      }
    }
    __syncthreads();
    if (warp < 4) {  // dKV = Q^T dA on diagonal tile `warp`, masked, rounded
      fm::Acc16 acc;
      fm::zero(acc);
#pragma unroll
      for (int k = 0; k < T / 16; ++k) {
        uint32_t fa[4], fb[4];
        fm::load_a_trans(fa, qs + k * 16 * LDA + warp * 16, LDA, lane);
        fm::load_b(fb, das + k * 16 * LDA + warp * 16, LDA, lane);
        fm::mma16(acc, fa, fb);
      }
      fm::tile_epilogue(acc, 0, 0, lane, [&](int r, int c, float v) {
        const bool same = (warp * 16 + r) / D == (warp * 16 + c) / D;
        dkvd[warp * 256 + r * 16 + c] = __float2bfloat16(same ? v : 0.f);
      });
    } else if (threadIdx.x < 4 * 32 + C) {  // dK_sum[c] = sum_r Q[r, c] dZ_h[r]
      const int c = threadIdx.x - 4 * 32;
      float s = 0.f;
      for (int r = 0; r < N; ++r) s += bf(qs[r * LDA + c]) * dzh[r * kMaxHeads + c / D];
      dks[c] = fm::round_bf16(s);
    }
    __syncthreads();
    // dqf = (dA . KV_bdᵀ + dZ_h K_sum) elu'(x . wq) into region B
    for (int u = warp; u < 16; u += kWarps) {
      const int tm = u / 4, j = u % 4;
      uint32_t fa[4], fb[4];
      fm::Acc16 acc;
      fm::zero(acc);
      fm::load_a(fa, das + tm * 16 * LDA + j * 16, LDA, lane);
      load_b_t(fb, kvd + j * 256, 16, lane);
      fm::mma16(acc, fa, fb);
      fm::tile_epilogue(acc, tm * 16, j * 16, lane, [&](int row, int col, float v) {
        const float dq = v + dzh[row * kMaxHeads + col / D] * ksum[col];
        rb[row * LDA + col] = __float2bfloat16(dq * qfac[fidx(row, col)]);
      });
    }
    __syncthreads();
    fm::copy_rows_from_smem(io.dqf + row0 * C, C, rb, LDA, N, C);
    // dx = g + [dy1 | dqf] . [w1[:C]ᵀ ; wqᵀ]
    float* dxg = io.dx + row0 * C;
    fm::gemm_rows64_split<kWarps, 2 * C, C, C / 16>(
        hs, LD2, rb, LDA, io.wdxt, 0, warp, lane, [&](int r, int c, float v) {
          if (r < N) dxg[(size_t)r * C + c] = gval(r, c) + v;
        });
    // per (16 rows, 16 columns), over K | V in place: dv = K . dKV / N;
    // dkf = (V . dKVᵀ + dK_sum) elu'(src . wk)
    for (int u = warp; u < 16; u += kWarps) {
      const int tm = u / 4, j = u % 4;
      fm::Acc16 av, ak;
      fm::zero(av);
      fm::zero(ak);
      uint32_t fk[4], fv[4], fb[4], ft[4];
      fm::load_a(fk, kvs + tm * 16 * LD2 + j * 16, LD2, lane);
      fm::load_a(fv, kvs + tm * 16 * LD2 + C + j * 16, LD2, lane);
      fm::load_b(fb, dkvd + j * 256, 16, lane);
      load_b_t(ft, dkvd + j * 256, 16, lane);
      fm::mma16(av, fk, fb);
      fm::mma16(ak, fv, ft);
      __syncwarp();  // every lane has read the unit's K and V before any writes over them
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = tm * 16 + (lane >> 2) + 8 * ((q >> 1) & 1);
        const int col = j * 16 + 8 * (q >> 2) + 2 * (lane & 3) + (q & 1);
        float dkf = 0.f, dv = 0.f;
        if (row < N) {
          dkf = (ak.c[q] + dks[col]) * kfac[fidx(row, col)];
          dv = av.c[q] * inv_n;
        }
        kvs[row * LD2 + col] = __float2bfloat16(dkf);
        kvs[row * LD2 + C + col] = __float2bfloat16(dv);
      }
    }
    __syncthreads();
    fm::copy_rows_from_smem(io.dkv3 + row0 * 2 * C, 2 * C, kvs, LD2, N, 2 * C);
    // dsrc = [dkf | dv] . wkvᵀ; a self call adds it into dx (written above,
    // before the barrier)
    float* dsg = (io.self_call ? io.dx : io.dsrc) + row0 * C;
    fm::gemm_rows64<kWarps, 2 * C, C / 16>(kvs, LD2, io.wkvt, 0, warp, lane,
                                           [&](int r, int c, float v) {
                                             if (r >= N) return;
                                             float& d = dsg[(size_t)r * C + c];
                                             d = io.self_call ? d + v : v;
                                           });
    __syncthreads();  // the window's buffers are free for the next
  }
  if (threadIdx.x < C) {
    float* p = io.part_ln + (size_t)blockIdx.x * 4 * C + threadIdx.x;
    p[0] = acc_n1s;
    p[C] = acc_n1b;
    p[2 * C] = acc_n2s;
    p[3 * C] = acc_n2b;
  }
}

#define FM_CHECK(expr)                \
  do {                                \
    cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <int D>
cudaError_t launch_bwd(const Io& io, int blocks, cudaStream_t st) {
  FM_CHECK(cudaFuncSetAttribute(window_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmemBytes));
  window_bwd_kernel<D><<<blocks, kThreads, kSmemBytes, st>>>(io);
  return cudaGetLastError();
}

}  // namespace

FM_ERROR_STRING_ENTRY

// One encoder call's backward over G windows of N taps (C = 64, head dim D).
// in = {x [G, N, C], src [G, N, C] (bf16; the same pointer for a self call),
// g [G, N, C] (f32); wq, wkv, wmerge, n1s, n1b, w1, w2, n2s, n2b (fm_fine_stage's
// operands of one layer); w2t [C, 2C], w1mt [2C, C], wmt [C, C], wdxt [3C, C],
// wkvt [2C, C] (bf16, packed: w2ᵀ, w1[C:]ᵀ, wmergeᵀ, [w1[:C]ᵀ ; wqᵀ], wkvᵀ)}.
// out = {dx, dsrc [G, N, C] (f32; a self call writes dx + dsrc to dx and
// takes no dsrc, which may be null); dwq [C, C], dwkv [C, 2C], dwmerge [C, C],
// dln [4C] (dn1s | dn1b | dn2s | dn2b), dw1 [2C, 2C], dw2 [2C, C] (f32, [in,
// out]); scratch: stash bf16 [11 G N C], LN partials f32 [blocks][4C],
// weight-gradient partials f32 (ops/wgrad.partial_floats of the six
// products)}. blocks: the window stage's grid (at most G); sms: the card's
// SMs.
extern "C" int fm_fine_train_bwd(const void* const* in, void* const* out, int G, int N, int D,
                                 int blocks, int sms, void* stream) {
  if (G <= 0 || N < 1 || N > T || (D != 8 && D != 16) || blocks <= 0 || blocks > G ||
      sms <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto Bf = [](const void* q) { return static_cast<const bf16*>(q); };
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  const size_t TL = (size_t)G * N;
  Io io;
  io.x = Bf(in[0]);
  io.src = Bf(in[1]);
  io.g = F(in[2]);
  io.wq = Bf(in[3]);
  io.wkv = Bf(in[4]);
  io.wm = Bf(in[5]);
  io.n1s = F(in[6]);
  io.n1b = F(in[7]);
  io.w1 = Bf(in[8]);
  io.w2 = Bf(in[9]);
  io.n2s = F(in[10]);
  io.n2b = F(in[11]);
  io.w2t = Bf(in[12]);
  io.w1mt = Bf(in[13]);
  io.wmt = Bf(in[14]);
  io.wdxt = Bf(in[15]);
  io.wkvt = Bf(in[16]);
  io.dx = static_cast<float*>(out[0]);
  io.dsrc = static_cast<float*>(out[1]);
  bf16* stash = static_cast<bf16*>(out[8]);
  io.o = stash;
  io.msg = io.o + TL * C;
  io.dm1 = io.msg + TL * C;
  io.dqf = io.dm1 + TL * C;
  io.dy2 = io.dqf + TL * C;
  io.h = io.dy2 + TL * C;
  io.dy1 = io.h + TL * 2 * C;
  io.dkv3 = io.dy1 + TL * 2 * C;
  io.part_ln = static_cast<float*>(out[9]);
  io.G = G;
  io.N = N;
  io.self_call = in[0] == in[1];
  float* gemm = static_cast<float*>(out[10]);
  FM_CHECK(D == 8 ? launch_bwd<8>(io, blocks, st) : launch_bwd<16>(io, blocks, st));

  // out: dwq [C, C], dwkv [C, 2C], dwmerge [C, C], dln [4C], dw1 [2C, 2C], dw2 [2C, C]
  const int TLi = (int)TL;
  FM_CHECK(fm::sum_parts(io.part_ln, blocks, (size_t)4 * C, 4 * C, out[5], st));
  // the six weight gradients in one launch
  float* dw1 = static_cast<float*>(out[6]);
  const fm::WgradCall calls[] = {{io.x, C, io.dqf, C, TLi, C, C, out[2]},
                                 {io.src, C, io.dkv3, 2 * C, TLi, C, 2 * C, out[3]},
                                 {io.o, C, io.dm1, C, TLi, C, C, out[4]},
                                 {io.x, C, io.dy1, 2 * C, TLi, C, 2 * C, dw1},
                                 {io.msg, C, io.dy1, 2 * C, TLi, C, 2 * C,
                                  dw1 + (size_t)C * 2 * C},
                                 {io.h, 2 * C, io.dy2, C, TLi, 2 * C, C, out[7]}};
  return (int)fm::wgrad_group(calls, 6, sms, gemm, st);
}
