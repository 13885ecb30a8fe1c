// K9: the backward of one LoFTR linear-attention encoder call (the forward is
// K5's stats and apply kernels, coarse_transformer.cu, whose merged K^T V and
// K_sum the backward reads again).
//
// Replaces featurematching_tpu/ops/pallas_coarse_grad.py ·
// coarse_transformer_train (_apply_bwd_kernel through _apply_bwd,
// _stats_bwd_kernel through _stats_bwd).
//
// Bound on the H100 by tensor-core operations: twice the forward's products
// (about 40 C^2 multiply-adds x2 a query-and-source token pair) against about
// 8 C bytes a token of activations and gradients. The TPU kernels keep a
// query chunk's recomputed forward in VMEM and add each chunk's weight
// gradients into one output block across the sequential grid. On the H100
// blocks run in parallel and a block has 227 KB of shared memory, so:
//   1. apply_bwd: one block a 64-token query tile recomputes the forward tile
//      on chip from x, the saved K^T V and K_sum and the weights (in the
//      forward's bf16 rounding), then runs its backward: LN2, the FFN
//      (relu mask kept as bits), LN1, the merge, the per-head attention
//      gradients and the Q feature map, and writes dx. Shared memory holds
//      two [64, 2C] and two [64, C] bf16 buffers, reused phase by phase
//      (x | msg, then dy1; o, hidden chunks, y2, dy2, then the f32 dmsg,
//      then dopre | dqf; Q; m1, then dm1, then x again), 226 KB at C = 256.
//      The per-head products are formed by (head, 16-row) units that keep
//      both factors of an elementwise step in registers of one layout: the
//      merge gradient do beside the recomputed Q.KV, and the recomputed
//      x.wq beside dQ, so neither f32 [64, C] tile is stored.
//      It writes the bf16 operands of the weight products (o, msg, h, dy2,
//      dy1, dm1, dqf: the operands the TPU kernel feeds its bf16 products),
//      and per-tile partials of the LN gradients, each head's dK^T V [D, D]
//      and the head-summed dK_sum [C] (only K^T 1's row sums are ever read).
//   2. bwd_merge: the partials of each image added in a fixed order and
//      rounded to bf16, as the stats backward reads them.
//   3. stats_bwd: one block a 64-token source tile recomputes K and V, forms
//      [dkf | dv] over K | V in place (per (head, 16-row) unit, with the
//      recomputed src.wk for the feature map's derivative in registers) and
//      dsrc = [dkf | dv] . wkvᵀ.
//   4. the weight gradients dW = Aᵀ B over the tokens (wgrad.cuh, shared with
//      K8) and the LN gradients' fixed-order sums: no float atomics, so the
//      gradients repeat bit for bit.
// Only each head's diagonal [D, D] block of dK^T V is formed (the TPU kernel
// forms [C, C] and masks it). The weights' transposes (the B operands of
// the dY . Wᵀ products) come packed from the wrapper.

#include "tiles.cuh"
#include "wgrad.cuh"

namespace {

using fm::bf16;

constexpr int T = 64;  // token rows of a tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int HC = 128;  // FFN hidden columns per chunk
constexpr float kEps = 1e-6f;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// B fragment of the 16x16 tile whose B[k][n] is s[n * lds + k] (the
// transpose of a row-major tile in shared memory): plain ldmatrix
__device__ __forceinline__ void load_b_t(uint32_t* r, const bf16* s, int lds, int lane) {
  const int m = lane >> 3;
  fm::ldsm_x4(r, s + ((lane & 7) + (m >> 1) * 8) * lds + (m & 1) * 8);
}

// LayerNorm of 64 rows from src to dst as fm::warp_layer_norm computes it,
// keeping each row's mean and reciprocal deviation
template <int C>
__device__ __forceinline__ void ln_fwd_rows(const bf16* src, int lds, const float* s,
                                            const float* b, float* mu, float* rs, bf16* dst,
                                            int ldd, int warp, int lane) {
  constexpr int V = C / 32;
  for (int r = warp; r < T; r += kWarps) {
    float v[V];
    fm::load_bf16<V>(src + r * lds + lane * V, v);
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

// Column sums of an LN backward over the tile's valid rows, by the thread
// owning column c: sum dh * xhat and sum dh (xhat = (x - mu) rs)
template <int C, typename Dh>
__device__ __forceinline__ void ln_bwd_columns(const bf16* xin, int ldx, const float* mu,
                                               const float* rs, int valid, Dh dh,
                                               float* out_s, float* out_b) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float ss = 0.f, sb = 0.f;
    for (int r = 0; r < valid; ++r) {
      const float d = dh(r, c);
      ss += d * ((bf(xin[r * ldx + c]) - mu[r]) * rs[r]);
      sb += d;
    }
    out_s[c] = ss;
    out_b[c] = sb;
  }
}

// LN backward of the rows: dx = rs (dxhat - mean(dxhat) - xhat mean(dxhat
// xhat)), dxhat = dh * scale, rounded to bf16 into dst (rows past valid: 0)
template <int C, typename Dh>
__device__ __forceinline__ void ln_bwd_rows(const bf16* xin, int ldx, const float* mu,
                                            const float* rs, const float* scale, int valid, Dh dh,
                                            bf16* dst, int ldd, int warp, int lane) {
  constexpr int V = C / 32;
  for (int r = warp; r < T; r += kWarps) {
    float out[V];
    if (r < valid) {
      float xh[V], dxh[V];
      fm::load_bf16<V>(xin + r * ldx + lane * V, xh);
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
    fm::store_bf16<V>(dst + r * ldd + lane * V, out);
  }
}

template <int C, int D>
struct BwdSmem {
  static constexpr int H = C / D;
  static constexpr int LD2 = 2 * C + 8;  // [64, 2C] bf16 rows
  static constexpr int LD1 = C + 8;      // [64, C] bf16 rows
  static constexpr int LDF = C + 4;      // [64, C] f32 rows (over a [64, 2C] bf16 buffer)
  static constexpr int LDH = HC + 8;     // a hidden chunk
  static constexpr int LDKV = D + 8;     // each head's K^T V rows
  static constexpr int MW = 2 * C / 32;  // relu mask words a row
  static constexpr size_t a_off = 0;                          // x | msg, then dy1
  static constexpr size_t b_off = a_off + T * LD2 * 2;        // o, h, y2/dy2, dmsg, dopre | dqf
  static constexpr size_t q_off = b_off + T * LD2 * 2;        // Q
  static constexpr size_t m_off = q_off + T * LD1 * 2;        // m1, dm1, then x
  static constexpr size_t kv_off = m_off + T * LD1 * 2;       // K^T V, plain [H][D][LDKV]
  static constexpr size_t ks_off = kv_off + C * LDKV * 2;     // f32 K_sum [C]
  static constexpr size_t z_off = ks_off + C * 4;             // f32 Z [64][H]
  static constexpr size_t dz_off = z_off + T * H * 4;         // f32 head sums of dZ [64][H]
  static constexpr size_t st_off = dz_off + T * H * 4;        // f32 mu1, rs1, mu2, rs2 [64]
  static constexpr size_t mask_off = st_off + 4 * T * 4;      // relu(y1) > 0 bits
  static constexpr size_t bytes = mask_off + T * MW * 4;
  static_assert(T * LDF * 4 <= T * LD2 * 2, "f32 dmsg must fit a [64, 2C] bf16 buffer");
  static_assert(LDH <= LD1, "a hidden chunk must fit a [64, C] row");
  static_assert(bytes <= kMaxSmem, "apply_bwd shared memory");
};

struct BwdIO {
  const bf16 *x, *kv, *ks, *g;
  const bf16 *wq, *wmerge, *w1, *w2;  // forward operands, packed [in, out]
  const float *n1s, *n1b, *n2s, *n2b;
  const bf16 *w2t, *w1mt, *wmt, *wdxt;  // packed transposes
  bf16* dx;
  bf16 *o, *msg, *h, *dy2, *dy1, *dm1, *dqf;  // stash [G L][width]
  float *part_ln, *part_kv, *part_ks;         // per-tile partials
};

// grid (ceil(L / 64), G): block (b, g) takes query rows [64 b, 64 b + 64) of image g
template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1) apply_bwd_kernel(BwdIO io, int L, int S) {
  using Sm = BwdSmem<C, D>;
  constexpr int H = Sm::H, DT = D / 16, LD2 = Sm::LD2, LD1 = Sm::LD1, LDF = Sm::LDF;
  constexpr int LDH = Sm::LDH, LDKV = Sm::LDKV, MW = Sm::MW;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xa = reinterpret_cast<bf16*>(smem + Sm::a_off);
  bf16* rb = reinterpret_cast<bf16*>(smem + Sm::b_off);
  float* rbf = reinterpret_cast<float*>(smem + Sm::b_off);
  bf16* qs = reinterpret_cast<bf16*>(smem + Sm::q_off);
  bf16* ms = reinterpret_cast<bf16*>(smem + Sm::m_off);
  bf16* kvp = reinterpret_cast<bf16*>(smem + Sm::kv_off);
  float* kss = reinterpret_cast<float*>(smem + Sm::ks_off);
  float* zs = reinterpret_cast<float*>(smem + Sm::z_off);
  float* dzs = reinterpret_cast<float*>(smem + Sm::dz_off);
  float* mu1 = reinterpret_cast<float*>(smem + Sm::st_off);
  float* rs1 = mu1 + T;
  float* mu2 = rs1 + T;
  float* rs2 = mu2 + T;
  unsigned* mask = reinterpret_cast<unsigned*>(smem + Sm::mask_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.y, r0 = blockIdx.x * T, valid = min(T, L - r0);
  const size_t row0 = (size_t)g * L + r0;  // first token of the tile
  const size_t tile = (size_t)g * gridDim.x + blockIdx.x;
  const bf16* gg = io.g + row0 * C;
  const float s_f = (float)S;

  // ---- forward recompute, as coarse_transformer.cu's apply_kernel ----
  fm::copy_rows_to_smem(xa, LD2, io.x + row0 * C, C, T, C, valid);
  for (int c = threadIdx.x; c < C; c += kThreads) kss[c] = bf(io.ks[(size_t)g * C + c]);
  {  // K^T V from fragment order (the merge's layout) to plain rows
    const bf16* kvg = io.kv + (size_t)g * C * D;
    for (int e = threadIdx.x; e < C * D; e += kThreads) {
      const int e8 = e & 7, ln = (e >> 3) & 31, tl = e >> 8;
      const int h = tl / (DT * DT), nt = (tl / DT) % DT, kt = tl % DT;
      const int k = kt * 16 + 2 * (ln & 3) + (e8 & 1) + 8 * ((e8 >> 1) & 1);
      const int n = nt * 16 + (ln >> 2) + 8 * (e8 >> 2);
      kvp[(h * D + k) * LDKV + n] = kvg[e];
    }
  }
  for (int i = threadIdx.x; i < T * MW; i += kThreads) mask[i] = 0u;
  __syncthreads();
  // Q = elu(x . wq) + 1
  fm::gemm_rows64<kWarps, C, C / 16>(xa, LD2, io.wq, 0, warp, lane, [&](int r, int c, float v) {
    qs[r * LD1 + c] = __float2bfloat16(fm::elu1(v));
  });
  __syncthreads();
  for (int e = threadIdx.x; e < T * H; e += kThreads) {
    const int r = e / H, h = e % H;
    float z = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) z += __bfloat162float(qs[r * LD1 + h * D + d]) * kss[h * D + d];
    zs[e] = z;
  }
  __syncthreads();
  // o = Q_h . KV_h * (S / (Z + eps)) into rb
  for (int u = warp; u < H * (T / 16); u += kWarps) {
    const int h = u / (T / 16), tm = u % (T / 16);
    fm::Acc16 acc[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) fm::zero(acc[j]);
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      uint32_t fa[4];
      fm::load_a(fa, qs + tm * 16 * LD1 + h * D + k * 16, LD1, lane);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t fb[4];
        fm::load_b(fb, kvp + (h * D + k * 16) * LDKV + j * 16, LDKV, lane);
        fm::mma16(acc[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j)
      fm::tile_epilogue(acc[j], tm * 16, h * D + j * 16, lane, [&](int row, int col, float v) {
        rb[row * LD1 + col] = __float2bfloat16(v * (s_f / (zs[row * H + h] + kEps)));
      });
  }
  __syncthreads();
  // m1 = bf16(o . wmerge) into ms
  fm::gemm_rows64<kWarps, C, C / 16>(rb, LD1, io.wmerge, 0, warp, lane,
                                     [&](int r, int c, float v) {
                                       ms[r * LD1 + c] = __float2bfloat16(v);
                                     });
  fm::copy_rows_from_smem(io.o + row0 * C, C, rb, LD1, valid, C);
  __syncthreads();
  // msg = LN1(m1), beside x
  ln_fwd_rows<C>(ms, LD1, io.n1s, io.n1b, mu1, rs1, xa + C, LD2, warp, lane);
  __syncthreads();
  fm::copy_rows_from_smem(io.msg + row0 * C, C, xa + C, LD2, valid, C);
  // FFN: relu([x | msg] . w1) in chunks of HC hidden columns (in rb, stashed),
  // the y2 products in registers as the forward keeps them
  constexpr int S2 = C / 16, RT2 = fm::rows_per_unit(S2, kWarps), G2 = 4 / RT2;
  constexpr int UPW = S2 * G2 / kWarps;
  static_assert(S2 * G2 % kWarps == 0, "wmlp2 units must spread evenly over the warps");
  {
    fm::Acc16 acc2[UPW][RT2];
#pragma unroll
    for (int j = 0; j < UPW; ++j)
#pragma unroll
      for (int i = 0; i < RT2; ++i) fm::zero(acc2[j][i]);
    for (int c0 = 0; c0 < 2 * C; c0 += HC) {
      fm::gemm_rows64<kWarps, 2 * C, HC / 16>(xa, LD2, io.w1, c0 / 16, warp, lane,
                                              [&](int r, int c, float v) {
                                                rb[r * LDH + c] = __float2bfloat16(fmaxf(v, 0.f));
                                                if (v > 0.f)
                                                  atomicOr(&mask[r * MW + (c0 + c) / 32],
                                                           1u << ((c0 + c) % 32));
                                              });
      __syncthreads();
      fm::copy_rows_from_smem(io.h + row0 * 2 * C + c0, 2 * C, rb, LDH, valid, HC);
#pragma unroll
      for (int j = 0; j < UPW; ++j) {
        const int u = warp + j * kWarps, tn = u / G2, tm0 = (u % G2) * RT2;
        fm::strip_mma<HC, RT2>(acc2[j], rb + tm0 * 16 * LDH, LDH, io.w2, 2 * C, c0 / 16, tn,
                               lane);
      }
      __syncthreads();
    }
    // y2 = bf16(hidden . w2) into rb
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = warp + j * kWarps, tn = u / G2, tm0 = (u % G2) * RT2;
#pragma unroll
      for (int i = 0; i < RT2; ++i)
        fm::tile_epilogue(acc2[j][i], (tm0 + i) * 16, tn * 16, lane, [&](int r, int c, float v) {
          rb[r * LD1 + c] = __float2bfloat16(v);
        });
    }
  }
  __syncthreads();

  // ---- backward ----
  float* pln = io.part_ln + tile * 4 * C;  // dn1s | dn1b | dn2s | dn2b
  constexpr int V = C / 32;
  for (int r = warp; r < T; r += kWarps) {  // LN2 statistics of y2
    float v[V];
    fm::load_bf16<V>(rb + r * LD1 + lane * V, v);
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) t += v[i];
    const float m = fm::warp_sum(t) * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) q += (v[i] - m) * (v[i] - m);
    const float rr = rsqrtf(fm::warp_sum(q) * (1.0f / C) + fm::kLnEps);
    if (lane == 0) {
      mu2[r] = m;
      rs2[r] = rr;
    }
  }
  __syncthreads();
  auto gval = [&](int r, int c) { return bf(gg[(size_t)r * C + c]); };
  ln_bwd_columns<C>(rb, LD1, mu2, rs2, valid, gval, pln + 2 * C, pln + 3 * C);
  __syncthreads();
  ln_bwd_rows<C>(rb, LD1, mu2, rs2, io.n2s, valid, gval, rb, LD1, warp, lane);  // dy2 over y2
  __syncthreads();
  fm::copy_rows_from_smem(io.dy2 + row0 * C, C, rb, LD1, valid, C);
  // dy1 = (dy2 . w2ᵀ) * (y1 > 0) over x | msg
  fm::gemm_rows64<kWarps, C, 2 * C / 16>(rb, LD1, io.w2t, 0, warp, lane,
                                         [&](int r, int c, float v) {
                                           const bool on = (mask[r * MW + c / 32] >> (c % 32)) & 1u;
                                           xa[r * LD2 + c] = __float2bfloat16(on ? v : 0.f);
                                         });
  __syncthreads();
  fm::copy_rows_from_smem(io.dy1 + row0 * 2 * C, 2 * C, xa, LD2, valid, 2 * C);
  // dmsg = dy1 . w1[C:]ᵀ (f32, over rb)
  fm::gemm_rows64<kWarps, 2 * C, C / 16>(xa, LD2, io.w1mt, 0, warp, lane,
                                         [&](int r, int c, float v) { rbf[r * LDF + c] = v; });
  __syncthreads();
  auto dmsg = [&](int r, int c) { return rbf[r * LDF + c]; };
  ln_bwd_columns<C>(ms, LD1, mu1, rs1, valid, dmsg, pln, pln + C);
  __syncthreads();
  ln_bwd_rows<C>(ms, LD1, mu1, rs1, io.n1s, valid, dmsg, ms, LD1, warp, lane);  // dm1 over m1
  __syncthreads();
  fm::copy_rows_from_smem(io.dm1 + row0 * C, C, ms, LD1, valid, C);
  // per (head, 16 rows): do = dm1 . wmergeᵀ beside the recomputed Q_h . KV_h;
  // dopre = do n into rb[:, :C]; the head sums of dZ = -(do o) / (Z + eps)
  for (int u = warp; u < H * (T / 16); u += kWarps) {
    const int h = u / (T / 16), tm = u % (T / 16);
    fm::Acc16 ad[DT], ao[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      fm::zero(ad[j]);
      fm::zero(ao[j]);
    }
    for (int k = 0; k < C / 16; ++k) {
      uint32_t fa[4];
      fm::load_a(fa, ms + tm * 16 * LD1 + k * 16, LD1, lane);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t fb[4];
        fm::load_b_packed(fb, fm::packed_tile(io.wmt, C, k, h * DT + j), lane);
        fm::mma16(ad[j], fa, fb);
      }
    }
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      uint32_t fa[4];
      fm::load_a(fa, qs + tm * 16 * LD1 + h * D + k * 16, LD1, lane);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t fb[4];
        fm::load_b(fb, kvp + (h * D + k * 16) * LDKV + j * 16, LDKV, lane);
        fm::mma16(ao[j], fa, fb);
      }
    }
    float dz_lo = 0.f, dz_hi = 0.f;  // rows lane / 4 and lane / 4 + 8 of the unit
#pragma unroll
    for (int j = 0; j < DT; ++j) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = tm * 16 + (lane >> 2) + 8 * ((q >> 1) & 1);
        const int col = h * D + j * 16 + 8 * (q >> 2) + 2 * (lane & 3) + (q & 1);
        const float zz = zs[row * H + h] + kEps;
        const float nf = s_f / zz;
        const float dov = ad[j].c[q];
        rb[row * LD2 + col] = __float2bfloat16(dov * nf);
        const float dz = fm::round_bf16(-(dov * (ao[j].c[q] * nf)) / zz);
        if ((q >> 1) & 1)
          dz_hi += dz;
        else
          dz_lo += dz;
      }
    }
    dz_lo += __shfl_xor_sync(0xffffffffu, dz_lo, 1);
    dz_lo += __shfl_xor_sync(0xffffffffu, dz_lo, 2);
    dz_hi += __shfl_xor_sync(0xffffffffu, dz_hi, 1);
    dz_hi += __shfl_xor_sync(0xffffffffu, dz_hi, 2);
    if ((lane & 3) == 0) {
      dzs[(tm * 16 + (lane >> 2)) * H + h] = dz_lo;
      dzs[(tm * 16 + (lane >> 2) + 8) * H + h] = dz_hi;
    }
  }
  __syncthreads();
  // partials: dKV_h = Q_hᵀ dopre_h [D, D] per head; dks[c] = sum_r Q[r, c] dzs[r, head(c)]
  {
    constexpr int UNITS = H * DT * DT, UPW2 = (UNITS + kWarps - 1) / kWarps;
    float* pk = io.part_kv + tile * C * D;
#pragma unroll
    for (int jw = 0; jw < UPW2; ++jw) {
      const int u = warp + jw * kWarps;
      if (u < UNITS) {
        const int h = u / (DT * DT), i = (u / DT) % DT, jj = u % DT;
        fm::Acc16 acc;
        fm::zero(acc);
#pragma unroll
        for (int k = 0; k < T / 16; ++k) {
          uint32_t fa[4], fb[4];
          fm::load_a_trans(fa, qs + k * 16 * LD1 + h * D + i * 16, LD1, lane);
          fm::load_b(fb, rb + k * 16 * LD2 + h * D + jj * 16, LD2, lane);
          fm::mma16(acc, fa, fb);
        }
        fm::tile_epilogue(acc, i * 16, jj * 16, lane,
                          [&](int r, int c, float v) { pk[h * D * D + r * D + c] = v; });
      }
    }
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < valid; ++r) s += bf(qs[r * LD1 + c]) * dzs[r * H + c / D];
      io.part_ks[tile * C + c] = s;
    }
  }
  fm::copy_rows_to_smem(ms, LD1, io.x + row0 * C, C, T, C, valid);  // x again, over dm1
  __syncthreads();
  // per (head, 16 rows): dQ = dopre_h . KV_hᵀ + dzs K_sum beside the
  // recomputed qf = x . wq; dqf = dQ elu'(qf) into rb[:, C:]
  for (int u = warp; u < H * (T / 16); u += kWarps) {
    const int h = u / (T / 16), tm = u % (T / 16);
    fm::Acc16 aq[DT], adq[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      fm::zero(aq[j]);
      fm::zero(adq[j]);
    }
    for (int k = 0; k < C / 16; ++k) {
      uint32_t fa[4];
      fm::load_a(fa, ms + tm * 16 * LD1 + k * 16, LD1, lane);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t fb[4];
        fm::load_b_packed(fb, fm::packed_tile(io.wq, C, k, h * DT + j), lane);
        fm::mma16(aq[j], fa, fb);
      }
    }
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      uint32_t fa[4];
      fm::load_a(fa, rb + tm * 16 * LD2 + h * D + k * 16, LD2, lane);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t fb[4];
        load_b_t(fb, kvp + (h * D + j * 16) * LDKV + k * 16, LDKV, lane);
        fm::mma16(adq[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = tm * 16 + (lane >> 2) + 8 * ((q >> 1) & 1);
        const int col = h * D + j * 16 + 8 * (q >> 2) + 2 * (lane & 3) + (q & 1);
        const float qf = aq[j].c[q];
        const float dq = adq[j].c[q] + dzs[row * H + h] * kss[col];
        rb[row * LD2 + C + col] = __float2bfloat16(dq * (qf > 0.f ? 1.0f : expf(qf)));
      }
    }
  }
  __syncthreads();
  fm::copy_rows_from_smem(io.dqf + row0 * C, C, rb + C, LD2, valid, C);
  // dx = g + [dy1 | dqf] . [w1[:C]ᵀ ; wqᵀ]
  bf16* dxg = io.dx + row0 * C;
  fm::gemm_rows64_split<kWarps, 2 * C, C, C / 16>(
      xa, LD2, rb + C, LD2, io.wdxt, 0, warp, lane, [&](int r, int c, float v) {
        if (r < valid) dxg[(size_t)r * C + c] = __float2bfloat16(gval(r, c) + v);
      });
}

// dkv[g] = bf16(sum over the image's tiles of part_kv), plain [H][D][D];
// dks[g] likewise; tiles added in order
__global__ void bwd_merge_kernel(const float* __restrict__ part_kv,
                                 const float* __restrict__ part_ks, bf16* __restrict__ dkv,
                                 bf16* __restrict__ dks, int tiles, int C, int D) {
  const int g = blockIdx.y, CD = C * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < CD) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += part_kv[((size_t)g * tiles + t) * CD + e];
    dkv[(size_t)g * CD + e] = __float2bfloat16(s);
  } else if (e < CD + C) {
    const int i = e - CD;
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += part_ks[((size_t)g * tiles + t) * C + i];
    dks[(size_t)g * C + i] = __float2bfloat16(s);
  }
}

template <int C, int D>
struct StatsSmem {
  static constexpr int LD1 = C + 8, LD2 = 2 * C + 8, LDKV = D + 8;
  static constexpr size_t s_off = 0;                       // src
  static constexpr size_t kv_off = s_off + T * LD1 * 2;    // K | V, then dkf | dv
  static constexpr size_t d_off = kv_off + T * LD2 * 2;    // dK^T V, plain [H][D][LDKV]
  static constexpr size_t ks_off = d_off + C * LDKV * 2;   // f32 dK_sum [C]
  static constexpr size_t bytes = ks_off + C * 4;
  static_assert(bytes <= kMaxSmem, "stats_bwd shared memory");
};

// grid (ceil(S / 64), G): block (b, g) takes source rows [64 b, 64 b + 64) of image g
template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1)
stats_bwd_kernel(const bf16* __restrict__ src, const bf16* __restrict__ dkv,
                 const bf16* __restrict__ dks, const bf16* __restrict__ wkv,
                 const bf16* __restrict__ wkvt, bf16* __restrict__ dkv3, bf16* __restrict__ dsrc,
                 int S) {
  using Sm = StatsSmem<C, D>;
  constexpr int H = C / D, DT = D / 16, LD1 = Sm::LD1, LD2 = Sm::LD2, LDKV = Sm::LDKV;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ss = reinterpret_cast<bf16*>(smem + Sm::s_off);
  bf16* kvs = reinterpret_cast<bf16*>(smem + Sm::kv_off);
  bf16* dkvp = reinterpret_cast<bf16*>(smem + Sm::d_off);
  float* dkss = reinterpret_cast<float*>(smem + Sm::ks_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.y, r0 = blockIdx.x * T, valid = min(T, S - r0);
  const size_t row0 = (size_t)g * S + r0;
  const float inv_s = 1.0f / (float)S;

  fm::copy_rows_to_smem(ss, LD1, src + row0 * C, C, T, C, valid);
  const bf16* dg = dkv + (size_t)g * C * D;
  for (int e = threadIdx.x; e < C * D / 8; e += kThreads) {
    const int row = e / (D / 8), c = (e % (D / 8)) * 8;  // row = h * D + d
    *reinterpret_cast<uint4*>(dkvp + row * LDKV + c) =
        *reinterpret_cast<const uint4*>(dg + (size_t)row * D + c);
  }
  for (int c = threadIdx.x; c < C; c += kThreads) dkss[c] = bf(dks[(size_t)g * C + c]);
  __syncthreads();
  // [K | V] = elu(src . wk) + 1 | src . wv / S, as the forward's stats kernel
  fm::gemm_rows64<kWarps, C, 2 * C / 16>(ss, LD1, wkv, 0, warp, lane,
                                         [&](int r, int c, float v) {
                                           float o = 0.f;
                                           if (r < valid) o = c < C ? fm::elu1(v) : v * inv_s;
                                           kvs[r * LD2 + c] = __float2bfloat16(o);
                                         });
  __syncthreads();
  // per (head, 16 rows), over K_h | V_h in place: dv = K_h . dKV_h / S;
  // dkf = (V_h . dKV_hᵀ + dK_sum) elu'(kf) with kf = src . wk recomputed
  for (int u = warp; u < H * (T / 16); u += kWarps) {
    const int h = u / (T / 16), tm = u % (T / 16);
    fm::Acc16 af[DT], av[DT], ak[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      fm::zero(af[j]);
      fm::zero(av[j]);
      fm::zero(ak[j]);
    }
    for (int k = 0; k < C / 16; ++k) {
      uint32_t fa[4];
      fm::load_a(fa, ss + tm * 16 * LD1 + k * 16, LD1, lane);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t fb[4];
        fm::load_b_packed(fb, fm::packed_tile(wkv, C, k, h * DT + j), lane);
        fm::mma16(af[j], fa, fb);
      }
    }
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      uint32_t fk[4], fv[4];
      fm::load_a(fk, kvs + tm * 16 * LD2 + h * D + k * 16, LD2, lane);
      fm::load_a(fv, kvs + tm * 16 * LD2 + C + h * D + k * 16, LD2, lane);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t fb[4], ft[4];
        fm::load_b(fb, dkvp + (h * D + k * 16) * LDKV + j * 16, LDKV, lane);
        fm::mma16(av[j], fk, fb);
        load_b_t(ft, dkvp + (h * D + j * 16) * LDKV + k * 16, LDKV, lane);
        fm::mma16(ak[j], fv, ft);
      }
    }
    __syncwarp();  // every lane has read the unit's K and V before any writes over them
#pragma unroll
    for (int j = 0; j < DT; ++j) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = tm * 16 + (lane >> 2) + 8 * ((q >> 1) & 1);
        const int col = h * D + j * 16 + 8 * (q >> 2) + 2 * (lane & 3) + (q & 1);
        const float kf = af[j].c[q];
        float dkf = 0.f, dv = 0.f;
        if (row < valid) {
          dkf = (ak[j].c[q] + dkss[col]) * (kf > 0.f ? 1.0f : expf(kf));
          dv = av[j].c[q] * inv_s;
        }
        kvs[row * LD2 + col] = __float2bfloat16(dkf);
        kvs[row * LD2 + C + col] = __float2bfloat16(dv);
      }
    }
  }
  __syncthreads();
  fm::copy_rows_from_smem(dkv3 + row0 * 2 * C, 2 * C, kvs, LD2, valid, 2 * C);
  // dsrc = [dkf | dv] . wkvᵀ
  bf16* dsg = dsrc + row0 * C;
  fm::gemm_rows64<kWarps, 2 * C, C / 16>(
      kvs, LD2, wkvt, 0, warp, lane, [&](int r, int c, float v) {
        if (r < valid) dsg[(size_t)r * C + c] = __float2bfloat16(v);
      });
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

#define FM_CHECK(expr)                  \
  do {                                  \
    cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

template <int C, int D>
cudaError_t launch_bwd(const void* const* in, void* const* out, int G, int L, int S, int splits,
                       cudaStream_t st) {
  auto Bf = [](const void* q) { return static_cast<const bf16*>(q); };
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  const size_t TL = (size_t)G * L, TS = (size_t)G * S;
  bf16* stash = static_cast<bf16*>(out[8]);
  BwdIO io;
  io.x = Bf(in[0]);
  io.kv = Bf(in[2]);
  io.ks = Bf(in[3]);
  io.g = Bf(in[4]);
  io.wq = Bf(in[5]);
  io.wmerge = Bf(in[7]);
  io.n1s = F(in[8]);
  io.n1b = F(in[9]);
  io.w1 = Bf(in[10]);
  io.w2 = Bf(in[11]);
  io.n2s = F(in[12]);
  io.n2b = F(in[13]);
  io.w2t = Bf(in[14]);
  io.w1mt = Bf(in[15]);
  io.wmt = Bf(in[16]);
  io.wdxt = Bf(in[17]);
  io.dx = static_cast<bf16*>(out[0]);
  io.o = stash;
  io.msg = io.o + TL * C;
  io.h = io.msg + TL * C;
  io.dy2 = io.h + TL * 2 * C;
  io.dy1 = io.dy2 + TL * C;
  io.dm1 = io.dy1 + TL * 2 * C;
  io.dqf = io.dm1 + TL * C;
  bf16* dkv3 = io.dqf + TL * C;
  io.part_ln = static_cast<float*>(out[9]);
  io.part_kv = static_cast<float*>(out[10]);
  io.part_ks = static_cast<float*>(out[11]);
  bf16* dkv = static_cast<bf16*>(out[12]);
  bf16* dks = static_cast<bf16*>(out[13]);
  float* gemm = static_cast<float*>(out[14]);
  const int tiles_l = (L + T - 1) / T, tiles_s = (S + T - 1) / T;

  FM_CHECK(set_smem(apply_bwd_kernel<C, D>, BwdSmem<C, D>::bytes));
  apply_bwd_kernel<C, D><<<dim3(tiles_l, G), kThreads, BwdSmem<C, D>::bytes, st>>>(io, L, S);
  FM_CHECK(cudaGetLastError());
  const int n = C * D + C;
  bwd_merge_kernel<<<dim3((n + 255) / 256, G), 256, 0, st>>>(io.part_kv, io.part_ks, dkv, dks,
                                                             tiles_l, C, D);
  FM_CHECK(cudaGetLastError());
  FM_CHECK(set_smem(stats_bwd_kernel<C, D>, StatsSmem<C, D>::bytes));
  stats_bwd_kernel<C, D><<<dim3(tiles_s, G), kThreads, StatsSmem<C, D>::bytes, st>>>(
      Bf(in[1]), dkv, dks, Bf(in[6]), Bf(in[18]), dkv3, static_cast<bf16*>(out[1]), S);
  FM_CHECK(cudaGetLastError());

  // out: dwq [C, C], dwkv [C, 2C], dwmerge [C, C], dln [4C], dw1 [2C, 2C], dw2 [2C, C]
  const int TLi = (int)TL, TSi = (int)TS;
  FM_CHECK(fm::sum_parts(io.part_ln, G * tiles_l, (size_t)4 * C, 4 * C, out[5], st));
  FM_CHECK(fm::wgrad(io.x, C, io.dqf, C, TLi, splits, C, C, gemm, out[2], st));
  FM_CHECK(fm::wgrad(io.o, C, io.dm1, C, TLi, splits, C, C, gemm, out[4], st));
  float* dw1 = static_cast<float*>(out[6]);
  FM_CHECK(fm::wgrad(io.x, C, io.dy1, 2 * C, TLi, splits, C, 2 * C, gemm, dw1, st));
  FM_CHECK(fm::wgrad(io.msg, C, io.dy1, 2 * C, TLi, splits, C, 2 * C, gemm,
                     dw1 + (size_t)C * 2 * C, st));
  FM_CHECK(fm::wgrad(io.h, 2 * C, io.dy2, C, TLi, splits, 2 * C, C, gemm, out[7], st));
  return fm::wgrad(Bf(in[1]), C, dkv3, 2 * C, TSi, splits, C, 2 * C, gemm, out[3], st);
}

}  // namespace

FM_ERROR_STRING_ENTRY

// One encoder call's backward, L query tokens x attending S source tokens
// of G images.
// in = {x [G, L, C], src [G, S, C], kv [G, C*D] (fm_coarse_stats' fragment
// order), ks [G, C], g [G, L, C] (all bf16); wq, wkv, wmerge, n1s, n1b, w1,
// w2, n2s, n2b (fm_coarse_apply's operands); w2t [C, 2C], w1mt [2C, C], wmt
// [C, C], wdxt [3C, C], wkvt [2C, C] (bf16, packed: w2ᵀ, w1[C:]ᵀ, wmergeᵀ,
// [w1[:C]ᵀ ; wqᵀ], wkvᵀ)}.
// out = {dx [G, L, C], dsrc [G, S, C] (bf16); dwq [C, C], dwkv [C, 2C], dwmerge
// [C, C], dln [4C] (dn1s | dn1b | dn2s | dn2b), dw1 [2C, 2C], dw2 [2C, C]
// (f32, [in, out]); scratch: stash bf16 [(9 G L + 2 G S) C], LN partials f32
// [G ceil(L/64)][4C], dK^T V partials f32 [G ceil(L/64)][C*D], dK_sum
// partials f32 [G ceil(L/64)][C], dkv bf16 [G][C*D], dks bf16 [G][C],
// weight-gradient partials f32 [splits][2 C^2]}.
extern "C" int fm_coarse_train_bwd(const void* const* in, void* const* out, int G, int L, int S,
                                   int C, int D, int splits, void* stream) {
  if (G <= 0 || L <= 0 || S <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FM_BWD(c, d) \
  if (C == c && D == d) return (int)launch_bwd<c, d>(in, out, G, L, S, splits, st);
  FM_BWD(128, 16) FM_BWD(128, 32) FM_BWD(256, 16) FM_BWD(256, 32)
#undef FM_BWD
  return (int)cudaErrorInvalidValue;
}
