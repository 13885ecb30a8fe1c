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
//   1. mlp_bwd: per window (a persistent grid of the blocks the card holds
//      walks the windows) LN2 is recomputed from x1, the hidden width is
//      streamed in slices of 64 columns of W1 and W2 by tensor copies into
//      shared memory (y1 = h2 W1 + b1, gelu, dge = dm W2ᵀ, dy1, dh2 += dy1
//      W1ᵀ on wgmma, two warpgroups on alternate slices), and the LN2
//      backward gives dx1 = g + ... (f32, to device memory) (section 1 says
//      how);
//   2. attn_bwd: per window LN1 and qkv are recomputed, o = P v from the
//      saved P, do = dx1 s1, da = do Wprojᵀ, then two heads at a time (head
//      dim 16; one at head dim 64) dP, dS = P (dP - rowsum(dP P)), dq, dk,
//      dv on register-resident units,
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

#include <type_traits>

#include "swin_block.cuh"
#include "tiles.cuh"
#include "wgmma.cuh"
#include "wgrad.cuh"

namespace {

using fm::Acc16;
using fm::bf16;
using swin::N;
constexpr int kWarps = 8;  // the backward's blocks
constexpr int kThreads = 32 * kWarps;
using fm::sum_parts;

constexpr int LDP = N + 8;     // bf16 [64][64] tile row stride
constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// 1. the MLP branch
// ---------------------------------------------------------------------------
//
// Bound on the H100 by bytes: 28 C bytes a token (x1, g, f32 dx1 and the
// stash's h2, dm, dy1, gelu(y1)) against 16 C^2 operations of dge and dh2
// (kernel_bounds.swin_block_train_mlp_bwd_work). A block of two warpgroups
// takes one window (64 rows, one wgmma tile) at a time; a persistent grid
// of the blocks the card holds at once walks the windows in turn
// (ops/swin_block_train.mlp_grid). Per window:
//   - prologue (8 warps of 8 rows, each lane V = C / 32 columns): LN2 of x1
//     gives h2; dm = bf16(g s2); h2, dm and g itself go into three [64, C]
//     bf16 tiles in shared memory in the 128-byte swizzle (h2 and dm are
//     wgmma's K-major A operands, g is read back by the LN2 backward, so g
//     leaves device memory once), h2 and dm also to the stash, a whole row
//     piece a lane (16 bytes at C = 256);
//   - the hidden width in slices of HS = 64 columns: slice s's W1 columns
//     [C, 64] and W2 rows [64, C] come by tensor copies into a slot of a
//     ring in shared memory, and warpgroup s % 2 takes it: y1 = h2 W1s (W1s
//     read MN-major, y1 starting at b1) and dge = dm W2sᵀ on m64n64k16 from
//     shared memory; GELU and its derivative in registers; ge and dy1
//     (bf16) to the stash; db1's column sums of the f32 dy1 by shuffles
//     over the warp's rows; then dh2 += dy1 W1sᵀ, dy1 as register A fragments (the
//     accumulator's layout) and the same W1s read K-major, so W1 leaves L2
//     once a window. dh2 [64, C] f32 stays in each warpgroup's registers
//     across its slices (C / 2 a thread);
//   - the two warpgroups' dh2 added in shared memory (over h2 and dm, in a
//     fixed order), then the LN2 backward, rows as in the prologue: dx1 = g
//     + rs (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) in f32.
// The ring: slot q % SLOTS holds the block's q-th slice (its windows in
// order, NS slices each). SLOTS and NS are even, so a slot serves one
// warpgroup, whose last warp to hand it back refills it (predicated, no
// producer warp). At C = 64 the four slices are the whole of W1 and W2
// (64 KB): they are copied once and stay for the block's life.
// Column sums, each in a fixed order, no atomics: db1 by shuffles over a
// warp's 16 rows into the block's per-warp partial rows in device memory
// (one owner an entry), added over the warps at the block's end; db2 and
// LN2's dscale and dbias in each lane's registers over its warp's 8 rows,
// then over the 8 warps through shared memory into the block's partial row.

constexpr int HS = 64;  // hidden columns a slice

template <int C>
struct MlpLayout {
  static constexpr int NS = 4 * C / HS;          // slices a window
  static constexpr int SLICE = 256 * C;          // bytes: W1's [C][64] box, W2's C / 64 [64][64]
  static constexpr int W2_OFF = 128 * C;
  static constexpr int SLOTS = C == 256 ? 2 : 4;
  static constexpr bool RESIDENT = SLOTS == NS;  // C = 64: W1 and W2 whole, copied once
  static constexpr int TILE = 128 * C;           // a [64, C] bf16 tile: C / 64 boxes of [64][64]
  static constexpr size_t h_off = (size_t)SLOTS * SLICE;
  static constexpr size_t m_off = h_off + TILE;  // dh2 (f32 [64][C]) lies over h2 and dm
  static constexpr size_t g_off = m_off + TILE;
  static constexpr size_t st_off = g_off + TILE;         // f32 mu[64], rs[64]
  static constexpr size_t bar_off = st_off + 2 * N * 4;  // full[SLOTS], then count[SLOTS]
  // + 1024: the swizzle atoms need 1024-byte aligned addresses
  static constexpr size_t bytes = bar_off + 12 * SLOTS + 1024;
  static_assert(SLOTS % 2 == 0 && NS % 2 == 0, "a slot serves one warpgroup");
  static_assert(bytes <= 232448, "shared memory of a block");
  static_assert(kWarps * 3 * C * 4 <= 2 * TILE, "the LN partials of the 8 warps fit over h2, dm");
};

// The partial row mlp_bwd's block writes, 19 C floats: db2, dl2s, dl2b,
// then db1 [4 warps][4C] (the warps' sums added into warp 0's row at the
// block's end).
template <int C>
struct MlpPart {
  static constexpr int db2 = 0, dl2s = C, dl2b = 2 * C, db1 = 3 * C;
  static constexpr int stride = 19 * C;
};

// Partial sums attn_bwd's block writes, 6 C floats: dbqkv [3C], dbproj [C],
// dln1_scale [C], dln1_bias [C].
template <int C>
struct Part {
  static constexpr int dbqkv = 0, dbproj = 3 * C, dl1s = 4 * C, dl1b = 5 * C;
  static constexpr int stride = 6 * C;
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

// element (r, k) of a [64, C] bf16 tile in C / 64 boxes of [64 rows][64
// columns], 128-byte swizzle (as a tensor copy writes one): the 16-byte
// chunk k / 8 of row r at chunk position (k / 8) ^ (r % 8)
__device__ __forceinline__ int sw_index(int r, int k) {
  return (k >> 6) * 4096 + r * 64 + ((((k >> 3) ^ r) & 7) << 3) + (k & 7);
}

// element (r, c) of the f32 dh2 [64][C] in shared memory: the 16-byte
// chunks c / 4 of row r permuted by (c / 4) ^ (r % 8), so neither the
// accumulators' pair stores nor the rows' loads meet in a bank
template <int C>
__device__ __forceinline__ int dh_index(int r, int c) {
  return r * C + ((c >> 2) ^ (r & 7)) * 4 + (c & 3);
}

// V consecutive bf16 <-> f32 in one access (V = 2, 4 or 8; the pointer
// aligned to 2 V bytes)
template <int V>
__device__ __forceinline__ void load_piece(const bf16* p, float* v) {
  uint32_t w[V / 2];
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void store_piece(bf16* p, const float* v) {
  uint32_t w[V / 2];
#pragma unroll
  for (int i = 0; i < V / 2; ++i) w[i] = fm::pack_bf16(v[2 * i], v[2 * i + 1]);
  if constexpr (V == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (V == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// V consecutive f32 of dh2's row r from column c (a multiple of V)
template <int C, int V>
__device__ __forceinline__ void load_dh(const float* dh, int r, int c, float* v) {
  if constexpr (V == 2) {
    const float2 u = *reinterpret_cast<const float2*>(dh + dh_index<C>(r, c));
    v[0] = u.x, v[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(dh + dh_index<C>(r, c + i));
      v[i] = u.x, v[i + 1] = u.y, v[i + 2] = u.z, v[i + 3] = u.w;
    }
  }
}

// The normal CDF of y for GELU and its derivative, 0.5 (1 + erf(y / √2)),
// with erf by Abramowitz and Stegun 7.1.26 (absolute error below 1.5e-7,
// as f32 erff's rounding of 1 +- erf in the tails), given ex = exp(-y² / 2),
// which the derivative uses too: no branch, one reciprocal
__device__ __forceinline__ float gelu_cdf(float y, float ex) {
  const float x = fabsf(y) * kSqrtHalf;
  const float t = __fdividef(1.0f, fmaf(0.3275911f, x, 1.0f));
  const float p =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float erf_abs = fmaf(-p, ex, 1.0f);
  return 0.5f * (1.0f + copysignf(erf_abs, y));
}

// 4 x 4 transpose of 32-bit words across the quad (t = lane % 4): word k of
// lane t becomes word t of lane k, by two exchanges (lanes t ^ 1, t ^ 2)
// that each send the two words whose index differs from t in that bit
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int t) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
    const bool hi = t & bit;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k & bit) continue;  // the pair (k, k + bit)
      const uint32_t send = hi ? x[k] : x[k + bit];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, bit);
      x[k] = hi ? got : x[k];  // selects, not branches: the products may be in flight
      x[k + bit] = hi ? x[k + bit] : got;
    }
  }
}

// dh2 += dy1 (register A fragments of a k-step) . B (descriptor), m64nCk16
template <int C>
__device__ __forceinline__ void dh2_step(float (&acc)[C / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (C == 256)
    fm::wgmma_rs_n256(acc, a, b, 1);
  else if constexpr (C == 128)
    fm::wgmma_rs_n128(acc, a, b, 1);
  else
    fm::wgmma_rs_n64(acc, a, b, 1);
}

// Windows blockIdx.x, + gridDim.x, .. below run_windows (num_windows, but
// for a check that leaves windows out); num_windows sets the stash's layout.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_kernel(const __grid_constant__ CUtensorMap map_w1,
               const __grid_constant__ CUtensorMap map_w2,
               const bf16* __restrict__ x1g, const bf16* __restrict__ g, const float* s2,
               const float* __restrict__ ln2s, const float* __restrict__ ln2b,
               const float* __restrict__ b1, int num_windows, int run_windows, bf16* stash_base,
               float* __restrict__ dx1, float* __restrict__ part) {
  using L = MlpLayout<C>;
  using P = MlpPart<C>;
  constexpr int HID = 4 * C, NS = L::NS, SLOTS = L::SLOTS, V = C / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (fm::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* hs = reinterpret_cast<bf16*>(smem + L::h_off);
  bf16* dms = reinterpret_cast<bf16*>(smem + L::m_off);
  bf16* gs = reinterpret_cast<bf16*>(smem + L::g_off);
  float* mu = reinterpret_cast<float*>(smem + L::st_off);
  float* rs = mu + N;
  float* dh = reinterpret_cast<float*>(smem + L::h_off);  // dh2, then the LN partials
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  int* count = reinterpret_cast<int*>(full + SLOTS);
  const uint32_t ring = fm::smem_u32(smem), h_u32 = ring + L::h_off, m_u32 = ring + L::m_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warpgroup by a shuffle, which ptxas takes as uniform: the operand
  // descriptors are then too, and the products stay asynchronous
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int w = warp % 4, gq = lane / 4, t = lane % 4;
  const Stash<C> st(stash_base, (size_t)num_windows * N);
  float* pb = part + (size_t)blockIdx.x * P::stride;
  const int wins = (run_windows - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (wins <= 0) {  // no window (run_windows below the grid): a zero partial row
    for (int i = threadIdx.x; i < P::stride; i += kThreads) pb[i] = 0.f;
    return;
  }
  const int total = wins * NS;  // the block's slices

  // slice q into its slot where p: W1's columns [64 s, + 64) as one [C][64]
  // box, then W2's rows [64 s, + 64) as C / 64 boxes of [64][64]
  auto load_slice = [&](uint32_t p, int q) {
    const int slot = q % SLOTS, s = q % NS;
    const uint32_t dst = ring + slot * L::SLICE;
    fm::expect_if(p, &full[slot], L::SLICE);
    fm::tma_2d_if(p, dst, &map_w1, HS * s, 0, &full[slot]);
#pragma unroll
    for (int kb = 0; kb < C / 64; ++kb)
      fm::tma_2d_if(p, dst + L::W2_OFF + kb * 8192, &map_w2, 64 * kb, HS * s, &full[slot]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      fm::mbar_init(&full[i], 1);
      count[i] = 0;
    }
    fm::mbar_init_fence();
    for (int q = 0; q < min(SLOTS, total); ++q) load_slice(1u, q);
  }

#pragma unroll 1
  for (int it = 0; it < wins; ++it) {
    const int win = blockIdx.x + it * gridDim.x;
    const size_t row0 = (size_t)win * N;
    const float sc2 = s2 ? s2[win] : 1.0f;
    __syncthreads();  // the previous window is done with the tiles (the barriers are set)
    // prologue: h2 = LN2(x1), g and dm = bf16(g s2) into their tiles; h2, dm
    // to the stash; the warp's 8 rows loaded before the first reduction
    {
      const int c = lane * V;
      float v[8][V], gv[8][V];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        load_piece<V>(x1g + (row0 + warp * 8 + i) * C + c, v[i]);
        load_piece<V>(g + (row0 + warp * 8 + i) * C + c, gv[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp * 8 + i;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) sum += v[i][j];
        const float m = fm::warp_sum(sum) * (1.0f / C);
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          v[i][j] -= m;
          q += v[i][j] * v[i][j];
        }
        const float rr = rsqrtf(fm::warp_sum(q) * (1.0f / C) + fm::kLnEps);
#pragma unroll
        for (int j = 0; j < V; ++j) v[i][j] = v[i][j] * rr * ln2s[c + j] + ln2b[c + j];
        store_piece<V>(hs + sw_index(r, c), v[i]);
        store_piece<V>(st.h2 + (row0 + r) * C + c, v[i]);
        store_piece<V>(gs + sw_index(r, c), gv[i]);
#pragma unroll
        for (int j = 0; j < V; ++j) gv[i][j] *= sc2;
        store_piece<V>(dms + sw_index(r, c), gv[i]);
        store_piece<V>(st.dm + (row0 + r) * C + c, gv[i]);
        if (lane == 0) {
          mu[r] = m;
          rs[r] = rr;
        }
      }
    }
    fm::fence_proxy_async();  // the tiles' writes, before wgmma reads them
    __syncthreads();

    // the next window's x1 and g rows into L2 while this one's products run
    if (threadIdx.x == 0 && it + 1 < wins) {
      const size_t next = (row0 + (size_t)gridDim.x * N) * C;
      fm::prefetch_l2(x1g + next, N * C * 2);
      fm::prefetch_l2(g + next, N * C * 2);
    }
    // the hidden loop: warpgroup wg takes slices wg, wg + 2, .. Where a
    // warpgroup has two slots (C = 64, 128), slice s + 2's y1 and dge are
    // issued before slice s's stores and its dh2 product's wait, so they
    // overlap; at C = 256 slice s + 2 takes slice s's slot
    constexpr bool AHEAD = SLOTS >= 4;
    float dh2[C / 2], y[32], dg[32];
    fm::zero_regs(dh2);
    // slice s's y1 = h2 W1s + b1 (y starts at b1, so the product adds to the
    // bias in f32) and dge = dm W2sᵀ, as one group; y[4 j + 2 i + e]: row 16 w
    // + gq + 8 i, hidden column 64 s + 8 j + 2 t + e
    auto issue_first = [&](int s) {
      const int q = it * NS + s, slot = q % SLOTS;
      const uint32_t w1s = ring + slot * L::SLICE, w2s = w1s + L::W2_OFF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(b1 + HS * s + 8 * j + 2 * t);
        y[4 * j] = y[4 * j + 2] = bb.x;
        y[4 * j + 1] = y[4 * j + 3] = bb.y;
      }
      fm::fence_regs(y);
      fm::zero_regs(dg);
      fm::mbar_wait(&full[slot], L::RESIDENT ? 0u : (uint32_t)(q / SLOTS) & 1u);
      fm::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)  // k-step ks: rows 16 ks.. of W1's box, read MN-major
        fm::wgmma_ss_n64<1>(y, fm::sw128_desc(h_u32 + (ks >> 2) * 8192 + (ks & 3) * 32),
                            fm::sw128_mn_desc(w1s + ks * 2048, 8192), 1);
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        fm::wgmma_ss_n64(dg, fm::sw128_desc(m_u32 + (ks >> 2) * 8192 + (ks & 3) * 32),
                         fm::sw128_desc(w2s + (ks >> 2) * 8192 + (ks & 3) * 32), 1);
      fm::wgmma_commit();
    };
    // the rest of slice s (its y1 and dge issued); `ahead`: slice s + 2's
    // are issued after its dh2 product (compile-time, so no branch lies
    // between a product's issue and its wait)
    auto finish_slice = [&](int s, auto ahead) {
      constexpr bool kAhead = decltype(ahead)::value;
      const int q = it * NS + s, slot = q % SLOTS, c0 = HS * s;
      const uint32_t w1s = ring + slot * L::SLICE;
      fm::wgmma_wait<0>();
      fm::fence_regs(y);
      fm::fence_regs(dg);
      uint32_t f[4][4];   // bf16 dy1 as the A fragments of its four k-steps
      uint32_t gw[2][8];  // bf16 ge pairs: row + 8 i, columns 8 j + 2 t, + 1
      float2 csum[8];     // db1: the f32 dy1's sums over the warp's 16 rows, columns 8 j + 2 t, + 1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float gev[2], dyv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float yv = y[4 * j + 2 * i + e], ex = __expf(-0.5f * yv * yv);
            const float cdf = gelu_cdf(yv, ex);
            gev[e] = yv * cdf;
            dyv[e] = dg[4 * j + 2 * i + e] * (cdf + yv * kInvSqrt2Pi * ex);
            dg[4 * j + 2 * i + e] = dyv[e];
          }
          gw[i][j] = fm::pack_bf16(gev[0], gev[1]);
          f[j >> 1][2 * (j & 1) + i] = fm::pack_bf16(dyv[0], dyv[1]);
        }
        csum[j] = make_float2(fm::column_sum(dg[4 * j] + dg[4 * j + 2]),
                              fm::column_sum(dg[4 * j + 1] + dg[4 * j + 3]));
      }
      // dh2 += dy1 W1sᵀ: k-step kk, hidden columns 16 kk.., 32 bytes into the box's rows
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) dh2_step<C>(dh2, f[kk], fm::sw128_desc(w1s + 32 * kk));
      fm::wgmma_commit();
      if constexpr (kAhead) issue_first(s + 2);
      // while they run, ge and dy1 to the stash in whole 16-byte pieces of a
      // row: the quad's 4 x 4 transposes give lane t columns 8 (4 h + t) ..
      // + 8 of each half h of the slice
      const size_t ra = row0 + 16 * w + gq;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t a[4], b[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            a[k] = gw[i][4 * h + k];
            b[k] = f[2 * h + (k >> 1)][2 * (k & 1) + i];
          }
          quad_transpose(a, t);
          quad_transpose(b, t);
          const size_t at = (ra + 8 * i) * HID + c0 + 8 * (4 * h + t);
          *reinterpret_cast<uint4*>(st.ge + at) = make_uint4(a[0], a[1], a[2], a[3]);
          *reinterpret_cast<uint4*>(st.dy1 + at) = make_uint4(b[0], b[1], b[2], b[3]);
        }
      // and db1's sums into the warp's partial row (the same lanes own the
      // same columns every window; a column's 8 lanes all hold its sum and
      // store the same value: no branch between the products' issue and
      // their wait)
      float* db1w = pb + P::db1 + w * HID + c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2* p = reinterpret_cast<float2*>(db1w + 8 * j);
        float2 o = *p;
        o = it ? o : make_float2(0.f, 0.f);
        *p = make_float2(o.x + csum[j].x, o.y + csum[j].y);
      }
      if constexpr (kAhead)
        fm::wgmma_wait<1>();  // dh2's product is done; slice s + 2's may run on
      else
        fm::wgmma_wait<0>();
      fm::fence_regs(dh2);
      fm::fence_frags(f);
      if constexpr (!L::RESIDENT) {  // the slot goes back; the warpgroup's last warp refills it
        const uint32_t last = fm::handback((uint32_t)(lane == 0), &count[slot], 3);
        load_slice(last & (uint32_t)(q + SLOTS < total), q + SLOTS);
      }
    };
    if constexpr (AHEAD) {
      issue_first(wg);
      int s = wg;
#pragma unroll 1
      for (; s + 2 < NS; s += 2) finish_slice(s, std::true_type{});
      finish_slice(s, std::false_type{});
    } else {
#pragma unroll 1
      for (int s = wg; s < NS; s += 2) {
        issue_first(s);
        finish_slice(s, std::false_type{});
      }
    }

    // dh2 = warpgroup 1's + warpgroup 0's, over h2 and dm
    __syncthreads();  // every product is done with h2 and dm
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(dh + dh_index<C>(16 * w + gq + 8 * i, 8 * j + 2 * t)) =
              make_float2(dh2[4 * j + 2 * i], dh2[4 * j + 2 * i + 1]);
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2* p =
              reinterpret_cast<float2*>(dh + dh_index<C>(16 * w + gq + 8 * i, 8 * j + 2 * t));
          const float2 o = *p;
          *p = make_float2(o.x + dh2[4 * j + 2 * i], o.y + dh2[4 * j + 2 * i + 1]);
        }
    }
    __syncthreads();

    // LN2 backward: dx1 = g + rs (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
    // dxhat = dh2 scale; the lane's column sums over its warp's 8 rows
    float pg[V], ps[V], pbias[V], sc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      pg[j] = ps[j] = pbias[j] = 0.f;
      sc[j] = ln2s[lane * V + j];
    }
    float xr[8][V];  // the warp's 8 rows of x1, loaded before the first reduction
#pragma unroll
    for (int i = 0; i < 8; ++i) load_piece<V>(x1g + (row0 + warp * 8 + i) * C + lane * V, xr[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i, c = lane * V;
      float* xh = xr[i];
      float gv[V], d[V], dxh[V];
      load_piece<V>(gs + sw_index(r, c), gv);
      load_dh<C, V>(dh, r, c, d);
      const float m = mu[r], rr = rs[r];
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xh[j] = (xh[j] - m) * rr;
        dxh[j] = d[j] * sc[j];
        m1 += dxh[j];
        m2 += dxh[j] * xh[j];
        ps[j] += d[j] * xh[j];
        pbias[j] += d[j];
        pg[j] += gv[j] * sc2;
      }
      m1 = fm::warp_sum(m1) * (1.0f / C);
      m2 = fm::warp_sum(m2) * (1.0f / C);
      float out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = gv[j] + rr * (dxh[j] - m1 - xh[j] * m2);
      float* o = dx1 + (row0 + r) * C + c;
      if constexpr (V == 2) {
        *reinterpret_cast<float2*>(o) = make_float2(out[0], out[1]);
      } else {
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(o + j) =
              make_float4(out[j], out[j + 1], out[j + 2], out[j + 3]);
      }
    }
    __syncthreads();  // every warp is done with dh2 and g
    float* stage = dh;  // [8 warps][db2 | dl2s | dl2b]
#pragma unroll
    for (int j = 0; j < V; ++j) {
      stage[warp * 3 * C + P::db2 + lane * V + j] = pg[j];
      stage[warp * 3 * C + P::dl2s + lane * V + j] = ps[j];
      stage[warp * 3 * C + P::dl2b + lane * V + j] = pbias[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 3 * C; c += kThreads) {
      float v = stage[c];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) v += stage[k * 3 * C + c];
      pb[c] = it ? pb[c] + v : v;  // db2 | dl2s | dl2b
    }
  }
  // db1: the four warps' rows, in order, into warp 0's
  __syncthreads();
  for (int c = threadIdx.x; c < HID; c += kThreads) {
    const float* r = pb + P::db1 + c;
    pb[P::db1 + c] = r[0] + r[HID] + r[2 * HID] + r[3 * HID];
  }
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
//   - the heads two at a time (a group; at head dim 64 one, Units below),
//     on register-resident units, with two barriers a group. Phase A: warp w
//     takes (head 2 group + w / 4, query rows 16 (w % 4) ..; at head dim 64
//     head `group`, the same rows, columns 32 (w / 4) ..): its strip of the
//     saved P as A fragments, o = P v,
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

// The attention units at head dim D: a group of GH heads at a time, each
// head's 4 row tiles split into NC column parts of DW = D / NC columns, one
// (head, row tile, column part) a warp. D = 16: two heads a group, a unit
// the head's whole 16 columns. D = 64: one head a group, a unit 32 of its
// columns; the two warps of a row tile both form the tile's whole dP and dS
// (16 x 64, a contraction over the head's 64 columns), and each writes the
// key tiles it owns (KT of the 4) of the P and dS strips and of the rel_bias
// partial.
template <int D>
struct Units {
  static constexpr int GH = D == 16 ? 2 : 1;  // heads a group
  static constexpr int NC = 2 / GH;           // column parts of a head
  static constexpr int DW = D / NC;           // a unit's columns
  static constexpr int NT = DW / 16;          // its 16-column tiles
  static constexpr int KT = N / 16 / NC;      // key tiles a unit writes
  static_assert(GH * 4 * NC == kWarps && DW % 16 == 0, "a group's units: one a warp");
};

// The two warps of row tile `tile` (column parts 0 and 1, NC = 2) meet:
// named barrier 1 + tile over 64 threads
__device__ __forceinline__ void tile_pair_sync(int tile) { fm::named_barrier(1 + tile, 64); }

// Phase A of the unit (head hd, query rows 16 tile .., column part cp): see
// the section's comment. pv: the unit's strip of P (load_p_strip); ps / ss:
// the head's P and dS strips [64][LDP]; o_out: the window's rows of the o
// stash; colq: this row tile's dbqkv accumulator.
// The unit's f32 dS goes to the block's rel_bias partial: REG, into dbr
// (the unit's 32 values a lane, kept in registers over the block's
// windows); otherwise into dbias in device memory, which the block's first
// window writes and the others add to. Leaves dq (x head_dim^-0.5) in dq.
template <int C, int D, bool REG>
__device__ __forceinline__ void grad_unit_rows(const bf16* qkv, const bf16* das,
                                               const uint4 (&pv)[4], bf16* ps, bf16* ss,
                                               bf16* o_out, float* dbias,
                                               float (&dbr)[32], float* colq, bool first, int hd,
                                               int tile, int cp, int lane,
                                               float (&dq)[Units<D>::NT][8]) {
  using U = Units<D>;
  constexpr int LDQ = 3 * C + 8, LDX = C + 8, NT = U::NT, KT = U::KT;
  constexpr float kScale = swin::attn_scale(D);
  const int g = lane >> 2, t = lane & 3, c0 = hd * D + cp * U::DW, kt0 = cp * KT;
  // the unit's strip of P (its key tiles) into its rows of ps, then A fragments
  bf16* pr = ps + tile * 16 * LDP;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = lane + 32 * i;
    if (U::NC == 1 || (e & 7) / (2 * KT) == cp)
      *reinterpret_cast<uint4*>(pr + (e >> 3) * LDP + (e & 7) * 8) = pv[i];
  }
  if constexpr (U::NC == 1)
    __syncwarp();
  else
    tile_pair_sync(tile);
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) fm::load_a(pa[kt], pr + kt * 16, LDP, lane);
  // o = P v_h, rounded to bf16, to the stash
  const bf16* vh = qkv + 2 * C + hd * D;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    Acc16 o;
    fm::zero(o);
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt) {
      uint32_t vb[4];
      fm::load_b(vb, qkv + kt * 16 * LDQ + 2 * C + c0 + 16 * j, LDQ, lane);
      fm::mma16(o, pa[kt], vb);
    }
    store_tile_bf16(o.c, o_out + (size_t)tile * 16 * C + c0 + 16 * j, C, lane);
  }
  // dP = da_h v_hᵀ: 16 rows x 64 keys, over the head's D columns
  Acc16 dp[N / 16];
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) fm::zero(dp[kt]);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t aa[4];
    fm::load_a(aa, das + tile * 16 * LDX + hd * D + 16 * kd, LDX, lane);
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt) {
      uint32_t vb[4];
      fm::load_bt(vb, vh + kt * 16 * LDQ + 16 * kd, LDQ, lane);
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
  // dS = P (dP - rowsum): f32 into the rel_bias partial, bf16 to ss (the
  // unit's key tiles) and as A fragments
  uint32_t sa[N / 16][4];
  float* db = dbias + ((size_t)hd * N + tile * 16) * N;
  bf16* sr = ss + tile * 16 * LDP;
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    const bool mine = kt >= kt0 && kt < kt0 + KT;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const float2 p = unpack_bf16(pa[kt][jp]);
      const float r = rsum[jp & 1];
      const float s0 = p.x * (dp[kt].c[2 * jp] - r), s1 = p.y * (dp[kt].c[2 * jp + 1] - r);
      const int row = g + 8 * (jp & 1), col = 16 * kt + 8 * (jp >> 1) + 2 * t;
      float2* d2 = reinterpret_cast<float2*>(db + row * N + col);
      sa[kt][jp] = fm::pack_bf16(s0, s1);
      if (!mine) continue;
      if (REG) {
        dbr[kt * 8 + 2 * jp] += s0;
        dbr[kt * 8 + 2 * jp + 1] += s1;
      } else if (first) {
        *d2 = make_float2(s0, s1);
      } else {
        const float2 acc = *d2;
        *d2 = make_float2(acc.x + s0, acc.y + s1);
      }
      *reinterpret_cast<uint32_t*>(sr + row * LDP + col) = sa[kt][jp];
    }
  }
  // dq = dS k_h x head_dim^-0.5
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    Acc16 a;
    fm::zero(a);
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt) {
      uint32_t kb[4];
      fm::load_b(kb, qkv + kt * 16 * LDQ + C + c0 + 16 * j, LDQ, lane);
      fm::mma16(a, sa[kt], kb);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dq[j][i] = a.c[i] * kScale;
    add_col_sums(dq[j], colq + c0 + 16 * j, lane);
  }
}

// Phase B of the unit (head hd, key rows 16 tile .., column part cp): dk =
// dSᵀ q_h x head_dim^-0.5 and dv = Pᵀ da_h over the unit's columns, their
// column sums into colq, bf16 over the unit's rows of k_h and v_h.
template <int C, int D>
__device__ __forceinline__ void grad_unit_keys(bf16* qkv, const bf16* das, const bf16* ps,
                                               const bf16* ss, float* colq, int hd, int tile,
                                               int cp, int lane) {
  using U = Units<D>;
  constexpr int LDQ = 3 * C + 8, LDX = C + 8;
  constexpr float kScale = swin::attn_scale(D);
  const int c0 = hd * D + cp * U::DW;
#pragma unroll
  for (int j = 0; j < U::NT; ++j) {
    Acc16 dk, dv;
    fm::zero(dk);
    fm::zero(dv);
#pragma unroll
    for (int kq = 0; kq < N / 16; ++kq) {
      uint32_t fa[4], fb[4];
      fm::load_a_trans(fa, ss + kq * 16 * LDP + tile * 16, LDP, lane);
      fm::load_b(fb, qkv + kq * 16 * LDQ + c0 + 16 * j, LDQ, lane);
      fm::mma16(dk, fa, fb);
      fm::load_a_trans(fa, ps + kq * 16 * LDP + tile * 16, LDP, lane);
      fm::load_b(fb, das + kq * 16 * LDX + c0 + 16 * j, LDX, lane);
      fm::mma16(dv, fa, fb);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dk.c[i] *= kScale;
    add_col_sums(dk.c, colq + C + c0 + 16 * j, lane);
    add_col_sums(dv.c, colq + 2 * C + c0 + 16 * j, lane);
    bf16* rows = qkv + tile * 16 * LDQ + c0 + 16 * j;
    store_tile_bf16(dk.c, rows + C, LDQ, lane);
    store_tile_bf16(dv.c, rows + 2 * C, LDQ, lane);
  }
}

// h1 = LN1(x) for the window's 64 rows (x in device memory, row stride C),
// 8 rows a warp, with mlp_bwd's LN2 arithmetic; all of a warp's rows are loaded
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

// The rows of the LN1 backward of one window, with mlp_bwd's LN2
// backward's arithmetic: dx = dx1 + rs (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
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
template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const bf16* __restrict__ x, const float* s1, const bf16* __restrict__ probs,
                const float* __restrict__ dx1, const float* __restrict__ ln1s,
                const float* __restrict__ ln1b, const bf16* __restrict__ wqkv,
                const float* __restrict__ bqkv, const bf16* __restrict__ wproj, int num_windows,
                bf16* stash_base, bf16* __restrict__ dx, float* __restrict__ part,
                float* __restrict__ dbias_part) {
  using S = AttnSmem<C>;
  using P = Part<C>;
  using U = Units<D>;
  constexpr int H = C / D, GH = U::GH, LDX = S::LDX, LDQ = S::LDQ, LDD = S::LDD;
  constexpr int R = kThreads / C;  // a thread's column sums take every R-th row
  static_assert(H % GH == 0, "whole groups of heads");
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
  // the attention units: warp w takes head GH group + slot, row tile w % 4,
  // column part cp
  const int slot = GH == 2 ? warp / 4 : 0, cp = GH == 2 ? 0 : warp / 4, tile = warp % 4;
  bf16* ps = hs + slot * N * LDP;
  bf16* ss = hs + (2 + slot) * N * LDP;
  float* colq = colacc + tile * 3 * C;
  // REG: the warp's rel_bias partial stays in registers over the block's
  // windows, which pays at C = 64 (two units a warp at head dim 16, one at
  // 64: 64 or 32 registers a lane, some nine windows a block); at C = 128 it
  // would take 128 registers at head dim 16, and at C = 256 a block takes
  // one window
  constexpr bool REG = C == 64;
  constexpr int NREG = REG ? H / GH : 1;
  float dbr[NREG][32];  // REG: the rel_bias partial of the warp's unit in each group
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

    // the heads, a group at a time; dq goes over q_h once no unit reads q_h
    float dq[U::NT][8];
    auto store_dq = [&](int hd) {
#pragma unroll
      for (int j = 0; j < U::NT; ++j)
        store_tile_bf16(dq[j], qkv + tile * 16 * LDQ + hd * D + cp * U::DW + 16 * j, LDQ, lane);
    };
#pragma unroll NREG
    for (int grp = 0; grp < H / GH; ++grp) {
      const int hd = GH * grp + slot;
      __syncthreads();  // da written; the previous group's phase B is done
      if (grp > 0) store_dq(hd - GH);
      grad_unit_rows<C, D, REG>(qkv, das, pv, ps, ss, st.o + row0 * C, dbias,
                                dbr[REG ? grp : 0], colq, win == (int)blockIdx.x, hd, tile,
                                cp, lane, dq);
      if (grp + 1 < H / GH) load_p_strip(pw, hd + GH, tile, lane, pv);  // the next group's
      __syncthreads();  // the group's P and dS strips are in shared memory
      grad_unit_keys<C, D>(qkv, das, ps, ss, colq, hd, tile, cp, lane);
    }
    __syncthreads();
    store_dq(H - GH + slot);
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
    for (int grp = 0; grp < NREG; ++grp) {
      float* db = dbias + ((size_t)(GH * grp + slot) * N + tile * 16) * N;
#pragma unroll
      for (int kt = 0; kt < N / 16; ++kt)  // the key tiles the warp's units own
#pragma unroll
        for (int jp = 0; jp < 4; ++jp)
          if (kt / U::KT == cp)
            *reinterpret_cast<float2*>(db + fm::pair_row(jp, lane) * N +
                                       fm::pair_col(kt, jp, lane)) =
                make_float2(dbr[grp][kt * 8 + 2 * jp], dbr[grp][kt * 8 + 2 * jp + 1]);
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

template <int C, int D>
cudaError_t launch_fwd(const void* const* in, int num_windows, int nW, cudaStream_t st) {
  // in: x, mask, s1, s2, 13 params, out, probs, x1
  swin::TrainIO io{static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
                   static_cast<bf16*>(const_cast<void*>(in[18])),
                   static_cast<bf16*>(const_cast<void*>(in[19]))};
  return swin::launch_block<C, D>(io, in[0], in[1], nW, in + 4, const_cast<void*>(in[17]),
                               num_windows, st);
}

// mlp_bwd's operands W1 [C][4C] and W2 [4C][C] (bf16) as tensor maps: W1's
// [C rows][64 columns] boxes (a slice's columns), W2's [64][64]
template <int C>
cudaError_t mlp_maps(const bf16* w1, const bf16* w2, CUtensorMap* m1, CUtensorMap* m2) {
  const cuuint64_t d1[2] = {4 * C, C}, s1[1] = {8 * C}, d2[2] = {C, 4 * C}, s2[1] = {2 * C};
  const cuuint32_t b1[2] = {HS, C}, b2[2] = {64, HS};
  const cudaError_t e = fm::bf16_tensor_map(m1, w1, 2, d1, s1, b1);
  return e != cudaSuccess ? e : fm::bf16_tensor_map(m2, w2, 2, d2, s2, b2);
}

template <int C, int D>
cudaError_t launch_bwd(const void* const* in, void* const* out, int num_windows, int nb,
                       int nbm, int mlp_windows, int sms, cudaStream_t st) {
  // in: x, s1, s2, probs, x1, g, then the 13 params (PARAM_KEYS order)
  // out: dx, the 13 grads, stash, dx1, attn_bwd's partials, mlp_bwd's
  // partials, rel_bias partials, gemm partials
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  auto Bf = [](const void* q) { return static_cast<const bf16*>(q); };
  const void* const* p = in + 6;
  const int H = C / D, T = num_windows * N;
  bf16* stash = static_cast<bf16*>(out[14]);
  float* dx1 = static_cast<float*>(out[15]);
  float* small = static_cast<float*>(out[16]);
  float* mpart = static_cast<float*>(out[17]);
  float* dbias = static_cast<float*>(out[18]);
  float* gemm = static_cast<float*>(out[19]);
  using P = Part<C>;
  using MP = MlpPart<C>;

  CUtensorMap m1, m2;
  cudaError_t e = mlp_maps<C>(Bf(p[9]), Bf(p[11]), &m1, &m2);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(mlp_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)MlpLayout<C>::bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_bwd_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)AttnSmem<C>::bytes);
  if (e != cudaSuccess) return e;
  mlp_bwd_kernel<C><<<nbm, kThreads, MlpLayout<C>::bytes, st>>>(
      m1, m2, Bf(in[4]), Bf(in[5]), F(in[2]), F(p[7]), F(p[8]), F(p[10]), num_windows,
      mlp_windows, stash, dx1, mpart);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_kernel<C, D><<<nb, kThreads, AttnSmem<C>::bytes, st>>>(
      Bf(in[0]), F(in[1]), Bf(in[3]), dx1, F(p[0]), F(p[1]), Bf(p[2]), F(p[3]), Bf(p[5]),
      num_windows, stash, static_cast<bf16*>(out[0]), small, dbias);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  Stash<C> s(stash, (size_t)T);
  // grads in PARAM_KEYS order: ln1_scale, ln1_bias, w_qkv, b_qkv, rel_bias,
  // w_proj, b_proj, ln2_scale, ln2_bias, w_mlp1, b_mlp1, w_mlp2, b_mlp2;
  // each kernel's block partials added over its own blocks in order
  void* const* gr = out + 1;
  const struct { int off, len, out; } sums[] = {
      {P::dl1s, C, 0}, {P::dl1b, C, 1}, {P::dbqkv, 3 * C, 3}, {P::dbproj, C, 6}};
  for (const auto& q : sums) {
    e = sum_parts(small + q.off, nb, P::stride, q.len, gr[q.out], st);
    if (e != cudaSuccess) return e;
  }
  // mlp_bwd's db2 | dl2s | dl2b | db1 in one sum: the gradients of b_mlp2,
  // ln2_scale, ln2_bias and b_mlp1 lie contiguous in that order
  e = sum_parts(mpart, nbm, MP::stride, MP::db1 + 4 * C, gr[12], st);
  if (e != cudaSuccess) return e;
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

template <int C, int D>
cudaError_t bwd_occupancy(int* info) {
  cudaError_t e = occupancy(attn_bwd_kernel<C, D>, (int)AttnSmem<C>::bytes, info);
  if (e != cudaSuccess) return e;
  return occupancy(mlp_bwd_kernel<C>, (int)MlpLayout<C>::bytes, info + 2);
}

}  // namespace

FM_ERROR_STRING_ENTRY

namespace {

// f(integral_constant C, integral_constant D) at a width and head dim the
// kernels take: C in (64, 128, 256), D in HEAD_DIMS (16, 64); an invalid
// value error for any other pair
template <typename F>
cudaError_t at_width(int C, int D, F f) {
  using std::integral_constant;
  if (D != 16 && D != 64) return cudaErrorInvalidValue;
  switch (C) {
    case 64:
      return D == 16 ? f(integral_constant<int, 64>{}, integral_constant<int, 16>{})
                     : f(integral_constant<int, 64>{}, integral_constant<int, 64>{});
    case 128:
      return D == 16 ? f(integral_constant<int, 128>{}, integral_constant<int, 16>{})
                     : f(integral_constant<int, 128>{}, integral_constant<int, 64>{});
    case 256:
      return D == 16 ? f(integral_constant<int, 256>{}, integral_constant<int, 16>{})
                     : f(integral_constant<int, 256>{}, integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward: in = {x, mask, s1, s2, ln1s, ln1b, wqkv, bqkv, rel_bias, wproj,
// bproj, ln2s, ln2b, w1, b1, w2, b2, out, probs, x1} (mask, s1, s2 may be
// null; nW = mask windows, 0 for none). Layouts as fm_swin_block; probs
// [num_windows][C/D][64][64] bf16, x1 [num_windows][64][C] bf16; D: the
// head dim, 16 or 64.
extern "C" int fm_swin_block_train_fwd(const void* const* in, int num_windows, int C, int D,
                                       int nW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(at_width(C, D, [&](auto c, auto d) {
    return launch_fwd<decltype(c)::value, decltype(d)::value>(in, num_windows, nW, st);
  }));
}

// Backward: in = {x, s1, s2, probs, x1, g, the 13 params}; out = {dx,
// the 13 gradients (f32, the params' layouts), bf16 stash [16 C T], f32
// dx1 [T C], f32 attn_bwd block partials [nb][6 C], f32 mlp_bwd block
// partials [nbm][19 C], f32 rel_bias partials [nb][C/D][64][64], f32
// weight-gradient partials (ops/wgrad.partial_floats of the four
// products)}, T = 64 num_windows (the gradients of b_mlp2, ln2_scale,
// ln2_bias and b_mlp1 contiguous in that order); D: the head dim, 16 or 64;
// nb: attn_bwd's blocks; nbm: mlp_bwd's
// (ops/swin_block_train.mlp_grid); mlp_windows: the windows mlp_bwd takes
// (num_windows; fewer only to check that a check sees windows left out);
// sms: the card's SMs. (The backward reads the saved probabilities, so no
// mask.)
extern "C" int fm_swin_block_train_bwd(const void* const* in, void* const* out, int num_windows,
                                       int C, int D, int nb, int nbm, int mlp_windows,
                                       int sms, void* stream) {
  const float* b2 = static_cast<const float*>(out[13]);  // b_mlp2's gradient, then ln2_scale's, ..
  if (nb <= 0 || nbm <= 0 || sms <= 0 || mlp_windows > num_windows || out[8] != b2 + C ||
      out[9] != b2 + 2 * C || out[11] != b2 + 3 * C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(at_width(C, D, [&](auto c, auto d) {
    return launch_bwd<decltype(c)::value, decltype(d)::value>(in, out, num_windows, nb, nbm,
                                                               mlp_windows, sms, st);
  }));
}

// The backward's window kernels at width C and head dim D: info =
// {attn_bwd's dynamic shared memory (bytes), its resident blocks an SM,
// mlp_bwd's bytes, its blocks an SM}.
extern "C" int fm_swin_block_train_bwd_occupancy(int C, int D, int* info) {
  return static_cast<int>(at_width(C, D, [&](auto c, auto d) {
    return bwd_occupancy<decltype(c)::value, decltype(d)::value>(info);
  }));
}
