// The whole fine stage on window pairs:
//   for each layer: self  -> w0 = enc(w0, w0); w1 = enc(w1, w1)
//                   cross -> w0 = enc(w0, w1); w1 = enc(w1, w0)
//   m0 = mix0(w0), m1 = mix1(w1)  (learned taps -> 1 mix)
//   fold:  heat0 = softmax(m0 . w1^T / sqrt(C)), heat1 = softmax(m1 . w0^T / sqrt(C))
//   plain: w0, w1, m0, m1
// where enc is the LoFTR encoder layer of csrc/coarse_transformer.cu on a
// 64-row window (linear attention, merge + LN1, split-weight FFN + LN2,
// residual).
//
// Replaces featurematching_tpu/ops/pallas_fine_stage.py · fine_stage_fused
// (_fine_kernel with _enc_math, _mix_math, _heat_math). Bound on the H100 by
// tensor-core operations (about 82 k multiply-adds a tap and layer against
// 128 bytes of window in and 4 bytes of heatmap out), but a pair's chain of
// small dependent steps is what takes the time: the design this replaced
// (one pair a block, three blocks an SM, about 40 block-wide barriers a
// pair, the weights read from L1/L2 for every window) measured 145k cycles
// a pair of a block, of which its 1.31 GB of weight reads were only 8%.
// Design:
//   - A window is 49 taps padded to 64 rows: one wgmma tile (M = 64). Each
//     window pair belongs to one warpgroup, which runs its four encoder
//     calls, the mixes and the heatmaps alone, synchronising only itself
//     (its named barrier: two an encoder call, three a pair for the mixes
//     and heatmaps). A block holds 3 pairs in flight, so one pair's
//     latencies hide behind the others' work; the grid is persistent, one
//     block an SM. (384 threads leave 168 registers a thread, and a few
//     values spill; four warpgroups, at 128, spilled more and ran slower.)
//   - The layers' weights leave L2 once a block: the block bulk-copies each
//     layer's weight image (ops/fine_stage.fine_image, 80 KB: every
//     product's k-steps as [N, 16] K-major tiles, wgmma.cuh) into shared
//     memory when it starts, and every pair it takes reads them there.
//   - A window lives in registers, as the m16n8k16 A fragments of its
//     warp's 16 rows, and every weight product is a wgmma with A from
//     registers: [K | V] (n = 128), Q, the merge, FFN1 over [x | msg]
//     without a concatenation (two halves of n = 64), FFN2 over the hidden
//     activations. Each product's accumulator is the next product's A
//     fragment after its epilogue (elu, the head scale, LN1, ReLU, LN2 and
//     the residual all in registers; a row's 64 values lie in one quad of
//     lanes).
//   - Only K | V goes through shared memory (a [64, 128] K-major tile), for
//     the four diagonal 16x16 tiles of K^T V, one a warp on mma.sync, each
//     masked to its heads' D x D blocks; the same A fragments times a
//     column of ones give K_sum. Z = Q_h . K_sum_h and the 49 -> 1 mixes are
//     quad and column sums over shuffles, the heatmaps 64-long dot products
//     over a quad and a warp softmax.
//   - Head dims 8, 16 and 64. With one head of 64, K^T V is the whole
//     [64, 64]: warp w forms its K strip against all four V strips (16
//     tiles), Z runs over all 64 features, and each output tile sums four
//     products. The 8 KB of tiles would not fit beside three pairs' scratch,
//     so they go over the K | V tile once every warp has read it (two more
//     barriers an encoder call).
//   - Padded taps get no key or value mass, a mixing weight of zero, and no
//     heatmap entry.
//
// Rounding follows the TPU kernel: K and V/N rounded after the f32 product
// and feature map; K_sum rounded to bf16; Q rounded after its feature map;
// o * (N / (Z + eps)) in f32, rounded once; each product rounded to bf16
// before its LayerNorm; the residual add is bf16 + bf16; the mix sum is
// rounded, then the bias added in bf16; heatmaps in f32. Every sum runs in
// a fixed order: two runs agree bit for bit.

#include "tiles.cuh"
#include "wgmma.cuh"

namespace {

using fm::bf16;

constexpr int C = 64;
constexpr int NP = 64;  // taps padded to one 64-row tile
constexpr int kMaxLayers = 2;
constexpr float kEps = 1e-6f;
constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block may use

// one layer's weight image (bytes): each product's k-steps as [N, 16]
// K-major tiles, wq [C, C], wkv [C, 2C], wmerge [C, C], w1 [2C, 2C], w2 [2C, C]
constexpr uint32_t WQ_OFF = 0;
constexpr uint32_t WKV_OFF = WQ_OFF + C * C * 2;
constexpr uint32_t WM_OFF = WKV_OFF + 2 * C * C * 2;
constexpr uint32_t W1_OFF = WM_OFF + C * C * 2;
constexpr uint32_t W2_OFF = W1_OFF + 4 * C * C * 2;
constexpr uint32_t kImageBytes = W2_OFF + 2 * C * C * 2;  // 81920
constexpr uint32_t kCopyBytes = 16384;                    // one bulk copy
constexpr size_t kLnBytes = 4 * C * 4;                    // n1s, n1b, n2s, n2b (f32)
static_assert(kImageBytes % kCopyBytes == 0, "the image goes in whole copies");

// a pair's scratch (bytes)
constexpr int KV_OFF = 0;                         // bf16 [64, 2C] K | V, K-major
constexpr int KVD_OFF = KV_OFF + NP * 2 * C * 2;  // bf16 4 x [16, 16] K^T V tiles, fragment order
constexpr int KS_OFF = KVD_OFF + 4 * 256 * 2;     // f32 [C] K_sum (bf16 values)
constexpr int MIXP_OFF = KS_OFF + C * 4;          // f32 [4 warps][2][C] mix partials
constexpr int M_OFF = MIXP_OFF + 4 * 2 * C * 4;   // f32 [2][C] mixed centres
constexpr int SIM_OFF = M_OFF + 2 * C * 4;        // f32 [2][NP] heatmap logits
constexpr int kPairBytes = SIM_OFF + 2 * NP * 4;  // 21760

// pairs in flight a block, one a warpgroup: what shared memory holds with two
// layers (four warpgroups, at 128 registers a thread, spilled and ran slower
// with one layer)
constexpr int kPairs = 3;
constexpr int kThreads = 128 * kPairs;

// the block: the layers' images, their LN parameters, the mix weights, then
// the pairs' scratch and the images' mbarrier
__host__ __device__ constexpr size_t ln_off(int layers) { return (size_t)layers * kImageBytes; }
__host__ __device__ constexpr size_t mixw_off(int layers) {
  return ln_off(layers) + layers * kLnBytes;
}
__host__ __device__ constexpr size_t pair_off(int layers) { return mixw_off(layers) + 2 * NP * 4; }
__host__ __device__ constexpr size_t bar_off(int layers) {
  return pair_off(layers) + (size_t)kPairs * kPairBytes;
}
__host__ __device__ constexpr size_t smem_bytes(int layers) { return bar_off(layers) + 16; }
static_assert(smem_bytes(kMaxLayers) <= kSmemMax, "shared memory of a block");
static_assert(pair_off(1) % 128 == 0 && pair_off(2) % 128 == 0 && kPairBytes % 128 == 0,
              "pair scratch 128-byte aligned");

struct Args {
  const bf16* win[2];                    // [B, N, C] windows of image 0 and 1
  const unsigned char* image[kMaxLayers];  // the layers' weight images
  const float* ln[kMaxLayers][4];        // n1s, n1b, n2s, n2b [C]
  const float* mix_w[2];                 // [N]
  const float* mix_b[2];                 // [1]
  float* heat[2];                        // fold: [B, N]
  bf16* wout[2];                         // plain: [B, N, C]
  bf16* mout[2];                         // plain: [B, C]
  int B, N, layers, cross, fold;
};

// A window as its warp's 16 rows of m16n8k16 A fragments: Frag[kk][r] holds
// rows g + 8 (r & 1), columns 16 kk + 8 (r >> 1) + 2 t and the next (g =
// lane / 4, t = lane % 4), which is also where a [64, N] wgmma accumulator
// keeps them: acc[8 kk + 2 r] and the next.
using Frag = uint32_t[4][4];

// elu(v) + 1 = max(v, 0) + exp(min(v, 0)): no branch or select a value. exp
// by ex2.approx (__expf: a few f32 ulp, far below the bf16 rounding that
// follows it; exp(0) is 1 exactly)
__device__ __forceinline__ float elu1(float v) {
  return fmaxf(v, 0.f) + __expf(fminf(v, 0.f));
}

// bf16 pair of (relu(lo), relu(hi)), the first in the low half: one cvt
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// acc += A (KS k-steps of register fragments) . B (KS k-steps of [N, 16]
// K-major tiles from shared address b, `step` bytes apart: 32 N for a whole
// weight, more for N columns of a wider one)
template <int N, int KS>
__device__ __forceinline__ void product(float (&acc)[N / 2], const uint32_t (&a)[KS][4],
                                        uint32_t b, uint32_t step = 32 * N) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t desc = fm::kmajor_desc(fm::pinned(b + kk * step), 128, 256);
    if constexpr (N == 64)
      fm::wgmma_rs_n64(acc, a[kk], desc, 1);
    else
      fm::wgmma_rs_n128(acc, a[kk], desc, 1);
  }
}

template <int R>
__device__ __forceinline__ void finish(float (&acc)[R]) {
  fm::wgmma_commit();
  fm::wgmma_wait<0>();
  fm::fence_regs(acc);
}

// bf16 fragments of f(acc) (see Frag)
template <int KS, typename F>
__device__ __forceinline__ void to_frags(uint32_t (&f)[KS][4], const float (&acc)[8 * KS], F fn) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = fm::pack_bf16(fn(acc[8 * kk + 2 * r]), fn(acc[8 * kk + 2 * r + 1]));
}

// LayerNorm of the thread's two rows of a [64, C] accumulator (rounded to
// bf16 first, statistics in f32, a row's 64 values over the lane's quad), in
// place; scale and bias [C] in shared memory
__device__ __forceinline__ void layer_norm(float (&a)[32], const float* sc, const float* bi,
                                           int t) {
  float rs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        a[4 * j + 2 * i + e] = fm::round_bf16(a[4 * j + 2 * i + e]);
        s += a[4 * j + 2 * i + e];
      }
    const float mu = quad_sum(s) * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        a[4 * j + 2 * i + e] -= mu;
        q += a[4 * j + 2 * i + e] * a[4 * j + 2 * i + e];
      }
    rs[i] = rsqrtf(quad_sum(q) * (1.0f / C) + fm::kLnEps);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // a column pair's scale and bias, loaded once for both rows
    const float2 s2 = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t);
    const float2 b2 = *reinterpret_cast<const float2*>(bi + 8 * j + 2 * t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[4 * j + 2 * i] = a[4 * j + 2 * i] * rs[i] * s2.x + b2.x;
      a[4 * j + 2 * i + 1] = a[4 * j + 2 * i + 1] * rs[i] * s2.y + b2.y;
    }
  }
}

// A thread's place in its warpgroup's pair: lane coordinates, the rows of
// its warp, and the element offsets it reads and writes in the pair's
// scratch, each a base plus compile-time steps (kmajor_index of the K | V
// tile, with m = lane / 8 and rr = lane % 8 for ldmatrix rows)
struct Lane {
  int wg, warp, lane, g, t, wr;
  int kv_st;   // (wr + g, 2 t); + 64 (16 i + j) for row + 8 i, column + 8 j
  int kv_a;    // K^T's ldmatrix row (8 (m >> 1) + rr, 16 warp + 8 (m & 1)); + 2048 a k-step
  int kv_b;    // V's (8 (m & 1) + rr, C + 16 warp + 8 (m >> 1)); likewise
  int kvd_st;  // (g, 2 t) of tile `warp` of K^T V in fragment order
  __device__ explicit Lane(int tid)
      : wg(tid >> 7), warp((tid >> 5) & 3), lane(tid & 31), g(lane >> 2), t(lane & 3),
        wr(16 * warp) {
    const int m = lane >> 3, rr = lane & 7;
    kv_st = 2048 * warp + 8 * g + 2 * t;
    kv_a = ((m >> 1) * 16 + 2 * warp + (m & 1)) * 64 + 8 * rr;
    kv_b = ((m & 1) * 16 + 8 + 2 * warp + (m >> 1)) * 64 + 8 * rr;
    kvd_st = 256 * warp + 64 * t + 8 * (g >> 1) + (g & 1);
  }
};

// x = enc(x, src) with src = other (cross) or x, for the warpgroup's pair;
// wimg: the layer's image (shared address), ln: its LN parameters [4][C]
template <int D>
__device__ __forceinline__ void encoder(Frag& x, const Frag& other, bool cross, uint32_t wimg,
                                        const float* ln, unsigned char* ps, int N, const Lane& th) {
  const int wg = th.wg, lane = th.lane, g = th.g, t = th.t, wr = th.wr;
  bf16* kv = reinterpret_cast<bf16*>(ps + KV_OFF);
  bf16* kvd = reinterpret_cast<bf16*>(ps + KVD_OFF);
  float* ks = reinterpret_cast<float*>(ps + KS_OFF);
  const float inv_n = 1.0f / (float)N, n_f = (float)N;

  // [K | V] = [elu(src . wk) + 1 | src . wv / N], no mass past N, into the K | V tile
  {
    Frag src;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) src[kk][r] = cross ? other[kk][r] : x[kk][r];
    float acc[64];
    fm::zero_regs(acc);
    fm::wgmma_fence();
    product<2 * C, 4>(acc, src, wimg + WKV_OFF);
    finish(acc);
    // at D = 64 the last call's K^T V lies in the K | V tile: every warp
    // has read it first
    if (D == 64) fm::named_barrier(1 + wg, 128);
    const uint32_t live[2] = {wr + g < N ? ~0u : 0u, wr + g + 8 < N ? ~0u : 0u};  // rows
#pragma unroll
    for (int j = 0; j < 16; ++j)  // 8-column strips: K's 8, then V's
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
        if (j < 8) {
          v0 = elu1(v0);
          v1 = elu1(v1);
        } else {
          v0 *= inv_n;
          v1 *= inv_n;
        }
        *reinterpret_cast<uint32_t*>(kv + th.kv_st + 64 * (16 * i + j)) =
            fm::pack_bf16(v0, v1) & live[i];
      }
  }
  // Q = bf16(elu(x . wq) + 1), as fragments
  Frag q;
  {
    float acc[32];
    fm::zero_regs(acc);
    fm::wgmma_fence();
    product<C, 4>(acc, x, wimg + WQ_OFF);
    finish(acc);
    to_frags(q, acc, [](float v) { return elu1(v); });
  }
  fm::named_barrier(1 + wg, 128);
  // warp w: the diagonal 16x16 tile w of K^T V, masked to its heads' D x D
  // blocks (at D = 64: row strip w, its four tiles), into fragment order;
  // the same K^T fragments times ones: K_sum
  {
    const int j = th.warp;
    constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 ones
    constexpr int NT = D == 64 ? 4 : 1;      // the warp's tiles
    fm::Acc16 acc[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) fm::zero(acc[n]);
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t fa[4], fb[4];
      fm::ldsm_x4_trans(fa, kv + th.kv_a + 2048 * kk);  // K^T: A[i][k] = K[k][i]
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // V's strip n (D = 64), else the warp's own: V's ldmatrix rows move
        // 16 columns (two 8-column steps of 64 elements) a strip
        fm::ldsm_x4_trans(fb, kv + th.kv_b + 2048 * kk + (D == 64 ? 128 * (n - j) : 0));
        fm::mma16(acc[n], fa, fb);
      }
      fm::mma16x8(sum, fa, kOnes, kOnes);
    }
    if (D == 64) {
      kvd = kv;  // over the K | V tile, once every warp has read it
      fm::named_barrier(1 + wg, 128);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // (row g + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 t + (e & 1)) of the tile;
        // with D = 8 the two heads' blocks are (rows 0-7, columns 0-7), (8-15, 8-15);
        // at D = 64 tile n of strip j is tile 4 j + n
        const float v = (D != 8 || ((e >> 1) & 1) == (e >> 2)) ? acc[n].c[e] : 0.f;
        kvd[th.kvd_st + (D == 64 ? 256 * (3 * j + n) : 0) + 32 * (e & 1) + 2 * ((e >> 1) & 1) +
            4 * (e >> 2)] = __float2bfloat16(v);
      }
    if (t == 0) {
      ks[16 * j + g] = fm::round_bf16(sum[0]);
      ks[16 * j + g + 8] = fm::round_bf16(sum[2]);
    }
  }
  fm::named_barrier(1 + wg, 128);
  // Z = Q_h . K_sum_h over the quad; o = Q . KV_bd * (N / (Z + eps)), as fragments
  Frag o;
  if (D == 64) {  // one head: Z over all 64 features, each output tile over four products
    float z[2] = {0.f, 0.f};  // rows g and g + 8
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 k0 = *reinterpret_cast<const float2*>(ks + 16 * kk + 2 * t);
      const float2 k1 = *reinterpret_cast<const float2*>(ks + 16 * kk + 8 + 2 * t);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 qv = unpack2(q[kk][r]), kc = r < 2 ? k0 : k1;
        z[r & 1] += qv.x * kc.x + qv.y * kc.y;
      }
    }
    const float sc[2] = {__fdividef(n_f, quad_sum(z[0]) + kEps),
                         __fdividef(n_f, quad_sum(z[1]) + kEps)};  // z > 0: Q, K > 0
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      fm::Acc16 acc;
      fm::zero(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 bv = *reinterpret_cast<const uint4*>(kvd + (4 * kk + jn) * 256 + lane * 8);
        const uint32_t fb[4] = {bv.x, bv.y, bv.z, bv.w};
        fm::mma16(acc, q[kk], fb);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        o[jn][r] = fm::pack_bf16(acc.c[2 * r] * sc[r & 1], acc.c[2 * r + 1] * sc[r & 1]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4 && D != 64; ++kk) {
    const float2 k0 = *reinterpret_cast<const float2*>(ks + 16 * kk + 2 * t);
    const float2 k1 = *reinterpret_cast<const float2*>(ks + 16 * kk + 8 + 2 * t);
    float z[4];  // (row g, columns 0-7 of the tile), (row g + 8, 0-7), (g, 8-15), (g + 8, 8-15)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 qv = unpack2(q[kk][r]), kc = r < 2 ? k0 : k1;
      z[r] = qv.x * kc.x + qv.y * kc.y;
    }
    if (D == 16) {  // one head a tile
      z[0] = quad_sum(z[0] + z[2]);
      z[1] = quad_sum(z[1] + z[3]);
      z[2] = z[0];
      z[3] = z[1];
    } else {  // two heads a tile
#pragma unroll
      for (int r = 0; r < 4; ++r) z[r] = quad_sum(z[r]);
    }
    const uint4 bv = *reinterpret_cast<const uint4*>(kvd + kk * 256 + lane * 8);
    const uint32_t fb[4] = {bv.x, bv.y, bv.z, bv.w};
    fm::Acc16 acc;
    fm::zero(acc);
    fm::mma16(acc, q[kk], fb);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float s = __fdividef(n_f, z[r] + kEps);  // z > 0: Q, K > 0
      o[kk][r] = fm::pack_bf16(acc.c[2 * r] * s, acc.c[2 * r + 1] * s);
    }
  }
  // msg = bf16(LN1(bf16(o . wmerge))), as fragments
  Frag msg;
  {
    float acc[32];
    fm::zero_regs(acc);
    fm::wgmma_fence();
    product<C, 4>(acc, o, wimg + WM_OFF);
    finish(acc);
    layer_norm(acc, ln, ln + C, t);
    to_frags(msg, acc, [](float v) { return v; });
  }
  // hidden = bf16(relu(x . w1[:C] + msg . w1[C:])), as fragments, in two
  // halves of 64 columns (hidden k-steps 4 h .. 4 h + 3 of the next product)
  uint32_t hid[8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float acc[32];
    fm::zero_regs(acc);
    fm::wgmma_fence();
    product<C, 4>(acc, x, wimg + W1_OFF + h * 32 * C, 32 * 2 * C);
    product<C, 4>(acc, msg, wimg + W1_OFF + 4 * 32 * 2 * C + h * 32 * C, 32 * 2 * C);
    finish(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        hid[4 * h + kk][r] = pack_relu(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
  }
  // x = x + bf16(LN2(bf16(hidden . w2)))
  {
    float acc[32];
    fm::zero_regs(acc);
    fm::wgmma_fence();
    product<C, 8>(acc, hid, wimg + W2_OFF);
    finish(acc);
    layer_norm(acc, ln + 2 * C, ln + 3 * C, t);
    // bf16 + bf16 as one bf16x2 add: the exact sum rounded once, as the f32
    // sum of two bf16 values rounded to bf16 is
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t y = fm::pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
        const __nv_bfloat162 sum = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&x[kk][r]),
                                           *reinterpret_cast<const __nv_bfloat162*>(&y));
        x[kk][r] = *reinterpret_cast<const uint32_t*>(&sum);
      }
  }
}

// the window's rows [0, N) of `pair` into fragments, zeros past N
__device__ __forceinline__ void load_window(Frag& x, const bf16* __restrict__ w, int pair, int N,
                                            const Lane& th) {
  const int row = th.wr + th.g;  // and row + 8
  const bf16* base = w + ((size_t)pair * N + row) * C + 2 * th.t;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned int* p =
          reinterpret_cast<const unsigned int*>(base + 8 * C * (r & 1) + 16 * kk + 8 * (r >> 1));
      x[kk][r] = row + 8 * (r & 1) < N ? __ldg(p) : 0u;
    }
}

__device__ __forceinline__ void store_window(const Frag& x, bf16* w, int pair, int N,
                                             const Lane& th) {
  const int row = th.wr + th.g;
  bf16* base = w + ((size_t)pair * N + row) * C + 2 * th.t;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (row + 8 * (r & 1) < N)
        *reinterpret_cast<uint32_t*>(base + 8 * C * (r & 1) + 16 * kk + 8 * (r >> 1)) = x[kk][r];
}

// this warp's column sums of mix[r] * x[r] over its 16 rows, into out[C]
// (lanes of g = 0)
__device__ __forceinline__ void mix_partial(const Frag& x, const float* mixw, float* out, int wr,
                                            int g, int t) {
  const float m0 = mixw[wr + g], m1 = mixw[wr + g + 8];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 a = unpack2(x[kk][2 * h]), b = unpack2(x[kk][2 * h + 1]);
      const float p0 = fm::column_sum(m0 * a.x + m1 * b.x), p1 = fm::column_sum(m0 * a.y + m1 * b.y);
      if (g == 0) *reinterpret_cast<float2*>(out + 16 * kk + 8 * h + 2 * t) = make_float2(p0, p1);
    }
}

// out[r] = m . x[r] / sqrt(C) for the warp's 16 rows (lanes of t = 0)
__device__ __forceinline__ void heat_logits(const Frag& x, const float* m, float* out, int wr,
                                            int g, int t) {
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 mm = *reinterpret_cast<const float2*>(m + 16 * kk + 8 * h + 2 * t);
      const float2 a = unpack2(x[kk][2 * h]), b = unpack2(x[kk][2 * h + 1]);
      d0 += mm.x * a.x + mm.y * a.y;
      d1 += mm.x * b.x + mm.y * b.y;
    }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (t == 0) {
    out[wr + g] = d0 * (1.0f / 8.0f);  // 1 / sqrt(64)
    out[wr + g + 8] = d1 * (1.0f / 8.0f);
  }
}

// kPairs warpgroups, each taking the pairs blockIdx.x + k gridDim.x, k = wg,
// wg + kPairs, ...
template <int D>
__global__ void __launch_bounds__(kThreads, 1) fine_stage_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.layers, N = a.N;
  float* lns = reinterpret_cast<float*>(smem + ln_off(L));
  float* mixw = reinterpret_cast<float*>(smem + mixw_off(L));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + bar_off(L));
  const Lane th(threadIdx.x);
  const int wg = th.wg, warp = th.warp, lane = th.lane, g = th.g, t = th.t, wr = th.wr;
  const int wt = threadIdx.x & 127;
  unsigned char* ps = smem + pair_off(L) + wg * kPairBytes;
  float* mixp = reinterpret_cast<float*>(ps + MIXP_OFF);
  float* mc = reinterpret_cast<float*>(ps + M_OFF);
  float* sim = reinterpret_cast<float*>(ps + SIM_OFF);

  if (threadIdx.x == 0) {
    fm::mbar_init(bar, 1);
    fm::mbar_init_fence();
    fm::mbar_arrive_expect(bar, L * kImageBytes);
    for (int l = 0; l < L; ++l)
      for (uint32_t off = 0; off < kImageBytes; off += kCopyBytes)
        fm::bulk_load(smem + l * kImageBytes + off, (l == 0 ? a.image[0] : a.image[1]) + off,
                      kCopyBytes, bar);
  }
  // (the parameter arrays only at constant indices: no copy of them in local memory)
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      for (int c = threadIdx.x; c < C; c += blockDim.x)
        lns[(4 * l + i) * C + c] = (l == 0 ? a.ln[0][i] : a.ln[1][i])[c];
  for (int e = threadIdx.x; e < 2 * NP; e += blockDim.x) {
    const int r = e % NP;
    mixw[e] = r < N ? fm::round_bf16((e < NP ? a.mix_w[0] : a.mix_w[1])[r]) : 0.f;
  }
  __syncthreads();
  const float mb0 = fm::round_bf16(__ldg(a.mix_b[0])), mb1 = fm::round_bf16(__ldg(a.mix_b[1]));

  for (int k = wg;; k += kPairs) {
    const int pair = blockIdx.x + k * gridDim.x;
    if (pair >= a.B) break;
    Frag x0, x1;
    load_window(x0, a.win[0], pair, N, th);
    load_window(x1, a.win[1], pair, N, th);
    fm::mbar_wait(bar, 0);  // the images are in
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      const bool cross = (a.cross >> l) & 1;
      const uint32_t wimg = fm::smem_u32(smem) + l * kImageBytes;
      const float* ln = lns + l * 4 * C;
      encoder<D>(x0, x1, cross, wimg, ln, ps, N, th);
      encoder<D>(x1, x0, cross, wimg, ln, ps, N, th);
    }
    // m_s = bf16(bf16(sum_r mix_s[r] w_s[r]) + bf16(bias_s)): each warp's
    // column sums, then the 4 warps' in order
    mix_partial(x0, mixw, mixp + warp * 2 * C, wr, g, t);
    mix_partial(x1, mixw + NP, mixp + warp * 2 * C + C, wr, g, t);
    fm::named_barrier(1 + wg, 128);
    {
      const float* p = mixp + wt;  // wt = s * C + c
      const float m = fm::round_bf16(
          fm::round_bf16(((p[0] + p[2 * C]) + p[4 * C]) + p[6 * C]) + (wt < C ? mb0 : mb1));
      mc[wt] = m;
      if (!a.fold)
        (wt < C ? a.mout[0] : a.mout[1])[(size_t)pair * C + wt % C] = __float2bfloat16(m);
    }
    fm::named_barrier(1 + wg, 128);
    if (a.fold) {
      // heat_s = softmax over the live taps of (m_s . w_{1-s}[r]) / sqrt(C): warp s
      heat_logits(x1, mc, sim, wr, g, t);
      heat_logits(x0, mc + C, sim + NP, wr, g, t);
      fm::named_barrier(1 + wg, 128);
      if (warp < 2) {
        const int s = warp;
        const float v0 = lane < N ? sim[s * NP + lane] : -1e30f;  // no padded taps
        const float v1 = lane + 32 < N ? sim[s * NP + lane + 32] : -1e30f;
        const float mx = fm::warp_max(fmaxf(v0, v1));
        const float e0 = expf(v0 - mx), e1 = expf(v1 - mx);
        const float inv = 1.0f / fm::warp_sum(e0 + e1);
        float* out = (s == 0 ? a.heat[0] : a.heat[1]) + (size_t)pair * N;
        if (lane < N) out[lane] = e0 * inv;
        if (lane + 32 < N) out[lane + 32] = e1 * inv;
      }
    } else {
      store_window(x0, a.wout[0], pair, N, th);
      store_window(x1, a.wout[1], pair, N, th);
    }
  }
}

template <int D>
cudaError_t set_smem(int layers, size_t* bytes) {
  *bytes = smem_bytes(layers);
  return cudaFuncSetAttribute(fine_stage_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

// the persistent grid: a block an SM, none without a pair
int grid_for(int B, int sms) {
  const int blocks = (B + kPairs - 1) / kPairs;
  return sms < blocks ? sms : blocks;
}

template <int D>
cudaError_t launch(const Args& a, int sms, cudaStream_t st) {
  size_t bytes;
  cudaError_t e = set_smem<D>(a.layers, &bytes);
  if (e != cudaSuccess) return e;
  fine_stage_kernel<D><<<grid_for(a.B, sms), kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t occupancy(int layers, int B, int sms, int* info) {
  size_t bytes;
  cudaError_t e = set_smem<D>(layers, &bytes);
  if (e != cudaSuccess) return e;
  info[0] = kPairs;
  info[1] = (int)bytes;
  info[3] = grid_for(B, sms);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], fine_stage_kernel<D>, kThreads,
                                                       bytes);
}

}  // namespace

FM_ERROR_STRING_ENTRY

// w0, w1: [B, N, C=64] bf16 windows (N <= 64). Layer l (the second's
// pointers null when layers == 1): image, the layer's weight image
// (ops/fine_stage.fine_image, 81920 bytes, 16-byte aligned), then n1s, n1b,
// n2s, n2b f32 [C]. mix weights f32 [N], biases f32 [1]. fold: heat0, heat1
// f32 [B, N]; else wout0, wout1 bf16 [B, N, C] and mout0, mout1 bf16 [B, C].
// cross: bit l set when layer l is a cross layer. D: head dim (8, 16 or 64).
// sms: the card's SMs.
extern "C" int fm_fine_stage(const void* w0, const void* w1, const void* img0, const void* l0_1,
                             const void* l0_2, const void* l0_3, const void* l0_4,
                             const void* img1, const void* l1_1, const void* l1_2,
                             const void* l1_3, const void* l1_4, const void* mix_w0,
                             const void* mix_b0, const void* mix_w1, const void* mix_b1,
                             void* out0, void* out1, void* mout0, void* mout1, int B, int N,
                             int D, int layers, int cross, int fold, int sms, void* stream) {
  if (N < 1 || N > NP || (D != 8 && D != 16 && D != 64) || layers < 1 || layers > kMaxLayers ||
      B < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const void* lp[kMaxLayers][5] = {{img0, l0_1, l0_2, l0_3, l0_4},
                                   {img1, l1_1, l1_2, l1_3, l1_4}};
  Args a{};
  a.win[0] = static_cast<const bf16*>(w0);
  a.win[1] = static_cast<const bf16*>(w1);
  for (int l = 0; l < layers; ++l) {
    a.image[l] = static_cast<const unsigned char*>(lp[l][0]);
    for (int i = 0; i < 4; ++i) a.ln[l][i] = static_cast<const float*>(lp[l][1 + i]);
  }
  a.mix_w[0] = static_cast<const float*>(mix_w0);
  a.mix_b[0] = static_cast<const float*>(mix_b0);
  a.mix_w[1] = static_cast<const float*>(mix_w1);
  a.mix_b[1] = static_cast<const float*>(mix_b1);
  if (fold) {
    a.heat[0] = static_cast<float*>(out0);
    a.heat[1] = static_cast<float*>(out1);
  } else {
    a.wout[0] = static_cast<bf16*>(out0);
    a.wout[1] = static_cast<bf16*>(out1);
    a.mout[0] = static_cast<bf16*>(mout0);
    a.mout[1] = static_cast<bf16*>(mout1);
  }
  a.B = B;
  a.N = N;
  a.layers = layers;
  a.cross = cross;
  a.fold = fold;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D == 8 ? launch<8>(a, sms, st)
                      : (D == 16 ? launch<16>(a, sms, st) : launch<64>(a, sms, st)));
}

// info: the block's pairs in flight, its dynamic shared memory in bytes, the
// blocks an SM can hold and the grid for B pairs, at (layers, D)
extern "C" int fm_fine_stage_occupancy(int layers, int D, int B, int sms, int* info) {
  if ((D != 8 && D != 16 && D != 64) || layers < 1 || layers > kMaxLayers || B < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  return (int)(D == 8    ? occupancy<8>(layers, B, sms, info)
               : D == 16 ? occupancy<16>(layers, B, sms, info)
                         : occupancy<64>(layers, B, sms, info));
}
