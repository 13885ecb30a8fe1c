// The whole fine stage on one pair of match windows at a time:
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
// 128 bytes of window in and 4 bytes of heatmap out). Design:
//   - A block takes one window pair at a time (the unit of work: the cross
//     layer needs both windows) and loops over pairs; three blocks share an
//     SM. The layers' weights (160 KB in bf16), stored in tensor-core
//     fragment order (tiles.cuh), are read from L1/L2 with one 16-byte load
//     a lane for each 16x16 tile, where every block of the SM finds them.
//     Holding them in shared memory instead (one block an SM) measured 1.6x
//     slower: eight warps an SM cannot hide the latency of the block's
//     barrier-separated phases.
//   - The 49 taps are padded to 64 rows (four 16-row tensor-core tiles) and
//     masked: padded taps get no key or value mass, a mixing weight of zero,
//     and no heatmap entry.
//   - Head dim 8 is below the tensor cores' K of 16, so attention keeps the
//     TPU kernel's block-diagonal form: K^T V is formed only on its four
//     diagonal 16x16 tiles and masked to the 8x8 head blocks, and o = Q . KV
//     is one 16-deep product per column tile.
//   - Every intermediate of a window (Q, K | V, the FFN hidden, msg) lives
//     in shared memory; only the windows are read and the heatmaps written.
//
// Rounding follows the TPU kernel: K and V/N rounded after the f32 product
// and feature map; K_sum rounded to bf16; o * (N / (Z + eps)) in f32,
// rounded once; each product rounded to bf16 before its LayerNorm; the
// residual add is bf16 + bf16; the mix sum is rounded, then the bias added
// in bf16; heatmaps in f32.

#include "tiles.cuh"

namespace {

using fm::bf16;

constexpr int C = 64;
constexpr int NP = 64;  // taps padded to four 16-row tiles
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLayers = 2;
constexpr int kMaxHeads = 8;
constexpr float kEps = 1e-6f;
constexpr int LDA = C + 8;       // window / Q / msg rows
constexpr int LDKV = 2 * C + 8;  // K | V rows, then FFN hidden rows

constexpr int kMinBlocks = 3;  // blocks an SM

// the activations of one window pair in shared memory
constexpr size_t A0_OFF = 0;
constexpr size_t A1_OFF = A0_OFF + NP * LDA * 2;
constexpr size_t Q_OFF = A1_OFF + NP * LDA * 2;
constexpr size_t KV_OFF = Q_OFF + NP * LDA * 2;
constexpr size_t MSG_OFF = KV_OFF + NP * LDKV * 2;
constexpr size_t KVD_OFF = MSG_OFF + NP * LDA * 2;   // bf16 [4][16][16] diagonal tiles
constexpr size_t KSUM_OFF = KVD_OFF + 4 * 256 * 2;   // f32 [C] (bf16 values)
constexpr size_t Z_OFF = KSUM_OFF + C * 4;           // f32 [NP][kMaxHeads]
constexpr size_t MIX_OFF = Z_OFF + NP * kMaxHeads * 4;  // f32 [2][NP] weights (bf16 values)
constexpr size_t M_OFF = MIX_OFF + 2 * NP * 4;       // f32 [2][C] mixed centres
constexpr size_t kSmemBytes = M_OFF + 2 * C * 4;
static_assert(kMinBlocks * (kSmemBytes + 1024) <= 233472, "shared memory of an SM");

struct LayerArgs {
  const bf16 *wq, *wkv, *wmerge;
  const float *n1s, *n1b;
  const bf16 *w1, *w2;
  const float *n2s, *n2b;
};

struct Args {
  const bf16* win[2];  // [B, N, C] windows of image 0 and 1
  LayerArgs layer[kMaxLayers];
  const float* mix_w[2];  // [N]
  const float* mix_b[2];  // [1]
  float* heat[2];         // fold: [B, N]
  bf16* wout[2];          // plain: [B, N, C]
  bf16* mout[2];          // plain: [B, C]
  int B, N, D, layers, cross, fold;
};

struct Bufs {
  bf16 *q, *kv, *msg, *kvd;
  float *ksum, *z;
};

// x = enc(x, src) with one layer's weights (global memory); N live taps
__device__ void encoder(bf16* x, const bf16* src, const LayerArgs& W,
                        const Bufs& b, int N, int D, int warp, int lane) {
  const float inv_n = 1.0f / (float)N, n_f = (float)N;
  // Q = elu(x . wq) + 1;  [K | V] = [elu(src . wk) + 1 | src . wv / N], no mass past N
  fm::gemm_rows64<kWarps, C, C / 16>(x, LDA, W.wq, 0, warp, lane,
                                     [&](int r, int c, float v) {
                                       b.q[r * LDA + c] = __float2bfloat16(fm::elu1(v));
                                     });
  fm::gemm_rows64<kWarps, C, 2 * C / 16>(
      src, LDA, W.wkv, 0, warp, lane, [&](int r, int c, float v) {
        float o = 0.f;
        if (r < N) o = c < C ? fm::elu1(v) : v * inv_n;
        b.kv[r * LDKV + c] = __float2bfloat16(o);
      });
  __syncthreads();
  if (warp < 4) {
    // diagonal tile `warp` of K^T V, masked to the heads' D x D blocks
    fm::Acc16 acc;
    fm::zero(acc);
#pragma unroll
    for (int k = 0; k < NP / 16; ++k) {
      uint32_t fa[4], fb[4];
      fm::load_a_trans(fa, b.kv + k * 16 * LDKV + warp * 16, LDKV, lane);
      fm::load_b(fb, b.kv + k * 16 * LDKV + C + warp * 16, LDKV, lane);
      fm::mma16(acc, fa, fb);
    }
    fm::tile_epilogue(acc, 0, 0, lane, [&](int r, int c, float v) {
      const bool same = (warp * 16 + r) / D == (warp * 16 + c) / D;
      b.kvd[warp * 256 + r * 16 + c] = __float2bfloat16(same ? v : 0.f);
    });
  } else if (threadIdx.x < 4 * 32 + C) {
    const int c = threadIdx.x - 4 * 32;
    float s = 0.f;
    for (int r = 0; r < N; ++r) s += __bfloat162float(b.kv[r * LDKV + c]);
    b.ksum[c] = fm::round_bf16(s);
  }
  __syncthreads();
  // Z[r][h] = Q[r, head h] . K_sum[head h]
  const int H = C / D;
  for (int e = threadIdx.x; e < NP * H; e += kThreads) {
    const int r = e / H, h = e % H;
    float z = 0.f;
    for (int d = 0; d < D; ++d) z += __bfloat162float(b.q[r * LDA + h * D + d]) * b.ksum[h * D + d];
    b.z[r * kMaxHeads + h] = z;
  }
  __syncthreads();
  // o = Q . KV_bd * (N / (Z + eps)) over Q in place; tile (tm, j) reads only itself
  for (int u = warp; u < 16; u += kWarps) {
    const int tm = u / 4, j = u % 4;
    uint32_t fa[4], fb[4];
    fm::Acc16 acc;
    fm::zero(acc);
    fm::load_a(fa, b.q + tm * 16 * LDA + j * 16, LDA, lane);
    fm::load_b(fb, b.kvd + j * 256, 16, lane);
    fm::mma16(acc, fa, fb);
    fm::tile_epilogue(acc, tm * 16, j * 16, lane, [&](int row, int col, float v) {
      b.q[row * LDA + col] = __float2bfloat16(v * (n_f / (b.z[row * kMaxHeads + col / D] + kEps)));
    });
  }
  __syncthreads();
  // msg = LN1(o . wmerge)
  fm::gemm_rows64<kWarps, C, C / 16>(b.q, LDA, W.wmerge, 0, warp, lane,
                                     [&](int r, int c, float v) {
                                       b.msg[r * LDA + c] = __float2bfloat16(v);
                                     });
  __syncthreads();
  fm::layer_norm_rows64<kWarps, C>(b.msg, LDA, W.n1s, W.n1b, warp, lane);
  __syncthreads();
  // hidden = relu(x . w1[:C] + msg . w1[C:]) over the K | V buffer
  fm::gemm_rows64_split<kWarps, C, C, 2 * C / 16>(
      x, LDA, b.msg, LDA, W.w1, 0, warp, lane, [&](int r, int c, float v) {
        b.kv[r * LDKV + c] = __float2bfloat16(fmaxf(v, 0.f));
      });
  __syncthreads();
  // y = hidden . w2 into the Q buffer, then x = x + LN2(y)
  fm::gemm_rows64<kWarps, 2 * C, C / 16>(b.kv, LDKV, W.w2, 0, warp, lane,
                                         [&](int r, int c, float v) {
                                           b.q[r * LDA + c] = __float2bfloat16(v);
                                         });
  __syncthreads();
  constexpr int V = C / 32;
  float sv[V], bv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sv[i] = W.n2s[lane * V + i];
    bv[i] = W.n2b[lane * V + i];
  }
  for (int r = warp; r < NP; r += kWarps) {
    float y[V], xr[V];
    fm::load_bf16<V>(b.q + r * LDA + lane * V, y);
    fm::warp_layer_norm<V, C>(y, sv, bv);
    fm::load_bf16<V>(x + r * LDA + lane * V, xr);
#pragma unroll
    for (int i = 0; i < V; ++i) y[i] = xr[i] + fm::round_bf16(y[i]);
    fm::store_bf16<V>(x + r * LDA + lane * V, y);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) fine_stage_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* win[2] = {reinterpret_cast<bf16*>(smem + A0_OFF), reinterpret_cast<bf16*>(smem + A1_OFF)};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Bufs b{reinterpret_cast<bf16*>(smem + Q_OFF), reinterpret_cast<bf16*>(smem + KV_OFF),
               reinterpret_cast<bf16*>(smem + MSG_OFF), reinterpret_cast<bf16*>(smem + KVD_OFF),
               reinterpret_cast<float*>(smem + KSUM_OFF), reinterpret_cast<float*>(smem + Z_OFF)};
  float* mixw = reinterpret_cast<float*>(smem + MIX_OFF);
  float* mc = reinterpret_cast<float*>(smem + M_OFF);
  const int N = a.N;

  for (int e = threadIdx.x; e < 2 * NP; e += kThreads) {
    const int s = e / NP, r = e % NP;
    mixw[e] = r < N ? fm::round_bf16(a.mix_w[s][r]) : 0.f;
  }
  __syncthreads();

  for (int pair = blockIdx.x; pair < a.B; pair += gridDim.x) {
    for (int s = 0; s < 2; ++s)
      fm::copy_rows_to_smem(win[s], LDA, a.win[s] + (size_t)pair * N * C, C, NP, C, N);
    __syncthreads();
    for (int l = 0; l < a.layers; ++l) {
      const bool cross = (a.cross >> l) & 1;
      encoder(win[0], cross ? win[1] : win[0], a.layer[l], b, N, a.D, warp, lane);
      encoder(win[1], win[cross ? 0 : 1], a.layer[l], b, N, a.D, warp, lane);
    }
    // m_s = bf16(bf16(sum_r mix_s[r] win_s[r]) + bf16(bias_s))
    if (threadIdx.x < 2 * C) {
      const int s = threadIdx.x / C, c = threadIdx.x % C;
      float acc = 0.f;
      for (int r = 0; r < N; ++r) acc += mixw[s * NP + r] * __bfloat162float(win[s][r * LDA + c]);
      mc[threadIdx.x] = fm::round_bf16(fm::round_bf16(acc) + fm::round_bf16(a.mix_b[s][0]));
    }
    __syncthreads();
    if (a.fold) {
      // heat_s = softmax over the live taps of (m_s . win_{1-s}[r]) / sqrt(C): warp s
      if (warp < 2) {
        const int s = warp;
        const bf16* other = win[1 - s];
        const float* m = mc + s * C;
        float sim[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int r = lane + 32 * k;
          float acc = 0.f;
          for (int c = 0; c < C; ++c) acc += m[c] * __bfloat162float(other[r * LDA + c]);
          sim[k] = r < N ? acc * (1.0f / 8.0f) : -1e30f;  // 1 / sqrt(64); no padded taps
        }
        const float mx = fm::warp_max(fmaxf(sim[0], sim[1]));
        const float e0 = expf(sim[0] - mx), e1 = expf(sim[1] - mx);
        const float inv = 1.0f / fm::warp_sum(e0 + e1);
        float* out = a.heat[s] + (size_t)pair * N;
        if (lane < N) out[lane] = e0 * inv;
        if (lane + 32 < N) out[lane + 32] = e1 * inv;
      }
    } else {
      for (int s = 0; s < 2; ++s) {
        bf16* out = a.wout[s] + (size_t)pair * N * C;
        for (int e = threadIdx.x; e < N * C / 8; e += kThreads) {
          const int r = e / (C / 8), c = (e % (C / 8)) * 8;
          *reinterpret_cast<uint4*>(out + r * C + c) =
              *reinterpret_cast<const uint4*>(win[s] + r * LDA + c);
        }
      }
      if (threadIdx.x < 2 * C)
        a.mout[threadIdx.x / C][(size_t)pair * C + threadIdx.x % C] =
            __float2bfloat16(mc[threadIdx.x]);
    }
    __syncthreads();
  }
}

}  // namespace

FM_ERROR_STRING_ENTRY

// w0, w1: [B, N, C=64] bf16 windows (N <= 64). layers: 9 pointers each (wq
// [C, C], wkv [C, 2C], wmerge [C, C] bf16; n1s, n1b f32 [C]; w1 [2C, 2C],
// w2 [2C, C] bf16; n2s, n2b f32 [C]; weights [in, out] in fragment order),
// the second null when layers == 1.
// mix weights f32 [N], biases f32 [1]. fold: heat0, heat1 f32 [B, N]; else
// wout0, wout1 bf16 [B, N, C] and mout0, mout1 bf16 [B, C]. cross: bit l set
// when layer l is a cross layer. D: head dim (8 or 16). sms: the card's SMs.
extern "C" int fm_fine_stage(const void* w0, const void* w1, const void* const l0_0,
                             const void* l0_1, const void* l0_2, const void* l0_3,
                             const void* l0_4, const void* l0_5, const void* l0_6,
                             const void* l0_7, const void* l0_8, const void* l1_0,
                             const void* l1_1, const void* l1_2, const void* l1_3,
                             const void* l1_4, const void* l1_5, const void* l1_6,
                             const void* l1_7, const void* l1_8, const void* mix_w0,
                             const void* mix_b0, const void* mix_w1, const void* mix_b1,
                             void* out0, void* out1, void* mout0, void* mout1, int B, int N,
                             int D, int layers, int cross, int fold, int sms, void* stream) {
  if (N < 1 || N > NP || (D != 8 && D != 16) || layers < 1 || layers > kMaxLayers || B < 1 ||
      sms < 1)
    return (int)cudaErrorInvalidValue;
  const void* lp[kMaxLayers][9] = {{l0_0, l0_1, l0_2, l0_3, l0_4, l0_5, l0_6, l0_7, l0_8},
                                   {l1_0, l1_1, l1_2, l1_3, l1_4, l1_5, l1_6, l1_7, l1_8}};
  Args a{};
  a.win[0] = static_cast<const bf16*>(w0);
  a.win[1] = static_cast<const bf16*>(w1);
  for (int l = 0; l < layers; ++l) {
    auto Bf = [&](int i) { return static_cast<const bf16*>(lp[l][i]); };
    auto F = [&](int i) { return static_cast<const float*>(lp[l][i]); };
    a.layer[l] = LayerArgs{Bf(0), Bf(1), Bf(2), F(3), F(4), Bf(5), Bf(6), F(7), F(8)};
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
  a.D = D;
  a.layers = layers;
  a.cross = cross;
  a.fold = fold;
  cudaError_t e = cudaFuncSetAttribute(
      fine_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  // as many blocks as the SMs hold, at most one a pair
  const int grid = kMinBlocks * sms < B ? kMinBlocks * sms : B;
  fine_stage_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
