// K10: the backward of one fine-window encoder call, o = enc(x, src) over G
// windows of N <= 64 taps at C = 64 (the forward is K6's kernel, one layer
// at a time, fine_stage.cu).
//
// Replaces featurematching_tpu/ops/pallas_fine_grad.py ·
// fine_transformer_train (_fine_bwd_kernel through _layer_bwd_call:
// _enc_fwd_stash, then _enc_bwd).
//
// The TPU kernel holds a chunk of windows in VMEM and adds each chunk's
// weight gradients into one output block across its sequential grid. On the
// H100 blocks run in parallel, so the backward is split where the weight
// gradients begin:
//   1. window_bwd_kernel: each window's forward recomputed in K6's rounding
//      and its backward, writing dx and dsrc (f32: a layer's cotangents stay
//      in f32 between its calls, as the TPU kernel keeps them inside its one
//      call a layer; in a self call, where src is x, dsrc is added into dx),
//      per token in bf16 the operands of the weight products (o, msg, dm1,
//      dqf, dy2, h, dy1 and [dkf | dv], the stash), and per block the
//      partial sums of the LN parameters' gradients;
//   2. the weight gradients dW = A^T B over the G N tokens (wgrad.cuh, shared
//      with K8 and K9) and the LN partials added in a fixed order by one
//      sum_parts: no float atomics, so the gradients repeat bit for bit.
//
// window_bwd is bound on the H100 by bytes: x (and src) in bf16, g in f32,
// dx (and dsrc) in f32 and the 11 C bf16 stash, 2048 bytes a token in a self
// call and 2432 in a cross call, against 10 C^2 + 4 C D multiply-adds of its
// activation-gradient and attention products
// (kernel_bounds.fine_train_window_bwd_work). Its first design (one window a
// 256-thread block, two blocks an SM, 21 block barriers a window, every
// weight product on mma.sync reading its packed fragments from L2: 160 KB a
// window) took 3.07 ms over the training step's three calls against 0.54.
// Design (that of K6, fine_stage.cu):
//   - One window a warpgroup. The 49 taps are padded to one 64-row wgmma
//     tile and masked out of every sum; the warpgroup synchronises only
//     itself (named barrier 1 + its index, six a window). A block holds
//     kWarpgroups windows in flight; the grid is persistent, one block an
//     SM, and windows go to warpgroups in a fixed order.
//   - The layer's weights leave L2 once a block: the block bulk-copies the
//     layer's image (ops/fine_transformer_train.train_image, 80 KB: each
//     weight [in, out] as [out, 64] boxes of bf16 in the 128-byte swizzle,
//     one a 64-column block of its input) into shared memory when it starts.
//     The forward's products read a box K-major (sw128_desc), the backward's
//     dY W^T products read the same box MN-major (sw128_mn_desc), so one
//     copy of the weights serves both: 80 KB, where a second image of the
//     transposes would take 160 KB and leave room for one window a block.
//   - Every product is a wgmma, the weight products with A from registers:
//     each product's accumulator, after its epilogue, is the next product's
//     A fragments (wgmma.cuh: a row's 64 values lie in one quad of lanes).
//     The forward: [K | V], Q, o = Q KV_bd, the merge, FFN1 over [x | msg]
//     (its two halves of 64 hidden columns in one group), FFN2. The
//     backward: dy1 = dy2
//     w2^T, dmsg = dy1 w1[C:]^T beside dx = g + dy1 w1[:C]^T (accumulated
//     on g), do = dm1 wmerge^T, dQ = dA KV_bd^T, dx += dqf wq^T, and dsrc =
//     [dkf | dv] wkv^T.
//   - Attention's head-block-diagonal C x C matrices are whole 64x64
//     products on [64, 64] tiles in shared memory, masked to the heads' D x
//     D blocks: K^T V and dKV = Q^T dA with both operands MN-major, and K
//     dKV, V dKV^T and Q KV_bd, dA KV_bd^T reading the same tile MN-major or
//     K-major.
//   - Row work in registers over the quad: the LN statistics and backwards,
//     elu and its derivative (by __expf), Z = Q_h . K_sum_h, N / (Z + eps),
//     the head sums of dZ, and the ReLU mask as two words of bits a thread.
//     At head dim 64 (one head) nothing is masked, and Z and dZ's head sum
//     span a row's four k-steps (head_sums).
//     Column sums (K_sum, dK_sum and the four LN gradients) are
//     reduce-scatters over a column's 8 lanes, then over the 4 warps (or a
//     block's warps and warpgroups) in a fixed order.
//   - g is read once, as the dx accumulator's first value; dx is written
//     once. The stash goes out in 8-byte pieces of a row, a quad's store 32
//     bytes, after one exchange between lane pairs (16-byte pieces by quad
//     transposes, twice the shuffles, took 1.31 ms against 1.22).
//   - Registers: the recomputed forward keeps Q's and K's feature-map
//     inputs (x wq and src wk) for their derivatives by computing them again
//     where the backward needs them (4 k-steps each); m1 waits for the LN1
//     backward in the tile Q later takes, elu'(x wq) for dqf and the lanes'
//     running LN column sums in shared memory (a thread's own entries). With
//     either in registers, or FFN1's halves in two groups, ptxas spilled
//     8-104 bytes at the 255 registers a 256-thread block allows; so two
//     warpgroups a block (three would cap a thread at 168 registers).
//
// Measured (tools/fine_train_bwd_ab.py, NVIDIA H100 80GB HBM3, 700 W): about
// 1.22 ms over the step's three calls, against 3.07 for the first design;
// with one warpgroup a block (what shared memory would hold beside a second
// image of the transposes) the self call took 0.90 ms against 0.59.
//
// Rounding follows the TPU kernel as the plain twin
// (ops/fine_transformer_train.fine_layer_backward_reference) has it: bf16
// operands, f32 accumulation; K, V/N, Q, K^T V, K_sum, o, m1, msg, h, y2,
// dy2, dy1, dm1, dA, dZ, dKV, dK_sum, dqf, dkf and dv rounded to bf16. Every
// sum runs in a fixed order: two runs agree bit for bit.

#include "wgmma.cuh"
#include "wgrad.cuh"

namespace {

using fm::bf16;

constexpr int C = 64;
constexpr float kEps = 1e-6f;
constexpr int kWarpgroups = 2;  // windows in flight a block, one a warpgroup
constexpr int kThreads = 128 * kWarpgroups;

// the layer's weight image (bytes): [out, 64] boxes of bf16, 128-byte swizzle
constexpr uint32_t WQ = 0;                    // wq: [64][64]
constexpr uint32_t WKV = WQ + 8192;           // wkv: [128][64], K's 64 outputs, then V's
constexpr uint32_t WM = WKV + 16384;          // wmerge: [64][64]
constexpr uint32_t W1X = WM + 8192;           // w1[:C] (the window's half): [128][64]
constexpr uint32_t W1M = W1X + 16384;         // w1[C:] (the message's half): [128][64]
constexpr uint32_t W2 = W1M + 16384;          // w2: hidden 0..63, then 64..127, [64][64] each
constexpr uint32_t kImageBytes = W2 + 16384;  // 81920
constexpr uint32_t kCopyBytes = 16384;        // one bulk copy
static_assert(kImageBytes % kCopyBytes == 0, "the image goes in whole copies");

// a warpgroup's window (bytes): [64][64] bf16 tiles in the 128-byte swizzle,
// then f32 vectors
constexpr uint32_t KT = 0;                // K [token][d]
constexpr uint32_t VT = KT + 8192;        // V [token][e]
constexpr uint32_t KVT = VT + 8192;       // KV_bd [d][e]
constexpr uint32_t QT = KVT + 8192;       // m1 [token][c]; then Q [token][d]; then dKV [d][e]
constexpr uint32_t AT = QT + 8192;        // dA [token][e]
constexpr uint32_t KS = AT + 8192;        // K_sum [C] (bf16 values)
constexpr uint32_t DKS = KS + 4 * C;      // dK_sum [C] (bf16 values)
constexpr uint32_t COLP = DKS + 4 * C;    // the 4 warps' column partials [4][C]
constexpr uint32_t QF = COLP + 4 * 4 * C; // f32 elu'(x . wq): [16 pairs][128 threads] float2
constexpr uint32_t LNP = QF + 16 * 128 * 8;  // f32 LN gradients' column sums: [4][4 warps][32 lanes] float2
constexpr uint32_t kWgBytes = (LNP + 16 * 32 * 8 + 1023) / 1024 * 1024;  // whole atoms: 63488

// the block: the image, LN1's scale and bias and LN2's scale, the windows,
// the image's mbarrier; + 1024 for aligning the atoms
constexpr uint32_t LN_OFF = kImageBytes;
constexpr uint32_t WG_OFF = LN_OFF + 1024;
constexpr uint32_t BAR_OFF = WG_OFF + kWarpgroups * kWgBytes;
constexpr size_t kSmemBytes = BAR_OFF + 16 + 1024;
static_assert(kSmemBytes <= 232448, "shared memory of a block");

struct Io {
  const bf16 *x, *src;
  const float* g;
  const unsigned char* image;                        // the layer's image
  const float *n1s, *n1b, *n2s;                      // [C]
  float *dx, *dsrc;                                  // [G N][C]
  bf16 *o, *msg, *dm1, *dqf, *dy2, *h, *dy1, *dkv;  // stash [G N][width]
  float* part_ln;  // [grid][4C]: dn1s | dn1b | dn2s | dn2b
  int N, run, self_call;
};

// A [64, 16 KS] bf16 matrix as its warp's m16n8k16 A fragments, KS k-steps:
// f[kk][r] holds rows r0 = 16 w + g and r0 + 8 (r & 1), columns 16 kk + 8
// (r >> 1) + 2 t and the next, which is also where a [64, 16 KS] wgmma
// accumulator keeps them: acc[8 kk + 2 r] and the next (wgmma.cuh).
using Frag = uint32_t[4][4];
using Frag8 = uint32_t[8][4];

// elu(v) + 1 = max(v, 0) + exp(min(v, 0)), and its derivative exp(min(v,
// 0)), by ex2.approx (__expf)
__device__ __forceinline__ float elu1(float v) { return fmaxf(v, 0.f) + __expf(fminf(v, 0.f)); }
__device__ __forceinline__ float delu(float v) { return __expf(fminf(v, 0.f)); }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16(v)); }

// bf16 pair of (relu(lo), relu(hi)), the first in the low half: one cvt
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// operand descriptors computed where they are used (fm::pinned)
__device__ __forceinline__ uint64_t kdesc(uint32_t a) { return fm::sw128_desc(fm::pinned(a)); }
__device__ __forceinline__ uint64_t mdesc(uint32_t a) {
  return fm::sw128_mn_desc(fm::pinned(a), 8192);
}

template <int KS>
__device__ __forceinline__ void keep(uint32_t (&f)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j])::"memory");
}

template <int R>
__device__ __forceinline__ void finish(float (&acc)[R]) {
  fm::wgmma_wait<0>();
  fm::fence_regs(acc);
}

// byte offset of (row r, column c) in a [rows][64] bf16 tile, 128-byte swizzle
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void st_tile(unsigned char* tile, int r, int c, uint32_t w) {
  *reinterpret_cast<uint32_t*>(tile + sw(r, c)) = w;
}

__device__ __forceinline__ uint32_t ld_tile(const unsigned char* tile, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(tile + sw(r, c));
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

// rows r0, r0 + 8 of a window's [N, C] bf16 rows `w` as fragments, zeros past N
__device__ __forceinline__ void load_rows(Frag& f, const bf16* __restrict__ w, int r0, int N,
                                          int t) {
  const bf16* base = w + (size_t)r0 * C + 2 * t;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(base + 8 * C * (r & 1) + 16 * kk + 8 * (r >> 1));
      f[kk][r] = r0 + 8 * (r & 1) < N ? __ldg(p) : 0u;
    }
}

// rows r0, r0 + 8 (those below N) of fragments f into a window's [N, 16 KS]
// bf16 rows at dst, 8 bytes a store: lanes t and t ^ 1 exchange a word so
// that each holds 4 columns of one 8-column strip (a quad's store: 32 bytes)
template <int KS>
__device__ __forceinline__ void store_rows(bf16* dst, const uint32_t (&f)[KS][4], int r0, int N,
                                           int t) {
  const bool odd = t & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int m = 0; m < KS; ++m) {  // strips 2 m (words f[m][i]) and 2 m + 1 (f[m][2 + i])
      const uint32_t w0 = f[m][i], w1 = f[m][2 + i];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w0 : w1, 1);
      const int r = r0 + 8 * i, c = odd ? 16 * m + 8 + 2 * (t - 1) : 16 * m + 2 * t;
      if (r < N)
        *reinterpret_cast<uint2*>(dst + (size_t)r * 16 * KS + c) =
            odd ? make_uint2(got, w1) : make_uint2(w0, got);
    }
}

// v[2 j + e]: this lane's part of column 8 j + 2 t + e. Returns the sums
// over a column's 8 lanes (lane bits 2-4) of columns 8 g + 2 t and the next:
// a reduce-scatter, 14 shuffles, in a fixed order
__device__ __forceinline__ float2 column_sums(float (&v)[16], int g) {
#pragma unroll
  for (int s = 2; s >= 0; --s) {
    const bool up = (g >> s) & 1;
#pragma unroll
    for (int j = 0; j < (1 << s); ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo = v[2 * j + e], hi = v[2 * (j + (1 << s)) + e];
        const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, 4 << s);
        v[2 * j + e] = (up ? hi : lo) + got;
      }
  }
  return make_float2(v[0], v[1]);
}

// mean and reciprocal deviation of the thread's two rows of a [64, C]
// accumulator (a row over its quad)
__device__ __forceinline__ void row_stats(const float (&a)[32], float (&mu)[2], float (&rs)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += a[4 * j + 2 * i] + a[4 * j + 2 * i + 1];
    mu[i] = quad_sum(s) * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = a[4 * j + 2 * i + e] - mu[i];
        q += d * d;
      }
    rs[i] = rsqrtf(quad_sum(q) * (1.0f / C) + fm::kLnEps);
  }
}

// A LayerNorm's backward in place: dh (the output's gradient) becomes
// rs (dxh - mean(dxh) - xh mean(dxh xh)), dxh = dh scale, for xh (the
// normalised input); the lane's running column sums ps and pb (shared
// memory) += the warp's column sums of dh xh and dh
__device__ __forceinline__ void ln_backward(float (&dh)[32], const float (&xh)[32],
                                            const float (&rs)[2], const float* scale,
                                            float2* ps, float2* pb, int g, int t) {
  {
    float cs[16], cb[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int a0 = 4 * j + e, a1 = a0 + 2;
        cs[2 * j + e] = dh[a0] * xh[a0] + dh[a1] * xh[a1];
        cb[2 * j + e] = dh[a0] + dh[a1];
      }
    const float2 s = column_sums(cs, g), b = column_sums(cb, g);
    const float2 os = *ps, ob = *pb;
    *ps = make_float2(os.x + s.x, os.y + s.y);
    *pb = make_float2(ob.x + b.x, ob.y + b.y);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 sc = *reinterpret_cast<const float2*>(scale + 8 * j + 2 * t);
      const int a = 4 * j + 2 * i;
      dh[a] *= sc.x;
      dh[a + 1] *= sc.y;
      m1 += dh[a] + dh[a + 1];
      m2 += dh[a] * xh[a] + dh[a + 1] * xh[a + 1];
    }
    m1 = quad_sum(m1) * (1.0f / C);
    m2 = quad_sum(m2) * (1.0f / C);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int a = 4 * j + 2 * i + e;
        dh[a] = rs[i] * (dh[a] - m1 - xh[a] * m2);
      }
  }
}

// the lane's terms of Q . K_sum over k-step kk of Q's fragments (qk =
// q[kk]): z[r] over its two columns of row r0 + 8 (r & 1) in the strip of
// columns 16 kk + 8 (r >> 1) ..
__device__ __forceinline__ void z_terms(const uint32_t (&qk)[4], const float* ks, int kk,
                                        float (&z)[4], int t) {
  const float2 k0 = *reinterpret_cast<const float2*>(ks + 16 * kk + 2 * t);
  const float2 k1 = *reinterpret_cast<const float2*>(ks + 16 * kk + 8 + 2 * t);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 qv = unpack2(qk[r]), kc = r < 2 ? k0 : k1;
    z[r] = qv.x * kc.x + qv.y * kc.y;
  }
}

// each head's sum of the lane's terms v[kk][r] (row r0 + 8 (r & 1), its two
// columns in the strip 16 kk + 8 (r >> 1) ..), in place: at D = 8 over a
// strip's quad, at D = 16 over a k-step's two strips and the quad, at D =
// 64 (one head) over a row's four k-steps, the lane's terms first, then
// the quad
template <int D>
__device__ __forceinline__ void head_sums(float (&v)[4][4]) {
  static_assert(D == 8 || D == 16 || D == 64, "heads within a k-step, or one head");
  if constexpr (D == 64) {
    float s[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i] = v[0][i] + v[0][i + 2];
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) s[i] += v[kk][i] + v[kk][i + 2];
      s[i] = quad_sum(s[i]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) v[kk][r] = s[r & 1];
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (D == 16) {  // one head a k-step
        v[kk][0] = v[kk][2] = quad_sum(v[kk][0] + v[kk][2]);
        v[kk][1] = v[kk][3] = quad_sum(v[kk][1] + v[kk][3]);
      } else {  // two heads a k-step
#pragma unroll
        for (int r = 0; r < 4; ++r) v[kk][r] = quad_sum(v[kk][r]);
      }
    }
  }
}

// Z = Q_h . K_sum_h for the thread's rows over Q's fragments q: z[kk][r]
// for row r0 + 8 (r & 1) and the head of columns 16 kk + 8 (r >> 1) ..
template <int D>
__device__ __forceinline__ void z_all(const Frag& q, const float* ks, float (&z)[4][4], int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) z_terms(q[kk], ks, kk, z[kk], t);
  head_sums<D>(z);
}

// a [64, 64] accumulator's head-diagonal D x D blocks (rows r0, r0 + 8,
// columns 8 j + 2 t, + 1), rounded, into a tile; zeros elsewhere
template <int D>
__device__ __forceinline__ void masked_to_tile(unsigned char* tile, const float (&a)[32], int r0,
                                               int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i, c = 8 * j + 2 * t;
      st_tile(tile, r, c, r / D == c / D ? fm::pack_bf16(a[4 * j + 2 * i], a[4 * j + 2 * i + 1]) : 0u);
    }
}

// the sums of the 4 warps' column partials, in order, rounded to bf16
__device__ __forceinline__ float colp_total(const float* colp, int c) {
  return bfr(((colp[c] + colp[C + c]) + colp[2 * C + c]) + colp[3 * C + c]);
}

// kWarpgroups warpgroups, each taking windows blockIdx.x + k gridDim.x, k =
// wg, wg + kWarpgroups, .. below io.run (G but for a check that leaves
// windows out)
template <int D>
__global__ void __launch_bounds__(kThreads, 1) window_bwd_kernel(Io io) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (fm::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t img = fm::smem_u32(smem);
  float* n1s = reinterpret_cast<float*>(smem + LN_OFF);  // n1s, n1b, n2s
  const float* n1b = n1s + C;
  const float* n2s = n1b + C;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  // the warpgroup by a shuffle, which ptxas takes as uniform: the operand
  // descriptors are then too, and the products stay asynchronous
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int wt = threadIdx.x & 127, w = wt >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int r0 = 16 * w + g;  // the thread's rows: r0, r0 + 8
  unsigned char* ws = smem + WG_OFF + wg * kWgBytes;
  const uint32_t wsa = img + WG_OFF + wg * kWgBytes;
  float* ks = reinterpret_cast<float*>(ws + KS);
  float* dks = reinterpret_cast<float*>(ws + DKS);
  float* colp = reinterpret_cast<float*>(ws + COLP);
  float2* qfac = reinterpret_cast<float2*>(ws + QF) + wt;  // this thread's 16 pairs, 128 apart
  // the lane's running column sums of dn1s, dn1b, dn2s, dn2b (columns 8 g + 2 t, + 1)
  float2* lnp = reinterpret_cast<float2*>(ws + LNP) + w * 32 + lane;  // + 128 a gradient
  const int N = io.N;
  const float n_f = (float)N, inv_n = 1.0f / (float)N;

  if (threadIdx.x == 0) {
    fm::mbar_init(bar, 1);
    fm::mbar_init_fence();
    fm::mbar_arrive_expect(bar, kImageBytes);
    for (uint32_t off = 0; off < kImageBytes; off += kCopyBytes)
      fm::bulk_load(smem + off, io.image + off, kCopyBytes, bar);
  }
  for (int c = threadIdx.x; c < 3 * C; c += kThreads)
    n1s[c] = (c < C ? io.n1s : c < 2 * C ? io.n1b : io.n2s)[c % C];
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 4; ++p) lnp[128 * p] = make_float2(0.f, 0.f);
  fm::mbar_wait(bar, 0);  // the image is in

  // ---- the block's windows ----
#pragma unroll 1
  for (int k = wg;; k += kWarpgroups) {
    const int win = blockIdx.x + k * gridDim.x;
    if (win >= io.run) break;
    const size_t row0 = (size_t)win * N;
    const bf16* xw = io.x + row0 * C;
    const bf16* sp = io.src + row0 * C;
    if (wt == 0) {  // this window's g, and the next window's x and src, into L2
      fm::prefetch_l2(io.g + row0 * C, N * C * 4);
      const int next = win + kWarpgroups * gridDim.x;
      if (next < io.run) {
        fm::prefetch_l2(io.x + (size_t)next * N * C, N * C * 2);
        if (!io.self_call) fm::prefetch_l2(io.src + (size_t)next * N * C, N * C * 2);
      }
    }

    // ---- the window's forward, recomputed ----
    Frag q;  // Q = bf16(elu(x . wq) + 1)
    {
      Frag xf, sf;
      load_rows(xf, xw, r0, N, t);
      load_rows(sf, sp, r0, N, t);
      float kv[64], qa[32];
      fm::zero_regs(kv);
      fm::zero_regs(qa);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fm::wgmma_rs_n128(kv, sf[kk], kdesc(img + WKV + 32 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fm::wgmma_rs_n64(qa, xf[kk], kdesc(img + WQ + 32 * kk), 1);
      fm::wgmma_commit();
      finish(kv);
      fm::fence_regs(qa);
      keep(xf);
      keep(sf);
      // K = elu(src . wk) + 1 and V = src . wv / N into their tiles, no mass
      // past N; K's column sums over the warp's rows
      float cs[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t m = r0 + 8 * i < N ? ~0u : 0u;
          const int a = 4 * j + 2 * i;
          const uint32_t kw = fm::pack_bf16(elu1(kv[a]), elu1(kv[a + 1])) & m;
          const uint32_t vw = fm::pack_bf16(kv[32 + a] * inv_n, kv[32 + a + 1] * inv_n) & m;
          st_tile(ws + KT, r0 + 8 * i, 8 * j + 2 * t, kw);
          st_tile(ws + VT, r0 + 8 * i, 8 * j + 2 * t, vw);
          const float2 kf = unpack2(kw);
          s0 += kf.x;
          s1 += kf.y;
        }
        cs[2 * j] = s0;
        cs[2 * j + 1] = s1;
      }
      *reinterpret_cast<float2*>(colp + w * C + 8 * g + 2 * t) = column_sums(cs, g);
      to_frags(q, qa, [](float v) { return elu1(v); });
    }
    fm::fence_proxy_async();
    fm::named_barrier(1 + wg, 128);
    // ---- K^T V and K_sum ----
    {
      float kvd[32];
      fm::zero_regs(kvd);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // k-step kk: tokens 16 kk.., two atoms
        fm::wgmma_ss_mn_n64(kvd, mdesc(wsa + KT + kk * 2048), mdesc(wsa + VT + kk * 2048), 1);
      fm::wgmma_commit();
      finish(kvd);
      if (wt < C) ks[wt] = colp_total(colp, wt);
      masked_to_tile<D>(ws + KVT, kvd, r0, t);
    }
    fm::fence_proxy_async();
    fm::named_barrier(1 + wg, 128);
    // ---- Z and o ----
    Frag o;  // o = bf16(Q . KV_bd * (N / (Z + eps)))
    {
      float z[4][4], a[32];
      z_all<D>(q, ks, z, t);
      fm::zero_regs(a);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fm::wgmma_rs_n64<1>(a, q[kk], mdesc(wsa + KVT + kk * 2048), 1);
      fm::wgmma_commit();
      finish(a);
      keep(q);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float s = __fdividef(n_f, z[kk][r] + kEps);  // z > 0: Q, K > 0
          o[kk][r] = fm::pack_bf16(a[8 * kk + 2 * r] * s, a[8 * kk + 2 * r + 1] * s);
        }
    }
    // ---- m1, LN1, msg ----
    Frag msg;  // msg = bf16(LN1(m1)), m1 = bf16(o . wmerge), m1 kept in QT
    {
      float m[32];
      fm::zero_regs(m);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fm::wgmma_rs_n64(m, o[kk], kdesc(img + WM + 32 * kk), 1);
      fm::wgmma_commit();
      store_rows(io.o + row0 * C, o, r0, N, t);
      finish(m);
      keep(o);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a = 4 * j + 2 * i;
          const uint32_t mw = fm::pack_bf16(m[a], m[a + 1]);
          st_tile(ws + QT, r0 + 8 * i, 8 * j + 2 * t, mw);
          const float2 mf = unpack2(mw);
          m[a] = mf.x;
          m[a + 1] = mf.y;
        }
      float mu[2], rs[2];
      row_stats(m, mu, rs);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(n1s + 8 * j + 2 * t);
        const float2 bi = *reinterpret_cast<const float2*>(n1b + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a = 4 * j + 2 * i;
          m[a] = (m[a] - mu[i]) * rs[i] * sc.x + bi.x;
          m[a + 1] = (m[a + 1] - mu[i]) * rs[i] * sc.y + bi.y;
        }
      }
      to_frags(msg, m, [](float v) { return v; });
    }
    // ---- h ----
    Frag8 hid;          // h = bf16(relu(x . w1[:C] + msg . w1[C:]))
    uint32_t mask[2];   // y1 > 0: bit a of word hh is y1's accumulator entry a of half hh
    {
      Frag xf;
      load_rows(xf, xw, r0, N, t);
      float y[2][32];
      fm::zero_regs(y[0]);
      fm::zero_regs(y[1]);
      fm::wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          fm::wgmma_rs_n64(y[hh], xf[kk], kdesc(img + W1X + hh * 8192 + 32 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          fm::wgmma_rs_n64(y[hh], msg[kk], kdesc(img + W1M + hh * 8192 + 32 * kk), 1);
      }
      fm::wgmma_commit();
      store_rows(io.msg + row0 * C, msg, r0, N, t);
      finish(y[0]);
      fm::fence_regs(y[1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t bits = 0u;
#pragma unroll
        for (int a = 0; a < 32; ++a) bits |= (y[hh][a] > 0.f ? 1u : 0u) << a;
        mask[hh] = bits;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            hid[4 * hh + kk][r] = pack_relu(y[hh][8 * kk + 2 * r], y[hh][8 * kk + 2 * r + 1]);
      }
      keep(xf);
      keep(msg);
    }
    // ---- y2, LN2 ----
    float xh2[32];  // y2 = bf16(h . w2), then its normalised values
    float rs2[2];
    {
      fm::zero_regs(xh2);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        fm::wgmma_rs_n64(xh2, hid[kk], kdesc(img + W2 + (kk >> 2) * 8192 + 32 * (kk & 3)), 1);
      fm::wgmma_commit();
      store_rows(io.h + row0 * 2 * C, hid, r0, N, t);
      finish(xh2);
      keep(hid);
#pragma unroll
      for (int a = 0; a < 32; ++a) xh2[a] = bfr(xh2[a]);
      float mu2[2];
      row_stats(xh2, mu2, rs2);
#pragma unroll
      for (int a = 0; a < 32; ++a) xh2[a] = (xh2[a] - mu2[(a >> 1) & 1]) * rs2[(a >> 1) & 1];
    }
    // ---- the backward: LN2 ----
    float dx[32];  // g, then dx = g + dy1 . w1[:C]ᵀ + dqf . wqᵀ (+ dsrc in a self call)
    Frag dy2;
    {
      const float* gw = io.g + row0 * C;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 v = r0 + 8 * i < N
              ? *reinterpret_cast<const float2*>(gw + (size_t)(r0 + 8 * i) * C + 8 * j + 2 * t)
              : make_float2(0.f, 0.f);
          dx[4 * j + 2 * i] = v.x;
          dx[4 * j + 2 * i + 1] = v.y;
        }
      float d[32];
#pragma unroll
      for (int a = 0; a < 32; ++a) d[a] = dx[a];
      ln_backward(d, xh2, rs2, n2s, lnp + 256, lnp + 384, g, t);
      to_frags(dy2, d, [](float v) { return v; });
    }
    // ---- dy1 ----
    Frag8 dy1;  // dy1 = bf16((dy2 . w2ᵀ) (y1 > 0))
    {
      float dh[64];
      fm::zero_regs(dh);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // w2's boxes read MN-major: k-step kk, rows 16 kk..
        fm::wgmma_rs_n128<1>(dh, dy2[kk], mdesc(img + W2 + kk * 2048), 1);
      fm::wgmma_commit();
      store_rows(io.dy2 + row0 * C, dy2, r0, N, t);
      finish(dh);
      keep(dy2);
#pragma unroll
      for (int a = 0; a < 64; ++a)
        if (!((mask[a >> 5] >> (a & 31)) & 1u)) dh[a] = 0.f;
      to_frags(dy1, dh, [](float v) { return v; });
    }
    // ---- dmsg, LN1 backward ----
    Frag dm1;  // dm1 = bf16(LN1's backward of dmsg = dy1 . w1[C:]ᵀ)
    {
      float dm[32];
      fm::zero_regs(dm);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        fm::wgmma_rs_n64<1>(dm, dy1[kk], mdesc(img + W1M + kk * 2048), 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        fm::wgmma_rs_n64<1>(dx, dy1[kk], mdesc(img + W1X + kk * 2048), 1);
      fm::wgmma_commit();
      store_rows(io.dy1 + row0 * 2 * C, dy1, r0, N, t);
      finish(dm);
      fm::fence_regs(dx);
      keep(dy1);
      float xh1[32];  // m1 from its tile, normalised
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 mf = unpack2(ld_tile(ws + QT, r0 + 8 * i, 8 * j + 2 * t));
          xh1[4 * j + 2 * i] = mf.x;
          xh1[4 * j + 2 * i + 1] = mf.y;
        }
      float mu1[2], rs1[2];
      row_stats(xh1, mu1, rs1);
#pragma unroll
      for (int a = 0; a < 32; ++a) xh1[a] = (xh1[a] - mu1[(a >> 1) & 1]) * rs1[(a >> 1) & 1];
      ln_backward(dm, xh1, rs1, n1s, lnp, lnp + 128, g, t);
      to_frags(dm1, dm, [](float v) { return v; });
    }
    // ---- do ----
    float dov[32], qf[32];  // do = dm1 . wmergeᵀ; x . wq again, for Q and elu'(x . wq)
    {
      Frag xf;
      load_rows(xf, xw, r0, N, t);
      fm::zero_regs(dov);
      fm::zero_regs(qf);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fm::wgmma_rs_n64<1>(dov, dm1[kk], mdesc(img + WM + kk * 2048), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fm::wgmma_rs_n64(qf, xf[kk], kdesc(img + WQ + 32 * kk), 1);
      fm::wgmma_commit();
      store_rows(io.dm1 + row0 * C, dm1, r0, N, t);
      finish(dov);
      fm::fence_regs(qf);
      keep(dm1);
      keep(xf);
    }
    // ---- dA, dZ ----
    Frag da;          // dA = bf16(do (N / (Z + eps)))
    float dzh[4][4];  // the head sums of dZ = bf16(-(do o32) / (Z + eps)), as z_all
    {
      to_frags(q, qf, [](float v) { return elu1(v); });
      // elu'(x . wq) waits for dqf in shared memory (the thread's own pairs)
#pragma unroll
      for (int p = 0; p < 16; ++p) qfac[128 * p] = make_float2(delu(qf[2 * p]), delu(qf[2 * p + 1]));
      float a[32];
      fm::zero_regs(a);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fm::wgmma_rs_n64<1>(a, q[kk], mdesc(wsa + KVT + kk * 2048), 1);
      fm::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // Q into its tile, over m1
#pragma unroll
        for (int r = 0; r < 4; ++r) st_tile(ws + QT, r0 + 8 * (r & 1), 16 * kk + 8 * (r >> 1) + 2 * t, q[kk][r]);
      finish(a);
      keep(q);
      // Q back from its tile (the thread's own entries), then Z, dA, dZ's
      // head sums and dK_sum's parts Q[r, c] dZ_h(c)[r]
      Frag qt;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) qt[kk][r] = ld_tile(ws + QT, r0 + 8 * (r & 1), 16 * kk + 8 * (r >> 1) + 2 * t);
      float z[4][4];
      z_all<D>(qt, ks, z, t);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float zi = __frcp_rn(z[kk][r] + kEps), nf = n_f * zi;
          float dzv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ai = 8 * kk + 2 * r + e;
            dzv[e] = bfr(-(dov[ai] * (a[ai] * nf)) * zi);
            dov[ai] *= nf;
          }
          da[kk][r] = fm::pack_bf16(dov[8 * kk + 2 * r], dov[8 * kk + 2 * r + 1]);
          st_tile(ws + AT, r0 + 8 * (r & 1), 16 * kk + 8 * (r >> 1) + 2 * t, da[kk][r]);
          dzh[kk][r] = dzv[0] + dzv[1];  // this lane's two columns
        }
      head_sums<D>(dzh);
      float cs[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // strip j = 2 kk + h: rows r = 2 h, 2 h + 1
          const float2 qa = unpack2(qt[kk][2 * h]), qb = unpack2(qt[kk][2 * h + 1]);
          cs[4 * kk + 2 * h] = qa.x * dzh[kk][2 * h] + qb.x * dzh[kk][2 * h + 1];
          cs[4 * kk + 2 * h + 1] = qa.y * dzh[kk][2 * h] + qb.y * dzh[kk][2 * h + 1];
        }
      *reinterpret_cast<float2*>(colp + w * C + 8 * g + 2 * t) = column_sums(cs, g);
    }
    fm::fence_proxy_async();
    fm::named_barrier(1 + wg, 128);
    // ---- dKV, dQ ----
    Frag dqf;  // dqf = bf16((dA . KV_bdᵀ + dZ_h K_sum) elu'(x . wq))
    {
      float dkv[32], dq[32];
      fm::zero_regs(dkv);
      fm::zero_regs(dq);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // Qᵀ dA: k-step kk, tokens 16 kk..
        fm::wgmma_ss_mn_n64(dkv, mdesc(wsa + QT + kk * 2048), mdesc(wsa + AT + kk * 2048), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // KV_bd's tile read K-major: its transpose
        fm::wgmma_rs_n64(dq, da[kk], kdesc(wsa + KVT + 32 * kk), 1);
      fm::wgmma_commit();
      finish(dkv);
      fm::fence_regs(dq);
      keep(da);
      if (wt < C) dks[wt] = colp_total(colp, wt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 kc = *reinterpret_cast<const float2*>(ks + 16 * kk + 8 * (r >> 1) + 2 * t);
          const float2 qd = qfac[128 * (4 * kk + r)];
          const int a = 8 * kk + 2 * r;
          dqf[kk][r] = fm::pack_bf16((dq[a] + dzh[kk][r] * kc.x) * qd.x,
                                     (dq[a + 1] + dzh[kk][r] * kc.y) * qd.y);
        }
      fm::named_barrier(1 + wg, 128);  // every warp's products are done with Q's tile
      masked_to_tile<D>(ws + QT, dkv, r0, t);
    }
    fm::fence_proxy_async();
    fm::named_barrier(1 + wg, 128);
    // ---- dV, dK ----
    Frag8 dkv;  // [dkf | dv] = bf16([(V . dKVᵀ + dK_sum) elu'(src . wk) | K . dKV / N])
    {
      Frag sf;  // for src . wk again, wkv's first 64 rows (its own product below)
      load_rows(sf, sp, r0, N, t);
      float dv[32], dk[32];
      fm::zero_regs(dv);
      fm::zero_regs(dk);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // K . dKV: dKV's tile read MN-major
        fm::wgmma_ss_n64<1>(dv, kdesc(wsa + KT + 32 * kk), mdesc(wsa + QT + kk * 2048), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // V . dKVᵀ: read K-major
        fm::wgmma_ss_n64(dk, kdesc(wsa + VT + 32 * kk), kdesc(wsa + QT + 32 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dx += dqf . wqᵀ
        fm::wgmma_rs_n64<1>(dx, dqf[kk], mdesc(img + WQ + kk * 2048), 1);
      fm::wgmma_commit();
      store_rows(io.dqf + row0 * C, dqf, r0, N, t);
      finish(dv);
      fm::fence_regs(dk);
      fm::fence_regs(dx);
      keep(dqf);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int a = 8 * kk + 2 * r;
          dkv[4 + kk][r] = r0 + 8 * (r & 1) < N ? fm::pack_bf16(dv[a] * inv_n, dv[a + 1] * inv_n) : 0u;
        }
      float kf[32];
      fm::zero_regs(kf);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fm::wgmma_rs_n64(kf, sf[kk], kdesc(img + WKV + 32 * kk), 1);
      fm::wgmma_commit();
      finish(kf);
      keep(sf);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 kc = *reinterpret_cast<const float2*>(dks + 16 * kk + 8 * (r >> 1) + 2 * t);
          const int a = 8 * kk + 2 * r;
          dkv[kk][r] = r0 + 8 * (r & 1) < N ? fm::pack_bf16((dk[a] + kc.x) * delu(kf[a]),
                                                           (dk[a + 1] + kc.y) * delu(kf[a + 1]))
                                            : 0u;
        }
    }
    // ---- dsrc, dx ----
    {
      float ds[32];  // dsrc = [dkf | dv] . wkvᵀ
      fm::zero_regs(ds);
      fm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fm::wgmma_rs_n64<1>(ds, dkv[kk], mdesc(img + WKV + kk * 2048), 1);
      fm::wgmma_commit();
      store_rows(io.dkv + row0 * 2 * C, dkv, r0, N, t);
      finish(ds);
      keep(dkv);
      float* dxw = io.dx + row0 * C;
      float* dsw = io.dsrc + row0 * C;  // (a cross call)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (r0 + 8 * i >= N) continue;
          const size_t at = (size_t)(r0 + 8 * i) * C + 8 * j + 2 * t;
          const int a = 4 * j + 2 * i;
          if (io.self_call) {
            *reinterpret_cast<float2*>(dxw + at) = make_float2(dx[a] + ds[a], dx[a + 1] + ds[a + 1]);
          } else {
            *reinterpret_cast<float2*>(dxw + at) = make_float2(dx[a], dx[a + 1]);
            *reinterpret_cast<float2*>(dsw + at) = make_float2(ds[a], ds[a + 1]);
          }
        }
    }
    // ---- the window is done ----
    fm::named_barrier(1 + wg, 128);  // every warp is done with the window's tiles
  }
  // ---- the block's windows are done ----
  // the LN gradients' partial row: the lanes' column sums over the block's
  // warpgroups and warps, in order
  __syncthreads();
  for (int e = threadIdx.x; e < 4 * C; e += kThreads) {
    const int p = e / C, c = e % C, ln = (c >> 3) * 4 + ((c & 7) >> 1);
    float s = 0.f;
    for (int v = 0; v < kWarpgroups; ++v) {
      const float* q4 = reinterpret_cast<const float*>(smem + WG_OFF + v * kWgBytes + LNP);
#pragma unroll
      for (int u = 0; u < 4; ++u) s += q4[2 * ((4 * p + u) * 32 + ln) + (c & 1)];
    }
    io.part_ln[(size_t)blockIdx.x * 4 * C + e] = s;
  }
}

#define FM_CHECK(expr)                \
  do {                                \
    cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// the persistent grid: a block an SM, none without a window
int grid_for(int run, int sms) {
  const int blocks = (run + kWarpgroups - 1) / kWarpgroups;
  return sms < blocks ? sms : blocks;
}

template <int D>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(window_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmemBytes);
}

template <int D>
cudaError_t launch_bwd(const Io& io, int grid, cudaStream_t st) {
  FM_CHECK(set_smem<D>());
  window_bwd_kernel<D><<<grid, kThreads, kSmemBytes, st>>>(io);
  return cudaGetLastError();
}

template <int D>
cudaError_t occupancy(int* blocks_per_sm) {
  FM_CHECK(set_smem<D>());
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, window_bwd_kernel<D>,
                                                       kThreads, kSmemBytes);
}

}  // namespace

FM_ERROR_STRING_ENTRY

// One encoder call's backward over G windows of N taps (C = 64, head dim D:
// 8, 16 or 64).
// in = {x [G, N, C], src [G, N, C] (bf16; the same pointer for a self call),
// g [G, N, C] (f32); the layer's weight image (ops/fine_transformer_train.
// train_image, 81920 bytes, 16-byte aligned); n1s, n1b, n2s (f32 [C])}.
// out = {dx, dsrc [G, N, C] (f32; a self call writes dx + dsrc to dx and
// takes no dsrc, which may be null); dwq [C, C], dwkv [C, 2C], dwmerge [C, C],
// dln [4C] (dn1s | dn1b | dn2s | dn2b), dw1 [2C, 2C], dw2 [2C, C] (f32, [in,
// out]); scratch: stash bf16 [11 G N C], LN partials f32 [sms][4C],
// weight-gradient partials f32 (ops/wgrad.partial_floats of the six
// products)}. run: the windows the window stage runs (G, or fewer for a
// check that leaves the last windows out); sms: the card's SMs.
extern "C" int fm_fine_train_bwd(const void* const* in, void* const* out, int G, int N, int D,
                                 int run, int sms, void* stream) {
  if (G <= 0 || N < 1 || N > 64 || (D != 8 && D != 16 && D != 64) || run <= 0 || run > G ||
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
  io.image = static_cast<const unsigned char*>(in[3]);
  io.n1s = F(in[4]);
  io.n1b = F(in[5]);
  io.n2s = F(in[6]);
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
  io.dkv = io.dy1 + TL * 2 * C;
  io.part_ln = static_cast<float*>(out[9]);
  io.N = N;
  io.run = run;
  io.self_call = in[0] == in[1];
  const int grid = grid_for(run, sms);
  FM_CHECK(D == 8 ? launch_bwd<8>(io, grid, st)
                  : D == 16 ? launch_bwd<16>(io, grid, st) : launch_bwd<64>(io, grid, st));

  // out: dwq [C, C], dwkv [C, 2C], dwmerge [C, C], dln [4C], dw1 [2C, 2C], dw2 [2C, C]
  const int TLi = (int)TL;
  FM_CHECK(fm::sum_parts(io.part_ln, grid, (size_t)4 * C, 4 * C, out[5], st));
  // the six weight gradients in one launch
  float* dw1 = static_cast<float*>(out[6]);
  const fm::WgradCall calls[] = {{io.x, C, io.dqf, C, TLi, C, C, out[2]},
                                 {io.src, C, io.dkv, 2 * C, TLi, C, 2 * C, out[3]},
                                 {io.o, C, io.dm1, C, TLi, C, C, out[4]},
                                 {io.x, C, io.dy1, 2 * C, TLi, C, 2 * C, dw1},
                                 {io.msg, C, io.dy1, 2 * C, TLi, C, 2 * C,
                                  dw1 + (size_t)C * 2 * C},
                                 {io.h, 2 * C, io.dy2, C, TLi, 2 * C, C, out[7]}};
  return (int)fm::wgrad_group(calls, 6, sms, static_cast<float*>(out[10]), st);
}

// info: the block's windows in flight (one a warpgroup), its dynamic shared
// memory in bytes, the blocks an SM can hold and the grid for G windows, at
// head dim D
extern "C" int fm_fine_train_bwd_occupancy(int D, int G, int sms, int* info) {
  if ((D != 8 && D != 16 && D != 64) || G < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  info[0] = kWarpgroups;
  info[1] = (int)kSmemBytes;
  info[3] = grid_for(G, sms);
  return (int)(D == 8 ? occupancy<8>(&info[2])
                      : D == 16 ? occupancy<16>(&info[2]) : occupancy<64>(&info[2]));
}
