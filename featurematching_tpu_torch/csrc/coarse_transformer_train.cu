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
//   1. apply_bwd: one block of 8 warps a 64-token query tile recomputes the
//      forward tile on chip from x, the saved K^T V and K_sum and the
//      weights (in the forward's bf16 rounding), then runs its backward: LN2,
//      the FFN, LN1, the merge, the per-head attention gradients and the Q
//      feature map, and writes dx.
//      - Every product runs on tiles.cuh's mma.sync tiles with the warps as
//        2 x 4 over a [64, N] output, a warp's 32 x N/4 tile in registers.
//        The nine weight products read their packed B fragments straight
//        from L2 by ld.global.nc, each warp four k-steps ahead of their use,
//        into registers; the two warps of a column group read the same
//        fragments, which L1 merges, and no barrier couples the warps. (A
//        cp.async ring of 16 KB slices shared by the block, a barrier a
//        slice, ran the tile 1.4x slower on the H100 at three, five or seven
//        slots: its copies came at about 9 bytes a cycle an SM, PERF.md.)
//      - LN1, LN2 and both LN backwards run a warp a row over shared memory
//        in compact loops (the products' accumulators are written there
//        first; dmsg, in f32, a row half at a time), since the code of
//        register epilogues unrolled over a warp's tile outgrew the
//        instruction cache; a column's sums (the LN gradients) stay in each
//        warp's registers over its rows, then the 8 warps add in a fixed
//        order. g is read once, into shared memory at the tile's start, for
//        LN2 and dx. The ReLU mask is one bit a hidden entry in the
//        registers of the lane that computed it, which later takes the same
//        entry of dy1.
//      - The per-head products (Q.KV, dopre.KVᵀ) run in the same warp tiles,
//        beside the merge gradient do and the recomputed x.wq, so both
//        factors of each elementwise step share a layout in registers; Z
//        and the head sums of dZ are formed in the lanes that hold the rows,
//        and dK_sum's column sums go across a warp's rows by shuffles, then
//        across the two row halves in a fixed order.
//      - The hidden width runs in chunks of 128 columns: relu([x | msg].w1)
//        and then its part of y2, later dy1 and then its part of dmsg, so no
//        [64, 2C] f32 tile exists. x is read again for x.wq, over Q.
//      - Shared memory: six [64, C] bf16 buffers, five reused phase by phase
//        (x, then y2, then dy1 over the first two; o, then msg; Q, then x,
//        then dqf; m1, then dm1, then dopre; the plain K^T V, the hidden
//        chunk, dy2, dmsg's row halves, the plain K^T V again; at head dim
//        64 its 16-byte chunks permuted by row in place of [C][D + 8]'s
//        padding, KvSmem, which would outgrow the buffer) and g; K_sum,
//        the LN parameters and statistics and the dK_sum partial: 209,408
//        bytes at C = 256, one block an SM.
//      It writes the bf16 operands of the weight products (o, msg, h, dy2,
//      dy1, dm1, dqf: the operands the TPU kernel feeds its bf16 products),
//      and per-tile partials of the LN gradients, each head's dK^T V [D, D]
//      and the head-summed dK_sum [C] (only K^T 1's row sums are ever read).
//   2. bwd_merge: the partials of each image added in a fixed order and
//      rounded to bf16, as the stats backward reads them.
//   3. stats_bwd (on wgmma; its design where it is defined): 64-token source
//      tiles recompute K and V, form [dkf | dv] and dsrc = [dkf | dv] . wkvᵀ,
//      the layer's wkv read both ways from one image.
//   4. the weight gradients dW = Aᵀ B over the tokens (wgrad.cuh, shared with
//      K8) and the LN gradients' fixed-order sums: no float atomics, so the
//      gradients repeat bit for bit.
// Only each head's diagonal [D, D] block of dK^T V is formed (the TPU kernel
// forms [C, C] and masks it). apply_bwd's weight transposes (the B operands
// of its dY . Wᵀ products) come packed from the wrapper.

#include "tiles.cuh"
#include "wgrad.cuh"

namespace {

using fm::Acc16;
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

struct BwdIO {
  const bf16 *x, *kv, *ks, *g;
  const bf16 *wq, *wmerge, *w1, *w2;  // forward operands, packed [in, out]
  const float *n1s, *n1b, *n2s, *n2b;
  const bf16 *w2t, *w1mt, *wmt, *wdxt;  // packed transposes
  bf16* dx;
  bf16 *o, *msg, *h, *dy2, *dy1, *dm1, *dqf;  // stash [G L][width]
  float *part_ln, *part_kv, *part_ks;         // per-tile partials
};

// a warp's accumulators over a [64, N] output: 2 x N/64 tiles of 16x16
template <int N>
using Acc = Acc16[2][N / 64];

template <int N>
__device__ __forceinline__ void zero(Acc<N>& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < N / 64; ++j) fm::zero(acc[i][j]);
}

// acc += [a1 | a2] . B over the warp's tile (warps 2 x 4, a warp rows 32
// (warp / 4) .., columns N/4 (warp % 4) ..): a1 the first K1 of A's K
// columns, a2 the rest (shared, row strides lda1, lda2). B is rows [k0, k0
// + K) of the N columns from strip s0 on of a packed weight w with `steps`
// 16-row steps. The warp takes its columns two 16-column tiles a pass and
// reads each pass's B fragments from L2 by ld.global.nc, PF k-steps ahead
// of their use, into registers (the two warps of a column group read the
// same fragments, which L1 merges).
template <int N, int K, int K1 = K>
__device__ __forceinline__ void product(Acc<N>& acc, const bf16* a1, int lda1, const bf16* a2,
                                        int lda2, const bf16* w, int steps, int s0, int k0,
                                        int warp, int lane) {
  constexpr int NT = N / 64, NP = 2, KSTEPS = K / 16, PF = 8;
  static_assert(NT % NP == 0 && KSTEPS % PF == 0 && K1 % 16 == 0, "whole passes and rounds");
  const int m0 = warp / 4 * 32;
#pragma unroll
  for (int pass = 0; pass < NT / NP; ++pass) {
    const uint4* b = reinterpret_cast<const uint4*>(
        w + ((size_t)(s0 + warp % 4 * NT + pass * NP) * steps + k0 / 16) * 256) + lane;
    uint4 fb[PF][NP];  // the B fragments of the next PF k-steps
#pragma unroll
    for (int p = 0; p < PF; ++p)
#pragma unroll
      for (int j = 0; j < NP; ++j) fb[p][j] = __ldg(b + ((size_t)j * steps + p) * 32);
    for (int kr = 0; kr < KSTEPS; kr += PF) {
#pragma unroll
      for (int p = 0; p < PF; ++p) {
        const int kk = kr + p;
        const bf16* a = kk * 16 < K1 ? a1 + kk * 16 : a2 + (kk * 16 - K1);
        const int lda = kk * 16 < K1 ? lda1 : lda2;
        uint32_t fa[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) fm::load_a(fa[i], a + (m0 + 16 * i) * lda, lda, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NP; ++j)
            fm::mma16(acc[i][pass * NP + j], fa[i], reinterpret_cast<const uint32_t*>(&fb[p][j]));
        if (kk + PF < KSTEPS) {
#pragma unroll
          for (int j = 0; j < NP; ++j) fb[p][j] = __ldg(b + ((size_t)j * steps + kk + PF) * 32);
        }
      }
    }
  }
}

// f(i, jp, ri, row, col) for each accumulator pair (acc[i][j].c[2 jp],
// .c[2 jp + 1]) of column tile j of the warp's tile of an Acc<64 NT>: the
// pair's row (the lane's ri-th of 4) and its first column
template <int NT, typename F>
__device__ __forceinline__ void for_pairs_of(int j, int warp, int lane, F f) {
  const int m0 = warp / 4 * 32, n0 = warp % 4 * NT * 16, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
      f(i, jp, 2 * i + (jp & 1), m0 + 16 * i + g + 8 * (jp & 1),
        n0 + 16 * j + 8 * (jp >> 1) + 2 * t);
}

// f(i, j, jp, ri, row, col) for every pair of the warp's tile
template <int NT, typename F>
__device__ __forceinline__ void for_pairs(int warp, int lane, F f) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    for_pairs_of<NT>(j, warp, lane,
                     [&](int i, int jp, int ri, int r, int c) { f(i, j, jp, ri, r, c); });
}

// d = acc's column tile j (a runtime index) by predicated moves, so that a
// loop over the tiles need not be unrolled
template <int NT>
__device__ __forceinline__ void pick(Acc16 (&d)[2], const Acc16 (&acc)[2][NT], int j) {
#pragma unroll
  for (int jj = 0; jj < NT; ++jj)
    if (jj == j) {
      d[0] = acc[0][jj];
      d[1] = acc[1][jj];
    }
}

// the lane's ri-th row of the warp's tile
__device__ __forceinline__ int lane_row(int ri, int warp, int lane) {
  return warp / 4 * 32 + 16 * (ri >> 1) + (lane >> 2) + 8 * (ri & 1);
}

// NV column sums of column tile j over the warp's 32 rows into part
// ([2][NV][C] f32, by row half): v[k][q] holds column 16 j + 8 (q >> 1) +
// 2 t + (q & 1) of the warp's tile summed over the lane's 4 rows, then
// across the warp's 8 row groups by shuffles. After a barrier col_total
// adds the two row halves in a fixed order.
template <int C, int NV>
__device__ __forceinline__ void col_part(float (&v)[NV][4], float* part, int j, int warp,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) v[k][q] += __shfl_xor_sync(0xffffffffu, v[k][q], o);
  if (lane < 4) {
    const int c0 = warp % 4 * (C / 4) + 16 * j + 2 * lane;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[(warp / 4 * NV + k) * C + c0 + 8 * (q >> 1) + (q & 1)] = v[k][q];
  }
}

template <int C, int NV>
__device__ __forceinline__ void col_total(const float* part, float* out) {
  for (int e = threadIdx.x; e < NV * C; e += kThreads) out[e] = part[e] + part[NV * C + e];
}

// Z of the lane's 4 rows for each head of the warp's columns: Q_h . K_sum_h,
// a quarter of the head's columns a lane of the row, then across the four
// lanes (Q bf16 [64][C + 8] in shared memory, K_sum f32)
template <int C, int D>
__device__ __forceinline__ void head_z(float (&z)[4][C / 4 / D], const bf16* qs,
                                       const float* kss, int warp, int lane) {
  constexpr int V = D / 4;
  const int n0 = warp % 4 * (C / 4), t = lane & 3;
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int hh = 0; hh < C / 4 / D; ++hh) {
      const int c0 = n0 + hh * D + t * V;
      float q[V];
      fm::load_bf16<V>(qs + lane_row(ri, warp, lane) * (C + 8) + c0, q);
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) s += q[v] * kss[c0 + v];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      z[ri][hh] = s;
    }
}

// apply_bwd's plain K^T V in shared memory, [C][D] (row h D + k, column n):
// rows of D + 8 values (the padding keeps ldmatrix's rows in distinct
// banks), or at D = 64, where [C][72] outgrows the fifth buffer, rows of 64
// with each row's 16-byte chunks permuted by (chunk ^ row % 8), which does
// the same in 32 KB
template <int D>
struct KvSmem {
  static constexpr bool SWIZZLED = D == 64;
  static constexpr int LD = SWIZZLED ? D : D + 8;
  __device__ __forceinline__ static int at(int row, int col) {
    if constexpr (SWIZZLED) return row * D + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
    else return row * LD + col;
  }
};

// B fragment of the 16x16 tile of K^T V at (row0, col0) (fm::load_b's
// lanes; TRANS: load_b_t's, the tile's transpose)
template <int D, bool TRANS>
__device__ __forceinline__ void load_kv_b(uint32_t* r, const bf16* kvp, int row0, int col0,
                                          int lane) {
  const int m = lane >> 3;
  if (TRANS)
    fm::ldsm_x4(r, kvp + KvSmem<D>::at(row0 + (lane & 7) + (m >> 1) * 8, col0 + (m & 1) * 8));
  else
    fm::ldsm_x4_trans(r, kvp + KvSmem<D>::at(row0 + (lane & 7) + (m & 1) * 8,
                                              col0 + (m >> 1) * 8));
}

// acc[i] += A_h . KV_h (TRANS: A_h . KV_hᵀ) for column tile j of the
// warp's tile of a [64, C] output (its two row tiles i), the 16 columns'
// head h: A bf16 [64][C + 8], the plain K^T V (KvSmem, row h D + k)
template <int C, int D, bool TRANS>
__device__ __forceinline__ void head_tile(Acc16 (&acc)[2], const bf16* a, const bf16* kvp, int j,
                                          int warp, int lane) {
  constexpr int LD1 = C + 8;
  const int m0 = warp / 4 * 32, col = warp % 4 * (C / 4) + 16 * j, h = col / D, e0 = col % D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[2][4], fb[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      fm::load_a(fa[i], a + (m0 + 16 * i) * LD1 + h * D + 16 * kk, LD1, lane);
    if (TRANS)
      load_kv_b<D, true>(fb, kvp, h * D + e0, 16 * kk, lane);
    else
      load_kv_b<D, false>(fb, kvp, h * D + 16 * kk, e0, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) fm::mma16(acc[i], fa[i], fb);
  }
}

// K^T V of one image from the merge's fragment order into plain rows
// of shared memory (KvSmem: row h D + k, column n): this thread's
// 16-byte pieces are read first (load) and written out later (store), so
// that the read's latency hides behind other work
template <int C, int D>
struct KvPlain {
  static constexpr int PIECES = C * D / 8 / kThreads;
  uint4 raw[PIECES];

  __device__ __forceinline__ void load(const bf16* kvg) {
#pragma unroll
    for (int p = 0; p < PIECES; ++p)
      raw[p] = *reinterpret_cast<const uint4*>(kvg + (size_t)(threadIdx.x + p * kThreads) * 8);
  }

  __device__ __forceinline__ void store(bf16* kvp) const {
    constexpr int DT = D / 16;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      const int e8 = threadIdx.x + p * kThreads, ln = e8 & 31, tl = e8 >> 5;
      const int h = tl / (DT * DT), nt = (tl / DT) % DT, kt = tl % DT;
      const uint32_t w[4] = {raw[p].x, raw[p].y, raw[p].z, raw[p].w};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int k = kt * 16 + 2 * (ln & 3) + (q & 1) + 8 * ((q >> 1) & 1);
        const int n = nt * 16 + (ln >> 2) + 8 * (q >> 2);
        const uint32_t bits = q & 1 ? w[q >> 1] >> 16 : w[q >> 1] & 0xffffu;
        kvp[KvSmem<D>::at(h * D + k, n)] =
            __ushort_as_bfloat16(static_cast<unsigned short>(bits));
      }
    }
  }
};

// Column sums of NV quantities, each warp's v[k][i] for columns lane V + i
// summed over its rows, into out[k C + column]: each warp's into part
// ([8][NV][C] f32), then, after a barrier, the 8 warps added in a fixed order.
template <int C, int NV>
__device__ __forceinline__ void warp_col_sums(const float (&v)[NV][C / 32], float* part,
                                             float* out, int warp, int lane) {
  constexpr int V = C / 32;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) part[(warp * NV + k) * C + lane * V + i] = v[k][i];
  __syncthreads();
  for (int e = threadIdx.x; e < NV * C; e += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += part[w * NV * C + e];
    out[e] = t;
  }
}

// 64 rows of C bf16 (row stride C) into shared memory (row stride ld) by
// cp.async, committed as one group; rows at or past valid zero-filled
template <int C>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* src, int valid) {
  for (int e = threadIdx.x; e < T * C / 8; e += kThreads) {
    const int r = e / (C / 8), c = e % (C / 8) * 8;
    if (r < valid)
      fm::cp_async16(dst + r * ld + c, src + (size_t)r * C + c);
    else
      *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  fm::cp_async_commit();
}

__device__ __forceinline__ float2 get2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void put2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <int C, int D>
struct BwdSmem {
  static constexpr int LD1 = C + 8;      // [64, C] bf16 rows
  static constexpr int LD2 = 2 * C + 8;  // dy1 [64, 2C] over the first two buffers
  static constexpr int LDH = HC + 8;     // a hidden chunk
  static constexpr size_t R = (size_t)T * LD1 * 2;  // bytes of a [64, C] buffer
  static constexpr size_t x_off = 0;                // x, y2; then dy1 over x | o
  static constexpr size_t o_off = R;                // o, msg, LN2's column sums
  static constexpr size_t q_off = 2 * R;            // Q, then x, then dqf
  static constexpr size_t m_off = 3 * R;            // m1, then dm1, then dopre
  static constexpr size_t k_off = 4 * R;            // K^T V, hidden chunk, dy2, dmsg, K^T V
  static constexpr size_t g_off = 5 * R;            // g
  static constexpr size_t ks_off = 6 * R;           // f32 K_sum [C]
  static constexpr size_t st_off = ks_off + C * 4;  // f32 mu1, rs1 [64]
  static constexpr size_t col_off = st_off + 2 * T * 4;           // f32 column sums [2][C]
  static constexpr size_t ln_off = col_off + 2 * C * 4;           // f32 n1s, n1b, n2s [C]
  static constexpr size_t z_off = ln_off + 3 * C * 4;             // f32 n1s, n1b, n2s [C]
  // f32 [64][H] each: Z + eps, S / (Z + eps) and the head sums of dZ
  static constexpr size_t bytes = z_off + 3 * T * (C / D) * 4;
  static_assert(T * LD2 * 2 <= 2 * R, "dy1 must fit the first two buffers");
  static_assert(T * LDH * 2 <= R && C * KvSmem<D>::LD * 2 <= R && T / 2 * (C + 4) * 4 <= R &&
                    kWarps * 2 * C * 4 <= R,
                "the tenants of the second and fifth buffers must fit");
  static_assert(bytes <= kMaxSmem, "apply_bwd shared memory");
};

// grid (ceil(L / 64), G): block (b, g) takes query rows [64 b, 64 b + 64) of image g
template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1)
apply_bwd_kernel(const __grid_constant__ BwdIO io, int L, int S) {
  using Sm = BwdSmem<C, D>;
  constexpr int H = C / D, DT = D / 16, NT = C / 64, NCH = 2 * C / HC, HPW = C / 4 / D;
  constexpr int LD1 = Sm::LD1, LD2 = Sm::LD2, LDH = Sm::LDH;
  constexpr int V = C / 32;  // a lane's columns of a row
  constexpr float kInvC = 1.0f / C;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + Sm::x_off);
  bf16* dy1s = xs;  // [64][LD2]
  bf16* os = reinterpret_cast<bf16*>(smem + Sm::o_off);
  bf16* qs = reinterpret_cast<bf16*>(smem + Sm::q_off);
  bf16* ms = reinterpret_cast<bf16*>(smem + Sm::m_off);
  bf16* ks4 = reinterpret_cast<bf16*>(smem + Sm::k_off);
  float* kss = reinterpret_cast<float*>(smem + Sm::ks_off);
  float* mu1 = reinterpret_cast<float*>(smem + Sm::st_off);
  float* rs1 = mu1 + T;
  float* colp = reinterpret_cast<float*>(smem + Sm::col_off);
  float* n1s = reinterpret_cast<float*>(smem + Sm::ln_off);  // LN1's scale and bias, LN2's scale
  float* n1b = n1s + C;
  float* n2s = n1b + C;
  bf16* gs = reinterpret_cast<bf16*>(smem + Sm::g_off);
  float* zsm = reinterpret_cast<float*>(smem + Sm::z_off);  // [64][H] Z + eps of the do phase
  float* nsm = zsm + T * H;                                   // S / (Z + eps)
  float* dzs = nsm + T * H;                                   // the head sums of dZ
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.y, r0 = blockIdx.x * T, valid = min(T, L - r0);
  const size_t row0 = (size_t)g * L + r0;  // first token of the tile
  const size_t tile = (size_t)g * gridDim.x + blockIdx.x;
  const float s_f = (float)S;
  float* pln = io.part_ln + tile * 4 * C;  // dn1s | dn1b | dn2s | dn2b
  // a stash operand's tile rows from shared memory, 16 bytes a thread (rows past valid: none)
  auto stash = [&](bf16* base, int ld, const bf16* from, int lds, int cols) {
    fm::copy_rows_from_smem(base + row0 * ld, ld, from, lds, valid, cols);
  };

  load_rows_async<C>(xs, LD1, io.x + row0 * C, valid);
  load_rows_async<C>(gs, LD1, io.g + row0 * C, valid);  // g for LN2 and dx, read once
  for (int c = threadIdx.x; c < C; c += kThreads) {
    kss[c] = bf(io.ks[(size_t)g * C + c]);
    n1s[c] = io.n1s[c];
    n1b[c] = io.n1b[c];
    n2s[c] = io.n2s[c];
  }
  KvPlain<C, D> kvl;
  kvl.load(io.kv + (size_t)g * C * D);

  // ---- forward recompute, in coarse_transformer.cu's apply rounding ----
  fm::cp_async_wait<1>();
  __syncthreads();  // x has landed
  constexpr int S1 = C / 16, S2 = 2 * C / 16, S3 = 3 * C / 16;  // 16-row steps of C, 2C, 3C rows
  Acc<C> acc;  // the [64, C] products
  zero<C>(acc);
  product<C, C>(acc, xs, LD1, xs, LD1, io.wq, S1, 0, 0, warp, lane);  // Q = elu(x . wq) + 1
  for_pairs<NT>(warp, lane, [&](int i, int j, int jp, int, int r, int c) {
    put2(qs + r * LD1 + c, fm::elu1(acc[i][j].c[2 * jp]), fm::elu1(acc[i][j].c[2 * jp + 1]));
  });
  kvl.store(ks4);
  __syncthreads();
  float z[4][HPW];  // Z of the lane's rows and the warp's heads, then S / (Z + eps)
  head_z<C, D>(z, qs, kss, warp, lane);
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) z[ri][hh] = s_f / (z[ri][hh] + kEps);
#pragma unroll
  for (int j = 0; j < NT; ++j) {  // o = Q_h . KV_h * (S / (Z + eps)), a column tile at a time
    Acc16 t[2];
    fm::zero(t[0]);
    fm::zero(t[1]);
    head_tile<C, D, false>(t, qs, ks4, j, warp, lane);
    for_pairs_of<NT>(j, warp, lane, [&](int i, int jp, int ri, int r, int c) {
      const float nf = z[ri][16 * j / D];
      const float v0 = t[i].c[2 * jp] * nf, v1 = t[i].c[2 * jp + 1] * nf;
      put2(os + r * LD1 + c, v0, v1);
    });
  }
  __syncthreads();
  stash(io.o, C, os, LD1, C);
  zero<C>(acc);
  product<C, C>(acc, os, LD1, os, LD1, io.wmerge, S1, 0, 0, warp, lane);  // m1 = bf16(o . wmerge)
  for_pairs<NT>(warp, lane, [&](int i, int j, int jp, int, int r, int c) {
    put2(ms + r * LD1 + c, acc[i][j].c[2 * jp], acc[i][j].c[2 * jp + 1]);
  });
  __syncthreads();  // m1 is in place, and every warp is done reading o
  // msg = LN1(m1) over o, a warp a row (stashed); m1 and its statistics kept
  // for the LN1 backward
  for (int r = warp; r < T; r += kWarps) {
    float v[V];
    fm::load_bf16<V>(ms + r * LD1 + lane * V, v);
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) t += v[i];
    const float m = fm::warp_sum(t) * kInvC;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] -= m;
      q += v[i] * v[i];
    }
    const float rr = rsqrtf(fm::warp_sum(q) * kInvC + fm::kLnEps);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = v[i] * rr * n1s[lane * V + i] + n1b[lane * V + i];
    fm::store_bf16<V>(os + r * LD1 + lane * V, v);
    if (lane == 0) {
      mu1[r] = m;
      rs1[r] = rr;
    }
  }
  __syncthreads();
  stash(io.msg, C, os, LD1, C);
  // FFN in chunks of HC hidden columns: h = relu([x | msg] . w1[:, chunk])
  // into the fifth buffer (stashed; its positive entries as bits in
  // mask[chunk]), then y2 += h . w2[chunk, :] in registers
  uint32_t mask[NCH];
  Acc<C> acc2;  // y2, then dmsg
  zero<C>(acc2);
#pragma unroll 1
  for (int ch = 0; ch < NCH; ++ch) {
    Acc<HC> ah;
    zero<HC>(ah);
    product<HC, 2 * C, C>(ah, xs, LD1, os, LD1, io.w1, S2, ch * HC / 16, 0, warp, lane);
    __syncthreads();  // every warp is done with the previous hidden chunk
    uint32_t bits = 0u;
    for_pairs<HC / 64>(warp, lane, [&](int i, int j, int jp, int, int r, int c) {
      const float v0 = ah[i][j].c[2 * jp], v1 = ah[i][j].c[2 * jp + 1];
      const int b = ((i * (HC / 64) + j) * 4 + jp) * 2;
      bits |= (v0 > 0.f ? 1u : 0u) << b | (v1 > 0.f ? 1u : 0u) << (b + 1);
      put2(ks4 + r * LDH + c, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
    mask[ch] = bits;
    __syncthreads();
    stash(io.h + ch * HC, 2 * C, ks4, LDH, HC);
    product<C, HC>(acc2, ks4, LDH, ks4, LDH, io.w2, S2, 0, ch * HC, warp, lane);
  }

  // ---- backward ----
  // LN2 of y2 = bf16(acc2) (over x) and its backward for g, a warp a row:
  // dy2 into the fifth buffer (stashed), dn2s and dn2b
  for_pairs<NT>(warp, lane, [&](int i, int j, int jp, int, int r, int c) {
    put2(xs + r * LD1 + c, acc2[i][j].c[2 * jp], acc2[i][j].c[2 * jp + 1]);
  });
  fm::cp_async_wait<0>();  // g
  __syncthreads();
  {
    float cs[2][V] = {};
    for (int r = warp; r < T; r += kWarps) {
      float y[V], gv[V];
      fm::load_bf16<V>(xs + r * LD1 + lane * V, y);
      fm::load_bf16<V>(gs + r * LD1 + lane * V, gv);
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) t += y[i];
      const float m = fm::warp_sum(t) * kInvC;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        y[i] -= m;
        q += y[i] * y[i];
      }
      const float rr = rsqrtf(fm::warp_sum(q) * kInvC + fm::kLnEps);
      float d1 = 0.f, d2 = 0.f, dh[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        y[i] *= rr;  // xhat
        dh[i] = gv[i] * n2s[lane * V + i];
        d1 += dh[i];
        d2 += dh[i] * y[i];
        cs[0][i] += gv[i] * y[i];
        cs[1][i] += gv[i];
      }
      d1 = fm::warp_sum(d1) * kInvC;
      d2 = fm::warp_sum(d2) * kInvC;
#pragma unroll
      for (int i = 0; i < V; ++i) dh[i] = rr * (dh[i] - d1 - y[i] * d2);
      fm::store_bf16<V>(ks4 + r * LD1 + lane * V, dh);
    }
    warp_col_sums<C, 2>(cs, reinterpret_cast<float*>(os), pln + 2 * C, warp, lane);
  }
  stash(io.dy2, C, ks4, LD1, C);
  __syncthreads();  // every warp is done with the column sums over o's buffer
  // dy1 = (dy2 . w2ᵀ) * (y1 > 0) chunk by chunk into the first two buffers
  // (stashed), then dmsg += dy1[:, chunk] . w1[C:]ᵀ[chunk, :] in registers
  zero<C>(acc2);
#pragma unroll 1
  for (int ch = 0; ch < NCH; ++ch) {
    Acc<HC> ah;
    zero<HC>(ah);
    product<HC, C>(ah, ks4, LD1, ks4, LD1, io.w2t, S1, ch * HC / 16, 0, warp, lane);
    const uint32_t bits = mask[ch];
    for_pairs<HC / 64>(warp, lane, [&](int i, int j, int jp, int, int r, int c) {
      const int b = ((i * (HC / 64) + j) * 4 + jp) * 2;
      const float v0 = (bits >> b) & 1u ? ah[i][j].c[2 * jp] : 0.f;
      const float v1 = (bits >> (b + 1)) & 1u ? ah[i][j].c[2 * jp + 1] : 0.f;
      put2(dy1s + r * LD2 + ch * HC + c, v0, v1);
    });
    __syncthreads();
    stash(io.dy1 + ch * HC, 2 * C, dy1s + ch * HC, LD2, HC);
    product<C, HC>(acc2, dy1s + ch * HC, LD2, dy1s + ch * HC, LD2, io.w1mt, S2, 0, ch * HC,
                   warp, lane);
  }
  {  // the LN1 backward of dmsg (acc2, f32), a warp a row, dmsg through the
     // fifth buffer (dy2's, no longer read) a row half at a time: dm1 over m1
     // (stashed), dn1s, dn1b
    constexpr int LDF = C + 4;
    float* dm = reinterpret_cast<float*>(ks4);  // f32 [32][LDF]
    float cs[2][V] = {};
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      if (warp / 4 == half)
        for_pairs<NT>(warp, lane, [&](int i, int j, int jp, int, int r, int c) {
          *reinterpret_cast<float2*>(dm + (r - 32 * half) * LDF + c) =
              make_float2(acc2[i][j].c[2 * jp], acc2[i][j].c[2 * jp + 1]);
        });
      __syncthreads();
      for (int r = 32 * half + warp; r < 32 * half + 32; r += kWarps) {
        float x[V], d[V];
        fm::load_bf16<V>(ms + r * LD1 + lane * V, x);
        const float* dr = dm + (r - 32 * half) * LDF + lane * V;
        float d1 = 0.f, d2 = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          x[i] = (x[i] - mu1[r]) * rs1[r];
          cs[0][i] += dr[i] * x[i];
          cs[1][i] += dr[i];
          d[i] = dr[i] * n1s[lane * V + i];
          d1 += d[i];
          d2 += d[i] * x[i];
        }
        d1 = fm::warp_sum(d1) * kInvC;
        d2 = fm::warp_sum(d2) * kInvC;
#pragma unroll
        for (int i = 0; i < V; ++i) d[i] = rs1[r] * (d[i] - d1 - x[i] * d2);
        fm::store_bf16<V>(ms + r * LD1 + lane * V, d);
      }
      __syncthreads();
    }
    warp_col_sums<C, 2>(cs, dm, pln, warp, lane);
  }
  stash(io.dm1, C, ms, LD1, C);
  __syncthreads();  // every warp is done with the column sums over the fifth buffer
  kvl.load(io.kv + (size_t)g * C * D);
  // do = dm1 . wmergeᵀ beside the recomputed Q_h . KV_h; dopre = do n over
  // dm1 (stashed nowhere), the head sums of dZ = -(do o) / (Z + eps) kept in
  // the lanes of their rows, and the dK_sum partial Qᵀ dZ
  zero<C>(acc);
  product<C, C>(acc, ms, LD1, ms, LD1, io.wmt, S1, 0, 0, warp, lane);
  kvl.store(ks4);  // over dy2, which no warp reads any more
  {
    head_z<C, D>(z, qs, kss, warp, lane);  // the lane's rows and the warp's heads
    if ((lane & 3) == 0) {
#pragma unroll
      for (int ri = 0; ri < 4; ++ri)
#pragma unroll
        for (int hh = 0; hh < HPW; ++hh) {
          const int at = lane_row(ri, warp, lane) * H + warp % 4 * HPW + hh;
          zsm[at] = z[ri][hh] + kEps;
          nsm[at] = s_f / zsm[at];
        }
    }
    __syncthreads();  // every warp has read dm1, and K^T V is in place
#pragma unroll 1
    for (int j = 0; j < NT; ++j) {  // Q_h . KV_h beside do, a column tile at a time
      Acc16 dj[2], t[2];
      pick<NT>(dj, acc, j);
      fm::zero(t[0]);
      fm::zero(t[1]);
      head_tile<C, D, false>(t, qs, ks4, j, warp, lane);
      float dzj[4] = {};
      for_pairs_of<NT>(j, warp, lane, [&](int i, int jp, int ri, int r, int c) {
        const float zz = zsm[r * H + c / D], n = nsm[r * H + c / D];
        const float do0 = dj[i].c[2 * jp], do1 = dj[i].c[2 * jp + 1];
        put2(ms + r * LD1 + c, do0 * n, do1 * n);
        dzj[ri] += fm::round_bf16(-(do0 * (t[i].c[2 * jp] * n)) / zz) +
                   fm::round_bf16(-(do1 * (t[i].c[2 * jp + 1] * n)) / zz);
      });
      const int h = (warp % 4 * (C / 4) + 16 * j) / D;
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        dzj[ri] += __shfl_xor_sync(0xffffffffu, dzj[ri], 1);
        dzj[ri] += __shfl_xor_sync(0xffffffffu, dzj[ri], 2);
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          float& d = dzs[lane_row(ri, warp, lane) * H + h];
          d = (16 * j % D == 0 ? 0.f : d) + dzj[ri];
        }
      }
    }
    __syncwarp();  // the warp's dZ head sums, for its rows and heads
#pragma unroll 1
    for (int j = 0; j < NT; ++j) {
      float cs[1][4] = {};
      for_pairs_of<NT>(j, warp, lane, [&](int, int jp, int, int r, int c) {
        const float2 qv = get2(qs + r * LD1 + c);
        const float dz = dzs[r * H + c / D];
        const int qq = 2 * (jp >> 1);
        cs[0][qq] += qv.x * dz;
        cs[0][qq + 1] += qv.y * dz;
      });
      col_part<C, 1>(cs, colp, j, warp, lane);
    }
    __syncthreads();  // also orders dopre's writes before the partials
    col_total<C, 1>(colp, io.part_ks + tile * C);
  }
  {  // the dK^T V partial Q_hᵀ dopre_h [D, D] of each head
    constexpr int UNITS = H * DT * DT, UPW = (UNITS + kWarps - 1) / kWarps;
    float* pk = io.part_kv + tile * C * D;
#pragma unroll
    for (int jw = 0; jw < UPW; ++jw) {
      const int u = warp + jw * kWarps;
      if (u < UNITS) {
        const int h = u / (DT * DT), i = (u / DT) % DT, jj = u % DT;
        Acc16 pa;
        fm::zero(pa);
#pragma unroll
        for (int k = 0; k < T / 16; ++k) {
          uint32_t fa[4], fb[4];
          fm::load_a_trans(fa, qs + k * 16 * LD1 + h * D + i * 16, LD1, lane);
          fm::load_b(fb, ms + k * 16 * LD1 + h * D + jj * 16, LD1, lane);
          fm::mma16(pa, fa, fb);
        }
        fm::tile_epilogue(pa, i * 16, jj * 16, lane,
                          [&](int r, int c, float v) { pk[h * D * D + r * D + c] = v; });
      }
    }
  }
  __syncthreads();  // every warp has read Q
  // dQ = dopre_h . KV_hᵀ + dZ K_sum while x comes again over Q; then the
  // recomputed qf = x . wq, and dqf = dQ elu'(qf) over x (stashed)
  load_rows_async<C>(qs, LD1, io.x + row0 * C, valid);
  fm::cp_async_wait<0>();
  __syncthreads();  // x has landed
  zero<C>(acc);
  product<C, C>(acc, qs, LD1, qs, LD1, io.wq, S1, 0, 0, warp, lane);
  __syncthreads();  // every warp has read x
#pragma unroll 1
  for (int j = 0; j < NT; ++j) {  // dopre_h . KV_hᵀ beside qf, a column tile at a time
    Acc16 qj[2], t[2];
    pick<NT>(qj, acc, j);
    fm::zero(t[0]);
    fm::zero(t[1]);
    head_tile<C, D, true>(t, ms, ks4, j, warp, lane);
    for_pairs_of<NT>(j, warp, lane, [&](int i, int jp, int, int r, int c) {
      const float zd = dzs[r * H + c / D];
      const float q0 = qj[i].c[2 * jp], q1 = qj[i].c[2 * jp + 1];
      // elu's derivative exp(min(qf, 0)), by ex2.approx (__expf)
      const float v0 = (t[i].c[2 * jp] + zd * kss[c]) * __expf(fminf(q0, 0.f));
      const float v1 = (t[i].c[2 * jp + 1] + zd * kss[c + 1]) * __expf(fminf(q1, 0.f));
      put2(qs + r * LD1 + c, v0, v1);
    });
  }
  __syncthreads();
  stash(io.dqf, C, qs, LD1, C);
  // dx = g + [dqf | dy1] . [wqᵀ ; w1[:C]ᵀ]
  zero<C>(acc);
  product<C, C>(acc, qs, LD1, qs, LD1, io.wdxt, S3, 0, 2 * C, warp, lane);
  product<C, 2 * C>(acc, dy1s, LD2, dy1s, LD2, io.wdxt, S3, 0, 0, warp, lane);
  for_pairs<NT>(warp, lane, [&](int i, int j, int jp, int, int r, int c) {
    const float2 gv = get2(gs + r * LD1 + c);
    if (r < valid)
      put2(io.dx + (row0 + r) * C + c, gv.x + acc[i][j].c[2 * jp], gv.y + acc[i][j].c[2 * jp + 1]);
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

// ---- stats_bwd: the source side, on wgmma ----
//
// For each source token: [K | V] = elu(src . wk) + 1 | src . wv / S
// recomputed, then per head dV = K_h dKV_h / S and dK = V_h dKV_hᵀ +
// dK_sum, dkf = dK elu'(src . wk), the stash's [dkf | dv] and dsrc = [dkf |
// dv] wkvᵀ. Bound on the H100 by bytes (src in, dsrc and [dkf | dv] out:
// 8 C bytes a token, against 2 C² + 2 C D multiply-adds; kernel_bounds.
// coarse_train_stats_bwd_work). The first design (one 64-token tile a block
// of 8 warps on mma.sync, every B fragment read from L2 by ld.global.nc, src
// . wk computed twice, wkv and a packed wkvᵀ both read a tile: about 8 KB of
// L2 reads a token) took 1.89 ms over the training step's 12 calls against
// 0.189. Design:
//   - A persistent grid of one 256-thread block an SM; block b takes a run
//     of the G images' 64-token tiles (numbered image by image; the runs
//     differ by one tile at most) and its two warpgroups take alternate
//     tiles of the run. A warpgroup synchronises only itself (named barrier
//     1 + its index).
//   - The weights come as units of SU = 32 K features and their V features
//     (ops/coarse_transformer_train.stats_bwd_image: a unit's [C, 64]
//     columns [wk_u | wv_u] as C / 64 boxes [64 outputs][64 inputs] of bf16
//     in the 128-byte swizzle, C * 128 bytes) through a ring of kSbSlots
//     slots, each filled by one bulk copy completing on its mbarrier. Both
//     warpgroups read every unit, so a unit leaves L2 once for 128 tokens,
//     and each reads it twice: K-major (sw128_desc) as the B of [K | V] =
//     src W_u, MN-major (sw128_mn_desc) as the B of dsrc += [dkf | dv]
//     W_uᵀ. So the weights leave L2 once a tile pair for both products (2
//     C² bf16) where a separate transposed image would double that. A warp
//     hands a slot back when its dsrc product has completed; the last of
//     the round's warps to hand it back starts the copy of the unit
//     kSbSlots further on (no producer warp).
//   - The source tile comes by C / 64 tensor copies of [64, 64] boxes (a
//     tensor map over [G S, C], 128-byte swizzle: the A of [K | V] read
//     K-major; rows past G S read as zeros) into the warpgroup's slot; the
//     next tile's copy starts as soon as the last unit's [K | V] has read it.
//   - A unit, in registers: [K | V] on m64n64k16 wgmma (C / 16 k-steps),
//     the pre-activation kf kept for elu's derivative; K and V as m16n8k16
//     A fragments (wgmma.cuh: an accumulator's 16 columns are the fragment
//     of a k-step); each warp's 16 rows of dV and dK per head on mma.sync
//     (a head is 16 or 32 columns wide, too narrow for wgmma) with the
//     image's dKᵀV read by ldmatrix from shared memory (plain rows [C][D +
//     8], loaded when a warpgroup's tile starts a new image); [dkf | dv]
//     rounded once to bf16, as A fragments of dsrc += [dkf | dv] W_uᵀ on
//     m64nCk16 wgmma (4 k-steps a unit, the [64, C] accumulator in
//     registers over the units, C / 2 a thread) and as the stash's values,
//     stored from the same registers in 8-byte pieces after one exchange
//     between lane pairs. Units of 32 keep a thread's registers below 255:
//     the dsrc accumulator, the unit's [K | V] (32) and its fragments.
//   - At head dim 64 a head spans two units, whose dV and dK each need the
//     other's K and V. So the loop takes the units in groups of UG, the
//     units a head spans (one below head dim 64, a group's head k-steps
//     read from the unit and k-step that hold them): the pair's [K | V]
//     products come first (both units'
//     fragments and elu' kept: 64 registers), then each unit's [dkf | dv]
//     over the head and its dsrc product, the two slots handed back
//     together. Two slots, not three: the warpgroups' [256][72] dKᵀV
//     (73,728 bytes) leave no room for a third (207,912 bytes of 232,448).
//   - No atomics and no cross-block sums: each output is written once, so
//     two runs agree bit for bit.
// Rounding as `stats_backward_reference`: K and V rounded to bf16 before the
// products, dKᵀV and dK_sum read as bf16, [dkf | dv] rounded once, f32 sums;
// elu and its derivative by __expf (as K5's stats kernel forms K).
// Measured (tools/coarse_train_bwd_ab.py, tools/coarse_stats_bwd_probe.py;
// NVIDIA H100 80GB HBM3, 700 W): about 0.50 ms over the step's 12 calls
// against 1.89 for the first design. A block's start-up (its first source
// tile and units) takes about 5 us, a tile pair about 17.5 us and a tile
// alone about 9.5; at 64-token tiles a cross call's 300 tiles leave 36
// blocks a third tile. Neither issuing the next unit's [K | V] behind dsrc's
// product (ptxas then serialized the products for want of registers), nor
// the warpgroups taking turns at [K | V], nor 16-byte or 4-byte stash
// stores in place of the 8-byte ones, was faster.

constexpr int SU = 32;           // K features of a unit, and as many V features
constexpr int kSbThreads = 256;  // two warpgroups, a 64-token tile each
constexpr int kSbSlots = 3;      // weight units in flight a block

template <int C, int D>
struct SbLayout {
  static constexpr int UNITS = C / SU;
  static constexpr int UG = D > SU ? D / SU : 1;  // units a group: those a head spans
  // weight units in flight: at D = 64 two (two units make a head, and the
  // two warpgroups' [C][72] dKᵀV leave no room for a third slot)
  static constexpr int NS = D == 64 ? 2 : kSbSlots;
  static constexpr uint32_t UNIT = (uint32_t)C * 128;  // a unit's image: C / 64 boxes [64][64]
  static constexpr uint32_t SRC = (uint32_t)T * C * 2;  // a source tile: C / 64 boxes [64][64]
  static constexpr int LDKV = D + 8;                    // dKᵀV rows, plain [C][D + 8]
  static constexpr uint32_t DKV = (uint32_t)C * LDKV * 2;
  static constexpr uint32_t w_off = 0;                     // the ring's slots
  static constexpr uint32_t src_off = w_off + NS * UNIT;   // a source tile a warpgroup
  static constexpr uint32_t dkv_off = src_off + 2 * SRC;   // dKᵀV a warpgroup
  static constexpr uint32_t dks_off = dkv_off + 2 * DKV;   // f32 dK_sum [C] a warpgroup
  static constexpr uint32_t bar_off = dks_off + 2 * C * 4; // mbarriers, slot counters
  // + 1024: the slots' swizzle atoms need 1024-byte aligned addresses
  static constexpr size_t bytes = bar_off + 8 * (NS + 2) + 4 * NS + 1024;
  static_assert(bytes <= kMaxSmem, "stats_bwd shared memory");
  static_assert(C % 64 == 0 && (SU % D == 0 || D == UG * SU) && NS >= UG,
                "whole boxes, whole heads a group of units, a group's slots in the ring");
};

struct SbIO {
  const bf16* dkv;             // merged dKᵀV, plain [G][H][D][D]
  const bf16* dks;             // merged dK_sum [G][C]
  const unsigned char* image;  // stats_bwd_image
  bf16* dkv3;                  // the stash's [dkf | dv] [G S][2C]
  bf16* dsrc;                  // [G S][C]
  int S, tiles;                // tiles: G ceil(S / 64)
};

// operand descriptors computed where they are used (fm::pinned): a box
// K-major, or MN-major with its 64-wide column blocks 8 KB (a box) apart
__device__ __forceinline__ uint64_t kdesc(uint32_t a) { return fm::sw128_desc(fm::pinned(a)); }
__device__ __forceinline__ uint64_t mdesc(uint32_t a) {
  return fm::sw128_mn_desc(fm::pinned(a), 8192);
}

// The thread's part of a 16-column group of its rows r0 and r0 + 8 (those
// below `valid`), f[r] its bf16 pairs as an m16n8k16 A fragment holds them,
// into rows of `ld` values at dst: 8 bytes a store after one exchange
// between lanes t and t ^ 1 (a quad's store: 32 bytes of a row)
__device__ __forceinline__ void store16(bf16* dst, int ld, const uint32_t (&f)[4], int r0,
                                        int valid, int t) {
  const bool odd = t & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t w0 = f[i], w1 = f[2 + i];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w0 : w1, 1);
    const int r = r0 + 8 * i, c = odd ? 8 + 2 * (t - 1) : 2 * t;
    if (r < valid)
      *reinterpret_cast<uint2*>(dst + (size_t)r * ld + c) =
          odd ? make_uint2(got, w1) : make_uint2(w0, got);
  }
}

// start the copy of the source rows [row, row + 64) into a warpgroup's slot:
// C / 64 boxes of [64 rows, 64 columns], 8 KB each; completes on `bar`
template <int C>
__device__ __forceinline__ void fill_src(unsigned char* slot, const CUtensorMap* map, int row,
                                         uint64_t* bar) {
  fm::fence_proxy_async();
  fm::mbar_arrive_expect(bar, T * C * 2);
#pragma unroll
  for (int j = 0; j < C / 64; ++j) fm::tma_load_2d(slot + j * T * 128, map, 64 * j, row, bar);
}

template <int C, int D>
__global__ void __launch_bounds__(kSbThreads, 1)
stats_bwd_kernel(const __grid_constant__ CUtensorMap src, const __grid_constant__ SbIO io) {
  using L = SbLayout<C, D>;
  constexpr int UNITS = L::UNITS, NS = L::NS, LDKV = L::LDKV, UG = L::UG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (fm::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* sfull = full + NS;
  int* counts = reinterpret_cast<int*>(sfull + 2);
  // the warpgroup by a shuffle, which ptxas takes as uniform: the operand
  // descriptors are then too, and the products stay asynchronous
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int wt = threadIdx.x & 127, w = wt >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * w + (lane >> 2);  // the thread's rows: r0, r0 + 8
  const uint32_t sm = fm::smem_u32(smem);
  unsigned char* srcs = smem + L::src_off + wg * L::SRC;
  const uint32_t ssrc = fm::smem_u32(srcs);
  bf16* dkvp = reinterpret_cast<bf16*>(smem + L::dkv_off + wg * L::DKV);
  float* dkss = reinterpret_cast<float*>(smem + L::dks_off) + wg * C;
  const int S = io.S, per_img = (S + T - 1) / T;
  const float inv_s = 1.0f / (float)S;
  // the block's run of tiles [t0, t1): warpgroup 0 takes t0, t0 + 2, ..,
  // warpgroup 1 t0 + 1, t0 + 3, ..; round k is each one's k-th tile
  const int t0 = (int)((long long)blockIdx.x * io.tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * io.tiles / gridDim.x);
  const int rounds = (t1 - t0 + 1) / 2, mine = (t1 - t0 + 1 - wg) / 2;
  const int items = rounds * UNITS;  // the units the ring brings in
  auto tile_row = [&](int tile) { return (tile / per_img) * S + tile % per_img * T; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS + 2; ++i) fm::mbar_init(&full[i], 1);
    fm::mbar_init_fence();
    for (int i = 0; i < NS && i < items; ++i) {
      fm::mbar_arrive_expect(&full[i], L::UNIT);
      fm::bulk_load(smem + L::w_off + i * L::UNIT, io.image + (size_t)(i % UNITS) * L::UNIT,
                    L::UNIT, &full[i]);
    }
  }
  if (threadIdx.x < NS) counts[threadIdx.x] = 0;
  __syncthreads();
  if (wt == 0 && mine > 0) fill_src<C>(srcs, &src, tile_row(t0 + wg), &sfull[wg]);

  int img = -1;  // the image whose dKᵀV and dK_sum are in place
#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    const int tile = t0 + 2 * k + wg, gi = tile / per_img;
    const int valid = min(T, S - tile % per_img * T);
    const size_t row0 = (size_t)tile_row(tile);
    // the warps that hand back this round's units, less one
    const uint32_t last = t0 + 2 * k + 1 < t1 ? 7 : 3;
    if (gi != img) {
      fm::named_barrier(1 + wg, 128);  // every warp is done with the last image's
      const bf16* dg = io.dkv + (size_t)gi * C * D;
      for (int e = wt; e < C * D / 8; e += 128) {
        const int row = e / (D / 8), c = e % (D / 8) * 8;  // row = h D + d
        *reinterpret_cast<uint4*>(dkvp + row * LDKV + c) =
            *reinterpret_cast<const uint4*>(dg + (size_t)row * D + c);
      }
      for (int c = wt; c < C; c += 128) dkss[c] = __bfloat162float(io.dks[(size_t)gi * C + c]);
      fm::named_barrier(1 + wg, 128);
      img = gi;
    }
    float ds[C / 2];  // dsrc [64, C] over the units
    fm::zero_regs(ds);
    fm::mbar_wait(&sfull[wg], k & 1);
    // the units a group at a time: a group is one unit, or at D = 64 the two
    // units a head spans (its K and V features 0..31 in the first, 32..63 in
    // the second), whose dV and dK each need the other's K and V. The
    // group's [K | V] products come first, then each unit's [dkf | dv] over
    // its heads and its dsrc product; the group's slots go back together
#pragma unroll 1
    for (int q = 0; q < UNITS; q += UG) {
      // K and V (bf16) as the A fragments of each unit's two k-steps, and
      // elu's derivative exp(min(kf, 0)) (elu(kf) + 1 is max(kf, 0) +
      // exp(min(kf, 0)), by ex2.approx, as K5's stats kernel forms K)
      uint32_t kfr[UG][2][4], vfr[UG][2][4];
      float der[UG][16];
#pragma unroll
      for (int u = 0; u < UG; ++u) {
        const int i = k * UNITS + q + u, s = i % NS;
        const uint32_t slot = sm + L::w_off + s * L::UNIT;
        fm::mbar_wait(&full[s], (i / NS) & 1);
        float acc[32];  // [kf | v] of the unit's 32 features, 16 columns an 8-entry group
        fm::zero_regs(acc);
        fm::wgmma_fence();
#pragma unroll
        for (int st = 0; st < C / 16; ++st) {  // k-step st: box st / 4, 32 bytes a k-step in
          const uint32_t at = (st / 4) * (T * 128) + (st % 4) * 32;
          fm::wgmma_ss_n64(acc, kdesc(ssrc + at), kdesc(slot + at), 1);
        }
        fm::wgmma_commit();
        fm::wgmma_wait<0>();
        fm::fence_regs(acc);
        if (q + u == UNITS - 1) {
          fm::named_barrier(1 + wg, 128);  // every warp's products have read the source tile
          if (wt == 0 && k + 1 < mine) fill_src<C>(srcs, &src, tile_row(tile + 2), &sfull[wg]);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int a = 8 * kk + 2 * r;
            const float e0 = __expf(fminf(acc[a], 0.f)), e1 = __expf(fminf(acc[a + 1], 0.f));
            kfr[u][kk][r] = fm::pack_bf16(fmaxf(acc[a], 0.f) + e0, fmaxf(acc[a + 1], 0.f) + e1);
            der[u][a] = e0;
            der[u][a + 1] = e1;
            vfr[u][kk][r] = fm::pack_bf16(acc[16 + a] * inv_s, acc[16 + a + 1] * inv_s);
          }
      }
      uint32_t af[UG][4][4];  // each unit's [dkf | dv] A fragments (dkf 0, 1; dv 2, 3)
#pragma unroll
      for (int u = 0; u < UG; ++u) {
        // per 16 features: dV = K_h dKV_h, dK = V_h dKV_hᵀ (mma.sync, the
        // warp's 16 rows), the head's k-step dd read from the group's unit
        // and k-step that hold its features h D + 16 dd ..
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int f0 = SU * (q + u) + 16 * n, h = f0 / D, e0 = f0 % D;
          fm::Acc16 dv, dk;
          fm::zero(dv);
          fm::zero(dk);
#pragma unroll
          for (int dd = 0; dd < D / 16; ++dd) {
            const int fd = h * D + 16 * dd, gu = fd / SU - q, gk = fd % SU / 16;
            uint32_t fb[4], ft[4];
            fm::load_b(fb, dkvp + fd * LDKV + e0, LDKV, lane);
            fm::mma16(dv, kfr[gu][gk], fb);
            load_b_t(ft, dkvp + (h * D + e0) * LDKV + 16 * dd, LDKV, lane);
            fm::mma16(dk, vfr[gu][gk], ft);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c = f0 + 8 * (r >> 1) + 2 * t;  // the pair's first feature
            const float2 dks = *reinterpret_cast<const float2*>(dkss + c);
            af[u][n][r] = fm::pack_bf16((dk.c[2 * r] + dks.x) * der[u][8 * n + 2 * r],
                                        (dk.c[2 * r + 1] + dks.y) * der[u][8 * n + 2 * r + 1]);
            af[u][2 + n][r] = fm::pack_bf16(dv.c[2 * r] * inv_s, dv.c[2 * r + 1] * inv_s);
          }
        }
        // dsrc += [dkf | dv] W_uᵀ: B the unit's boxes read MN-major, k-step kk
        // its output rows 16 kk .. (two atoms), the C inputs in 64-wide blocks
        const uint32_t slot = sm + L::w_off + ((k * UNITS + q + u) % NS) * L::UNIT;
        fm::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (C == 256)
            fm::wgmma_rs_n256<1>(ds, af[u][kk], mdesc(slot + kk * 2048), 1);
          else
            fm::wgmma_rs_n128<1>(ds, af[u][kk], mdesc(slot + kk * 2048), 1);
        }
        fm::wgmma_commit();
        // the stash's [dkf | dv] while the product runs
        bf16* st = io.dkv3 + row0 * 2 * C + SU * (q + u);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          store16(st + 16 * n, 2 * C, af[u][n], r0, valid, t);
          store16(st + C + 16 * n, 2 * C, af[u][2 + n], r0, valid, t);
        }
      }
      fm::wgmma_wait<0>();
      fm::fence_regs(ds);
#pragma unroll
      for (int u = 0; u < UG; ++u)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(af[u][kk][r])::"memory");
      // the group's slots back; the round's last warp to hand one back refills it
#pragma unroll
      for (int u = 0; u < UG; ++u) {
        const int i = k * UNITS + q + u, s = i % NS, next = i + NS;
        fm::ring_handback(lane == 0, fm::smem_u32(counts + s), last, next < items,
                          fm::smem_u32(&full[s]), sm + L::w_off + s * L::UNIT,
                          io.image + (size_t)(next % UNITS) * L::UNIT, L::UNIT);
      }
    }
    bf16* dst = io.dsrc + row0 * C;
#pragma unroll
    for (int n = 0; n < C / 16; ++n) {
      uint32_t f[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) f[r] = fm::pack_bf16(ds[8 * n + 2 * r], ds[8 * n + 2 * r + 1]);
      store16(dst + 16 * n, C, f, r0, valid, t);
    }
  }
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

// the tensor map of stats_bwd's source rows: [rows, C] bf16 in boxes of [64
// rows, 64 columns], 128-byte swizzle, rows past the end read as zeros
cudaError_t source_map(CUtensorMap* map, const void* src, int rows, int C) {
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)T};
  return fm::bf16_tensor_map(map, src, 2, dims, strides, box);
}

// stats_bwd's dynamic shared memory and resident blocks an SM (computed once)
template <int C, int D>
cudaError_t stats_bwd_occupancy(int* info) {
  static int blocks = 0;
  const int bytes = (int)SbLayout<C, D>::bytes;
  if (blocks == 0) {
    FM_CHECK(set_smem(stats_bwd_kernel<C, D>, bytes));
    FM_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, stats_bwd_kernel<C, D>,
                                                           kSbThreads, bytes));
  }
  info[0] = bytes;
  info[1] = blocks;
  return blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// stats_bwd over G images of S source tokens: a persistent grid of the
// blocks the card holds at once (at most one a tile)
template <int C, int D>
cudaError_t launch_stats_bwd(const void* src, const bf16* dkv, const bf16* dks, const void* image,
                             bf16* dkv3, bf16* dsrc, int G, int S, int sms, cudaStream_t st) {
  int occ[2];
  FM_CHECK((stats_bwd_occupancy<C, D>(occ)));
  FM_CHECK(set_smem(stats_bwd_kernel<C, D>, SbLayout<C, D>::bytes));
  CUtensorMap map;
  FM_CHECK(source_map(&map, src, G * S, C));
  const SbIO io{dkv, dks, static_cast<const unsigned char*>(image), dkv3, dsrc, S,
                G * ((S + T - 1) / T)};
  const int grid = std::min(io.tiles, sms * occ[1]);
  stats_bwd_kernel<C, D><<<grid, kSbThreads, SbLayout<C, D>::bytes, st>>>(map, io);
  return cudaGetLastError();
}

template <int C, int D>
cudaError_t launch_bwd(const void* const* in, void* const* out, int G, int L, int S, int sms,
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
  const int tiles_l = (L + T - 1) / T;

  FM_CHECK(set_smem(apply_bwd_kernel<C, D>, BwdSmem<C, D>::bytes));
  apply_bwd_kernel<C, D><<<dim3(tiles_l, G), kThreads, BwdSmem<C, D>::bytes, st>>>(io, L, S);
  FM_CHECK(cudaGetLastError());
  const int n = C * D + C;
  bwd_merge_kernel<<<dim3((n + 255) / 256, G), 256, 0, st>>>(io.part_kv, io.part_ks, dkv, dks,
                                                             tiles_l, C, D);
  FM_CHECK(cudaGetLastError());
  FM_CHECK((launch_stats_bwd<C, D>(in[1], dkv, dks, in[18], dkv3, static_cast<bf16*>(out[1]), G,
                                    S, sms, st)));

  // out: dwq [C, C], dwkv [C, 2C], dwmerge [C, C], dln [4C], dw1 [2C, 2C], dw2 [2C, C]
  const int TLi = (int)TL, TSi = (int)TS;
  FM_CHECK(fm::sum_parts(io.part_ln, G * tiles_l, (size_t)4 * C, 4 * C, out[5], st));
  // the six weight gradients in one launch
  float* dw1 = static_cast<float*>(out[6]);
  const fm::WgradCall calls[] = {{io.x, C, io.dqf, C, TLi, C, C, out[2]},
                                 {io.o, C, io.dm1, C, TLi, C, C, out[4]},
                                 {io.x, C, io.dy1, 2 * C, TLi, C, 2 * C, dw1},
                                 {io.msg, C, io.dy1, 2 * C, TLi, C, 2 * C,
                                  dw1 + (size_t)C * 2 * C},
                                 {io.h, 2 * C, io.dy2, C, TLi, 2 * C, C, out[7]},
                                 {Bf(in[1]), C, dkv3, 2 * C, TSi, C, 2 * C, out[3]}};
  return fm::wgrad_group(calls, 6, sms, gemm, st);
}

template <int C, int D>
cudaError_t bwd_occupancy(int* info) {
  const int bytes = (int)BwdSmem<C, D>::bytes;
  FM_CHECK(set_smem(apply_bwd_kernel<C, D>, bytes));
  info[0] = bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], apply_bwd_kernel<C, D>, kThreads,
                                                       bytes);
}

}  // namespace

FM_ERROR_STRING_ENTRY

// One encoder call's backward, L query tokens x attending S source tokens
// of G images.
// in = {x [G, L, C], src [G, S, C], kv [G, C*D] (fm_coarse_stats' fragment
// order), ks [G, C], g [G, L, C] (all bf16); wq, wkv, wmerge, n1s, n1b, w1,
// w2, n2s, n2b (fm_coarse_apply's operands); w2t [C, 2C], w1mt [2C, C], wmt
// [C, C], wdxt [3C, C] (bf16, packed: w2ᵀ, w1[C:]ᵀ, wmergeᵀ, [w1[:C]ᵀ ;
// wqᵀ]); wkv's stats_bwd image (ops/coarse_transformer_train.stats_bwd_image,
// 2 C² bf16, 16-byte aligned)}.
// out = {dx [G, L, C], dsrc [G, S, C] (bf16); dwq [C, C], dwkv [C, 2C], dwmerge
// [C, C], dln [4C] (dn1s | dn1b | dn2s | dn2b), dw1 [2C, 2C], dw2 [2C, C]
// (f32, [in, out]); scratch: stash bf16 [(9 G L + 2 G S) C], LN partials f32
// [G ceil(L/64)][4C], dK^T V partials f32 [G ceil(L/64)][C*D], dK_sum
// partials f32 [G ceil(L/64)][C], dkv bf16 [G][C*D], dks bf16 [G][C],
// weight-gradient partials f32 (ops/wgrad.partial_floats of the six
// products)}; sms: the card's SMs.
extern "C" int fm_coarse_train_bwd(const void* const* in, void* const* out, int G, int L, int S,
                                   int C, int D, int sms, void* stream) {
  if (G <= 0 || L <= 0 || S <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FM_BWD(c, d) \
  if (C == c && D == d) return (int)launch_bwd<c, d>(in, out, G, L, S, sms, st);
  FM_BWD(128, 16) FM_BWD(128, 32) FM_BWD(256, 16) FM_BWD(256, 32) FM_BWD(256, 64)
#undef FM_BWD
  return (int)cudaErrorInvalidValue;
}

// apply_bwd's dynamic shared memory and resident blocks an SM at (C, D):
// info = {bytes, blocks}
extern "C" int fm_coarse_train_bwd_occupancy(int C, int D, int* info) {
#define FM_OCC(c, d) \
  if (C == c && D == d) return (int)bwd_occupancy<c, d>(info);
  FM_OCC(128, 16) FM_OCC(128, 32) FM_OCC(256, 16) FM_OCC(256, 32) FM_OCC(256, 64)
#undef FM_OCC
  return (int)cudaErrorInvalidValue;
}

// stats_bwd's dynamic shared memory and resident blocks an SM at (C, D):
// info = {bytes, blocks}
extern "C" int fm_coarse_train_stats_bwd_occupancy(int C, int D, int* info) {
#define FM_OCC(c, d) \
  if (C == c && D == d) return (int)stats_bwd_occupancy<c, d>(info);
  FM_OCC(128, 16) FM_OCC(128, 32) FM_OCC(256, 16) FM_OCC(256, 32) FM_OCC(256, 64)
#undef FM_OCC
  return (int)cudaErrorInvalidValue;
}
