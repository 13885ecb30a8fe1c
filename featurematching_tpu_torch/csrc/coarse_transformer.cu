// One LoFTR linear-attention encoder layer as two kernels, stats and apply:
//   stats: K = elu(src.wk)+1, V = src.wv / S; each head's K^T V [D, D] and
//          K_sum [C] over the source tokens
//   apply: Q = elu(x.wq)+1; o = Q_h.KV_h * S / (Q_h.Ksum_h + eps);
//          msg = LN1(o.wmerge); y = LN2(relu([x | msg].wmlp1).wmlp2); x + y
//
// Replaces featurematching_tpu/ops/pallas_coarse_transformer.py ·
// coarse_transformer_fused (_stats_kernel / _apply_kernel). Bound on the
// H100 by tensor-core operations (10 C^2 multiply-adds per token and
// layer against 4 C bytes of activations in and out). Design:
//   - The TPU grid carries K^T V and K^T 1 across token chunks in one output
//     block; CUDA blocks cannot share one. A stats block reduces a run of
//     64-token tiles of one image into registers and writes one partial; a
//     merge kernel adds the partials in a fixed order and rounds them to
//     bf16 (the activation dtype the apply kernel's products take).
//   - Only the H diagonal [D, D] blocks of K^T V are ever read, so only they
//     are formed (the TPU kernel forms [C, C] and masks it): 1/H of the
//     operations. K^T 1 is K_sum repeated across columns: stored once.
//   - Head dims 16, 32 and 64. At 64 a head's K features span two warps'
//     strips, so each warp forms its K strips against all four V strips of
//     its head, and the apply kernel's K^T V (32 KB at C = 256) takes two
//     ring slots a tile.
//   - The stats kernel's products would read all of [wk | wv] (256 KB at C
//     = 256) from L2 for every 64-token tile, 1.26 GB a serving forward, if
//     a block took every column. Only a head's own K and V columns meet, so
//     a stats block owns one head group (128 K features and their 128 V
//     features) and holds its [C, 256] weights in shared memory for all of
//     its tiles: they leave L2 once a block. The source tiles stream through
//     a ring of slots; two warpgroups take alternate tiles, each product on
//     wgmma, K^T V and K_sum on mma.sync.
//   - The apply kernel does 80% of the operations (8 C^2 multiply-adds a
//     token) and reads the layer's 8 C^2 bf16 weights (1 MiB at C = 256)
//     in every block. Read once a 64-token tile, they would be 5.03 GB of
//     L2 reads a serving forward (4 self calls of [8, 4800, 256], 8 cross
//     calls of [4, 4800, 256]), and mma.sync products would take an
//     ldmatrix each. An apply block takes two 64-token tiles (of one image
//     or of two) in two warpgroups that read every weight slice
//     from one shared-memory ring, so each slice leaves L2 once for 128
//     rows: 2.52 GB a forward (300 blocks a self call, 150 a cross call).
//     Its products run on wgmma (wgmma.cuh), B from the ring, which bulk
//     copies fill and mbarriers guard, the accumulators in registers. One
//     block an SM (230 KB of shared memory at C = 256), so a cross call's
//     150 blocks run in two waves on 132 SMs.
//
// Rounding follows the TPU kernel: K and V/S rounded after the f32 product
// and feature map; K_sum rounded to bf16; Q rounded after its feature map;
// o * (S / (Z + eps)) in f32, rounded once; each product rounded to bf16
// before its LayerNorm; the residual add is bf16 + bf16.

#include <cuda.h>

#include "tiles.cuh"
#include "wgmma.cuh"

namespace {

using fm::bf16;

constexpr float kEps = 1e-6f;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

// ---- stats: a head group's weights resident, the source tiles streamed ----
//
// Work item (image g, head group hg, chunk c): the source tiles [c *
// per_chunk, (c + 1) * per_chunk) of image g against the group's columns
// [wk_hg | wv_hg] (N = 256; C / 128 groups). Block (g * chunks + c, hg)
// takes it (one block an SM: 230 KB of shared memory at C = 256; the
// wrapper picks per_chunk so that the blocks fill the card once):
//   - its weights (ops/coarse_transformer.stats_image: the group's [C, 256]
//     as C / 16 k-step tiles, wgmma.cuh) come by bulk copies of 16 KB, each
//     completing on its own mbarrier, so the first tile's products start
//     behind the first piece; they stay for all of the block's tiles;
//   - the source tiles ([64, C] bf16) flow through a ring of three 32 KB
//     slots, each filled by one thread with C / 64 tensor copies of [64, 64]
//     boxes (a tensor map over the [G S, C] source, 128-byte swizzle: the
//     layout wgmma reads as a swizzled K-major A; rows past the source come
//     as zeros) completing on the slot's mbarrier (cp.async 16 bytes a
//     thread into K-major positions took a warpgroup about 1.7k cycles a
//     tile to start, and slot waits rose to 1.3-2.9k);
//   - tile k lies in slot k % 3 and belongs to warpgroup k % 2, which, once
//     done with the slot, fills it with tile k + 3 (the other warpgroup's):
//     the warpgroups never wait on each other within the item. For a tile,
//     a warpgroup runs
//       1. [K | V] = src . W_hg, C / 16 m64n256k16 wgmma (A the slot, B the
//          resident weights), the accumulators in registers;
//       2. K = elu + 1, V / S, zero past S, rounded to bf16 into the slot
//          over the source (a [64, 256] K-major tile, kmajor_index, by
//          stmatrix);
//       3. on mma.sync, warp w of the warpgroup takes K features [32 w, 32 w
//          + 32) of the group: K^T (ldmatrix.trans) times V's strips of the
//          same heads (at D = 64 the V features [64 (w / 2), 64 (w / 2) +
//          64) of its head, which warps w and w ^ 1 share), and the same K^T
//          fragments times ones for K_sum, in registers over the
//          warpgroup's tiles.
// At the end warpgroup 1 hands its sums to warpgroup 0 through its last slot
// (at D = 64, 34 KB, through the ring's first slots once both are done) and
// warpgroup 0 adds them, in that order, and writes the item's partial:
// part_kv[g][c] = the diagonal blocks [H][D][D] of the group's heads,
// part_ks[g][c] = K_sum of its K features [C].

constexpr int T = 64;                   // token rows of a stats tile
constexpr int SG = 128;                 // K features of a head group (and as many of V)
constexpr int SN = 2 * SG;              // columns of a group's product: [K_hg | V_hg]
constexpr int kStatsThreads = 256;      // two warpgroups
constexpr int kStatsSlots = 3;          // source tiles in flight a block
constexpr int kStatsSlot = T * SN * 2;  // bytes of a slot: a source tile, then its K | V
constexpr int kPiece = 16384;           // bytes of a weight copy

template <int C>
struct StatsLayout {
  static constexpr int KSTEPS = C / 16;
  static constexpr int PIECES = C * SN * 2 / kPiece;
  static constexpr int KPP = KSTEPS / PIECES;            // k-steps a piece
  static constexpr size_t slot_off = (size_t)C * SN * 2;  // after the group's weights
  static constexpr size_t bar_off = slot_off + (size_t)kStatsSlots * kStatsSlot;
  // + 1024: the slots' swizzle atoms need 1024-byte aligned addresses
  static constexpr size_t bytes = bar_off + 8 * (PIECES + kStatsSlots) + 1024;
  static_assert(bytes <= (size_t)kSmemMax, "shared memory of a stats block");
  static_assert(T * C * 2 <= kStatsSlot, "a source tile must fit a slot");
};

// elu(v) + 1 as max(v, 0) + exp(min(v, 0)), exp by ex2.approx (__expf: a
// few f32 ulp, far below K's bf16 rounding). The stats kernel's K takes
// it: with `elu1_select`'s expf the kernel needs 255 registers, spills, and
// runs longer (PERF.md)
__device__ __forceinline__ float elu1_fast(float v) {
  return fmaxf(v, 0.f) + __expf(fminf(v, 0.f));
}

// elu(v) + 1 with both sides computed: no branch a value (expf of a
// clamped argument, so the result equals fm::elu1's)
__device__ __forceinline__ float elu1_select(float v) {
  const float e = expf(fminf(v, 0.f));
  return v > 0.f ? v + 1.f : e;
}

// start the copy of the source rows [row, row + 64) into a slot: C / 64
// boxes of [64 rows, 64 columns], each 8 KB of 128-byte swizzled rows;
// completes on `bar` (one thread; the slot's earlier reads are ordered
// before the copy by the caller's barrier and the proxy fence)
template <int C>
__device__ __forceinline__ void fill_slot(unsigned char* slot, const CUtensorMap* map, int row,
                                          uint64_t* bar) {
  fm::fence_proxy_async();
  fm::mbar_arrive_expect(bar, T * C * 2);
#pragma unroll
  for (int j = 0; j < C / 64; ++j) fm::tma_load_2d(slot + j * T * 128, map, 64 * j, row, bar);
}

template <int C, int D>
__global__ void __launch_bounds__(kStatsThreads, 1)
stats_kernel(const __grid_constant__ CUtensorMap src, const bf16* __restrict__ image,
             float* __restrict__ part_kv, float* __restrict__ part_ks, int S, int per_chunk,
             int chunks) {
  using L = StatsLayout<C>;
  constexpr int NS = kStatsSlots;
  constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 ones
  static_assert(D == 16 || D == 32 || D == 64, "head dims 16, 32 and 64");
  // the V strips (16 features) a warp's two K strips meet: its own two at D
  // <= 32 (at 16 each K strip only its own), the four of its head at 64
  constexpr int VB = D == 64 ? 4 : 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (fm::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = wbar + L::PIECES;
  unsigned char* slots = smem + L::slot_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w = warp % 4, wt = threadIdx.x % 128;
  const int gq = lane / 4, t = lane % 4, m = lane / 8, rr = lane % 8;
  const int hg = blockIdx.y, img = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int t0 = chunk * per_chunk;
  const int n = min((S + T - 1) / T, t0 + per_chunk) - t0;  // the item's tiles, >= 1
  const int row0 = img * S + t0 * T;  // the item's first source row in [G S, C]
  // the first tile and the weights by thread 0, the next two tiles by
  // warpgroup 1's first thread (each copy costs the thread that starts it
  // about 80 cycles)
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::PIECES; ++i) fm::mbar_init(&wbar[i], 1);
    for (int i = 0; i < NS; ++i) fm::mbar_init(&full[i], 1);
    fm::mbar_init_fence();
    fill_slot<C>(slots, &src, row0, &full[0]);
    const unsigned char* wimg =
        reinterpret_cast<const unsigned char*>(image) + (size_t)hg * C * SN * 2;
    for (int i = 0; i < L::PIECES; ++i) {
      fm::mbar_arrive_expect(&wbar[i], kPiece);
      fm::bulk_load(smem + (size_t)i * kPiece, wimg + (size_t)i * kPiece, kPiece, &wbar[i]);
    }
  }
  __syncthreads();
  if (threadIdx.x == 128)
    for (int k = 1; k < min(n, NS); ++k)
      fill_slot<C>(slots + k * kStatsSlot, &src, row0 + k * T, &full[k]);

  const uint32_t wsm = fm::smem_u32(smem);
  const float inv_s = 1.0f / (float)S;
  const int vb0 = D == 64 ? 4 * (w / 2) : 2 * w;  // the warp's first V strip in the group
  fm::Acc16 kv[2][VB];  // [K strip a][V strip vb0 + b] of warp w's heads (D = 16: a == b only)
  float ks[2][4];       // K_sum of K strip a (columns alike)
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < VB; ++b) fm::zero(kv[a][b]);
#pragma unroll
    for (int e = 0; e < 4; ++e) ks[a][e] = 0.f;
  }
#pragma unroll 1
  for (int k = wg; k < n; k += 2) {
    const int s = k % NS;
    unsigned char* slot = slots + s * kStatsSlot;
    const uint32_t ssm = fm::smem_u32(slot);
    fm::mbar_wait(&full[s], (k / NS) & 1);
    {
      float acc[SN / 2];
      fm::zero_regs(acc);
      fm::wgmma_fence();
#pragma unroll
      for (int p = 0; p < L::PIECES; ++p) {
        fm::mbar_wait(&wbar[p], 0);
#pragma unroll
        for (int i = 0; i < L::KPP; ++i) {
          const int st = p * L::KPP + i;
          // k-step st of A: box st / 4, 32 bytes a k-step into its rows
          fm::wgmma_ss_n256(acc, fm::sw128_desc(ssm + (st / 4) * T * 128 + (st % 4) * 32),
                            fm::kmajor_desc(wsm + st * 32 * SN, 128, 256), 1);
        }
        fm::wgmma_commit();  // a group a piece: the waits lie between groups
      }
      fm::wgmma_wait<0>();
      fm::fence_regs(acc);
      fm::named_barrier(1 + wg, 128);  // every warp's product has read the slot
      // K | V over the source; rows past S carry no mass
      const int valid = S - (t0 + k) * T;
      const uint32_t live[2] = {16 * w + gq < valid ? ~0u : 0u, 16 * w + gq + 8 < valid ? ~0u : 0u};
      // stmatrix: the 8x8 matrices (rows + 8 i, strip j) for i, j + jj < 2;
      // lane l gives row l % 8 of matrix l / 8
      bf16* kvt = reinterpret_cast<bf16*>(slot) +
                  fm::kmajor_index(16 * w + 8 * (m & 1) + rr, 8 * (m >> 1), SN);
#pragma unroll
      for (int j = 0; j < SN / 8; j += 2) {
        uint32_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jj = j + (q >> 1), i = q & 1;
          float v0 = acc[4 * jj + 2 * i], v1 = acc[4 * jj + 2 * i + 1];
          if (jj < SG / 8) {
            v0 = elu1_fast(v0);
            v1 = elu1_fast(v1);
          } else {
            v0 *= inv_s;
            v1 *= inv_s;
          }
          r[q] = fm::pack_bf16(v0, v1) & live[i];
        }
        fm::stsm_x4(kvt + 64 * j, r[0], r[1], r[2], r[3]);  // strip j: + 8 j columns
      }
    }
    fm::named_barrier(1 + wg, 128);
    // K^T (A[f][token] = K[token][f]) and V (B[token][f]) by ldmatrix.trans
    // from the K-major tile, 16 tokens a step
    const bf16* kvt = reinterpret_cast<const bf16*>(slot);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t fa[2][4], fb[VB][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int f = 16 * (2 * w + a);
        fm::ldsm_x4_trans(fa[a],
                          kvt + fm::kmajor_index(16 * kk + rr + 8 * (m >> 1), f + 8 * (m & 1), SN));
      }
#pragma unroll
      for (int b = 0; b < VB; ++b) {
        const int f = 16 * (vb0 + b);
        fm::ldsm_x4_trans(
            fb[b], kvt + fm::kmajor_index(16 * kk + rr + 8 * (m & 1), SG + f + 8 * (m >> 1), SN));
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < VB; ++b)
          if (D >= 32 || a == b) fm::mma16(kv[a][b], fa[a], fb[b]);
        fm::mma16x8(ks[a], fa[a], kOnes, kOnes);
      }
    }
    fm::named_barrier(1 + wg, 128);  // every warp's reads of the slot are done
    if (k + NS < n && wt == 0) fill_slot<C>(slot, &src, row0 + (k + NS) * T, &full[s]);
  }

  // warpgroup 1's sums to warpgroup 0 through warpgroup 1's last slot, which
  // no tile takes after it (slot 1, never filled, where the item has one
  // tile); thread wt of each warpgroup holds the same entries. At D = 64
  // they outgrow a slot: through the ring's first slots once both
  // warpgroups are done with theirs
  float* xch = reinterpret_cast<float*>(slots + (n >= 2 ? ((n - 2) | 1) % NS : 1) * kStatsSlot);
  if (D == 64) {
    static_assert(128 * (2 * VB * 8 + 4) * 4 <= kStatsSlots * kStatsSlot, "the exchange's room");
    __syncthreads();
    xch = reinterpret_cast<float*>(slots);
  }
  if (wg == 1) {
    int q = 0;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < VB; ++b)
        if (D >= 32 || a == b)
#pragma unroll
          for (int e = 0; e < 8; ++e) xch[128 * q++ + wt] = kv[a][b].c[e];
#pragma unroll
      for (int e = 0; e < 4; e += 2) xch[128 * q++ + wt] = ks[a][e];
    }
  }
  __syncthreads();
  if (wg == 1) return;
  const size_t part = (size_t)img * chunks + chunk;
  float* pk = part_kv + part * C * D;
  int q = 0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int f = hg * SG + 16 * (2 * w + a);  // the strip's first K feature
#pragma unroll
    for (int b = 0; b < VB; ++b)
      if (D >= 32 || a == b) {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[a][b].c[e] += xch[128 * q++ + wt];
        const int h = f / D;
        fm::tile_epilogue(kv[a][b], f % D, 16 * (vb0 + b) % D, lane,
                          [&](int r, int c, float v) { pk[h * D * D + r * D + c] = v; });
      }
    const float s0 = ks[a][0] + xch[128 * q++ + wt];
    const float s1 = ks[a][2] + xch[128 * q++ + wt];
    if (t == 0) {
      part_ks[part * C + f + gq] = s0;
      part_ks[part * C + f + gq + 8] = s1;
    }
  }
}

// kv[g] = bf16(sum over chunks of part_kv[g]) in fragment order (each head's
// [D, D] block packed as a B operand, tiles.cuh); ks[g] likewise, plain;
// chunks added in order
__global__ void merge_kernel(const float* __restrict__ part_kv, const float* __restrict__ part_ks,
                             bf16* __restrict__ kv, bf16* __restrict__ ks, int chunks, int C,
                             int D) {
  const int g = blockIdx.y, CD = C * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < CD) {
    const int DT = D / 16, e8 = e & 7, ln = (e >> 3) & 31, tile = e >> 8;
    const int h = tile / (DT * DT), nt = (tile / DT) % DT, kt = tile % DT;
    const int k = kt * 16 + 2 * (ln & 3) + (e8 & 1) + 8 * ((e8 >> 1) & 1);
    const int n = nt * 16 + (ln >> 2) + 8 * (e8 >> 2);
    const int src = h * D * D + k * D + n;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part_kv[((size_t)g * chunks + c) * CD + src];
    kv[(size_t)g * CD + e] = __float2bfloat16(s);
  } else if (e < CD + C) {
    const int i = e - CD;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part_ks[((size_t)g * chunks + c) * C + i];
    ks[(size_t)g * C + i] = __float2bfloat16(s);
  }
}

// ---- apply: two 64-token row tiles a block, their weights fetched once ----
//
// The G images' 64-row tiles are numbered in order (ceil(L / 64) an image);
// block b takes tiles 2b and 2b + 1, one a warpgroup, which may lie in two
// images. The layer's weight image (`ops/coarse_transformer.apply_image`:
// wq, wmerge, then each 128-column chunk of wmlp1 followed by the matching
// 128 rows of wmlp2, every k-step a [N, 16] K-major tile, wgmma.cuh)
// streams as 16 KB slices through a ring of shared-memory slots, each
// filled by a bulk copy that completes on the slot's `full` mbarrier; after
// wq's slices the two tiles' K^T V blocks (fragment order) take the next two
// slots. Both warpgroups read every slice, so a slice leaves L2 once for
// 128 rows. A warp hands a slot back once the wgmma group that read it has
// completed (one group left in flight); the last of the eight warps to hand
// it back (a counter in shared memory) issues the copy of the slice SLOTS
// further on. So no thread waits for a slot to empty and the block needs no
// producer warp: its 256 threads may hold 255 registers each, which the y
// accumulator (128 registers a thread at C = 256) beside a hidden chunk's
// needs. (A producer warpgroup with setmaxnreg left ptxas allocating 168
// registers a consumer thread, and the kernel spilled.)
//
// The weight products run on wgmma: A from shared memory (x, Q then o, msg:
// [64, C] K-major tiles) or, for hidden . wmlp2, from the registers of the
// ReLU'd hidden chunk. Each epilogue that runs once a block is a short loop
// over shared memory: Q . K^T V per head on mma.sync (Q's fragments by
// ldmatrix), LN1 and LN2 a warp on 8 rows at a time.

constexpr int AR = 128;                   // token rows of an apply block
constexpr int kApplyThreads = 256;        // two warpgroups
constexpr int kSlice = 16384;             // bytes of a weight slice (a ring slot)
constexpr int AHC = 128;                  // FFN hidden columns a chunk

template <int C, int D>
struct ApplyLayout {
  static constexpr int H = C / D;
  static constexpr size_t x_off = 0;                      // two [64, C] x tiles
  static constexpr size_t o_off = x_off + AR * C * 2;     // two [64, C]: o, then msg, then out
  static constexpr size_t ring_off = o_off + AR * C * 2;
  static constexpr int FREE = kSmemMax - (int)ring_off - 128 - 4 * C;  // for the slots
  static constexpr int SLOTS = FREE / kSlice < 6 ? FREE / kSlice : 6;
  static constexpr size_t bar_off = ring_off + (size_t)SLOTS * kSlice;  // full[], then count[]
  static constexpr size_t ks_off = bar_off + (SLOTS * (8 + 4) + 15) / 16 * 16;  // two K_sum [C]
  static constexpr size_t bytes = ks_off + 2 * C * 2;
  // slices of the weight image: wq, wmerge, then per hidden chunk wmlp1's
  // [2C, AHC] columns and wmlp2's [AHC, C] rows
  static constexpr int SPS = kSlice / (32 * C);    // k-steps a slice of an N = C product
  static constexpr int SPSH = kSlice / (32 * AHC);  // k-steps a slice of a wmlp1 chunk
  static constexpr int CHUNKS = 2 * C / AHC;
  static constexpr int QSLICES = (C / 16) / SPS;  // wq's slices; the K^T V slots follow
  static constexpr int SLICES = 2 * QSLICES + CHUNKS * (2 * C / 16 / SPSH + AHC / 16 / SPS);
  // slots of a tile's K^T V (two at (256, 64)) and the heads a slot holds
  static constexpr int KVS = (C * D * 2 + kSlice - 1) / kSlice, HPS = kSlice / (D * D * 2);
  static_assert(SLOTS >= 2 * KVS, "the ring must hold both tiles' K^T V");
  static_assert(KVS <= 2 && H <= KVS * HPS && (KVS == 1 || C * D * 2 == 2 * kSlice),
                "a tile's K^T V in one or two whole slots of whole heads");
  static_assert(ring_off % 128 == 0, "slots must be 128-byte aligned");
  static_assert((C / 16) % SPS == 0 && (C / 16) % SPSH == 0 && (AHC / 16) % SPS == 0,
                "a slice must hold whole k-steps of one product");
};

// The ring of slices: slot q % SLOTS holds slice q. Each of the WARPS warps
// that read the slices acquires every slot in order and hands it back; the
// last to hand slot back refills it with slice q + SLOTS (Source::get gives
// its address and bytes, without branches).
template <int SLOTS, int WARPS, class Source>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  int* count;  // hand-backs of each slot's current slice
  Source src;
  int next = 0, released = 0;

  // start the copy of slice q into its slot (one thread)
  __device__ void fill(int q) {
    const void* from;
    uint32_t bytes;
    src.get(q, from, bytes);
    const int slot = q % SLOTS;
    fm::mbar_arrive_expect(&full[slot], bytes);
    fm::bulk_load(base + slot * kSlice, from, bytes, &full[slot]);
  }
  __device__ const unsigned char* acquire_ptr() {
    const int slot = next % SLOTS;
    fm::mbar_wait(&full[slot], (next / SLOTS) & 1);
    ++next;
    return base + slot * kSlice;
  }
  __device__ uint32_t acquire() { return fm::smem_u32(acquire_ptr()); }
  // hand back the oldest slot held if the warp holds more than `keep`: its
  // reads of it, by wgmma groups or loads, have completed
  __device__ void handback(int keep, int lane) {
    const bool go = released < next - keep;
    const int q = released + SLOTS, slot = released % SLOTS;
    const void* from;
    uint32_t bytes;
    src.get(min(q, src.total - 1), from, bytes);
    fm::ring_handback(go && lane == 0, fm::smem_u32(&count[slot]), WARPS - 1, q < src.total,
                      fm::smem_u32(&full[slot]), fm::smem_u32(base + slot * kSlice), from,
                      bytes);
    released += go;
  }
};

// the apply kernel's slices: the weight image's, with the two tiles' K^T V
// after wq's, kvs slices each (the last may be short)
struct ApplySource {
  const unsigned char* image;
  const unsigned char* kv0;  // the K^T V of warpgroup 0's tile, then of warpgroup 1's
  const unsigned char* kv1;
  int qslices, total, kvs;
  uint32_t kv_bytes;
  __device__ void get(int q, const void*& from, uint32_t& bytes) const {
    const int k = q - qslices;
    const bool is_kv = (unsigned)k < (unsigned)(2 * kvs);
    const int part = k % kvs;  // of the tile's K^T V (meaningful where is_kv)
    const unsigned char* w = image + (size_t)(q < qslices ? q : q - 2 * kvs) * kSlice;
    const unsigned char* kvp = (k < kvs ? kv0 : kv1) + (size_t)part * kSlice;
    from = is_kv ? static_cast<const void*>(kvp) : static_cast<const void*>(w);
    bytes = is_kv ? min((uint32_t)kSlice, kv_bytes - (uint32_t)part * kSlice) : kSlice;
  }
};

template <int N>
struct Wgmma;
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b) {
    fm::wgmma_ss_n128(d, a, b, 1);
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    fm::wgmma_rs_n128(d, a, b, 1);
  }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a, uint64_t b) {
    fm::wgmma_ss_n256(d, a, b, 1);
  }
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    fm::wgmma_rs_n256(d, a, b, 1);
  }
};

// descriptor of k-step i of a slot holding [N, 16] K-major tiles
template <int N>
__device__ __forceinline__ uint64_t slot_desc(uint32_t slot, int i) {
  return fm::kmajor_desc(slot + i * 32 * N, 128, 256);
}

// acc += A[64, 16 s0 .. 16 (s0 + KSTEPS)) . B, A a K-major tile of aK
// columns in shared memory, B the ring's next KSTEPS / SPS slices; one group
// a slice, one group left in flight (the waits and hand-backs between are
// branch-free, or ptxas would serialize the products)
template <int N, int KSTEPS, class Ring>
__device__ __forceinline__ void gemm_ss(float (&acc)[N / 2], const bf16* a, int aK, int s0,
                                        Ring& ring, int lane) {
  constexpr int SPS = kSlice / (32 * N);
#pragma unroll 1
  for (int s = 0; s < KSTEPS; s += SPS) {
    const uint32_t slot = ring.acquire();
    fm::wgmma_fence();
#pragma unroll
    for (int i = 0; i < SPS; ++i)
      Wgmma<N>::ss(acc, fm::tile_desc(a, aK, s0 + s + i), slot_desc<N>(slot, i));
    fm::wgmma_commit();
    fm::wgmma_wait<1>();
    ring.handback(1, lane);
  }
}

// acc += A . B with A's KSTEPS k-steps in registers (m16n8k16 A fragments)
template <int N, int KSTEPS, class Ring>
__device__ __forceinline__ void gemm_rs(float (&acc)[N / 2], const uint32_t (&a)[KSTEPS][4],
                                        Ring& ring, int lane) {
  constexpr int SPS = kSlice / (32 * N);
#pragma unroll
  for (int s = 0; s < KSTEPS; s += SPS) {
    const uint32_t slot = ring.acquire();
    fm::wgmma_fence();
#pragma unroll
    for (int i = 0; i < SPS; ++i) Wgmma<N>::rs(acc, a[s + i], slot_desc<N>(slot, i));
    fm::wgmma_commit();
    fm::wgmma_wait<1>();
    ring.handback(1, lane);
  }
}

// wait for every group and hand back the last slot; acc is then readable
template <int R, class Ring>
__device__ __forceinline__ void gemm_finish(float (&acc)[R], Ring& ring, int lane) {
  fm::wgmma_wait<0>();
  ring.handback(0, lane);
  fm::fence_regs(acc);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// bf16 pairs of f(accumulator) into a [64, C] K-major tile (wr: the warp's
// first row, g, t: the lane's quad coordinates)
template <int C, typename F>
__device__ __forceinline__ void store_acc(bf16* tile, const float (&acc)[C / 2], int wr, int g,
                                          int t, F f) {
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(tile + fm::kmajor_index(wr + g + 8 * i, 8 * j + 2 * t, C)) =
          fm::pack_bf16(f(acc[4 * j + 2 * i]), f(acc[4 * j + 2 * i + 1]));
}

// 8 bf16 of a row (16 bytes) as f32
__device__ __forceinline__ void unpack8(const uint4& u, float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(fm::pack_bf16(v[0], v[1]), fm::pack_bf16(v[2], v[3]),
                    fm::pack_bf16(v[4], v[5]), fm::pack_bf16(v[6], v[7]));
}

// LayerNorm (statistics in f32) of the warp's 16 rows [wr, wr + 16) of a
// [64, C] K-major bf16 tile, 8 rows at a time: lane (row r = lane % 8, k
// group kq = lane / 8) takes the row's 16-byte chunks kq, kq + 4, ..., so
// each 8 lanes read 128 contiguous bytes; a row's sums over the 4 lanes
// that share it. The lane's scales and biases are loaded once, before the
// rows, so no pass waits on device memory. out(row, kc, v) takes the 8
// normalised values of chunk kc.
template <int C, typename Out>
__device__ __forceinline__ void ln_rows(const bf16* tile, int wr, int lane,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias, Out out) {
  constexpr int CH = C / 32;  // chunks a lane
  const int kq = lane >> 3;
  float4 sc[CH][2], bi[CH][2];
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[i][h] = __ldg(reinterpret_cast<const float4*>(scale + 8 * (kq + 4 * i) + 4 * h));
      bi[i][h] = __ldg(reinterpret_cast<const float4*>(bias + 8 * (kq + 4 * i) + 4 * h));
    }
#pragma unroll 1
  for (int rb = 0; rb < 2; ++rb) {
    const int row = wr + 8 * rb + (lane & 7);
    const bf16* base = tile + fm::kmajor_index(row, 0, C);
    float v[CH][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      unpack8(*reinterpret_cast<const uint4*>(base + (kq + 4 * i) * 64), v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    const float mu = (s + __shfl_xor_sync(0xffffffffu, s, 16)) * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] -= mu;
        q += v[i][e] * v[i][e];
      }
    q += __shfl_xor_sync(0xffffffffu, q, 8);
    const float r = rsqrtf((q + __shfl_xor_sync(0xffffffffu, q, 16)) * (1.0f / C) + fm::kLnEps);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const float m[8] = {sc[i][0].x, sc[i][0].y, sc[i][0].z, sc[i][0].w,
                          sc[i][1].x, sc[i][1].y, sc[i][1].z, sc[i][1].w};
      const float b[8] = {bi[i][0].x, bi[i][0].y, bi[i][0].z, bi[i][0].w,
                          bi[i][1].x, bi[i][1].y, bi[i][1].z, bi[i][1].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = v[i][e] * r * m[e] + b[e];
      out(row, kq + 4 * i, v[i]);
    }
  }
}

// rows [0, valid) of a row-major [64, C] global block into a K-major tile,
// zeros past valid; 16 bytes a thread of the warpgroup, element e * 8 of the
// tile being (row group, k group, row) = e
// (all loads issued before the first store: one round trip to memory)
template <int C>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ src, int valid,
                                          int wt) {
  constexpr int PER = 64 * C / 8 / 128;
  uint4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = wt + 128 * i;
    const int r = (e >> 3) / (C / 8) * 8 + (e & 7), k = (e >> 3) % (C / 8) * 8;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v[i] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * C + k));
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) *reinterpret_cast<uint4*>(tile + (wt + 128 * i) * 8) = v[i];
}

// grid ceil(G * ceil(L / 64) / 2): warpgroup w of block b takes the 64-row
// tile 2 b + w (none past the last)
template <int C, int D>
__global__ void __launch_bounds__(kApplyThreads, 1)
apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kv, const bf16* __restrict__ ks,
             const bf16* __restrict__ image, const float* __restrict__ n1s,
             const float* __restrict__ n1b, const float* __restrict__ n2s,
             const float* __restrict__ n2b, bf16* __restrict__ out, int G, int L, int S) {
  using Lt = ApplyLayout<C, D>;
  constexpr int H = Lt::H, DT = D / 16, SLOTS = Lt::SLOTS, KVS = Lt::KVS, HPS = Lt::HPS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lt::bar_off);
  int* count = reinterpret_cast<int*>(full + SLOTS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wt = threadIdx.x % 128, wr = 16 * (warp % 4);
  const int gq = lane / 4, t = lane % 4;
  // tile 2 b + w of the G images' ceil(L / 64) tiles each; a tile past the
  // last stands in for it (it reads the last tile and writes nothing)
  const int tpi = (L + 63) / 64, last = G * tpi - 1;
  const int q0 = min(2 * (int)blockIdx.x, last), q1 = min(2 * (int)blockIdx.x + 1, last);
  const int tile = wg == 0 ? q0 : q1, img = tile / tpi, r0 = tile % tpi * 64;
  const int valid = 2 * (int)blockIdx.x + wg > last ? 0 : min(64, L - r0);
  const size_t row0 = (size_t)img * L + r0;
  using Src = ApplySource;
  Ring<SLOTS, 8, Src> ring{
      smem + Lt::ring_off, full, count,
      Src{reinterpret_cast<const unsigned char*>(image),
          reinterpret_cast<const unsigned char*>(kv + (size_t)(q0 / tpi) * C * D),
          reinterpret_cast<const unsigned char*>(kv + (size_t)(q1 / tpi) * C * D), Lt::QSLICES,
          Lt::SLICES + 2 * KVS, KVS, C * D * 2}};
  if (threadIdx.x == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      fm::mbar_init(&full[i], 1);
      count[i] = 0;
    }
    fm::mbar_init_fence();
    for (int q = 0; q < SLOTS; ++q) ring.fill(q);
  }
  __syncthreads();
  bf16* xt = reinterpret_cast<bf16*>(smem + Lt::x_off) + wg * 64 * C;
  bf16* ot = reinterpret_cast<bf16*>(smem + Lt::o_off) + wg * 64 * C;
  bf16* kst = reinterpret_cast<bf16*>(smem + Lt::ks_off) + wg * C;

  if (wt < C / 8)
    *reinterpret_cast<uint4*>(kst + 8 * wt) =
        __ldg(reinterpret_cast<const uint4*>(ks + (size_t)img * C + 8 * wt));
  load_tile<C>(xt, x + row0 * C, valid, wt);
  fm::fence_proxy_async();
  fm::named_barrier(1 + wg, 128);

  // Q = bf16(elu(x . wq) + 1) into the o tile; each warp reads back only
  // its own 16 rows
  {
    float acc[C / 2];
    fm::zero_regs(acc);
    gemm_ss<C, C / 16>(acc, xt, C, 0, ring, lane);
    gemm_finish(acc, ring, lane);
    store_acc<C>(ot, acc, wr, gq, t, [](float v) { return elu1_select(v); });
  }
  __syncwarp();
  // per head (a rolled loop): Z = Q_h . K_sum_h (quad sums), o_h = Q_h .
  // KV_h * S / (Z + eps) over Q_h in place; the first KVS of the K^T V
  // slots are warpgroup 0's, heads [0, HPS) in the first of them
  const unsigned char* kvp[2 * KVS];
#pragma unroll
  for (int i = 0; i < 2 * KVS; ++i) kvp[i] = ring.acquire_ptr();
  const bf16* kvs_lo = reinterpret_cast<const bf16*>(wg == 0 ? kvp[0] : kvp[KVS]);
  const bf16* kvs_hi = reinterpret_cast<const bf16*>(wg == 0 ? kvp[KVS - 1] : kvp[2 * KVS - 1]);
  const float s_f = (float)S;
#pragma unroll 1
  for (int h = 0; h < H; ++h) {
    const bf16* kvs = (h < HPS ? kvs_lo : kvs_hi) + (h % HPS) * D * D;
    uint32_t qa[DT][4];
    float z[2] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < DT; ++kt) {
      const int col = h * D + 16 * kt;
      fm::ldsm_x4(qa[kt], ot + fm::kmajor_index(wr + (lane & 15), col + 8 * (lane >> 4), C));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 kp = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kst + col + 8 * (r >> 1) + 2 * t));
        const float2 qp = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kt][r]));
        z[r & 1] += qp.x * kp.x + qp.y * kp.y;
      }
    }
    const float sc[2] = {s_f / (quad_sum(z[0]) + kEps), s_f / (quad_sum(z[1]) + kEps)};
#pragma unroll
    for (int jn = 0; jn < DT; ++jn) {
      fm::Acc16 acc;
      fm::zero(acc);
#pragma unroll
      for (int kt = 0; kt < DT; ++kt) {
        uint32_t fb[4];
        const uint4 v = *reinterpret_cast<const uint4*>(
            fm::packed_tile(kvs, D, kt, jn) + lane * 8);
        fb[0] = v.x;
        fb[1] = v.y;
        fb[2] = v.z;
        fb[3] = v.w;
        fm::mma16(acc, qa[kt], fb);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = p & 1, col = h * D + jn * 16 + 8 * (p >> 1) + 2 * t;
        *reinterpret_cast<uint32_t*>(ot + fm::kmajor_index(wr + gq + 8 * i, col, C)) =
            fm::pack_bf16(acc.c[2 * p] * sc[i], acc.c[2 * p + 1] * sc[i]);
      }
    }
  }
  __syncwarp();  // the K^T V slots: this warp's reads of them are done
#pragma unroll
  for (int i = 0; i < 2 * KVS; ++i) ring.handback(0, lane);
  fm::fence_proxy_async();
  fm::named_barrier(1 + wg, 128);

  // msg = LN1(bf16(o . wmerge)), over o in the same tile
  {
    float acc[C / 2];
    fm::zero_regs(acc);
    gemm_ss<C, C / 16>(acc, ot, C, 0, ring, lane);
    gemm_finish(acc, ring, lane);
    fm::named_barrier(1 + wg, 128);  // every warp's reads of o are done
    store_acc<C>(ot, acc, wr, gq, t, [](float v) { return v; });
  }
  __syncwarp();
  ln_rows<C>(ot, wr, lane, n1s, n1b, [&](int row, int kc, const float* v) {
    *reinterpret_cast<uint4*>(ot + fm::kmajor_index(row, 8 * kc, C)) = pack8(v);
  });
  fm::fence_proxy_async();
  fm::named_barrier(1 + wg, 128);

  // FFN: y = bf16(relu([x | msg] . wmlp1) . wmlp2) over 128-column hidden
  // chunks; a chunk's hidden . wmlp2 stays in flight into the next chunk's
  // first wmlp1 slice
  float y[C / 2];
  fm::zero_regs(y);
#pragma unroll 1
  for (int c = 0; c < Lt::CHUNKS; ++c) {
    uint32_t hf[AHC / 16][4];
    {
      float acc[AHC / 2];
      fm::zero_regs(acc);
      gemm_ss<AHC, C / 16>(acc, xt, C, 0, ring, lane);
      gemm_ss<AHC, C / 16>(acc, ot, C, 0, ring, lane);
      gemm_finish(acc, ring, lane);
#pragma unroll
      for (int kk = 0; kk < AHC / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          hf[kk][r] = fm::pack_bf16(fmaxf(acc[8 * kk + 2 * r], 0.f),
                                    fmaxf(acc[8 * kk + 2 * r + 1], 0.f));
    }
    gemm_rs<C, AHC / 16>(y, hf, ring, lane);
  }
  gemm_finish(y, ring, lane);
  // out = x + bf16(LN2(bf16(y))): y through the o tile (msg is read by then),
  // each row's chunks written to device memory from the LN loop
  fm::named_barrier(1 + wg, 128);
  store_acc<C>(ot, y, wr, gq, t, [](float v) { return v; });
  __syncwarp();
  bf16* og = out + row0 * C;
  ln_rows<C>(ot, wr, lane, n2s, n2b, [&](int row, int kc, float* v) {
    float xv[8];
    unpack8(*reinterpret_cast<const uint4*>(xt + fm::kmajor_index(row, 8 * kc, C)), xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = xv[e] + fm::round_bf16(v[e]);
    if (row < valid) *reinterpret_cast<uint4*>(og + (size_t)row * C + 8 * kc) = pack8(v);
  });
}

// the ring product's slices: one k-step of B ([256, 16], 8 KB) each
struct StepSource {
  const bf16* b;
  int total;
  __device__ void get(int q, const void*& from, uint32_t& bytes) const {
    from = b + (size_t)q * 16 * 256;
    bytes = 32 * 256;
  }
};

// [64, N] f32 = A [64, K] . B [K, N] with N = 256 through a two-slot ring
// (one warpgroup): A row-major in device memory, laid out K-major in shared
// memory; B as the apply image's k-step tiles, a k-step a slice. The wgmma,
// bulk-copy and mbarrier path of apply_kernel, alone, for tests.
__global__ void __launch_bounds__(128, 1)
ring_product_kernel(const bf16* __restrict__ a, const bf16* __restrict__ bimg,
                    float* __restrict__ out, int K) {
  constexpr int N = 256, SLOTS = 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* at = reinterpret_cast<bf16*>(smem);
  unsigned char* slots = smem + 64 * K * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + SLOTS * kSlice);
  int* count = reinterpret_cast<int*>(full + SLOTS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Ring<SLOTS, 4, StepSource> ring{slots, full, count, StepSource{bimg, K / 16}};
  if (threadIdx.x == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      fm::mbar_init(&full[i], 1);
      count[i] = 0;
    }
    fm::mbar_init_fence();
    for (int q = 0; q < SLOTS && q < K / 16; ++q) ring.fill(q);
  }
  for (int e = threadIdx.x; e < 64 * K; e += 128) at[fm::kmajor_index(e / K, e % K, K)] = a[e];
  fm::fence_proxy_async();
  __syncthreads();
  float acc[N / 2];
  fm::zero_regs(acc);
#pragma unroll 1
  for (int s = 0; s < K / 16; ++s) {
    const uint32_t slot = ring.acquire();
    fm::wgmma_fence();
    Wgmma<N>::ss(acc, fm::tile_desc(at, K, s), slot_desc<N>(slot, 0));
    fm::wgmma_commit();
    fm::wgmma_wait<1>();
    ring.handback(1, lane);
  }
  gemm_finish(acc, ring, lane);
  const int wr = 16 * warp, gq = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(out + (wr + gq + 8 * i) * N + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the tensor map of the stats kernel's source rows: [rows, C] bf16 in boxes
// of [64 rows, 64 columns], 128-byte swizzle, rows past the end read as zeros
cudaError_t source_map(CUtensorMap* map, const void* src, int rows, int C) {
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)T};
  return fm::bf16_tensor_map(map, src, 2, dims, strides, box);
}

template <int C, int D>
cudaError_t launch_stats(const void* src, const void* image, float* part_kv, float* part_ks,
                         void* kv, void* ks, int G, int S, int per_chunk, int chunks,
                         cudaStream_t st) {
  const size_t smem = StatsLayout<C>::bytes;
  cudaError_t e = set_smem(stats_kernel<C, D>, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  e = source_map(&map, src, G * S, C);
  if (e != cudaSuccess) return e;
  stats_kernel<C, D><<<dim3(G * chunks, C / SG), kStatsThreads, smem, st>>>(
      map, static_cast<const bf16*>(image), part_kv, part_ks, S, per_chunk, chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = C * D + C;
  merge_kernel<<<dim3((n + 255) / 256, G), 256, 0, st>>>(
      part_kv, part_ks, static_cast<bf16*>(kv), static_cast<bf16*>(ks), chunks, C, D);
  return cudaGetLastError();
}

template <int C, int D>
cudaError_t launch_apply(const void* const* p, void* out, int G, int L, int S, cudaStream_t st) {
  const size_t smem = ApplyLayout<C, D>::bytes;
  cudaError_t e = set_smem(apply_kernel<C, D>, smem);
  if (e != cudaSuccess) return e;
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  auto Bf = [](const void* q) { return static_cast<const bf16*>(q); };
  const int tiles = G * ((L + 63) / 64);
  apply_kernel<C, D><<<(tiles + 1) / 2, kApplyThreads, smem, st>>>(
      Bf(p[0]), Bf(p[1]), Bf(p[2]), Bf(p[3]), F(p[4]), F(p[5]), F(p[6]), F(p[7]),
      static_cast<bf16*>(out), G, L, S);
  return cudaGetLastError();
}

template <int C, int D>
cudaError_t stats_occupancy(int* info) {
  const size_t smem = StatsLayout<C>::bytes;
  cudaError_t e = set_smem(stats_kernel<C, D>, smem);
  if (e != cudaSuccess) return e;
  info[0] = (int)smem;
  info[1] = C / SG;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], stats_kernel<C, D>,
                                                       kStatsThreads, smem);
}

template <int C, int D>
cudaError_t apply_occupancy(int* info) {
  const size_t smem = ApplyLayout<C, D>::bytes;
  cudaError_t e = set_smem(apply_kernel<C, D>, smem);
  if (e != cudaSuccess) return e;
  info[0] = (int)smem;
  info[1] = AR;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], apply_kernel<C, D>,
                                                       kApplyThreads, smem);
}

}  // namespace

FM_ERROR_STRING_ENTRY

// src: [G, S, C] bf16; image: the layer's stats image
// (ops/coarse_transformer.stats_image: per head group of 128 K features,
// [wk_hg | wv_hg] as C / 16 k-step tiles; bf16, 16-byte aligned). Scratch
// part_kv [G, chunks, C*D] and part_ks [G, chunks, C] f32. Out: kv [G, C/D,
// D, D] bf16 in fragment order and ks [G, C] bf16. chunks * per_chunk >=
// ceil(S / 64) > (chunks - 1) * per_chunk.
extern "C" int fm_coarse_stats(const void* src, const void* image, void* part_kv, void* part_ks,
                               void* kv, void* ks, int G, int S, int C, int D, int per_chunk,
                               int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pk = static_cast<float*>(part_kv);
  float* ps = static_cast<float*>(part_ks);
#define FM_STATS(c, d) \
  if (C == c && D == d) return (int)launch_stats<c, d>(src, image, pk, ps, kv, ks, G, S, per_chunk, chunks, st);
  FM_STATS(128, 16) FM_STATS(128, 32) FM_STATS(128, 64)
  FM_STATS(256, 16) FM_STATS(256, 32) FM_STATS(256, 64)
#undef FM_STATS
  return (int)cudaErrorInvalidValue;
}

// x, out: [G, L, C] bf16; kv, ks from fm_coarse_stats over S source tokens;
// image: the layer's weight image (ops/coarse_transformer.apply_image, bf16,
// 16-byte aligned); LN scales and biases f32 [C].
extern "C" int fm_coarse_apply(const void* x, const void* kv, const void* ks, const void* image,
                               const void* n1s, const void* n1b, const void* n2s,
                               const void* n2b, void* out, int G, int L, int S, int C, int D,
                               void* stream) {
  const void* p[8] = {x, kv, ks, image, n1s, n1b, n2s, n2b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FM_APPLY(c, d) \
  if (C == c && D == d) return (int)launch_apply<c, d>(p, out, G, L, S, st);
  FM_APPLY(128, 16) FM_APPLY(128, 32) FM_APPLY(128, 64)
  FM_APPLY(256, 16) FM_APPLY(256, 32) FM_APPLY(256, 64)
#undef FM_APPLY
  return (int)cudaErrorInvalidValue;
}

// info: the stats block's dynamic shared memory in bytes, its head groups
// (blocks a work item of tiles) and the blocks an SM can hold, at (C, D)
extern "C" int fm_coarse_stats_occupancy(int C, int D, int* info) {
#define FM_OCC(c, d) \
  if (C == c && D == d) return (int)stats_occupancy<c, d>(info);
  FM_OCC(128, 16) FM_OCC(128, 32) FM_OCC(128, 64)
  FM_OCC(256, 16) FM_OCC(256, 32) FM_OCC(256, 64)
#undef FM_OCC
  return (int)cudaErrorInvalidValue;
}

// info: the apply block's dynamic shared memory in bytes, its token rows (two
// 64-row tiles) and the blocks an SM can hold, at (C, D)
extern "C" int fm_coarse_apply_occupancy(int C, int D, int* info) {
#define FM_OCC(c, d) \
  if (C == c && D == d) return (int)apply_occupancy<c, d>(info);
  FM_OCC(128, 16) FM_OCC(128, 32) FM_OCC(128, 64)
  FM_OCC(256, 16) FM_OCC(256, 32) FM_OCC(256, 64)
#undef FM_OCC
  return (int)cudaErrorInvalidValue;
}

// out [64, 256] f32 = a [64, K] (bf16, row-major) . b, b [K, 256] as K / 16
// k-step tiles (the apply image's layout); K a multiple of 16, at most 1024
extern "C" int fm_ring_product(const void* a, const void* bimg, void* out, int K, void* stream) {
  if (K < 16 || K % 16 || K > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = 64 * (size_t)K * 2 + 2 * kSlice + 32;
  cudaError_t e = set_smem(ring_product_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ring_product_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(bimg), static_cast<float*>(out), K);
  return (int)cudaGetLastError();
}
