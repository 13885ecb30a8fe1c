// Weight gradients dW = Aᵀ B over the tokens of a batch, shared by the
// training kernels' backwards (K8 in swin_block_train.cu, K9 in
// coarse_transformer_train.cu, K10 in fine_transformer_train.cu) and by the
// standalone entry fm_wgrad (wgrad.cu, ops/wgrad.py).
//
// Replaces the weight-gradient contractions inside the TPU kernels' bodies
// (featurematching_tpu/ops/pallas_swin_block_grad.py:326,343,363,449;
// pallas_coarse_grad.py:71 `_dot_g`, used at :158-223; pallas_fine_grad.py:
// 142-216): there each sequential grid step adds its tokens' Aᵀ B into an
// output block that stays in VMEM. On the H100 a product is bound by bytes:
// T (M + N) bf16 operands against 2 T M N operations, M N / (M + N) <= 205
// operations a byte at the training step's shapes, below the card's 295.
//
// Design. One launch takes a backward's whole group of products (up to
// kMaxProducts: K8's 4, K9's and K10's 6), so the card fills from the
// products' tiles together rather than from each product's token splits
// alone: fewer splits a product, fewer f32 partials through L2, and one
// launch where there were a product's two. A block forms one tile of one
// product's dW, up to 128 x 256 (two warpgroups of 64 rows; NT, the
// tile's width, 64, 128, 192 or 256), over one contiguous run of 64-token
// stages, its split. Both operands are stored token by token (A [T][M], B
// [T][N]), so the contraction runs over rows: each warpgroup runs wgmma
// m64nNTk16 with A and B both read MN-major from shared memory (the
// transpose flags). Tensor copies bring a stage's [64 tokens, 64 columns]
// boxes (128-byte swizzle; rows past T read as zeros) into a ring of NS
// slots on mbarriers, up to NS stages in flight; the last of the block's
// warps to hand a slot back refills it, predicated, so the products stay
// asynchronous (no producer warp: ptxas would cap the block at 168
// registers, and a 64 x 256 f32 accumulator takes 128). A stage leaves L2
// once for up to 128 x 256 outputs. `wgrad_plan` gives every product of
// the group the same number of splits, so that the group's tiles times
// its splits fill the SMs once (one block an SM). Each split writes its
// f32 partial [M][N] (or dW itself where the product has one split), and
// sum_parts_group adds each product's partials in split order: the
// gradients are deterministic on one card (the split depends on its SM
// count), and no float atomics are used.
#pragma once

#include <algorithm>
#include <initializer_list>

#include "wgmma.cuh"

namespace fm {

// one product of a group: out [M][N] f32 = Aᵀ B over T tokens, A [T][M]
// (row stride lda), B [T][N] (row stride ldb), bf16
struct WgradCall {
  const bf16* a;
  int lda;
  const bf16* b;
  int ldb;
  int T, M, N;
  void* out;
};

namespace wgrad_detail {

constexpr int kMaxProducts = 6;
constexpr int kStage = 64;          // tokens a stage
constexpr int TILE_M = 128;         // rows of dW a block
constexpr int kBox = 64 * 128;      // bytes of a [64 tokens, 64 columns] box
constexpr int kThreads = 256;       // two warpgroups of 64 rows
constexpr int kRingBytes = 200 * 1024;

// a slot holds A's two [64, 64] boxes (one a warpgroup), then B's NT / 64
template <int NT>
struct Ring {
  static constexpr int SLOT = (2 + NT / 64) * kBox;
  static constexpr int NS = kRingBytes / SLOT < 8 ? kRingBytes / SLOT : 8;
  static constexpr size_t bar_off = (size_t)NS * SLOT;  // full[NS], then count[NS]
  // + 1024: the swizzle atoms need 1024-byte aligned addresses
  static constexpr size_t bytes = bar_off + 8 * NS + 4 * NS + 1024;
  static_assert(bytes <= 232448, "shared memory of a block");
};

constexpr size_t kSmemBytes = std::max(std::max(Ring<64>::bytes, Ring<128>::bytes),
                                       std::max(Ring<192>::bytes, Ring<256>::bytes));

struct Product {
  float* out;  // dW [M][N] where the product has one split, else partials [splits][M][N]
  int M, N, nt, n_tiles, splits, per, stages, first;  // first: its first block
};

struct Group {
  CUtensorMap a[kMaxProducts], b[kMaxProducts];
  Product p[kMaxProducts];
  int n;
};

// A stage into the slot at `dst`, completing on `bar`, where p: A's `wgs`
// boxes from column m0, B's NT / 64 from column n0, tokens from t0.
template <int NT>
__device__ __forceinline__ void load_stage(uint32_t p, uint32_t dst, uint64_t* bar,
                                           const CUtensorMap* ma, const CUtensorMap* mb, int wgs,
                                           int m0, int n0, int t0) {
  expect_if(p, bar, (uint32_t)(wgs + NT / 64) * kBox);
  tma_2d_if(p, dst, ma, m0, t0, bar);
  tma_2d_if(p & (uint32_t)(wgs > 1), dst + kBox, ma, m0 + 64, t0, bar);
#pragma unroll
  for (int j = 0; j < NT / 64; ++j) tma_2d_if(p, dst + (2 + j) * kBox, mb, n0 + 64 * j, t0, bar);
}

template <int NT>
__device__ __forceinline__ void product(float (&acc)[NT / 2], uint64_t a, uint64_t b) {
  if constexpr (NT == 256)
    wgmma_ss_mn_n256(acc, a, b, 1);
  else if constexpr (NT == 192)
    wgmma_ss_mn_n192(acc, a, b, 1);
  else if constexpr (NT == 128)
    wgmma_ss_mn_n128(acc, a, b, 1);
  else
    wgmma_ss_mn_n64(acc, a, b, 1);
}

// Block `unit` of product pr: tile unit / splits, split unit % splits (a
// tile's splits adjacent).
template <int NT>
__device__ __forceinline__ void run_tile(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                         const Product& pr, int unit, unsigned char* smem) {
  using R = Ring<NT>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::bar_off);
  int* count = reinterpret_cast<int*>(full + R::NS);
  const int tile = unit / pr.splits, split = unit % pr.splits;
  const int m0 = tile / pr.n_tiles * TILE_M, n0 = tile % pr.n_tiles * NT;
  const int wgs = min(2, (pr.M - m0) / 64);  // warpgroups with rows in this tile
  const int s0 = split * pr.per;
  const int n = min(pr.stages, s0 + pr.per) - s0;  // stages of this split (at least 1)
  const uint32_t ring = smem_u32(smem);
  if (threadIdx.x == 0) {
    for (int i = 0; i < R::NS; ++i) {
      mbar_init(&full[i], 1);
      count[i] = 0;
    }
    mbar_init_fence();
    for (int i = 0; i < min(n, R::NS); ++i)
      load_stage<NT>(1u, ring + i * R::SLOT, &full[i], map_a, map_b, wgs, m0, n0,
                     (s0 + i) * kStage);
  }
  __syncthreads();
  // the warpgroup by a shuffle, which ptxas takes as uniform: the operand
  // descriptors are then too, and the products stay asynchronous
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg >= wgs) return;
  const int lane = threadIdx.x % 32;
  const uint32_t last = 4 * wgs - 1;
  float acc[NT / 2];
#pragma unroll
  for (int r = 0; r < NT / 2; ++r) acc[r] = 0.f;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int s = i % R::NS;
    const uint32_t slot = ring + s * R::SLOT;
    mbar_wait(&full[s], (i / R::NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kStage / 16; ++k)  // k-step k: tokens 16 k.., two atoms of 8 rows
      product<NT>(acc, sw128_mn_desc(slot + wg * kBox + k * 2048, kBox),
                  sw128_mn_desc(slot + 2 * kBox + k * 2048, kBox));
    wgmma_commit();
    wgmma_wait<1>();  // the last stage's products are done: its slot goes back
    fence_regs(acc);
    const int sp = (i + R::NS - 1) % R::NS;
    const uint32_t was_last = handback((uint32_t)(i > 0 && lane == 0), &count[sp], last);
    const int refill = i - 1 + R::NS;  // the stage the freed slot takes
    load_stage<NT>(was_last & (uint32_t)(refill < n), ring + sp * R::SLOT, &full[sp], map_a,
                   map_b, wgs, m0, n0, (s0 + refill) * kStage);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // acc[4 j + 2 i + e]: row 16 w + g + 8 i, column 8 j + 2 t + e (wgmma.cuh)
  const int w = (threadIdx.x / 32) % 4, g = lane / 4, t = lane % 4;
  float* out = pr.out + (size_t)split * pr.M * pr.N +
               (size_t)(m0 + 64 * wg + 16 * w + g) * pr.N + n0 + 2 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
      *reinterpret_cast<float2*>(out + (size_t)8 * i * pr.N + 8 * j) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

// Grid: the group's blocks, product after product (Product::first).
__global__ void __launch_bounds__(kThreads, 1) wgrad_kernel(const __grid_constant__ Group g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int q = 0;
  while (q + 1 < g.n && (int)blockIdx.x >= g.p[q + 1].first) ++q;
  const Product& pr = g.p[q];
  const int unit = (int)blockIdx.x - pr.first;
  switch (pr.nt) {
    case 256: run_tile<256>(&g.a[q], &g.b[q], pr, unit, smem); break;
    case 192: run_tile<192>(&g.a[q], &g.b[q], pr, unit, smem); break;
    case 128: run_tile<128>(&g.a[q], &g.b[q], pr, unit, smem); break;
    default: run_tile<64>(&g.a[q], &g.b[q], pr, unit, smem); break;
  }
}

// out[j] = sum over p < nparts of part[p * len + j] of each listed
// product (blockIdx.y), in order of p; four floats a thread
struct SumList {
  const float4* part[kMaxProducts];
  float4* out[kMaxProducts];
  int nparts[kMaxProducts], len4[kMaxProducts];
};

__global__ void sum_parts_group_kernel(const SumList s) {
  const int q = blockIdx.y, j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s.len4[q]) return;
  const float4* part = s.part[q];
  float4 v = part[j];
  for (int p = 1; p < s.nparts[q]; ++p) {
    const float4 x = part[(size_t)p * s.len4[q] + j];
    v.x += x.x;
    v.y += x.y;
    v.z += x.z;
    v.w += x.w;
  }
  s.out[q][j] = v;
}

}  // namespace wgrad_detail

// out[j] = sum over p < nparts of part[p * stride + j], in order of p
__global__ void sum_parts_kernel(const float* __restrict__ part, int nparts, size_t stride,
                                 int len, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[(size_t)p * stride + j];
  out[j] = s;
}

inline cudaError_t sum_parts(const float* part, int nparts, size_t stride, int len, void* out,
                             cudaStream_t st) {
  sum_parts_kernel<<<(len + 255) / 256, 256, 0, st>>>(part, nparts, stride, len,
                                                       static_cast<float*>(out));
  return cudaGetLastError();
}

// How a group of products is cut (ops/wgrad.plan mirrors it): each product
// into tiles of up to 128 rows by nt columns (the widest of 256, 192, 128,
// 64 that divides N; 0: N is none of their multiples), and its ceil(T / 64)
// stages into `splits` runs of `per` (the last may be shorter); every
// product takes the same number of splits where its stages allow, so that
// the group's tiles x splits fill the `sms` SMs once.
struct WgradPlan {
  int nt, m_tiles, n_tiles, stages, splits, per;
};

inline int wgrad_tile_width(int N) {
  for (const int nt : {256, 192, 128, 64})
    if (N % nt == 0) return nt;
  return 0;
}

inline cudaError_t wgrad_plan(const WgradCall* calls, int n, int sms, WgradPlan* plans) {
  if (n < 1 || n > wgrad_detail::kMaxProducts || sms < 1) return cudaErrorInvalidValue;
  int tiles = 0;
  for (int q = 0; q < n; ++q) {
    const WgradCall& c = calls[q];
    WgradPlan& p = plans[q];
    p.nt = wgrad_tile_width(c.N);
    if (p.nt == 0 || c.T < 1 || c.M < 64 || c.M % 64) return cudaErrorInvalidValue;
    p.m_tiles = (c.M + wgrad_detail::TILE_M - 1) / wgrad_detail::TILE_M;
    p.n_tiles = c.N / p.nt;
    p.stages = (c.T + wgrad_detail::kStage - 1) / wgrad_detail::kStage;
    tiles += p.m_tiles * p.n_tiles;
  }
  const int want = std::max(1, sms / tiles);
  for (int q = 0; q < n; ++q) {
    WgradPlan& p = plans[q];
    p.per = (p.stages + std::min(want, p.stages) - 1) / std::min(want, p.stages);
    p.splits = (p.stages + p.per - 1) / p.per;
  }
  return cudaSuccess;
}

// the tensor map of a [T][cols] bf16 operand (row stride ld elements) in
// [64 tokens, 64 columns] boxes, rows past T read as zeros
inline cudaError_t wgrad_map(CUtensorMap* map, const bf16* x, int ld, int T, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)T};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, wgrad_detail::kStage};
  return bf16_tensor_map(map, x, 2, dims, strides, box);
}

// Each call's out [M][N] f32 = Aᵀ B in one launch (and one more that adds
// the partials): n products (at most 6), base addresses and strides 16-byte
// aligned, M and N multiples of 64, T >= 1. `sms`: the card's SMs (the
// split's rule). part: f32 scratch for the partials of the products with
// more than one split, splits x M x N each in order (ops/wgrad.
// partial_floats); calls in stream order may share it.
inline cudaError_t wgrad_group(const WgradCall* calls, int n, int sms, float* part,
                               cudaStream_t st) {
  using namespace wgrad_detail;
  WgradPlan plans[kMaxProducts];
  cudaError_t e = wgrad_plan(calls, n, sms, plans);
  if (e != cudaSuccess) return e;
  Group g;
  SumList sums;
  int blocks = 0, nsums = 0, len4 = 0;
  float* at = part;
  for (int q = 0; q < n; ++q) {
    const WgradCall& c = calls[q];
    const WgradPlan& p = plans[q];
    e = wgrad_map(&g.a[q], c.a, c.lda, c.T, c.M);
    if (e != cudaSuccess) return e;
    e = wgrad_map(&g.b[q], c.b, c.ldb, c.T, c.N);
    if (e != cudaSuccess) return e;
    Product& pr = g.p[q];
    pr.out = p.splits > 1 ? at : static_cast<float*>(c.out);
    pr.M = c.M;
    pr.N = c.N;
    pr.nt = p.nt;
    pr.n_tiles = p.n_tiles;
    pr.splits = p.splits;
    pr.per = p.per;
    pr.stages = p.stages;
    pr.first = blocks;
    blocks += p.m_tiles * p.n_tiles * p.splits;
    if (p.splits > 1) {
      sums.part[nsums] = reinterpret_cast<const float4*>(at);
      sums.out[nsums] = static_cast<float4*>(c.out);
      sums.nparts[nsums] = p.splits;
      sums.len4[nsums] = c.M * c.N / 4;
      len4 = std::max(len4, c.M * c.N / 4);
      ++nsums;
      at += (size_t)p.splits * c.M * c.N;
    }
  }
  g.n = n;
  e = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  wgrad_kernel<<<blocks, kThreads, kSmemBytes, st>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsums == 0) return e;
  sum_parts_group_kernel<<<dim3((len4 + 255) / 256, nsums), 256, 0, st>>>(sums);
  return cudaGetLastError();
}

}  // namespace fm
