#pragma once

// Whole Swin block on 8x8 windows, shared by the serving and training forwards:
//   h = LN1(x); x += proj(W-MSA(qkv(h), rel_bias, shift mask)); x += mlp2(gelu(mlp1(LN2(x))))
//
// Replaces featurematching_tpu/ops/pallas_swin_block.py · swin_block_fused
// (_block_kernel / _block_math). Bound on the H100 by tensor-core operations:
// 24*C^2 + 256*C multiply-adds x2 a token against 4*C bytes of activations
// in and out (the 24*C^2 bytes of weights are read from device memory once
// a launch). One thread block takes one window and keeps every intermediate
// of it on chip (its activations, LN output and q|k|v in shared memory), so
// each block reads all 12*C^2 weights for only 64 rows of work: the weights
// stream from L2 at 24*C^2 bytes a window (1.5 MB at C = 256), and the block
// has to hide that stream behind its products. Design:
//   - Products on mma.sync.m16n8k16 bf16 tiles with f32 accumulation
//     (tiles.cuh): A fragments from shared memory by ldmatrix, B fragments
//     by ldmatrix.trans from the weights staged in shared memory, and the
//     bias, branch scale, bf16 rounding, residual add and GELU applied to
//     the accumulators in registers. The block's warps stand as 2 x WN over
//     each [64, C] product, a warp on a 32 x C/WN tile.
//   - Weights as one stream (WeightStream): the twelve [C, C] blocks in the
//     order they are used (w_qkv's q, k and v columns, w_proj, then w1's and
//     w2's halves of each of the four hidden chunks), cut into row slices
//     of 32 (64 at C = 64) and copied by cp.async, 16 bytes a thread, into a
//     ring of three slots shared by the block's warps: while one slice feeds
//     the tensor cores the next two are in flight, across the boundaries
//     between products, the attention and the LayerNorms. The callers'
//     row-major [in, out] layout is read as it is, so nothing is packed and
//     no launch is added.
//   - Attention: one warp takes whole (head, 16 query rows) units of
//     attention_unit.cuh (K11 runs a copy of it): scores, softmax and P in
//     registers, the output over the unit's own q columns. The head dim D
//     (16, 32 or 64) is a template parameter beside C: H = C / D heads, so
//     4 H units a window (at C = 64 with one head of 64, 4 units for the
//     block's 8 warps: half of them wait through the attention). The shift mask
//     arrives as each lane's mask registers: read from mask[win % nW] (K2,
//     K8), built from region labels (K12), or none.
//   - MLP: the hidden width runs in four chunks of C columns (gelu(mlp1)
//     into shared memory as bf16, mlp2's partial products accumulate in
//     registers across the chunks), so the [64, 4C] hidden never exists.
//   - Occupancy: 72,256 / 111,680 / 218,176 bytes of shared memory a block
//     at C = 64 / 128 / 256. C <= 128 runs two blocks of 8 warps an SM (the
//     launch bounds cap the registers at 128); C = 256 one block of 16
//     warps (128 registers), so every SM has 16 warps to hide latencies.
// What sets the pace on the card (PERF.md): the products' issue and
// latency with ldmatrix operands (mma.sync at a fraction of the tensor
// cores' rate), then the weights' way from L2 and the barrier a slice; at
// C = 256 the serving forward's 160 windows run as two waves on 132 SMs.
//
// Rounding follows the TPU kernel: products accumulate in f32, the bias is
// added in f32 (and, in training, the branch scale applied) and the sum is
// rounded to bf16; residual adds are bf16 + bf16; the attention scale
// multiplies the f32 q.k product.
//
// The same kernel serves the training forward (swin_block_train.cu, K8):
// TrainIO carries the drop-path branch scales and the outputs the backward
// reads; the serving forward (swin_block.cu, K2) passes nulls. It also
// serves the image-layout block (swin_block_image.cu, K12): ImageIO has it
// read each window straight from a padded [B, Hp2, Wp2, C] map and write it
// back to the same place, with the shift mask derived from each token's
// region label instead of read.

#include "attention_unit.cuh"

namespace swin {

using fm::Acc16;
using fm::bf16;

constexpr int N = fm::kWin;  // tokens of an 8x8 window
constexpr int kStages = 3;   // weight slices in the ring: one in use, two in flight

template <int C>
struct Smem {
  // C <= 128: two blocks an SM; C = 256 (one block an SM): twice the warps
  static constexpr int WARPS = C == 256 ? 16 : 8, THREADS = 32 * WARPS;
  static constexpr int LDX = C + 8;             // x, LN, hidden-chunk and weight-slice rows
  static constexpr int LDQ = 3 * C + 8;         // q|k|v rows
  static constexpr int KS = C == 64 ? 64 : 32;  // weight rows a slice
  static constexpr size_t x_off = 0;                    // bf16 [N][LDX] residual stream
  static constexpr size_t h_off = x_off + N * LDX * 2;  // bf16 [N][LDX] LN output
  static constexpr size_t q_off = h_off + N * LDX * 2;  // bf16 [N][LDQ] q|k|v, then hidden [N][LDX]
  static constexpr size_t w_off = q_off + N * LDQ * 2;  // bf16 kStages x [KS][LDX] weight slices
  static constexpr size_t o_off = w_off + kStages * KS * LDX * 2;  // int64 [N] token offsets
  static constexpr size_t l_off = o_off + N * 8;                   // uint8 [N] region labels
  static constexpr size_t bytes = l_off + N;
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// The block's weights as one stream of [KS][C] row slices through a ring of
// kStages slots, in the order the block consumes them: the twelve [C][C]
// blocks w_qkv[:, 0:C), [C:2C), [2C:3C), w_proj, then for each hidden chunk
// j w1[:, jC:(j+1)C) and w2[jC:(j+1)C, :], each in C / KS slices.
template <int C>
struct WeightStream {
  static constexpr int KS = Smem<C>::KS, LDX = Smem<C>::LDX, SLICES = C / KS;
  static constexpr int TOTAL = 12 * SLICES;
  const bf16 *wqkv, *wproj, *w1, *w2;
  bf16* ring;
  int issued, taken;

  // start copying the next slice into its slot; past the end an empty group,
  // so that every wait counts the same groups
  __device__ __forceinline__ void issue() {
    if (issued < TOTAL) {
      const int b = issued / SLICES, r = issued % SLICES;
      const bf16* src;
      int ld;
      if (b < 3) {
        src = wqkv + b * C;
        ld = 3 * C;
      } else if (b == 3) {
        src = wproj;
        ld = C;
      } else if ((b - 4) % 2 == 0) {
        src = w1 + (b - 4) / 2 * C;
        ld = 4 * C;
      } else {
        src = w2 + (size_t)((b - 5) / 2) * C * C;
        ld = C;
      }
      src += (size_t)r * KS * ld;
      bf16* dst = ring + (issued % kStages) * KS * LDX;
      for (int e = threadIdx.x; e < KS * C / 8; e += Smem<C>::THREADS) {
        const int row = e / (C / 8), c = e % (C / 8) * 8;
        fm::cp_async16(dst + row * LDX + c, src + (size_t)row * ld + c);
      }
    }
    fm::cp_async_commit();
    ++issued;
  }

  __device__ __forceinline__ void start() {
    issued = taken = 0;
    for (int s = 0; s < kStages - 1; ++s) issue();
  }

  // The next slice, once every thread's copies of it have landed. The
  // barrier also orders the block's shared-memory writes before it against
  // the reads after it; past it every warp is done with the previous slice,
  // whose slot takes the next copy.
  __device__ __forceinline__ const bf16* next() {
    fm::cp_async_wait<kStages - 2>();
    __syncthreads();
    const bf16* s = ring + (taken % kStages) * KS * LDX;
    ++taken;
    issue();
    return s;
  }
};

// A warp's tile of a [64][C] product, the block's warps as 2 x WN: rows
// 32 (warp / WN) + [0, 32), columns (C / WN) (warp % WN) + [0, C / WN), as
// 2 x NT accumulators of 16x16.
template <int C>
struct Tile {
  static constexpr int WN = Smem<C>::WARPS / 2, NT = C / (16 * WN);
};
template <int C>
using WarpAcc = Acc16[2][Tile<C>::NT];

template <int C>
__device__ __forceinline__ void zero(WarpAcc<C>& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Tile<C>::NT; ++j) fm::zero(acc[i][j]);
}

// acc += A[64][C] . W over the warp's tile: A in shared memory (row stride
// lda), W the stream's next [C][C] block
template <int C>
__device__ __forceinline__ void product(WarpAcc<C>& acc, const bf16* a, int lda,
                                        WeightStream<C>& ws, int warp, int lane) {
  constexpr int KS = Smem<C>::KS, LDX = Smem<C>::LDX, WN = Tile<C>::WN, NT = Tile<C>::NT;
  const int m0 = warp / WN * 32, n0 = warp % WN * (C / WN);
  for (int r = 0; r < C / KS; ++r) {
    const bf16* w = ws.next();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t fa[2][4], fb[NT][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        fm::load_a(fa[i], a + (m0 + 16 * i) * lda + r * KS + 16 * kk, lda, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) fm::load_b(fb[j], w + 16 * kk * LDX + n0 + 16 * j, LDX, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) fm::mma16(acc[i][j], fa[i], fb[j]);
    }
  }
}

// Hand the warp's tile to epi(row, col, v0, v1), v0 and v1 at columns col
// and col + 1 (col even), straight from the accumulator registers.
template <int C, typename Epi>
__device__ __forceinline__ void epilogue(const WarpAcc<C>& acc, int warp, int lane, Epi epi) {
  constexpr int WN = Tile<C>::WN;
  const int m0 = warp / WN * 32, n0 = warp % WN * (C / WN), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Tile<C>::NT; ++j)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
        epi(m0 + 16 * i + g + 8 * (jp & 1), n0 + 16 * j + 8 * (jp >> 1) + 2 * t,
            acc[i][j].c[2 * jp], acc[i][j].c[2 * jp + 1]);
}

__device__ __forceinline__ __nv_bfloat162& bf16x2_at(bf16* p) {
  return *reinterpret_cast<__nv_bfloat162*>(p);
}

__device__ __forceinline__ float2 f32x2_at(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// the attention scale D^-0.5: 0.25, 0.1767767 and 0.125 (16 and 64 powers
// of two, so s * scale is exact and rounds as the TPU kernel's product does)
__host__ __device__ constexpr float attn_scale(int D) {
  return D == 16 ? 0.25f : (D == 64 ? 0.125f : 0.17677669529663687f);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// LN over the window's 64 rows of `src` into `dst` (bf16), 64 / WARPS rows a warp.
template <int C>
__device__ __forceinline__ void layer_norm_rows(const bf16* src, bf16* dst, const float* s,
                                                const float* b, int warp, int lane) {
  constexpr int V = C / 32, LDX = Smem<C>::LDX, R = N / Smem<C>::WARPS;
  float sv[V], bv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sv[i] = s[lane * V + i];
    bv[i] = b[lane * V + i];
  }
#pragma unroll  // independent rows: their shuffle reductions overlap
  for (int r = warp * R; r < warp * R + R; ++r) {
    float v[V];
    fm::load_bf16<V>(src + r * LDX + lane * V, v);
    fm::warp_layer_norm<V, C>(v, sv, bv);
    fm::store_bf16<V>(dst + r * LDX + lane * V, v);
  }
}

// What the training forward adds: per-window branch scales (null: none) and
// the two tensors it keeps for the backward (null in the serving forward).
struct TrainIO {
  const float* s1;  // [num_windows] attention-branch scale
  const float* s2;  // [num_windows] MLP-branch scale
  bf16* probs;      // [num_windows][heads][64][64] attention probabilities
  bf16* x1;         // [num_windows][64][C] residual stream after the attention branch
};

// Where the block's tokens live. hp2 = 0: the window layout [windows, 64,
// C]. Otherwise the padded map [B, hp2, wp2, C] (hp2, wp2 multiples of 8),
// windows numbered image by image in row-major order; with shift > 0 the
// map is padded as ops/swin_block_image.py pads it ((8 - shift) rows and
// columns before the content, the content to a multiple of 8, shift after)
// and the mask is -100 between tokens of different regions.
struct ImageIO {
  int hp2 = 0, wp2 = 0, shift = 0;
};

// Region band of padded coordinate p along an axis of padded length p2
// (pad_region_masks): 3 in the added pad, else 2, 0 or 1 as the rolled
// map's shift mask labels the content coordinate.
__device__ __forceinline__ int region_band(int p, int p2, int shift) {
  const int y = p - (8 - shift), hp = p2 - 8;
  if (y < 0 || y >= hp) return 3;
  return y < shift ? 2 : (y < hp - 8 + shift ? 0 : 1);
}

// Each token's element offset in x and out, and its region label (shift
// mask of the image layout only), into shared memory.
__device__ __forceinline__ void window_tokens(const ImageIO& img, int win, int C,
                                              long long* off, unsigned char* lab) {
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    if (img.hp2 == 0) {
      off[t] = ((long long)win * N + t) * C;
      continue;
    }
    const int nww = img.wp2 / 8, nwh = img.hp2 / 8;
    const int b = win / (nwh * nww), y = (win / nww) % nwh * 8 + t / 8,
              xx = win % nww * 8 + t % 8;
    off[t] = (((long long)b * img.hp2 + y) * img.wp2 + xx) * C;
    if (img.shift > 0)
      lab[t] = region_band(y, img.hp2, img.shift) * 4 + region_band(xx, img.wp2, img.shift);
  }
}

// MASKED: the window has a shift mask, mask[win % nW] when nW > 0, else
// -100 between tokens of different region labels. D: the head dim.
template <int C, int D, bool MASKED>
__global__ void __launch_bounds__(Smem<C>::THREADS, C == 256 ? 1 : 2)
swin_block_kernel(TrainIO io, ImageIO img, const bf16* __restrict__ x,
                  const float* __restrict__ mask, int nW,
                  const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                  const bf16* __restrict__ wqkv, const float* __restrict__ bqkv,
                  const float* __restrict__ rel_bias, const bf16* __restrict__ wproj,
                  const float* __restrict__ bproj, const float* __restrict__ ln2s,
                  const float* __restrict__ ln2b, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, bf16* __restrict__ out) {
  using S = Smem<C>;
  constexpr int H = C / D, LDX = S::LDX, LDQ = S::LDQ, THREADS = S::THREADS;
  static_assert(D == 16 || D == 32 || D == 64, "head dims 16, 32 and 64");
  static_assert(S::WARPS % (N / 16) == 0, "a warp's attention units must share their row tile");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + S::x_off);
  bf16* hs = reinterpret_cast<bf16*>(smem + S::h_off);
  bf16* qkv = reinterpret_cast<bf16*>(smem + S::q_off);
  bf16* hid = qkv;  // the MLP's hidden chunk, once the attention output is consumed
  long long* toff = reinterpret_cast<long long*>(smem + S::o_off);
  unsigned char* lab = smem + S::l_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int win = blockIdx.x;

  // the first weight slices load while the tokens arrive and LN1 runs
  WeightStream<C> ws{wqkv, wproj, w1, w2, reinterpret_cast<bf16*>(smem + S::w_off)};
  ws.start();
  window_tokens(img, win, C, toff, lab);
  __syncthreads();
  for (int e = threadIdx.x; e < N * (C / 8); e += THREADS) {  // 16-byte loads
    const int r = e / (C / 8), c = e % (C / 8) * 8;
    *reinterpret_cast<uint4*>(xs + r * LDX + c) =
        *reinterpret_cast<const uint4*>(x + toff[r] + c);
  }
  __syncthreads();
  layer_norm_rows<C>(xs, hs, ln1s, ln1b, warp, lane);

  // qkv = LN1(x) @ w_qkv + b_qkv, its q, k and v blocks in turn
  WarpAcc<C> acc;
  for (int b = 0; b < 3; ++b) {
    zero<C>(acc);
    product<C>(acc, hs, LDX, ws, warp, lane);
    epilogue<C>(acc, warp, lane, [&](int row, int col, float v0, float v1) {
      const float2 bb = f32x2_at(bqkv + b * C + col);
      bf16x2_at(qkv + row * LDQ + b * C + col) = __floats2bfloat162_rn(v0 + bb.x, v1 + bb.y);
    });
  }
  __syncthreads();

  // attention: a warp's units share the row tile tm, so its mask registers
  // serve all of its heads
  const int tm = warp % (N / 16);
  float mv[N / 16][8];
  if (MASKED) {
    if (nW > 0) {
      fm::load_unit_mask(mv, mask + (size_t)(win % nW) * N * N, tm, lane);
    } else {
#pragma unroll
      for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const unsigned char lq = lab[tm * 16 + fm::pair_row(jp, lane)];
          const int k = fm::pair_col(kt, jp, lane);
          mv[kt][2 * jp] = lab[k] == lq ? 0.f : -100.f;
          mv[kt][2 * jp + 1] = lab[k + 1] == lq ? 0.f : -100.f;
        }
    }
  }
  bf16* probs = io.probs ? io.probs + (size_t)win * H * N * N : nullptr;
  for (int hd = warp / (N / 16); hd < H; hd += S::WARPS / (N / 16))
    fm::attention_unit<D, MASKED>(qkv, LDQ, C, hd, tm, attn_scale(D), rel_bias, mv, lane, probs);

  // x = x + s1 * (attn @ w_proj + b_proj); the stream's barrier orders the
  // attention's writes before the product's reads
  const float sc1 = io.s1 ? io.s1[win] : 1.0f, sc2 = io.s2 ? io.s2[win] : 1.0f;
  zero<C>(acc);
  product<C>(acc, qkv, LDQ, ws, warp, lane);
  epilogue<C>(acc, warp, lane, [&](int row, int col, float v0, float v1) {
    const float2 bb = f32x2_at(bproj + col);
    __nv_bfloat162& xr = bf16x2_at(xs + row * LDX + col);
    const float2 xv = __bfloat1622float2(xr);
    xr = __floats2bfloat162_rn(xv.x + fm::round_bf16((v0 + bb.x) * sc1),
                               xv.y + fm::round_bf16((v1 + bb.y) * sc1));
  });
  __syncthreads();
  if (io.x1) fm::copy_rows_from_smem(io.x1 + (size_t)win * N * C, C, xs, LDX, N, C);
  layer_norm_rows<C>(xs, hs, ln2s, ln2b, warp, lane);

  // out = x + s2 * mlp2(gelu(mlp1(LN2(x)))), the hidden width in chunks of C
  // columns; mlp2's accumulators stay in registers across the chunks
  WarpAcc<C> acc2;
  zero<C>(acc2);
  for (int j = 0; j < 4; ++j) {
    zero<C>(acc);
    product<C>(acc, hs, LDX, ws, warp, lane);
    epilogue<C>(acc, warp, lane, [&](int row, int col, float v0, float v1) {
      const float2 bb = f32x2_at(b1 + j * C + col);
      bf16x2_at(hid + row * LDX + col) = __floats2bfloat162_rn(gelu(v0 + bb.x), gelu(v1 + bb.y));
    });
    product<C>(acc2, hid, LDX, ws, warp, lane);
  }
  epilogue<C>(acc2, warp, lane, [&](int row, int col, float v0, float v1) {
    const float2 bb = f32x2_at(b2 + col);
    __nv_bfloat162& xr = bf16x2_at(xs + row * LDX + col);
    const float2 xv = __bfloat1622float2(xr);
    xr = __floats2bfloat162_rn(xv.x + fm::round_bf16((v0 + bb.x) * sc2),
                               xv.y + fm::round_bf16((v1 + bb.y) * sc2));
  });
  __syncthreads();
  for (int e = threadIdx.x; e < N * (C / 8); e += THREADS) {  // 16-byte stores
    const int r = e / (C / 8), c = e % (C / 8) * 8;
    *reinterpret_cast<uint4*>(out + toff[r] + c) =
        *reinterpret_cast<const uint4*>(xs + r * LDX + c);
  }
}

template <int C, int D, bool MASKED>
cudaError_t launch_as(TrainIO io, const void* x, const void* mask, int nW, const void* const* p,
                      void* out, int num_windows, cudaStream_t st, ImageIO img) {
  const size_t smem = Smem<C>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      swin_block_kernel<C, D, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  auto Bf = [](const void* q) { return static_cast<const bf16*>(q); };
  swin_block_kernel<C, D, MASKED><<<num_windows, Smem<C>::THREADS, smem, st>>>(
      io, img, Bf(x), F(mask), nW, F(p[0]), F(p[1]), Bf(p[2]), F(p[3]), F(p[4]), Bf(p[5]),
      F(p[6]), F(p[7]), F(p[8]), Bf(p[9]), F(p[10]), Bf(p[11]), F(p[12]),
      static_cast<bf16*>(out));
  return cudaGetLastError();
}

template <int C, int D>
cudaError_t launch_block(TrainIO io, const void* x, const void* mask, int nW,
                         const void* const* p, void* out, int num_windows, cudaStream_t st,
                         ImageIO img = {}) {
  if (nW > 0 || img.shift > 0)
    return launch_as<C, D, true>(io, x, mask, nW, p, out, num_windows, st, img);
  return launch_as<C, D, false>(io, x, mask, nW, p, out, num_windows, st, img);
}

// launch_block at C in (64, 128, 256) and a head dim D among Ds (instantiated
// only where it is called: K8's forward takes 16 alone); an invalid value
// error for any other pair
template <int C, int... Ds>
cudaError_t launch_block_dims(int D, TrainIO io, const void* x, const void* mask, int nW,
                              const void* const* p, void* out, int num_windows,
                              cudaStream_t st, ImageIO img) {
  cudaError_t e = cudaErrorInvalidValue;
  (void)((D == Ds && ((e = launch_block<C, Ds>(io, x, mask, nW, p, out, num_windows, st, img)),
                      true)) || ...);
  return e;
}

template <int... Ds>
cudaError_t launch_block_at(int C, int D, TrainIO io, const void* x, const void* mask, int nW,
                            const void* const* p, void* out, int num_windows, cudaStream_t st,
                            ImageIO img = {}) {
  switch (C) {
    case 64: return launch_block_dims<64, Ds...>(D, io, x, mask, nW, p, out, num_windows, st, img);
    case 128:
      return launch_block_dims<128, Ds...>(D, io, x, mask, nW, p, out, num_windows, st, img);
    case 256:
      return launch_block_dims<256, Ds...>(D, io, x, mask, nW, p, out, num_windows, st, img);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace swin
