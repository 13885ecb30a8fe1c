// PatchExpand tail: 2x2 depth-to-space of the expand output, the PatchExpand
// LN, the stage norm_up LN, and an optional per-token dense head.
//
// Replaces featurematching_tpu/ops/pallas_patch_expand.py · patch_expand_ln
// (_kernel). Bound on the H100: device-memory bytes (the expand output is
// read once, the LN and head outputs written once; the head's 2*C4*Chead
// operations per token are at most 32 a byte, under the card's ratio of
// ~295). Design, for the memory system:
//   - Order of work. The expand output y [B, H*W, (i, j, c)] is read in its
//     own order: "token" q = 4 p + 2 i + j of input token p = (b H + h) W + w
//     is the contiguous C4-run at q C4, and lands on output token (b, 2h + i,
//     2w + j). A tile is T consecutive q: its reads are contiguous, and its
//     writes are runs of two tokens (q, q + 1) in output rows 2h and 2h + 1.
//   - Rows. A token's C4 channels lie on C4 / 8 lanes, 16 bytes a lane
//     (`fm::RowLn`, shared with K3), kRows warp loads a tile a thread; both
//     LNs in f32 registers with the scales and biases held there, one bf16
//     rounding; the LN output (when asked) is stored from registers, each
//     warp store filling whole 32-byte sectors.
//   - A persistent grid walks the tiles; each thread issues the next tile's
//     16-byte loads before it normalises the current one.
//   - Head. The weight [C4, CH] is copied into shared memory once a block;
//     the tile's bf16 LN rows are staged in shared memory and multiplied on
//     mma.sync.m16n8k16 (tiles.cuh) with f32 accumulation, in passes of up
//     to 128 columns; the bias (where given) is added in f32 in registers,
//     the result rounded once and staged in shared memory, then written
//     with 16-byte stores. A pass's staging tile is small enough that two
//     blocks fit an SM at every (C4, CH), so one block's loads, products
//     and stores overlap the other's.

#include "tiles.cuh"

namespace {

using fm::bf16;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kRows = 4;  // warp loads a tile: tokens in flight a thread

// The output token of q = 4 p + 2 i + j, p = (b H + h) W + w: (b, 2h + i,
// 2w + j) of the [B, 2H, 2W] output, as a row of [B * 4 H W]
__device__ __forceinline__ int out_token(int q, int W) {
  const int p = q >> 2, bh = p / W, w = p - bh * W;
  return (2 * bh + ((q >> 1) & 1)) * 2 * W + 2 * w + (q & 1);
}

template <int C4, int CH>
struct Tile {
  static constexpr int T = kWarps * (256 / C4) * kRows;  // tokens: 128 at C4 = 64, 64 at 128
  static constexpr int PC = CH < 128 ? CH : 128;         // head columns a pass
  static constexpr int LDA = C4 + 8, LDW = CH + 8, LDO = PC + 8;  // shared row strides (bf16)
  static constexpr int WM = T / 16, WN = kWarps / WM;    // warps over the head's rows, columns
  static constexpr int CW = PC / WN;                     // a warp's columns of a pass
  static constexpr int CK = CW < 64 ? CW : 64;           // columns its accumulators hold
  // shared memory: the weight [C4][LDW], the LN rows [T][LDA], a pass of
  // the head output [T][LDO] (bf16), the bias [CH] (f32)
  static constexpr size_t kW = (size_t)C4 * LDW * 2, kA = (size_t)T * LDA * 2,
                          kO = (size_t)T * LDO * 2;
  static constexpr size_t kSmem = CH ? kW + kA + kO + CH * 4 : 0;
  static constexpr int kMinBlocks = 2;  // blocks an SM the registers must allow
};

// One pass of the tile's head product: out[T][PC] = a[T][C4] . w[C4][c0 ..
// c0 + PC) (+ bias), bf16 into `so`; warp (wm, wn) takes rows 16 wm.. and
// the pass's columns CW wn..
template <int C4, int CH>
__device__ __forceinline__ void head_pass(const bf16* sa, const bf16* sw, const float* sb,
                                          bool bias, bf16* so, int c0, int warp, int lane) {
  using S = Tile<C4, CH>;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n0 = wn * S::CW; n0 < (wn + 1) * S::CW; n0 += S::CK) {
    fm::Acc16 acc[S::CK / 16];
#pragma unroll
    for (int n = 0; n < S::CK / 16; ++n) fm::zero(acc[n]);
#pragma unroll
    for (int k = 0; k < C4 / 16; ++k) {
      uint32_t fa[4];
      fm::load_a(fa, sa + wm * 16 * S::LDA + k * 16, S::LDA, lane);
#pragma unroll
      for (int n = 0; n < S::CK / 16; ++n) {
        uint32_t fb[4];
        fm::load_b(fb, sw + k * 16 * S::LDW + c0 + n0 + n * 16, S::LDW, lane);
        fm::mma16(acc[n], fa, fb);
      }
    }
#pragma unroll
    for (int n = 0; n < S::CK / 16; ++n) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {  // (c[j], c[j + 1]): two neighbouring columns
        const int row = wm * 16 + g + 8 * ((j >> 1) & 1);
        const int col = n0 + n * 16 + 8 * (j >> 2) + 2 * t;
        float x0 = acc[n].c[j], x1 = acc[n].c[j + 1];
        if (bias) {
          x0 += sb[c0 + col];
          x1 += sb[c0 + col + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(so + row * S::LDO + col) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <int C4, int CH, bool TWO>
__global__ void __launch_bounds__(kThreads, Tile<C4, CH>::kMinBlocks)
patch_expand_kernel(const bf16* __restrict__ y, int W, int total,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const float* __restrict__ s2, const float* __restrict__ b2,
                    const bf16* __restrict__ wh, const float* __restrict__ bh,
                    bf16* __restrict__ ln_out, bf16* __restrict__ head_out) {
  using S = Tile<C4, CH>;
  using Ln = fm::RowLn<C4, TWO>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sw = reinterpret_cast<bf16*>(smem);
  bf16* sa = reinterpret_cast<bf16*>(smem + S::kW);
  bf16* so = reinterpret_cast<bf16*>(smem + S::kW + S::kA);
  float* sb = reinterpret_cast<float*>(smem + S::kW + S::kA + S::kO);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const Ln ln(s1, b1, s2, b2, lane);
  const int col = Ln::channel(lane);
  const int first = warp * Ln::RW * kRows + Ln::row_of(lane);  // this thread's first token a tile
  const int ntiles = (total + S::T - 1) / S::T;
  if constexpr (CH > 0) {  // the weight and bias, once a block; read after the first barrier
    fm::copy_rows_to_smem(sw, S::LDW, wh, CH, C4, CH, C4);
    for (int c = threadIdx.x; c < CH; c += kThreads) sb[c] = bh ? bh[c] : 0.f;
  }

  uint4 raw[kRows];
  auto load = [&](int tile) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int q = tile * S::T + first + r * Ln::RW;
      raw[r] = q < total ? fm::load16_stream(y + (size_t)q * C4 + col) : make_uint4(0, 0, 0, 0);
    }
  };
  const int step = gridDim.x;
  if ((int)blockIdx.x < ntiles) load(blockIdx.x);
  for (int tile = blockIdx.x; tile < ntiles; tile += step) {
    float v[kRows][8];
#pragma unroll
    for (int r = 0; r < kRows; ++r) fm::unpack8(raw[r], v[r]);
    if (tile + step < ntiles) load(tile + step);  // in flight while this tile runs
    ln(v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = first + r * Ln::RW, q = tile * S::T + i;
      const uint4 o = fm::pack8(v[r]);
      if (ln_out && q < total)
        *reinterpret_cast<uint4*>(ln_out + (size_t)out_token(q, W) * C4 + col) = o;
      if constexpr (CH > 0) *reinterpret_cast<uint4*>(sa + i * S::LDA + col) = o;
    }
    if constexpr (CH > 0) {
      __syncthreads();  // the LN rows (and, at first, the weight) in place
#pragma unroll 1
      for (int c0 = 0; c0 < CH; c0 += S::PC) {
        head_pass<C4, CH>(sa, sw, sb, bh != nullptr, so, c0, warp, lane);
        __syncthreads();  // the pass in place
        constexpr int kPer = S::PC / 8;  // 16-byte pieces a row of the pass
        static_assert(S::T * kPer % kThreads == 0, "whole rounds over the pass");
#pragma unroll
        for (int k = 0; k < S::T * kPer / kThreads; ++k) {
          const int e = threadIdx.x + k * kThreads;
          const int i = e / kPer, c = (e % kPer) * 8, q = tile * S::T + i;
          if (q < total)
            *reinterpret_cast<uint4*>(head_out + (size_t)out_token(q, W) * CH + c0 + c) =
                *reinterpret_cast<const uint4*>(so + i * S::LDO + c);
        }
        if (c0 + S::PC < CH) __syncthreads();  // the pass stored: `so` free again
      }
    }
  }
}

// the kernel at (C4, CH, TWO), its dynamic shared memory allowed once
template <int C4, int CH, bool TWO>
cudaError_t prepared(const void** fn) {
  static const cudaError_t set = cudaFuncSetAttribute(
      patch_expand_kernel<C4, CH, TWO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile<C4, CH>::kSmem);
  *fn = reinterpret_cast<const void*>(patch_expand_kernel<C4, CH, TWO>);
  return set;
}

template <int C4, int CH>
cudaError_t launch(const void* y, int W, int total, const void* s1, const void* b1,
                   const void* s2, const void* b2, int two, const void* wh, const void* bh,
                   void* ln_out, void* head_out, int grid, cudaStream_t st) {
  const void* fn;
  cudaError_t e = two ? prepared<C4, CH, true>(&fn) : prepared<C4, CH, false>(&fn);
  if (e != cudaSuccess) return e;
  void* args[] = {&y, &W, &total, &s1, &b1, &s2, &b2, &wh, &bh, &ln_out, &head_out};
  return cudaLaunchKernel(fn, grid, kThreads, args, Tile<C4, CH>::kSmem, st);
}

// the fewer of the two forms' resident blocks an SM
template <int C4, int CH>
cudaError_t blocks_per_sm(int* n) {
  const void* fn[2];
  cudaError_t e = prepared<C4, CH, false>(&fn[0]);
  if (e == cudaSuccess) e = prepared<C4, CH, true>(&fn[1]);
  int m[2] = {0, 0};
  for (int i = 0; i < 2 && e == cudaSuccess; ++i)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&m[i], fn[i], kThreads,
                                                      Tile<C4, CH>::kSmem);
  *n = m[0] < m[1] ? m[0] : m[1];
  return e;
}

}  // namespace

FM_ERROR_STRING_ENTRY

// y: [B, H*W, 4*C4] bf16, lanes ordered (i, j, c); total = 4*B*H*W output
// tokens (the kernel takes the first `total` of y's (p, i, j) runs). ln_out
// (or null): [B, 4*H*W, C4] bf16. head (CH > 0): wh [C4, CH] bf16, bh [CH]
// f32 or null (no bias), head_out [B, 4*H*W, CH] bf16. s1, b1, s2, b2: [C4]
// f32 (s2/b2 read only if two). grid: blocks (ops/patch_expand.plan).
extern "C" int fm_patch_expand_ln(const void* y, int W, int total, int c4, const void* s1,
                                  const void* b1, const void* s2, const void* b2, int two,
                                  const void* wh, const void* bh, int ch, void* ln_out,
                                  void* head_out, int grid, void* stream) {
  if (total < 1 || W < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FM_CALL(C4, CH)                                                                       \
  if (c4 == C4 && ch == CH)                                                                   \
    return static_cast<int>(launch<C4, CH>(y, W, total, s1, b1, s2, b2, two, wh, bh, ln_out, \
                                           head_out, grid, st));
  FM_CALL(64, 0) FM_CALL(64, 64) FM_CALL(64, 256)
  FM_CALL(128, 0) FM_CALL(128, 64) FM_CALL(128, 256)
#undef FM_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's resident blocks an SM at (C4, CH) (for the grid).
extern "C" int fm_patch_expand_blocks_per_sm(int c4, int ch, int* n) {
#define FM_CALL(C4, CH) \
  if (c4 == C4 && ch == CH) return static_cast<int>(blocks_per_sm<C4, CH>(n));
  FM_CALL(64, 0) FM_CALL(64, 64) FM_CALL(64, 256)
  FM_CALL(128, 0) FM_CALL(128, 64) FM_CALL(128, 256)
#undef FM_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
