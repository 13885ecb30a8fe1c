// K11: window multi-head attention over 8x8 windows,
//   out[b, :, head] = softmax(q_h k_h^T * scale + rel_bias[h] + mask[b % nW]) v_h
// with qkv [B_, 64, 3C] in the qkv Dense's layout ([q | k | v] blocks, heads
// d-contiguous within each) and out [B_, 64, C].
//
// Replaces featurematching_tpu/ops/pallas_window_attention.py ·
// window_attention_pallas (_wmsa_kernel / _wmsa_masked_kernel). Bound on the
// H100 by device-memory bytes: a window moves 8 * 64 * C bytes of q, k, v
// and out for 4 * 64 * 64 * C operations, 32 operations a byte, far under
// the tensor cores' 295. What else stands in the way: the relative-position
// bias (f32 [h, 64, 64]) and a shift mask window (f32 [64, 64]) are as
// large as a window's q, k and v at head dim 16, so reading them again for
// every window would double the bytes that pass through L2; the softmax's
// exponentials take the SFU about 0.4 of the bytes' time and its other
// arithmetic about as much of the issue slots, so both have to overlap the
// copies; and at C = 256 one block a window gives 160 blocks to 132 SMs.
// Design:
//   - A persistent grid (`ops/window_attention.plan`): a block owns one head
//     group (64 columns of each of q, k and v: 64 / D heads) and a run of
//     consecutive windows; the groups times the runs fill the card's SMs once
//     (C = 256 at head dim 16 gives 4 groups of 33 runs of 4 or 5 windows).
//   - A producer warp brings each window's three [64, 64] boxes (and, with a
//     mask, the window's [64, 64] mask as two f32 boxes) by tensor copies in
//     the 128-byte swizzle into a ring of 4-7 slots completed on mbarriers; a
//     slot is refilled as soon as the warps that read it hand it back, so
//     the next windows' copies are in flight while this one computes.
//   - 16 compute warps, each owning one (head, 16 query rows) unit for the
//     whole run: its 32 f32 of the bias stay in registers, read once. At
//     head dim D the block takes D / 16 windows at a time (one a window
//     lane of 64 / D heads x 4 row tiles).
//   - A unit runs as the Swin block body's does (attention_unit.cuh, whose
//     arithmetic this copies): Q.K^T on mma.sync from ldmatrix fragments of
//     the swizzled boxes, the scale, bias and mask added in registers (the
//     mask read from the slot, where one copy a window serves every head;
//     s * scale + bias one fused multiply-add where the scale is a power of
//     two, as at head dims 16 and 64, which rounds alike), the softmax
//     across the four lanes of a row with the exponentials as __expf runs
//     them (ex2.approx, here of one multiply-add that takes the row's
//     maximum off), P straight into the A fragments of P.V. The output goes
//     over the unit's own q columns in the slot and back to 16-byte stores
//     to device memory.
//   - 17 warps a block leave 96 registers a thread (one SM sub-partition
//     holds 5 of the warps); the unit fits them without spills.
//
// Rounding follows the TPU kernel: s = q.k in f32, then s * scale + bias in
// f32, then + mask, softmax in f32, p rounded to bf16, p.v summed in f32 and
// rounded to bf16.

#include <cmath>

#include "attention_unit.cuh"
#include "wgmma.cuh"

FM_ERROR_STRING_ENTRY

namespace {

using fm::bf16;

constexpr int N = fm::kWin;                // tokens of an 8x8 window
constexpr int kCols = 64;                  // a head group's columns of each of q, k and v
constexpr int kWarps = 16;                 // compute warps
constexpr int kThreads = 32 * kWarps + 32;  // and the producer warp
constexpr int kBox = N * kCols * 2;        // a [64, 64] bf16 box: 8 KB
constexpr int kMaskBox = N * 32 * 4;       // a [64, 32] f32 box of a mask window: 8 KB

template <int D, bool MASKED>
struct Layout {
  static constexpr int W = D / 16;          // windows a block takes at once (window lanes)
  static constexpr int UPW = kWarps / W;    // units (warps) a window: 64 / D heads x 4 row tiles
  static constexpr int SLOT = 3 * kBox + (MASKED ? 2 * kMaskBox : 0);
  static constexpr int FIT = 220 * 1024 / SLOT;
  static constexpr int NS = W + 3 < FIT ? W + 3 : FIT;  // ring slots
  static constexpr int BAR = NS * SLOT;     // full[2 NS], then empty[NS]
  static constexpr int BYTES = BAR + 3 * NS * 8 + 1024;  // + the 1024-byte alignment
  static_assert(NS > W, "a window lane needs a slot ahead");
};

// byte offset of 16-byte chunk c of row r in a box of 128-byte rows, as a
// tensor copy with the 128-byte swizzle lays it out
__device__ __forceinline__ uint32_t sw(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void ldsm4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds_u4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// 2^x on the SFU, the approximation __expf runs on
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// One (head hl of the group, query rows 16 tm ..) unit of the window in the
// slot at shared address `q` (its q, k and v boxes, then its mask boxes);
// bv: this lane's bias entries of the unit; dst: the unit's first output
// element in device memory (row stride C). FOLD: the scale is a power of
// two, so s * scale is exact and s * scale + bias one fused multiply-add.
template <int D, bool MASKED, bool FOLD>
__device__ __forceinline__ void unit(uint32_t q, const float (&bv)[N / 16][8], int hl, int tm,
                                     float scale, bf16* __restrict__ dst, int C, int lane) {
  const uint32_t k = q + kBox, v = q + 2 * kBox, mk = q + 3 * kBox;
  const int c0 = hl * D / 8;  // the head's first 16-byte chunk in a row
  const int m = lane >> 3, r8 = lane & 7;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldsm4(qa[kc], q + sw(16 * tm + (lane & 15), c0 + 2 * kc + (lane >> 4)));
  fm::Acc16 s[N / 16];
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    fm::zero(s[kt]);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t kb[4];  // B fragment of keys 16 kt .. from their rows
      ldsm4(kb, k + sw(16 * kt + r8 + 8 * (m >> 1), c0 + 2 * kc + (m & 1)));
      fm::mma16(s[kt], qa[kc], kb);
    }
  }
  // s[kt].c[j] is the score of row g + 8 ((j >> 1) & 1), key 16 kt + 8 (j >> 2) + 2 t + (j & 1)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      float v0 = FOLD ? __fmaf_rn(s[kt].c[2 * jp], scale, bv[kt][2 * jp])
                      : __fadd_rn(__fmul_rn(s[kt].c[2 * jp], scale), bv[kt][2 * jp]);
      float v1 = FOLD ? __fmaf_rn(s[kt].c[2 * jp + 1], scale, bv[kt][2 * jp + 1])
                      : __fadd_rn(__fmul_rn(s[kt].c[2 * jp + 1], scale), bv[kt][2 * jp + 1]);
      if (MASKED) {
        const int row = 16 * tm + fm::pair_row(jp, lane), col = fm::pair_col(kt, jp, lane);
        const float2 mv =
            lds_f2(mk + (col >> 5) * kMaskBox + sw(row, (col & 31) >> 2) + 4 * (col & 3));
        v0 += mv.x;
        v1 += mv.y;
      }
      s[kt].c[2 * jp] = v0;
      s[kt].c[2 * jp + 1] = v1;
      mx[jp & 1] = fmaxf(mx[jp & 1], fmaxf(v0, v1));
    }
  float z[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the four lanes of a row hold its 64 keys
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  // e = exp(v - max) = 2^(v log2 e - max log2 e)
  constexpr float kLog2e = 1.4426950408889634f;
  const float off[2] = {-mx[0] * kLog2e, -mx[1] * kLog2e};
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = (j >> 1) & 1;
      s[kt].c[j] = ex2(__fmaf_rn(s[kt].c[j], kLog2e, off[i]));
      z[i] += s[kt].c[j];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 1);
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 2);
  }
  // P.V: the probabilities of key tile kt are the A fragment of k-step kt
  const float rz[2] = {__frcp_rn(z[0]), __frcp_rn(z[1])};
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    const float* c = s[kt].c;
    pa[kt][0] = fm::pack_bf16(c[0] * rz[0], c[1] * rz[0]);
    pa[kt][1] = fm::pack_bf16(c[2] * rz[1], c[3] * rz[1]);
    pa[kt][2] = fm::pack_bf16(c[4] * rz[0], c[5] * rz[0]);
    pa[kt][3] = fm::pack_bf16(c[6] * rz[1], c[7] * rz[1]);
  }
  // a 16-column strip of the output at a time, over the unit's own q columns
  // (only this warp reads them)
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    fm::Acc16 o;
    fm::zero(o);
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt) {
      uint32_t vb[4];  // B fragment of v's rows 16 kt .., columns 16 nt ..
      ldsm4_t(vb, v + sw(16 * kt + r8 + 8 * (m & 1), c0 + 2 * nt + (m >> 1)));
      fm::mma16(o, pa[kt], vb);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
      sts_u32(q + sw(16 * tm + fm::pair_row(jp, lane), c0 + 2 * nt + (jp >> 1)) + 4 * (lane & 3),
              fm::pack_bf16(o.c[2 * jp], o.c[2 * jp + 1]));
  }
  __syncwarp();
  // the unit's [16, D] output in 16-byte pieces: D / 8 a row
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const int p = lane + 32 * i, row = p / (D / 8), cc = p % (D / 8);
    *reinterpret_cast<uint4*>(dst + (size_t)row * C + 8 * cc) =
        lds_u4(q + sw(16 * tm + row, c0 + cc));
  }
}

template <int D, bool MASKED, bool FOLD>
__global__ void __launch_bounds__(kThreads, 1)
window_attention_kernel(const __grid_constant__ CUtensorMap qkv_map,
                        const __grid_constant__ CUtensorMap mask_map,
                        const float* __restrict__ bias, bf16* __restrict__ out, int windows, int C,
                        int heads, int runs, int nW, float scale) {
  using L = Layout<D, MASKED>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (fm::smem_u32(smem_raw) & 1023)) & 1023);
  // a slot's even fills complete on full[2 s], its odd ones on full[2 s + 1]:
  // with D / 16 window lanes, a lane may come to wait for a slot's next
  // fill while the copies of its last fill, another lane's window, are still
  // in flight, one phase behind, where one barrier's parity would take the
  // one for the other. The window two fills back has been handed back (its
  // slot was refilled since), so each barrier is waited on in its own phase.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + 2 * L::NS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the block's head group and run of windows [w0, w0 + n)
  const int grp = blockIdx.x / runs, run = blockIdx.x % runs;
  const int w0 = (int)((long long)run * windows / runs);
  const int n = (int)((long long)(run + 1) * windows / runs) - w0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::NS; ++s) {
      fm::mbar_init(&full[2 * s], 1);
      fm::mbar_init(&full[2 * s + 1], 1);
      fm::mbar_init(&empty[s], 32 * L::UPW);
    }
    fm::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer: the run's windows into the ring, in order
    if (lane == 0) {
      for (int j = 0; j < n; ++j) {
        const int s = j % L::NS;
        if (j >= L::NS) fm::mbar_wait(&empty[s], (j / L::NS - 1) & 1);
        unsigned char* slot = smem + s * L::SLOT;
        uint64_t* bar = &full[2 * s + (j / L::NS) % 2];
        const int row = (w0 + j) * N;
        fm::mbar_arrive_expect(bar, L::SLOT);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          fm::tma_load_2d(slot + p * kBox, &qkv_map, p * C + grp * kCols, row, bar);
        if (MASKED) {
          const int mrow = ((w0 + j) % nW) * N;
          fm::tma_load_2d(slot + 3 * kBox, &mask_map, 0, mrow, bar);
          fm::tma_load_2d(slot + 3 * kBox + kMaskBox, &mask_map, 32, mrow, bar);
        }
      }
    }
    return;
  }

  const int wl = warp / L::UPW, u = warp % L::UPW;  // window lane; unit of a window
  const int hl = u / 4, tm = u % 4;
  const int hd = grp * (kCols / D) + hl;
  const bool live = hd < heads;  // the last group of an odd head count may have fewer heads
  float bv[N / 16][8];  // this lane's entries of the unit's bias rows, for the whole run
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      float2 b = make_float2(0.f, 0.f);
      if (live)
        b = *reinterpret_cast<const float2*>(bias + ((size_t)hd * N + 16 * tm +
                                                     fm::pair_row(jp, lane)) * N +
                                             fm::pair_col(kt, jp, lane));
      bv[kt][2 * jp] = b.x;
      bv[kt][2 * jp + 1] = b.y;
    }
  const uint32_t ring = fm::smem_u32(smem);
#pragma unroll 1
  for (int j = wl; j < n; j += L::W) {
    const int s = j % L::NS;
    fm::mbar_wait(&full[2 * s + (j / L::NS) % 2], (j / (2 * L::NS)) & 1);
    if (live) {
      unit<D, MASKED, FOLD>(ring + s * L::SLOT, bv, hl, tm, scale,
                            out + ((size_t)(w0 + j) * N + 16 * tm) * C + hd * D, C, lane);
      fm::fence_proxy_async();  // the output's writes to the slot before its refill
    }
    fm::mbar_arrive(&empty[s]);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the 2-D tensor map of [rows, cols] elements of `type` (`bytes` each) at
// `base` in boxes of [64 rows, box_cols]
cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, int bytes,
                          const void* base, cuuint64_t rows, cuuint64_t cols,
                          cuuint32_t box_cols) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * bytes};
  const cuuint32_t box[2] = {box_cols, N};
  return fm::tensor_map(map, type, base, 2, dims, strides, box);
}

template <int D, bool MASKED>
cudaError_t launch_as(const void* qkv, const void* bias, const void* mask, int nW, void* out,
                      int windows, int C, int heads, int runs, float scale, cudaStream_t st) {
  using L = Layout<D, MASKED>;
  int e2;
  const bool fold = scale > 0.f && std::frexp(scale, &e2) == 0.5f;  // a power of two
  auto kernel = fold ? window_attention_kernel<D, MASKED, true>
                     : window_attention_kernel<D, MASKED, false>;
  cudaError_t e = set_smem(kernel, L::BYTES);
  if (e != cudaSuccess) return e;
  // qkv as [windows * 64, 3C] in [64, 64] boxes; the mask as [nW * 64, 64] f32 in [64, 32] boxes
  CUtensorMap qmap, mmap;
  e = tensor_map_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qkv, (cuuint64_t)windows * N,
                    3 * C, kCols);
  if (e != cudaSuccess) return e;
  mmap = qmap;
  if (MASKED) {
    e = tensor_map_2d(&mmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, mask, (cuuint64_t)nW * N, N, 32);
    if (e != cudaSuccess) return e;
  }
  const int groups = (C + kCols - 1) / kCols;
  kernel<<<groups * runs, kThreads, L::BYTES, st>>>(
      qmap, mmap, static_cast<const float*>(bias), static_cast<bf16*>(out), windows, C, heads,
      runs, nW, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* qkv, const void* bias, const void* mask, int nW, void* out,
                   int windows, int C, int heads, int runs, float scale, cudaStream_t st) {
  return nW > 0 ? launch_as<D, true>(qkv, bias, mask, nW, out, windows, C, heads, runs, scale, st)
                : launch_as<D, false>(qkv, bias, mask, nW, out, windows, C, heads, runs, scale, st);
}

template <int D, bool MASKED>
cudaError_t occupancy_as(int* info) {
  using L = Layout<D, MASKED>;
  cudaError_t e = set_smem(window_attention_kernel<D, MASKED, false>, L::BYTES);
  if (e != cudaSuccess) return e;
  info[0] = L::BYTES;
  info[1] = L::NS;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[2], window_attention_kernel<D, MASKED, false>, kThreads, L::BYTES);
}

}  // namespace

// qkv: [windows, 64, 3C] bf16; bias: [C / D, 64, 64] f32; mask: [nW, 64, 64]
// f32 additive, window b uses mask[b % nW] (nW = 0: no mask); out: [windows,
// 64, C] bf16. Head dim D in (16, 32, 64), C a multiple of D up to 256.
// runs: runs of windows a head group (1 .. windows; ops/window_attention.plan),
// the grid ceil(C / 64) x runs blocks.
extern "C" int fm_window_attention(const void* qkv, const void* bias, const void* mask, int nW,
                                   void* out, int windows, int C, int heads, int runs,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || C % heads || C > 256 || windows <= 0 || runs <= 0 || runs > windows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t (*fn)(const void*, const void*, const void*, int, void*, int, int, int, int, float,
                    cudaStream_t);
  switch (C / heads) {
    case 16: fn = launch<16>; break;
    case 32: fn = launch<32>; break;
    case 64: fn = launch<64>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(fn(qkv, bias, mask, nW, out, windows, C, heads, runs, scale, st));
}

// info: {dynamic shared memory bytes, ring slots, blocks an SM} of the kernel
// at head dim D, with (masked != 0) or without a mask
extern "C" int fm_window_attention_occupancy(int D, int masked, int* info) {
  switch (D * 2 + (masked != 0)) {
    case 32: return static_cast<int>(occupancy_as<16, false>(info));
    case 33: return static_cast<int>(occupancy_as<16, true>(info));
    case 64: return static_cast<int>(occupancy_as<32, false>(info));
    case 65: return static_cast<int>(occupancy_as<32, true>(info));
    case 128: return static_cast<int>(occupancy_as<64, false>(info));
    case 129: return static_cast<int>(occupancy_as<64, true>(info));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
