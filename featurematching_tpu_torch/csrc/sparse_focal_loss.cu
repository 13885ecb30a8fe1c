// K7: the softmax terms of the sparse focal loss's backward,
//   dsim = -(a_r[i] exp(sim - lse_r[i]) + a_c[j] exp(sim - lse_c[j]))
//   df0 = inv_temp * dsim f1,   df1 = dsimᵀ f0s,   sim = f0s f1ᵀ
// without storing the [L, S] sim.
//
// Replaces featurematching_tpu/ops/sparse_focal_loss.py · _sfl_bwd_pallas
// (_sfl_bwd_kernel). Bound on the H100 by tensor-core operations: three
// products of 2 L S C a pair (141.6 GFLOP at [4, 4800, 256], 0.143 ms)
// against 59 MB of features in and gradients out. The TPU kernel walks row
// tiles in order and adds each tile's df1 contribution into one output
// block. On the H100 row tiles run in parallel, so df1 gets its own pass
// that recomputes simᵀ (a fourth product: 0.191 ms of operations) instead
// of per-tile [S, C] partials or float atomics; the result is
// deterministic.
//
// Design. Both passes are one persistent launch. A work unit is 128 rows
// of one side (the owned rows: f0s for df0, f1 for df1 with a / lse
// swapped) against all 64-row tiles of the other side, one tile a step.
// The units' steps, pass 0's then pass 1's, are cut into `gridDim.x` equal
// ranges, one a block (ops/sparse_focal_loss.plan mirrors this), so every
// SM gets the same number of steps whatever the wave arithmetic of 128-row
// units would give. A unit cut between blocks k < k' is finished by block
// k, the owner of its first step, which meets that piece last: blocks k'
// take theirs first, write its [128, C] f32 partial in fragment order and
// raise a flag; the owner adds the partials in block order. The grid never
// exceeds the blocks the card holds at once, so the waits end.
//
// A block is two warpgroups, 64 owned rows each, and nothing else: a
// producer warp would cap the block at 168 registers (ptxas rounds 288
// threads up to three warpgroups), and the C = 256 accumulator needs more.
// Tensor copies ([64, 64] boxes of a 3-D map over [B, n, C], 128-byte
// swizzle; rows past n read as zeros) bring each warpgroup's own rows, and
// every tile of the other side into a ring of NS slots on mbarriers, with a
// bulk copy of the tile's column values (-a, -lse log2 e, made with f0s by
// prep_kernel) beside it. Both warpgroups read every slot, so a tile leaves
// L2 once for 128 rows; the last of the eight warps to hand a slot back
// refills it, predicated rather than branched. For a tile a warpgroup runs
//   1. sim = own . tileᵀ on wgmma m64n64k16 from shared memory (both
//      operands K-major), 32 f32 registers a thread;
//   2. dsim on those registers: two ex2 a value (log2 e folded in),
//      rounded to bf16 as the TPU kernel does and packed in place as the A
//      fragments of the next product; columns past n set to exactly 0;
//   3. out += dsim . tile on register-A wgmma m64nCk16, each k-step issued
//      as soon as its fragments are packed, the same slot read as an
//      MN-major B (sw128_mn_desc); out is [64, C] f32 in registers over the
//      whole piece (C / 2 a thread).
// The warpgroups take turns at issuing step 1 (named barriers), so one's
// exponentials run beside the other's products. The warpgroup index comes
// from a shuffle: ptxas then takes the own rows' descriptors as uniform and
// keeps the products asynchronous (from threadIdx it serialized them).
// No block barrier in the loop, no shared f32 tile, no atomics on floats.

#include <algorithm>

#include "wgmma.cuh"

namespace {

using fm::bf16;

constexpr int TR = 64;                // rows a warpgroup owns; other-side rows a step
constexpr int kWG = 2;                // warpgroups a block
constexpr int UR = kWG * TR;          // owned rows a unit
constexpr int NS = 4;                 // other-side tiles in flight a block
constexpr int kThreads = 128 * kWG;
constexpr float kLog2e = 1.4426950408889634f;

template <int C>
struct Layout {
  static constexpr int BOX = TR * 128;       // bytes of a [64 rows, 64 columns] box
  static constexpr int TILE = C / 64 * BOX;  // bytes of a [64, C] tile
  static constexpr int VALS = TR * 8;        // bytes of a tile's column values
  static constexpr size_t own_off = 0;       // kWG tiles: each warpgroup's rows
  static constexpr size_t slot_off = own_off + (size_t)kWG * TILE;
  static constexpr size_t val_off = slot_off + (size_t)NS * TILE;  // NS x [64] float2
  static constexpr size_t bar_off = val_off + (size_t)NS * VALS;   // full[NS], own[kWG], count[NS]
  // + 1024: the swizzle atoms need 1024-byte aligned addresses
  static constexpr size_t bytes = bar_off + 8 * (NS + kWG) + 4 * NS + 1024;
  static_assert(bytes <= 232448, "shared memory of a block");
};

struct Args {
  const float2* v0;  // [B, Lp]: (-a_r, -lse_r log2 e), zero from L to Lp
  const float2* v1;  // [B, Sp]: (-a_c, -lse_c log2 e), zero from S to Sp
  float* df0;
  float* df1;
  float* part;  // [gridDim.x][kWG][C / 2][128] f32: the partial of a block's first piece
  int* flag;    // [gridDim.x][kWG], zeroed by prep_kernel: that partial is written
  float inv_temp;
  int B, L, S, Lp, Sp;
};

// The steps of both passes: pass p's units are (image b, row block rb) of
// R_p row blocks, each of T_p steps, in that order.
struct Dims {
  int R0, T0, R1, T1, P0, total;
};

__device__ __forceinline__ Dims dims(const Args& a) {
  Dims d;
  d.R0 = (a.L + UR - 1) / UR;
  d.T0 = (a.S + TR - 1) / TR;
  d.R1 = (a.S + UR - 1) / UR;
  d.T1 = (a.L + TR - 1) / TR;
  d.P0 = a.B * d.R0 * d.T0;
  d.total = d.P0 + a.B * d.R1 * d.T1;
  return d;
}

// the first step of block k's range: total / grid steps a block, one more
// for the first total % grid blocks
__device__ __forceinline__ int range_start(int k, const Dims& d) {
  const int q = d.total / (int)gridDim.x, r = d.total - q * (int)gridDim.x;
  return k * q + min(k, r);
}

struct Step {
  int pass, b, rb, jt, steps, first;  // unit (pass, b, rb); tile jt of its `steps`; its first step
};

__device__ __forceinline__ Step decode(int x, const Dims& d) {
  Step s;
  s.pass = x >= d.P0;
  const int y = s.pass ? x - d.P0 : x, T = s.pass ? d.T1 : d.T0, R = s.pass ? d.R1 : d.R0;
  const int u = y / T;
  s.jt = y - u * T;
  s.b = u / R;
  s.rb = u - s.b * R;
  s.steps = T;
  s.first = x - s.jt;
  return s;
}

// the step after s (no division: a step's cursor moves on by one each loop)
__device__ __forceinline__ void advance(Step& s, const Dims& d, int B) {
  if (++s.jt < s.steps) return;
  s.jt = 0;
  s.first += s.steps;
  if (++s.rb < (s.pass ? d.R1 : d.R0)) return;
  s.rb = 0;
  if (++s.b < B) return;
  s.b = 0;
  s.pass = 1;
  s.steps = d.T1;
}

// bar.arrive where p is not 0: lets the barrier's waiters on, without waiting
__device__ __forceinline__ void bar_arrive_if(uint32_t p, int id, int threads) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n@q bar.arrive %1, %2;\n}\n" ::"r"(p), "r"(id),
      "r"(threads)
      : "memory");
}

// 2^x on the MUFU alone (ex2.approx.ftz: about 2^-22 relative; results
// below 2^-126 flush to 0, far below dsim's bf16 rounding)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Predicated forms (no branch, so ptxas keeps the products asynchronous):
// each acts only where `p` is not 0.
__device__ __forceinline__ void expect_if(uint32_t p, uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n"
      "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n}\n" ::"r"(p),
      "r"(fm::smem_u32(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_3d_if(uint32_t p, void* dst, const CUtensorMap* map, int c0,
                                          int c1, int c2, uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n"
      "@q cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%1], [%2, {%3, %4, %5}], [%6];\n}\n" ::"r"(p),
      "r"(fm::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(fm::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_if(uint32_t p, void* dst, const void* src, uint32_t bytes,
                                        uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n"
      "@q cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%1], [%2], %3, [%4];\n"
      "}\n" ::"r"(p),
      "r"(fm::smem_u32(dst)), "l"(src), "r"(bytes), "r"(fm::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void store2_if(uint32_t p, float* dst, float x, float y) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n@q st.global.v2.f32 [%1], {%2, %3};\n}\n" ::"r"(p),
      "l"(dst), "f"(x), "f"(y)
      : "memory");
}

// raise (release) or wait for (acquire, every thread) a partial's flag
__device__ __forceinline__ void raise_flag_if(uint32_t p, int* flag) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n@q st.release.gpu.global.u32 [%1], %2;\n}\n" ::"r"(
          p),
      "l"(flag), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wait_flag(const int* flag) {
  asm volatile(
      "{\n.reg .pred q;\n.reg .u32 v;\nWAITF:\n"
      "ld.acquire.gpu.global.u32 v, [%0];\n"
      "setp.eq.u32 q, v, 0;\n@q bra WAITF;\n}\n" ::"l"(flag)
      : "memory");
}

// One warp's hand-back of a ring slot (every lane calls it): where `go`,
// lane 0 counts it in the slot's counter; the eighth hand-back resets the
// counter and, where `refill`, starts the copies of the tile of `st`:
// C / 64 boxes of its rows and its 512 bytes of column values.
template <int C>
__device__ __forceinline__ void handback(uint32_t go, int* count, bool refill, unsigned char* slot,
                                         void* vals, uint64_t* full, const CUtensorMap* map,
                                         const float2* src, const Step& st, int npad) {
  uint32_t last;
  asm volatile(
      "{\n.reg .pred p0, p1;\n.reg .u32 old;\nmov.u32 old, 0;\n"
      "setp.ne.u32 p0, %1, 0;\n"
      "@p0 fence.acq_rel.cta;\n"
      "@p0 atom.shared.add.u32 old, [%2], 1;\n"
      "setp.eq.and.u32 p1, old, %3, p0;\n"
      "@p1 st.shared.u32 [%2], 0;\n"
      "@p1 fence.acq_rel.cta;\n"
      "@p1 fence.proxy.async.shared::cta;\n"
      "selp.u32 %0, 1, 0, p1;\n}\n"
      : "=r"(last)
      : "r"(go), "r"(fm::smem_u32(count)), "r"(4 * kWG - 1)
      : "memory");
  const uint32_t p = last & (uint32_t)refill;
  expect_if(p, full, Layout<C>::TILE + Layout<C>::VALS);
#pragma unroll
  for (int f = 0; f < C / 64; ++f)
    tma_3d_if(p, slot + f * Layout<C>::BOX, map, 64 * f, st.jt * TR, st.b, full);
  bulk_if(p, vals, src + (size_t)st.b * npad + st.jt * TR, Layout<C>::VALS, full);
}

template <int C>
__device__ __forceinline__ void product2(float (&acc)[C / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (C == 256)
    fm::wgmma_rs_n256<1>(acc, a, b, scale_d);
  else if constexpr (C == 128)
    fm::wgmma_rs_n128<1>(acc, a, b, scale_d);
  else
    fm::wgmma_rs_n64<1>(acc, a, b, scale_d);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
sfl_bwd_kernel(const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
               const Args a) {
  using Ly = Layout<C>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (fm::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Ly::bar_off);
  uint64_t* own_full = full + NS;
  int* count = reinterpret_cast<int*>(own_full + kWG);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warpgroup by a shuffle, which ptxas takes as uniform: its own rows'
  // descriptors are then too, and the products stay asynchronous
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int w = warp % 4, g = lane / 4, t = lane % 4, wt = threadIdx.x % 128;
  const Dims d = dims(a);
  const int s0 = range_start(blockIdx.x, d), s1 = range_start(blockIdx.x + 1, d);
  // pass p's own side: map and values; the other side's are pass 1 - p's
  auto map_of = [&](int pass) { return pass ? &map1 : &map0; };
  auto vals_of = [&](int pass) { return pass ? a.v1 : a.v0; };
  auto npad_of = [&](int pass) { return pass ? a.Sp : a.Lp; };
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      fm::mbar_init(&full[i], 1);
      count[i] = 0;
    }
    for (int i = 0; i < kWG; ++i) fm::mbar_init(&own_full[i], 1);
    fm::mbar_init_fence();
    const Step st = decode(s0, d);
    for (int i = 0; i < kWG; ++i) {
      fm::mbar_arrive_expect(&own_full[i], Ly::TILE);
      for (int f = 0; f < C / 64; ++f)
        fm::tma_load_3d(smem + Ly::own_off + i * Ly::TILE + f * Ly::BOX, map_of(st.pass), 64 * f,
                        st.rb * UR + i * TR, st.b, &own_full[i]);
    }
    for (int x = s0; x < min(s1, s0 + NS); ++x) {
      const Step sx = decode(x, d);
      const int s = x - s0;
      fm::mbar_arrive_expect(&full[s], Ly::TILE + Ly::VALS);
      for (int f = 0; f < C / 64; ++f)
        fm::tma_load_3d(smem + Ly::slot_off + s * Ly::TILE + f * Ly::BOX, map_of(1 - sx.pass),
                        64 * f, sx.jt * TR, sx.b, &full[s]);
      fm::bulk_load(smem + Ly::val_off + s * Ly::VALS,
                    vals_of(1 - sx.pass) + (size_t)sx.b * npad_of(1 - sx.pass) + sx.jt * TR,
                    Ly::VALS, &full[s]);
    }
  }
  __syncthreads();

  const uint32_t own = fm::smem_u32(smem + Ly::own_off + wg * Ly::TILE);
  float acc[C / 2];
  float nar[2], nlr[2];  // -a and -lse log2 e of this thread's two own rows
  uint32_t af[4][4];     // dsim of a tile: the A fragments of its four k-steps
  int piece = 0;
  uint32_t pending = 0;  // the last step's second product holds its slot
  // the cursors: this step, and the step a slot handed back now is refilled with
  Step st = decode(s0, d), rf = decode(min(s0 + NS - 1, d.total - 1), d);
  // the warpgroups take turns at issuing their first product (named barriers
  // 3 + wg), so one's exponentials run beside the other's products
  bar_arrive_if((uint32_t)(wg == 1), 3, 2 * 128);
#pragma unroll 1
  for (int x = s0; x < s1; ++x, advance(st, d, a.B), advance(rf, d, a.B)) {
    const int n_own = st.pass ? a.S : a.L, n_oth = st.pass ? a.L : a.S;
    const int row0 = st.rb * UR + wg * TR;  // this warpgroup's first own row
    const bool begins = x == s0 || st.jt == 0;
    const bool ends = x == s1 - 1 || st.jt == st.steps - 1;
    const int it = x - s0, s = it % NS;
    const uint32_t slot = fm::smem_u32(smem + Ly::slot_off + s * Ly::TILE);
    if (begins) {  // a piece begins: its rows' values (rows past n: zeros or unused)
      const float2* vo = vals_of(st.pass) + (size_t)st.b * npad_of(st.pass);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 v = vo[min(row0 + 16 * w + g + 8 * i, npad_of(st.pass) - 1)];
        nar[i] = v.x;
        nlr[i] = v.y;
      }
      fm::mbar_wait(&own_full[wg], piece & 1);
    }
    fm::mbar_wait(&full[s], (it / NS) & 1);
    float sim[32];
    fm::named_barrier(3 + wg, 2 * 128);  // this warpgroup's turn
    fm::wgmma_fence();
#pragma unroll
    for (int k = 0; k < C / 16; ++k)  // k-step k: box k / 4, 32 bytes a k-step into its rows
      fm::wgmma_ss_n64(sim, fm::sw128_desc(own + (k / 4) * Ly::BOX + (k % 4) * 32),
                       fm::sw128_desc(slot + (k / 4) * Ly::BOX + (k % 4) * 32), k > 0);
    fm::wgmma_commit();
    // the other's turn (warpgroup 1 gives none after its last step: every
    // arrival meets a wait)
    bar_arrive_if((uint32_t)(wg == 0 || x + 1 < s1), 4 - wg, 2 * 128);
    fm::wgmma_wait<0>();  // this product and the last step's second one
    fm::fence_regs(sim);
    fm::fence_regs(acc);
    fm::fence_frags(af);
    {  // the last step's slot is free: hand it back
      const int xr = x - 1 + NS, sp = (it + NS - 1) % NS;
      handback<C>(pending & (uint32_t)(lane == 0), &count[sp], xr < s1,
                  smem + Ly::slot_off + sp * Ly::TILE, smem + Ly::val_off + sp * Ly::VALS,
                  &full[sp], map_of(1 - rf.pass), vals_of(1 - rf.pass), rf, npad_of(1 - rf.pass));
    }
    if (ends) {  // the own rows are read: the next piece's by this warpgroup's first thread
      fm::named_barrier(1 + wg, 128);
      Step sn = st;
      advance(sn, d, a.B);
      const uint32_t p = (uint32_t)(wt == 0 && x + 1 < s1);
      expect_if(p, &own_full[wg], Ly::TILE);
#pragma unroll
      for (int f = 0; f < C / 64; ++f)
        tma_3d_if(p, smem + Ly::own_off + wg * Ly::TILE + f * Ly::BOX, map_of(sn.pass), 64 * f,
                  sn.rb * UR + wg * TR, sn.b, &own_full[wg]);
    }
    // dsim for rows 16 w + g (+ 8) and columns 8 j + 2 t (+ 1): the m16n8k16
    // A fragments of k-step j / 2 (wgmma.cuh's accumulator layout). Each
    // k-step's product is issued as soon as its fragments are packed, so
    // the next k-step's exponentials overlap it.
    const float4* cv = reinterpret_cast<const float4*>(smem + Ly::val_off + s * Ly::VALS);
    const int vc = n_oth - st.jt * TR;  // valid columns of the tile: dsim 0 past them
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        const float4 c = cv[4 * j + t];  // (-a, -lse log2 e) of columns 8 j + 2 t, + 1
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sv = sim[4 * j + 2 * i + e];
            const float er = fast_exp2(fmaf(sv, kLog2e, nlr[i]));
            const float ec = fast_exp2(fmaf(sv, kLog2e, e ? c.w : c.y));
            v[e] = fmaf(e ? c.z : c.x, ec, nar[i] * er);
          }
          af[kk][2 * jj + i] = fm::pack_bf16(v[0], v[1]);
        }
      }
      if (vc < TR) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 16 * kk + 8 * (q >> 1) + 2 * t;
          af[kk][q] &= (c < vc ? 0xFFFFu : 0u) | (c + 1 < vc ? 0xFFFF0000u : 0u);
        }
      }
      // k-step kk: tile rows 16 kk.., two atoms; a piece's first zeroes out
      fm::wgmma_fence();
      product2<C>(acc, af[kk], fm::sw128_mn_desc(slot + kk * 2048, Ly::BOX), kk > 0 || !begins);
    }
    fm::wgmma_commit();
    pending = 1;
    if (!ends) continue;

    // the piece ends: drain, hand the slot back, then its output
    fm::wgmma_wait<0>();
    fm::fence_regs(acc);
    fm::fence_frags(af);
    {
      const int xr = x + NS;
      Step sr = rf;
      advance(sr, d, a.B);
      handback<C>((uint32_t)(lane == 0), &count[s], xr < s1, smem + Ly::slot_off + s * Ly::TILE,
                  smem + Ly::val_off + s * Ly::VALS, &full[s], map_of(1 - sr.pass),
                  vals_of(1 - sr.pass), sr, npad_of(1 - sr.pass));
    }
    pending = 0;
    ++piece;
    if (st.first < s0) {  // a later piece of a unit another block owns: the partial
      float* p = a.part + (size_t)(blockIdx.x * kWG + wg) * (C / 2) * 128 + wt;
#pragma unroll
      for (int r = 0; r < C / 2; ++r) p[r * 128] = acc[r];
      __threadfence();
      fm::named_barrier(1 + wg, 128);
      raise_flag_if((uint32_t)(wt == 0), a.flag + blockIdx.x * kWG + wg);
      continue;
    }
    // the owner: the later pieces' partials, in block order
#pragma unroll 1
    for (int k = blockIdx.x + 1; k < (int)gridDim.x && range_start(k, d) < st.first + st.steps;
         ++k) {
      wait_flag(a.flag + k * kWG + wg);
      const float* p = a.part + (size_t)(k * kWG + wg) * (C / 2) * 128 + wt;
#pragma unroll
      for (int r = 0; r < C / 2; ++r) acc[r] += __ldcg(p + r * 128);
    }
    float* out = st.pass ? a.df1 : a.df0;
    const float scale = st.pass ? 1.f : a.inv_temp;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 16 * w + g + 8 * i;
      float* o = out + ((size_t)st.b * n_own + min(r, n_own - 1)) * C + 2 * t;
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
        store2_if((uint32_t)(r < n_own), o + 8 * j, acc[4 * j + 2 * i] * scale,
                  acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// f0s = f0 * inv_temp rounded to bf16 (8 values a thread), the two sides'
// (-a, -lse log2 e) padded with zeros to whole 64-row tiles, and the flags
// zeroed, in one grid-stride loop
__global__ void prep_kernel(const bf16* __restrict__ f0, bf16* __restrict__ f0s, size_t n8,
                            float inv_temp, const float* __restrict__ a_r,
                            const float* __restrict__ lse_r, const float* __restrict__ a_c,
                            const float* __restrict__ lse_c, float2* v0, float2* v1, int B,
                            int L, int S, int Lp, int Sp, int* flag, int nflag) {
  const size_t n0 = (size_t)B * Lp, n1 = (size_t)B * Sp;
  const size_t n = n8 + n0 + n1 + nflag;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    if (e < n8) {
      float v[8];
      fm::unpack8(reinterpret_cast<const uint4*>(f0)[e], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= inv_temp;
      reinterpret_cast<uint4*>(f0s)[e] = fm::pack8(v);
    } else if (e < n8 + n0 + n1) {
      const bool one = e >= n8 + n0;
      const size_t q = e - n8 - (one ? n0 : 0);
      const int np = one ? Sp : Lp, nv = one ? S : L;
      const int b = (int)(q / np), j = (int)(q % np);
      const float* av = one ? a_c : a_r;
      const float* lv = one ? lse_c : lse_r;
      float2 r = make_float2(0.f, 0.f);
      if (j < nv) r = make_float2(-av[(size_t)b * nv + j], -lv[(size_t)b * nv + j] * kLog2e);
      (one ? v1 : v0)[q] = r;
    } else {
      flag[e - n8 - n0 - n1] = 0;
    }
  }
}

// the tensor map of features [B, n, C] bf16 in boxes of [64 rows, 64 columns]
// of one image, rows past n read as zeros
cudaError_t feature_map(CUtensorMap* map, const void* f, int B, int n, int C) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)n, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)n * C * 2};
  const cuuint32_t box[3] = {64, TR, 1};
  return fm::bf16_tensor_map(map, f, 3, dims, strides, box);
}

template <int C>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(sfl_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Layout<C>::bytes);
}

template <int C>
cudaError_t launch(const void* f0s, const void* f1, const Args& a, int grid, cudaStream_t st) {
  cudaError_t e = set_smem<C>();
  if (e != cudaSuccess) return e;
  CUtensorMap m0, m1;
  e = feature_map(&m0, f0s, a.B, a.L, C);
  if (e != cudaSuccess) return e;
  e = feature_map(&m1, f1, a.B, a.S, C);
  if (e != cudaSuccess) return e;
  sfl_bwd_kernel<C><<<grid, kThreads, Layout<C>::bytes, st>>>(m0, m1, a);
  return cudaGetLastError();
}

template <int C>
cudaError_t blocks_per_sm(int* n) {
  const cudaError_t e = set_smem<C>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, sfl_bwd_kernel<C>, kThreads,
                                                       Layout<C>::bytes);
}

}  // namespace

FM_ERROR_STRING_ENTRY

// f0: [B, L, C] bf16 (unscaled); f1: [B, S, C] bf16; a_r, lse_r: [B, L] f32;
// a_c, lse_c: [B, S] f32 (all 16-byte aligned). df0: [B, L, C] f32 (d/d f0,
// inv_temp applied); df1: [B, S, C] f32. grid from ops/sparse_focal_loss.plan
// (at most the blocks the card holds at once). Scratch: f0s [B, L, C] bf16,
// v0 [B, Lp, 2] and v1 [B, Sp, 2] f32 (Lp, Sp: L, S rounded up to 64), part
// [grid, 128, C] f32, flag [grid, 2] int32.
extern "C" int fm_sparse_focal_backward(const void* f0, const void* f1, const void* a_r,
                                        const void* lse_r, const void* a_c, const void* lse_c,
                                        float inv_temp, int B, int L, int S, int C, int grid,
                                        void* f0s, void* v0, void* v1, void* part, void* flag,
                                        void* df0, void* df1, void* stream) {
  if (C != 64 && C != 128 && C != 256) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.v0 = static_cast<const float2*>(v0);
  a.v1 = static_cast<const float2*>(v1);
  a.df0 = static_cast<float*>(df0);
  a.df1 = static_cast<float*>(df1);
  a.part = static_cast<float*>(part);
  a.flag = static_cast<int*>(flag);
  a.inv_temp = inv_temp;
  a.B = B;
  a.L = L;
  a.S = S;
  a.Lp = (L + TR - 1) / TR * TR;
  a.Sp = (S + TR - 1) / TR * TR;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n8 = (size_t)B * L * C / 8;
  const size_t items = n8 + (size_t)B * (a.Lp + a.Sp) + 2 * (size_t)grid;
  const int blocks = (int)std::min<size_t>((items + 255) / 256, 1056);
  prep_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const bf16*>(f0), static_cast<bf16*>(f0s), n8, inv_temp,
      static_cast<const float*>(a_r), static_cast<const float*>(lse_r),
      static_cast<const float*>(a_c), static_cast<const float*>(lse_c), static_cast<float2*>(v0),
      static_cast<float2*>(v1), B, L, S, a.Lp, a.Sp, a.flag, 2 * grid);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (C) {
    case 64: e = launch<64>(f0s, f1, a, grid, st); break;
    case 128: e = launch<128>(f0s, f1, a, grid, st); break;
    default: e = launch<256>(f0s, f1, a, grid, st); break;
  }
  return static_cast<int>(e);
}

// the blocks an SM holds at once at width C (shared memory and registers)
extern "C" int fm_sparse_focal_blocks_per_sm(int C, int* n) {
  switch (C) {
    case 64: return static_cast<int>(blocks_per_sm<64>(n));
    case 128: return static_cast<int>(blocks_per_sm<128>(n));
    case 256: return static_cast<int>(blocks_per_sm<256>(n));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
