// Dual-softmax mutual-NN statistics: row and column max/argmax of
//   conf = softmax_rows(sim) * softmax_cols(sim),  sim = (f0 * inv_temp) f1^T
// without storing the [L, S] matrix.
//
// Replaces featurematching_tpu/ops/pallas_dual_softmax.py ·
// dual_softmax_match_stats (_pass1_stats/_stats_kernel and
// _pass2_conf/_conf_kernel); fm_dual_softmax_lse runs pass 1 and its
// combine alone, as featurematching_tpu/ops/sparse_focal_loss.py ·
// _lses_pallas runs _pass1_stats. Bound on the H100: tensor-core operations (two
// passes of 2*L*S*C, against (L + S)*C bf16 inputs).
//
// Design. A block's work unit is 128 rows of f0 (8 warps of 16 rows) against
// one chunk of f1's 64-column tiles; the grid is (row tiles x chunks, B), the
// chunk count chosen on the host (plan) so that the units fill the SMs
// evenly. A warp's 16 rows, scaled by inv_temp and rounded to bf16 as the TPU
// kernel does before its product, stay in registers as mma A fragments; f1's
// tiles stream through a cp.async ring of kStages slots with one barrier a
// tile, and each warp reads its B fragments from a slot by ldmatrix
// (attention_unit.cuh's load_bt) into raw mma.sync.m16n8k16 products
// (tiles.cuh). Each warp's 16x64 sim tile lives in registers (32 f32 a
// lane); no f32 tile goes to shared memory. Statistics are kept in base 2
// (sim * log2 e, the MUFU's ex2), the log-sum-exps converted back on output.
//   pass 1: the online row max and sum-exp, per lane over its own columns
//           (the max shared by the four lanes of a row, the sums added across
//           them at the end), written per chunk; the column max and sum-exp
//           of the tile merged over the warp's 16 rows by a reduce-scatter
//           across the 8 lanes of a column (each lane ends with two columns),
//           then over the 8 warps through a small shared array after the
//           next tile's barrier, written per row tile;
//   combine: merges the chunk and row-tile partials into log-sum-exps;
//   pass 2: t = 2 sim - lse_r - lse_c (log2 conf) per element, no exp: the
//           argmax of conf is that of t; row and column max/argmax of t
//           partials as in pass 1;
//   combine: the partials' max/argmax, conf = exp2(t) of the winners.
// Masked entries (rows past L, columns past S) hold kNeg, a finite stand-in
// for -inf, so no merge meets inf - inf.
// Ties keep the lowest index at every merge (jnp.argmax's rule): within a
// lane by strict comparison in index order, across lanes and warps by the
// comparator that prefers the lower index, across tiles, chunks and row
// tiles by strict comparison in index order.

#include "attention_unit.cuh"

#include <type_traits>

namespace {

using fm::bf16;

constexpr int TM = 128, TN = 64;  // rows of f0 per block, columns of f1 per tile
constexpr int kWarps = TM / 16, kThreads = 32 * kWarps;
constexpr int kStages = 3;  // f1 tiles in the ring
constexpr int kMaxSplit = 32;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
constexpr float kNeg = -1e30f;  // -inf stand-in: 2^(kNeg - m) = 0 for every finite m

template <int C>
struct Smem {
  static constexpr int LDF = C + 8;
  static constexpr size_t tile = (size_t)TN * LDF * 2;  // bf16 [TN][LDF] f1 tile
  static constexpr size_t slot = tile + TN * 4;         // + the tile's lse_c (pass 2)
  static constexpr size_t part_off = kStages * slot;    // float2 [2][kWarps][TN]
  static constexpr size_t bytes = part_off + 2 * kWarps * TN * 8;
};

struct Args {
  const bf16* f0;
  const bf16* f1;
  float inv_temp;
  int L, S, n_split, chunk;  // chunk: column tiles of one split
  // pass 1: (max, sum-exp) partials; pass 2: (max, argmax) partials in the same buffers
  float* row_a;  // [B, n_split, L]
  float* row_b;
  float* col_a;  // [B, nT, S]
  float* col_b;
  const float* lse_r2;  // pass 2: [B, L], [B, S] in base 2
  const float* lse_c2;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ uint32_t scale_pair(uint32_t raw, float s) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&raw);
  return fm::pack_bf16(__low2float(v) * s, __high2float(v) * s);
}

// 2^x on the MUFU alone (ex2.approx.ftz: about 2^-22 relative; results
// below 2^-126 flush to 0, nothing next to the sums' terms of at least 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (m, z) <- the merge of two (max, sum of exp2(x - max)); symmetric in its
// operands to the bit, so equal inputs at other positions give equal results
__device__ __forceinline__ void merge(float& m, float& z, float om, float oz) {
  const bool mine = m >= om;
  const float zh = mine ? z : oz, zl = mine ? oz : z;
  z = zh + zl * fast_exp2(fminf(m, om) - fmaxf(m, om));
  m = fmaxf(m, om);
}

// (v, i) <- the larger value; equal values keep the lower index
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// the second member of a pair (a sum-exp or an index) through a float slot
__device__ __forceinline__ float to_slot(float z) { return z; }
__device__ __forceinline__ float to_slot(int i) { return __int_as_float(i); }
__device__ __forceinline__ void from_slot(float s, float& z) { z = s; }
__device__ __forceinline__ void from_slot(float s, int& i) { i = __float_as_int(s); }

// One step of a reduce-scatter across the lanes `mask` apart: this lane
// keeps half of its N pairs (the upper half where its lane bit is set),
// merged with the partner's copies of them.
template <int N, typename T>
__device__ __forceinline__ void scatter_step(float* a, T* b, int mask, int lane) {
  const bool up = lane & mask;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float oa = __shfl_xor_sync(0xffffffffu, up ? a[i] : a[i + N / 2], mask);
    const T ob = __shfl_xor_sync(0xffffffffu, up ? b[i] : b[i + N / 2], mask);
    if (up) {
      a[i] = a[i + N / 2];
      b[i] = b[i + N / 2];
    }
    merge(a[i], b[i], oa, ob);
  }
}

// Reduce 16 column pairs a lane (columns 8 (q >> 1) + 2 t + (q & 1)) over the
// 8 lanes g of each column: lane (g, t) ends with columns 8 g + 2 t and the
// next in a[0..1], b[0..1].
template <typename T>
__device__ __forceinline__ void column_scatter(float* a, T* b, int lane) {
  scatter_step<16>(a, b, 16, lane);
  scatter_step<8>(a, b, 8, lane);
  scatter_step<4>(a, b, 4, lane);
}

// Two blocks an SM (at most 128 registers): pass 1 at C = 256 spills a few
// bytes for it (it would take 173 registers) but runs faster than alone on
// its SM, where the block's 8 warps reach each barrier in step.
template <int C, bool PASS2>
__global__ void __launch_bounds__(kThreads, 2) pass_kernel(Args p) {
  using Sm = Smem<C>;
  constexpr int LDF = Sm::LDF, KS = C / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float2* part = reinterpret_cast<float2*>(smem + Sm::part_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nT = gridDim.x / p.n_split, it = blockIdx.x % nT, sp = blockIdx.x / nT;
  const int b = blockIdx.y, i0 = it * TM, vr = min(TM, p.L - i0);
  const int nS = (p.S + TN - 1) / TN, c0 = sp * p.chunk, n = min(nS, c0 + p.chunk) - c0;
  const bf16* f1b = p.f1 + (size_t)b * p.S * C;
  using Aux = std::conditional_t<PASS2, int, float>;  // sum-exp or argmax

  auto prefetch = [&](int k) {  // column tile c0 + k into slot k % kStages
    if (k < n) {
      unsigned char* slot = smem + (k % kStages) * Sm::slot;
      const int j0 = (c0 + k) * TN, vc = min(TN, p.S - j0);
      bf16* dst = reinterpret_cast<bf16*>(slot);
      for (int e = threadIdx.x; e < vc * (C / 8); e += kThreads) {
        const int r = e / (C / 8), c = (e % (C / 8)) * 8;
        fm::cp_async16(dst + r * LDF + c, f1b + (size_t)(j0 + r) * C + c);
      }
      if (PASS2 && (int)threadIdx.x < vc)
        cp_async4(slot + Sm::tile + 4 * threadIdx.x, p.lse_c2 + (size_t)b * p.S + j0 + threadIdx.x);
    }
    fm::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) prefetch(k);

  // this lane's rows of the block: r0 and r0 + 8; A fragments in registers
  const int r0 = warp * 16 + g;
  const bool rv[2] = {r0 < vr, r0 + 8 < vr};
  uint32_t qa[KS][4];
  {
    const bf16* f0b = p.f0 + ((size_t)b * p.L + i0) * C;
#pragma unroll
    for (int kc = 0; kc < KS; ++kc)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, col = kc * 16 + 8 * (q >> 1) + 2 * t;
        const uint32_t raw =
            rv[h] ? __ldg(reinterpret_cast<const unsigned*>(f0b + (size_t)(r0 + 8 * h) * C + col))
                  : 0u;
        qa[kc][q] = scale_pair(raw, p.inv_temp);
      }
  }
  // row state: pass 1 (max, this lane's sum-exp), pass 2 (max, argmax) of t
  float ra[2] = {kNeg, kNeg}, rb[2] = {0.f, 0.f};
  int ri[2] = {0, 0};
  float lr2[2] = {0.f, 0.f};
  if constexpr (PASS2) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rv[h]) lr2[h] = p.lse_r2[(size_t)b * p.L + i0 + r0 + 8 * h];
  }
  const size_t col_base = ((size_t)b * nT + it) * p.S;

  // merge tile k's column partials over the warps: 4 threads a column, two
  // warps each, then across the four; one writes the row tile's partial
  auto flush = [&](int k) {
    const int col = threadIdx.x >> 2, q = threadIdx.x & 3;
    const float2* pk = part + (k & 1) * kWarps * TN;
    const float2 x = pk[q * TN + col], y = pk[(q + 4) * TN + col];
    float va = x.x;
    Aux vb, yb;
    from_slot(x.y, vb);
    from_slot(y.y, yb);
    merge(va, vb, y.x, yb);
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float oa = __shfl_xor_sync(0xffffffffu, va, o);
      merge(va, vb, oa, __shfl_xor_sync(0xffffffffu, vb, o));
    }
    if constexpr (PASS2) vb += i0;  // global row id
    const int j = (c0 + k) * TN + col;
    if (q == 0 && j < p.S) {
      p.col_a[col_base + j] = va;
      p.col_b[col_base + j] = to_slot(vb);
    }
  };

  for (int k = 0; k < n; ++k) {
    fm::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k landed; slot (k - 1) % kStages and part[(k + 1) & 1] are free
    if (k > 0) flush(k - 1);
    prefetch(k + kStages - 1);
    const unsigned char* slot = smem + (k % kStages) * Sm::slot;
    const bf16* tile = reinterpret_cast<const bf16*>(slot);
    fm::Acc16 s[TN / 16];
#pragma unroll
    for (int nt = 0; nt < TN / 16; ++nt) fm::zero(s[nt]);
#pragma unroll
    for (int kc = 0; kc < KS; ++kc)
#pragma unroll
      for (int nt = 0; nt < TN / 16; ++nt) {
        uint32_t kb[4];
        fm::load_bt(kb, tile + nt * 16 * LDF + kc * 16, LDF, lane);
        fm::mma16(s[nt], qa[kc], kb);
      }
    // s[nt].c[j]: row r0 + 8 ((j >> 1) & 1), column 16 nt + 8 (j >> 2) + 2 t + (j & 1)
    const int vc = min(TN, p.S - (c0 + k) * TN);
    const float* lc2 = reinterpret_cast<const float*>(slot + Sm::tile);
#pragma unroll
    for (int nt = 0; nt < TN / 16; ++nt)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 16 * nt + 8 * (j >> 2) + 2 * t + (j & 1);
        const bool ok = rv[(j >> 1) & 1] && col < vc;
        float v;
        if constexpr (PASS2)
          v = __fmul_rn(s[nt].c[j], 2.f * kLog2e) - lc2[col] - lr2[(j >> 1) & 1];
        else
          v = s[nt].c[j] * kLog2e;
        s[nt].c[j] = ok ? v : kNeg;
      }
    // rows
    if constexpr (PASS2) {
#pragma unroll
      for (int nt = 0; nt < TN / 16; ++nt)
#pragma unroll
        for (int jh = 0; jh < 2; ++jh)
#pragma unroll
          for (int odd = 0; odd < 2; ++odd)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = s[nt].c[4 * jh + 2 * h + odd];
              if (v > ra[h]) {  // columns in increasing order: ties keep the first
                ra[h] = v;
                ri[h] = (c0 + k) * TN + 16 * nt + 8 * jh + 2 * t + odd;
              }
            }
    } else {
      float tm[2] = {kNeg, kNeg};
#pragma unroll
      for (int nt = 0; nt < TN / 16; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j) tm[(j >> 1) & 1] = fmaxf(tm[(j >> 1) & 1], s[nt].c[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 1));
        tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 2));
        const float mn = fmaxf(ra[h], tm[h]);
        rb[h] *= fast_exp2(ra[h] - mn);
        ra[h] = mn;
      }
#pragma unroll
      for (int nt = 0; nt < TN / 16; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j) rb[(j >> 1) & 1] += fast_exp2(s[nt].c[j] - ra[(j >> 1) & 1]);
    }
    // columns: pair rows r0 and r0 + 8, then reduce-scatter over the 8 lanes g
    float ca[16];
    Aux cb[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int nt = q >> 2, j = 4 * ((q >> 1) & 1) + (q & 1);
      const float lo = s[nt].c[j], hi = s[nt].c[j + 2];
      if constexpr (PASS2) {
        ca[q] = hi > lo ? hi : lo;
        cb[q] = hi > lo ? r0 + 8 : r0;
      } else {
        ca[q] = fmaxf(lo, hi);
        cb[q] = 1.f + fast_exp2(fminf(lo, hi) - fmaxf(lo, hi));
      }
    }
    column_scatter(ca, cb, lane);
    reinterpret_cast<float4*>(part + ((k & 1) * kWarps + warp) * TN)[g * 4 + t] =
        make_float4(ca[0], to_slot(cb[0]), ca[1], to_slot(cb[1]));
  }
  __syncthreads();
  if (n > 0) flush(n - 1);
  // rows: across the four lanes of each row, then one lane writes the chunk's partial
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float oa = __shfl_xor_sync(0xffffffffu, ra[h], o);
      if constexpr (PASS2) {
        merge(ra[h], ri[h], oa, __shfl_xor_sync(0xffffffffu, ri[h], o));
      } else {
        rb[h] += __shfl_xor_sync(0xffffffffu, rb[h], o);
      }
    }
    if (t == 0 && rv[h]) {
      const size_t o = ((size_t)b * p.n_split + sp) * p.L + i0 + r0 + 8 * h;
      p.row_a[o] = ra[h];
      if constexpr (PASS2)
        reinterpret_cast<int*>(p.row_b)[o] = ri[h];
      else
        p.row_b[o] = rb[h];
    }
  }
}

// Pass 1's partials -> log-sum-exps, (m + log2 z) * out_scale: ln 2 gives
// natural units, 1 keeps base 2. Partials merged in index order.
__global__ void lse_combine(const float* __restrict__ row_m, const float* __restrict__ row_z,
                            int n_split, int L, const float* __restrict__ col_m,
                            const float* __restrict__ col_z, int nT, int S, int B,
                            float out_scale, float* __restrict__ lse_r,
                            float* __restrict__ lse_c) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const float *pm = row_m, *pz = row_z;
  int parts = n_split, len = L;
  float* out = lse_r;
  if (idx >= B * L) {
    idx -= B * L;
    if (idx >= B * S) return;
    pm = col_m, pz = col_z, parts = nT, len = S, out = lse_c;
  }
  const size_t o = (size_t)(idx / len) * parts * len + idx % len;
  float m = pm[o], z = pz[o];
  for (int q = 1; q < parts; ++q) merge(m, z, pm[o + (size_t)q * len], pz[o + (size_t)q * len]);
  out[idx] = (m + log2f(z)) * out_scale;
}

// Pass 2's partials -> max / argmax, in index order (strict: ties keep the
// lower partial, whose indices are the lower); conf = exp2(t) of the winner.
__global__ void argmax_combine(const float* __restrict__ row_t, const int* __restrict__ row_i,
                               int n_split, int L, const float* __restrict__ col_t,
                               const int* __restrict__ col_i, int nT, int S, int B,
                               float* __restrict__ row_max, int* __restrict__ row_arg,
                               float* __restrict__ col_max, int* __restrict__ col_arg) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const float* pt = row_t;
  const int* pi = row_i;
  int parts = n_split, len = L;
  float* out_v = row_max;
  int* out_i = row_arg;
  if (idx >= B * L) {
    idx -= B * L;
    if (idx >= B * S) return;
    pt = col_t, pi = col_i, parts = nT, len = S, out_v = col_max, out_i = col_arg;
  }
  const size_t o = (size_t)(idx / len) * parts * len + idx % len;
  float best = pt[o];
  int arg = pi[o];
  for (int q = 1; q < parts; ++q) {
    const float v = pt[o + (size_t)q * len];
    if (v > best) {
      best = v;
      arg = pi[o + (size_t)q * len];
    }
  }
  out_v[idx] = exp2f(best);
  out_i[idx] = arg;
}

// Both passes may take Smem<C>::bytes of dynamic shared memory.
template <int C>
cudaError_t allow_smem() {
  const int smem = (int)Smem<C>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      pass_kernel<C, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return e != cudaSuccess ? e
                          : cudaFuncSetAttribute(pass_kernel<C, true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Work units: the row tiles of all B against n_split chunks of `chunk`
// column tiles. The split count minimises ceil(units / SMs) * (chunk + 1),
// the per-SM share of the units with one tile's worth of set-up each.
template <int C>
cudaError_t make_plan(int B, int L, int S, int* plan) {
  const int smem = (int)Smem<C>::bytes;
  cudaError_t e = allow_smem<C>();
  int dev = 0, sms = 0, occ1 = 0, occ2 = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ1, pass_kernel<C, false>, kThreads, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ2, pass_kernel<C, true>, kThreads, smem);
  if (e != cudaSuccess) return e;
  const int nT = (L + TM - 1) / TM, nS = (S + TN - 1) / TN;
  long best_cost = -1;
  int best_split = 1, best_chunk = nS;
  for (int want = 1; want <= kMaxSplit && want <= nS; ++want) {
    const int chunk = (nS + want - 1) / want, split = (nS + chunk - 1) / chunk;
    const long units = (long)nT * split * B;
    const long cost = (units + sms - 1) / sms * (chunk + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_split = split;
      best_chunk = chunk;
    }
  }
  plan[0] = occ1 < occ2 ? occ1 : occ2;
  plan[1] = sms;
  plan[2] = best_split;
  plan[3] = best_chunk;
  plan[4] = nT * best_split * B;
  return cudaSuccess;
}

template <int C>
cudaError_t launch(const Args& a, int B, bool stats, float* lse_r, float* lse_c, void* const* out,
                   cudaStream_t st) {
  const int smem = (int)Smem<C>::bytes, nT = (a.L + TM - 1) / TM;
  const cudaError_t e = allow_smem<C>();
  if (e != cudaSuccess) return e;
  const dim3 grid(nT * a.n_split, B);
  const int combine_blocks = (B * (a.L + a.S) + 255) / 256;
  pass_kernel<C, false><<<grid, kThreads, smem, st>>>(a);
  lse_combine<<<combine_blocks, 256, 0, st>>>(a.row_a, a.row_b, a.n_split, a.L, a.col_a, a.col_b,
                                              nT, a.S, B, stats ? 1.f : kLn2, lse_r, lse_c);
  if (stats) {
    Args a2 = a;
    a2.lse_r2 = lse_r;
    a2.lse_c2 = lse_c;
    pass_kernel<C, true><<<grid, kThreads, smem, st>>>(a2);
    argmax_combine<<<combine_blocks, 256, 0, st>>>(
        a.row_a, reinterpret_cast<const int*>(a.row_b), a.n_split, a.L, a.col_a,
        reinterpret_cast<const int*>(a.col_b), nT, a.S, B, static_cast<float*>(out[0]),
        static_cast<int*>(out[1]), static_cast<float*>(out[2]), static_cast<int*>(out[3]));
  }
  return cudaGetLastError();
}

cudaError_t dispatch(int C, const Args& a, int B, bool stats, float* lse_r, float* lse_c,
                     void* const* out, cudaStream_t st) {
  if (a.n_split < 1 || a.chunk < 1 || (long)a.n_split * a.chunk < (a.S + TN - 1) / TN)
    return cudaErrorInvalidValue;
  switch (C) {
    case 64: return launch<64>(a, B, stats, lse_r, lse_c, out, st);
    case 128: return launch<128>(a, B, stats, lse_r, lse_c, out, st);
    case 256: return launch<256>(a, B, stats, lse_r, lse_c, out, st);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* f0, const void* f1, float inv_temp, int L, int S, int n_split,
               int chunk, void* row_a, void* row_b, void* col_a, void* col_b) {
  return Args{static_cast<const bf16*>(f0), static_cast<const bf16*>(f1), inv_temp, L, S,
              n_split, chunk, static_cast<float*>(row_a), static_cast<float*>(row_b),
              static_cast<float*>(col_a), static_cast<float*>(col_b), nullptr, nullptr};
}

}  // namespace

FM_ERROR_STRING_ENTRY

// The work decomposition for [B, L, C] x [B, S, C] on the current device:
// plan[0..5) = blocks an SM (the smaller of the two passes'), SMs, n_split,
// chunk (column tiles a split), work units (blocks of a pass).
extern "C" int fm_dual_softmax_plan(int B, int L, int S, int C, int* plan) {
  switch (C) {
    case 64: return static_cast<int>(make_plan<64>(B, L, S, plan));
    case 128: return static_cast<int>(make_plan<128>(B, L, S, plan));
    case 256: return static_cast<int>(make_plan<256>(B, L, S, plan));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f0: [B, L, C], f1: [B, S, C] bf16 (f0 unscaled; inv_temp = 1 / (C * T));
// n_split, chunk from fm_dual_softmax_plan. Scratch f32 (nT = ceil(L / 128)):
// row_a, row_b [B, n_split, L]; col_a, col_b [B, nT, S]; lse_r [B, L], lse_c
// [B, S] (base 2). Outputs: row_max f32 / row_arg int32 [B, L]; col_max f32 /
// col_arg int32 [B, S] (col_arg in global row ids).
extern "C" int fm_dual_softmax_stats(const void* f0, const void* f1, float inv_temp, int B,
                                     int L, int S, int C, int n_split, int chunk, void* row_a,
                                     void* row_b, void* col_a, void* col_b, void* lse_r,
                                     void* lse_c, void* row_max, void* row_arg, void* col_max,
                                     void* col_arg, void* stream) {
  void* out[4] = {row_max, row_arg, col_max, col_arg};
  const Args a = make_args(f0, f1, inv_temp, L, S, n_split, chunk, row_a, row_b, col_a, col_b);
  return static_cast<int>(dispatch(C, a, B, true, static_cast<float*>(lse_r),
                                   static_cast<float*>(lse_c), out,
                                   static_cast<cudaStream_t>(stream)));
}

// The row and column log-sum-exps alone: f0, f1, inv_temp, n_split, chunk and
// the scratch row_a, row_b, col_a, col_b as above; out lse_r [B, L], lse_c
// [B, S] f32.
extern "C" int fm_dual_softmax_lse(const void* f0, const void* f1, float inv_temp, int B, int L,
                                   int S, int C, int n_split, int chunk, void* row_a,
                                   void* row_b, void* col_a, void* col_b, void* lse_r,
                                   void* lse_c, void* stream) {
  const Args a = make_args(f0, f1, inv_temp, L, S, n_split, chunk, row_a, row_b, col_a, col_b);
  return static_cast<int>(dispatch(C, a, B, false, static_cast<float*>(lse_r),
                                   static_cast<float*>(lse_c), nullptr,
                                   static_cast<cudaStream_t>(stream)));
}
