// Dual-softmax matching statistics in float32 (kernel K1 at float32).
//
// Replaces featurematching_tpu/ops/pallas_dual_softmax.py:216,259
// (`dual_softmax_match_stats`: `_pass1_stats` and `_pass2_conf`) where the
// features are float32, as the LoFTR-tiny teacher (`loftr_tiny_config()`)
// runs them. sim = (f0 * inv_temp) f1^T in true float32: FFMA on the CUDA
// cores, no TF32, f0 * inv_temp one f32 multiply before the product (the
// TPU kernel's rounding point). Bound on the H100 by those FMAs (67 TFLOP/s
// float32 outside the tensor cores): 2 B L S C operations a pass.
//
// Design (simple first): a block owns a 128-row tile of f0 and a run of
// `chunk` 128-column tiles of f1 (a split). For each column tile it forms the
// [128, 128] sim tile in registers (256 threads, 8 x 8 each; f0's and f1's
// 16-wide k-slices double-buffered in shared memory, the next slice loaded
// into registers while the current one is multiplied), writes it to shared
// memory, then 128 threads walk its rows and 128 its columns:
//   pass 1 - each row's running (max, sum of exp) over the split's columns,
//            each column's (max, sum of exp) over the tile's rows;
//   pass 2 - t = 2 sim - lse_r - lse_c (log conf), each row's running max
//            and first argmax over the split, each column's over the tile.
// A combine kernel after each pass merges the partials in a fixed order
// (splits, then row tiles, in index order): the log-sum-exps after pass 1;
// after pass 2 the maxima exp(t) and their argmaxes, ties to the lower index
// as jnp.argmax and the plain twin take them.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int TM = 128;       // rows of f0 a block
constexpr int TN = 128;       // columns of f1 a tile
constexpr int KC = 16;        // k-slice
constexpr int THREADS = 256;
constexpr int SLD = TN + 1;   // sim tile row stride in shared memory

constexpr size_t kSmemBytes = sizeof(float) * (2 * KC * TM + 2 * KC * TN + TM * SLD + TM + TN);

struct Args {
  const float* f0;
  const float* f1;
  float inv_temp;
  int L, S, C, chunk;
  float* row_a;  // [B, n_split, L]: pass 1 max, pass 2 max t
  float* row_b;  // [B, n_split, L]: pass 1 sum of exp, pass 2 argmax (int bits)
  float* col_a;  // [B, nT, S]
  float* col_b;  // [B, nT, S]
  const float* lse_r;  // [B, L] (pass 2)
  const float* lse_c;  // [B, S] (pass 2)
};

// One 16-wide k-slice of a 128-row operand tile: 512 float4, two a thread,
// kept in registers until stored transposed ([k][row]) into shared memory.
struct Slice {
  float4 v[2];

  __device__ __forceinline__ void load(const float* base, int rows_valid, int C, int k0,
                                       float scale) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int row = idx >> 2, kq = idx & 3;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows_valid) {
        t = *reinterpret_cast<const float4*>(base + (size_t)row * C + k0 + kq * 4);
        t.x *= scale;
        t.y *= scale;
        t.z *= scale;
        t.w *= scale;
      }
      v[i] = t;
    }
  }

  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int row = idx >> 2, k = (idx & 3) * 4;
      s[(k + 0) * TM + row] = v[i].x;
      s[(k + 1) * TM + row] = v[i].y;
      s[(k + 2) * TM + row] = v[i].z;
      s[(k + 3) * TM + row] = v[i].w;
    }
  }
};

// sim tile [TM, TN] = A B^T (A rows `a`, B rows `b`, both [rows, C] f32; A's
// values times `scale`) into st (row stride SLD). Thread (ty, tx) owns rows
// ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j.
__device__ __forceinline__ void sim_tile(const float* a, int a_rows, const float* b, int b_rows,
                                         int C, float scale, float* As, float* Bs, float* st) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  Slice sa, sb;
  sa.load(a, a_rows, C, 0, scale);
  sb.load(b, b_rows, C, 0, 1.0f);
  sa.store(As);
  sb.store(Bs);
  __syncthreads();
  const int nk = C / KC;
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < nk) {
      sa.load(a, a_rows, C, (kc + 1) * KC, scale);
      sb.load(b, b_rows, C, (kc + 1) * KC, 1.0f);
    }
    const float* as = As + cur * KC * TM;
    const float* bs = Bs + cur * KC * TN;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * TM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * TM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * TN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * TN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kc + 1 < nk) {
      sa.store(As + (cur ^ 1) * KC * TM);
      sb.store(Bs + (cur ^ 1) * KC * TN);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) st[r * SLD + (j < 4 ? 0 : 64) + tx * 4 + (j & 3)] = acc[i][j];
  }
  __syncthreads();
}

// grid (nT, n_split, B): row tile, split of column tiles, image
template <bool PASS2>
__global__ void __launch_bounds__(THREADS) pass_kernel(Args a) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + 2 * KC * TM;
  float* st = Bs + 2 * KC * TN;
  float* lr = st + TM * SLD;
  float* lc = lr + TM;
  const int rt = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int nT = gridDim.x, n_split = gridDim.y;
  const int r0 = rt * TM;
  const int rows = min(TM, a.L - r0);
  const int n_ct = (a.S + TN - 1) / TN;
  const int ct0 = split * a.chunk, ct1 = min(n_ct, ct0 + a.chunk);
  const float* f0 = a.f0 + ((size_t)b * a.L + r0) * a.C;
  const int tid = threadIdx.x;
  const bool row_thread = tid < TM;
  const int r = tid, c = tid - TM;  // this thread's row (row threads) or column
  if (PASS2 && row_thread) lr[r] = r < rows ? a.lse_r[(size_t)b * a.L + r0 + r] : 0.f;
  float run_a = -INFINITY, run_b = 0.f;  // pass 1 (max, sum); pass 2 (max t, argmax bits)
  int run_i = 0;
  for (int ct = ct0; ct < ct1; ++ct) {
    const int c0 = ct * TN;
    const int cols = min(TN, a.S - c0);
    if (PASS2 && !row_thread) lc[c] = c < cols ? a.lse_c[(size_t)b * a.S + c0 + c] : 0.f;
    sim_tile(f0, rows, a.f1 + ((size_t)b * a.S + c0) * a.C, cols, a.C, a.inv_temp, As, Bs, st);
    if (row_thread) {
      const float* s = st + r * SLD;
      if (!PASS2) {
        float m = -INFINITY;
        for (int j = 0; j < cols; ++j) m = fmaxf(m, s[j]);
        float z = 0.f;
        for (int j = 0; j < cols; ++j) z += expf(s[j] - m);
        const float mn = fmaxf(run_a, m);
        run_b = run_b * expf(run_a - mn) + z * expf(m - mn);
        run_a = mn;
      } else {
        const float base = lr[r];
        for (int j = 0; j < cols; ++j) {
          const float t = 2.f * s[j] - base - lc[j];
          if (t > run_a) {
            run_a = t;
            run_i = c0 + j;
          }
        }
      }
    } else if (c < cols) {
      float ca, cb;
      if (!PASS2) {
        float m = -INFINITY;
        for (int i = 0; i < rows; ++i) m = fmaxf(m, st[i * SLD + c]);
        float z = 0.f;
        for (int i = 0; i < rows; ++i) z += expf(st[i * SLD + c] - m);
        ca = m;
        cb = z;
      } else {
        const float base = lc[c];
        float best = -INFINITY;
        int arg = 0;
        for (int i = 0; i < rows; ++i) {
          const float t = 2.f * st[i * SLD + c] - lr[i] - base;
          if (t > best) {
            best = t;
            arg = r0 + i;
          }
        }
        ca = best;
        cb = __int_as_float(arg);
      }
      const size_t o = ((size_t)b * nT + rt) * a.S + c0 + c;
      a.col_a[o] = ca;
      a.col_b[o] = cb;
    }
    __syncthreads();  // the tile's rows and columns read before lc is rewritten
  }
  if (row_thread && r < rows) {
    const size_t o = ((size_t)b * n_split + split) * a.L + r0 + r;
    a.row_a[o] = run_a;
    a.row_b[o] = PASS2 ? __int_as_float(run_i) : run_b;
  }
}

// One thread a row (the first B L threads) or a column (the next B S):
// merge its partials in index order. Pass 1 writes lse; pass 2 the max of
// conf = exp(t) and its first argmax.
template <bool PASS2>
__global__ void combine_kernel(const float* row_a, const float* row_b, const float* col_a,
                               const float* col_b, int B, int L, int S, int n_split, int nT,
                               float* lse_r, float* lse_c, float* row_max, int* row_arg,
                               float* col_max, int* col_arg) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool is_row = e < (long)B * L;
  if (!is_row && e >= (long)B * L + (long)B * S) return;
  const long k = is_row ? e : e - (long)B * L;
  const int n = is_row ? L : S, parts = is_row ? n_split : nT;
  const int b = (int)(k / n), i = (int)(k % n);
  const float* pa = (is_row ? row_a : col_a) + (size_t)b * parts * n + i;
  const float* pb = (is_row ? row_b : col_b) + (size_t)b * parts * n + i;
  if (!PASS2) {
    float m = -INFINITY;
    for (int p = 0; p < parts; ++p) m = fmaxf(m, pa[(size_t)p * n]);
    float z = 0.f;
    for (int p = 0; p < parts; ++p) z += pb[(size_t)p * n] * expf(pa[(size_t)p * n] - m);
    (is_row ? lse_r : lse_c)[k] = m + logf(z);
  } else {
    float best = -INFINITY;
    int arg = 0;
    for (int p = 0; p < parts; ++p) {
      const float t = pa[(size_t)p * n];
      if (t > best) {
        best = t;
        arg = __float_as_int(pb[(size_t)p * n]);
      }
    }
    (is_row ? row_max : col_max)[k] = expf(best);
    (is_row ? row_arg : col_arg)[k] = arg;
  }
}

}  // namespace

FM_ERROR_STRING_ENTRY

// f0: [B, L, C], f1: [B, S, C] float32, C a multiple of 16, 16-byte aligned
// (f0 unscaled; inv_temp = 1 / (C * T)); the column tiles in n_split runs of
// `chunk` (ops/dual_softmax.f32_plan). Scratch f32 (nT = ceil(L / 128)):
// row_a, row_b [B, n_split, L]; col_a, col_b [B, nT, S]; lse_r [B, L], lse_c
// [B, S]. Outputs: row_max f32 / row_arg int32 [B, L]; col_max f32 / col_arg
// int32 [B, S] (col_arg in global row ids).
extern "C" int fm_dual_softmax_stats_f32(const void* f0, const void* f1, float inv_temp, int B,
                                         int L, int S, int C, int n_split, int chunk,
                                         void* row_a, void* row_b, void* col_a, void* col_b,
                                         void* lse_r, void* lse_c, void* row_max, void* row_arg,
                                         void* col_max, void* col_arg, void* stream) {
  if (C % KC || C <= 0 || B <= 0 || L <= 0 || S <= 0 || n_split <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nT = (L + TM - 1) / TM;
  Args a{static_cast<const float*>(f0), static_cast<const float*>(f1), inv_temp, L, S, C, chunk,
         static_cast<float*>(row_a), static_cast<float*>(row_b), static_cast<float*>(col_a),
         static_cast<float*>(col_b), static_cast<const float*>(lse_r),
         static_cast<const float*>(lse_c)};
  cudaError_t e = cudaFuncSetAttribute(pass_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pass_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nT, n_split, B);
  const long n = (long)B * L + (long)B * S;
  const int cblocks = (int)((n + 255) / 256);
  float* lr = static_cast<float*>(lse_r);
  float* lc = static_cast<float*>(lse_c);
  pass_kernel<false><<<grid, THREADS, kSmemBytes, st>>>(a);
  combine_kernel<false><<<cblocks, 256, 0, st>>>(a.row_a, a.row_b, a.col_a, a.col_b, B, L, S,
                                                 n_split, nT, lr, lc, nullptr, nullptr,
                                                 nullptr, nullptr);
  pass_kernel<true><<<grid, THREADS, kSmemBytes, st>>>(a);
  combine_kernel<true><<<cblocks, 256, 0, st>>>(
      a.row_a, a.row_b, a.col_a, a.col_b, B, L, S, n_split, nT, nullptr, nullptr,
      static_cast<float*>(row_max), static_cast<int*>(row_arg), static_cast<float*>(col_max),
      static_cast<int*>(col_arg));
  return static_cast<int>(cudaGetLastError());
}
