// The coarse LoFTR encoder layer in float32 (kernel K5 at float32; also K9's
// forward): stats, merge, then apply.
//
// Replaces featurematching_tpu/ops/pallas_coarse_transformer.py:168,194
// (`coarse_transformer_fused`: `_stats_kernel`, `_apply_kernel`; reached in
// evaluation through pallas_coarse_grad.py:333) where the activations are
// float32, as the LoFTR-tiny teacher (`loftr_tiny_config()`) runs them, at
// (C, head dim) = (256, 32). Every product in true float32: FFMA on
// the CUDA cores, no TF32; the rounding points of the f32 plain twin. Bound
// on the H100 by those FMAs (67 TFLOP/s float32 outside the tensor cores):
// per token 2 x 2C^2 (stats) and 2 x 8C^2 (apply) operations.
//
// Design (simple first): 256 threads a block, one a channel of C = 256. The
// weights are the layer's operands as the bf16 kernels take them
// (`ops/coarse_transformer.LayerValues`, fragment order, here float32): a
// product's 16-row slices are read from that order into plain rows.
//   stats_kernel - a block takes a run of 32-token source tiles of one
//     image: [K | V] = src wkv on a register-tiled product (4 rows x 8
//     columns a thread, wkv's 16-row slices double-buffered in shared
//     memory), K = elu(.) + 1 and V / S into shared memory, then thread t
//     adds K[:, t] V[:, head(t)] (its row of the head's K^T V) and K[:, t]
//     in registers over the run; the run's partials go to global memory.
//   merge_kernel - sums the runs' partials in run order: kv (each head's
//     K^T V row-major, [H, D, D]) and ks [C].
//   apply_kernel - a block takes 32 query tokens: Q = elu(x wq) + 1, the
//     per-head normaliser and Q K^T V from the image's stats in shared
//     memory, o wmerge, LN1, [x | msg] wmlp1, ReLU, wmlp2, LN2 and the
//     residual, every intermediate in shared memory, the weights streamed
//     from L2 in 16-row slices.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int C = 256;        // channels (one a thread)
constexpr int THREADS = 256;
constexpr int TR = 32;        // tokens a tile
constexpr int KC = 16;        // k-slice of a weight
constexpr int NW = 256;       // output columns of one product pass
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float elu1(float v) { return v > 0.f ? v + 1.f : expf(v); }

// The float4 groups of a staged weight row are XOR-swizzled by swz(row) (row
// within the 16-row slice), so that the staging stores and the product's
// row reads each meet 32 banks.
__device__ __forceinline__ int swz(int row) { return ((row >> 1) & 1) | (row & 4); }

// out[TR, NW] = A[TR, K] W[K, n0 : n0 + NW] in f32; A in shared memory (rows
// of `lda` floats; k < k_split from a, the rest from a2 at k - k_split), W
// [K, N] in global memory in fragment order (`frag_pack`: [N/16, K/16, 32,
// 8], each 16x16 tile's lane l holding its 8 values contiguous; the value
// e of lane l sits at row 2(l % 4) + (e & 1) + 8((e >> 1) & 1) and column
// l / 4 + 8(e >> 2) of its tile). A slice's 16 tiles are read as float4s,
// a warp's 32 of them 512 contiguous bytes, each four rows of one column,
// and stored as rows [KC, NW] (swizzled). Thread (ty, tx) = (tid / 32, tid
// % 32) owns rows ty*4 + i and columns tx*4 + j, 128 + tx*4 + j; epi(row,
// col, value) takes the results after the last slice (the caller syncs
// after).
template <typename Epi>
__device__ __forceinline__ void rows_gemm(const float* a, int lda, const float* a2, int lda2,
                                          int k_split, int K, const float* __restrict__ w,
                                          int n0, float* ws, Epi epi) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // float4 u = tid + i * THREADS of a slice: tile u >> 6, its lane l = (u >>
  // 1) & 31, values 4(u & 1) .. + 3: rows 2(l % 4) + {0, 1, 8, 9} of the
  // slice's column 16(u >> 6) + l / 4 + 8(u & 1)
  float4 pre[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * THREADS;
      const size_t tile = ((size_t)((n0 >> 4) + (u >> 6)) * (K >> 4) + (k0 >> 4)) * 256;
      pre[i] = __ldg(reinterpret_cast<const float4*>(w + tile) + (u & 63));
    }
  };
  auto put = [&](float* s) {  // rows r, r + 1, r + 8, r + 9 share swz(r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * THREADS, l = (u >> 1) & 31, r = (l & 3) * 2;
      const int col = (u >> 6) * 16 + (l >> 2) + (u & 1) * 8;
      float* at = s + r * NW + (((col >> 2) ^ swz(r)) << 2) + (col & 3);
      at[0] = pre[i].x;
      at[NW] = pre[i].y;
      at[8 * NW] = pre[i].z;
      at[9 * NW] = pre[i].w;
    }
  };
  // the product's float4 of row k at (tx ^ swz(k)) * 4, swz(k) in {0, 1, 4, 5}
  const int sw0 = tx << 2, sw1 = (tx ^ 1) << 2, sw4 = (tx ^ 4) << 2, sw5 = (tx ^ 5) << 2;
  fetch(0);
  put(ws);
  __syncthreads();
  const int nk = K / KC;
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < nk) fetch((kc + 1) * KC);
    const float* s = ws + cur * KC * NW;
    const int k0 = kc * KC;
    const float* src = k0 < k_split ? a + k0 : a2 + (k0 - k_split);
    const int ld = k0 < k_split ? lda : lda2;
#pragma unroll
    for (int kq = 0; kq < KC; kq += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(src + (ty * 4 + i) * ld + kq);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sw = swz(kq + q);
        const float* b =
            s + (kq + q) * NW + (sw == 0 ? sw0 : sw == 1 ? sw1 : sw == 4 ? sw4 : sw5);
        const float4 b0 = *reinterpret_cast<const float4*>(b);
        const float4 b1 = *reinterpret_cast<const float4*>(b + 128);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
    if (kc + 1 < nk) put(ws + (cur ^ 1) * KC * NW);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      epi(ty * 4 + i, (j < 4 ? 0 : 128) + tx * 4 + (j & 3), acc[i][j]);
}

// `rows` rows of C floats from global (row stride C) into shared memory,
// rows at or past `valid` zero
__device__ __forceinline__ void load_rows(float* dst, const float* src, int rows, int valid) {
  for (int e = threadIdx.x; e < rows * (C / 4); e += THREADS) {
    const int r = e / (C / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = reinterpret_cast<const float4*>(src)[e];
    reinterpret_cast<float4*>(dst)[e] = v;
  }
}

// LayerNorm of TR rows of C in shared memory, in place: a warp a row at a
// time, 8 values a lane, mean then mean squared deviation, eps 1e-6
__device__ __forceinline__ void layer_norm_rows(float* x, const float* scale, const float* bias) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TR; r += THREADS / 32) {
    float v[8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = x[r * C + lane + 32 * i];
      s += v[i];
    }
    const float mu = fm::warp_sum(s) * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] -= mu;
      q += v[i] * v[i];
    }
    const float rs = rsqrtf(fm::warp_sum(q) * (1.0f / C) + kEps);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = lane + 32 * i;
      x[r * C + c] = v[i] * rs * scale[c] + bias[c];
    }
  }
}

constexpr size_t kStatsSmem = sizeof(float) * (TR * C + TR * 2 * C + 2 * KC * NW);

// grid (chunks, G): a run of `per` 32-token tiles of image g's S tokens
template <int D>
__global__ void __launch_bounds__(THREADS) stats_kernel(const float* __restrict__ src,
                                                        const float* __restrict__ wkv, int S,
                                                        int per, float* part_kv,
                                                        float* part_ks) {
  extern __shared__ float smem[];
  float* xs = smem;               // [TR, C]
  float* kvs = xs + TR * C;       // [TR, 2C]: K | V
  float* ws = kvs + TR * 2 * C;   // [2, KC, NW]
  const int chunk = blockIdx.x, g = blockIdx.y, chunks = gridDim.x;
  const int t = threadIdx.x, h = t / D;
  const int tiles = (S + TR - 1) / TR;
  const int t0 = chunk * per, t1 = min(tiles, t0 + per);
  const float inv_s = 1.0f / (float)S;
  float acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] = 0.f;
  float ks = 0.f;
  for (int tile = t0; tile < t1; ++tile) {
    const int s0 = tile * TR, valid = min(TR, S - s0);
    load_rows(xs, src + ((size_t)g * S + s0) * C, TR, valid);
    __syncthreads();
    for (int half = 0; half < 2; ++half)
      rows_gemm(xs, C, xs, C, C, C, wkv, half * C, ws, [&](int r, int c, float v) {
        const float out = half == 0 ? elu1(v) : v * inv_s;
        kvs[r * 2 * C + half * C + c] = r < valid ? out : 0.f;
      });
    __syncthreads();
    for (int s = 0; s < TR; ++s) {
      const float k = kvs[s * 2 * C + t];
      const float* vrow = kvs + s * 2 * C + C + h * D;
#pragma unroll
      for (int e = 0; e < D; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(vrow + e);
        acc[e] = fmaf(k, v.x, acc[e]);
        acc[e + 1] = fmaf(k, v.y, acc[e + 1]);
        acc[e + 2] = fmaf(k, v.z, acc[e + 2]);
        acc[e + 3] = fmaf(k, v.w, acc[e + 3]);
      }
      ks += k;
    }
    __syncthreads();
  }
  float* pk = part_kv + ((size_t)g * chunks + chunk) * C * D + (size_t)t * D;
#pragma unroll
  for (int e = 0; e < D; ++e) pk[e] = acc[e];
  part_ks[((size_t)g * chunks + chunk) * C + t] = ks;
}

// one thread an entry of (kv, ks) of one image: the runs' partials in order
template <int D>
__global__ void merge_kernel(const float* part_kv, const float* part_ks, int G, int chunks,
                             float* kv, float* ks) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long per_image = (long)C * D + C;
  if (e >= (long)G * per_image) return;
  const int g = (int)(e / per_image), k = (int)(e % per_image);
  if (k < C * D) {
    const float* p = part_kv + (size_t)g * chunks * C * D + k;
    float sum = 0.f;
    for (int i = 0; i < chunks; ++i) sum += p[(size_t)i * C * D];
    kv[(size_t)g * C * D + k] = sum;
  } else {
    const float* p = part_ks + (size_t)g * chunks * C + (k - C * D);
    float sum = 0.f;
    for (int i = 0; i < chunks; ++i) sum += p[(size_t)i * C];
    ks[(size_t)g * C + k - C * D] = sum;
  }
}

template <int D>
constexpr size_t apply_smem() {
  return sizeof(float) * (TR * C * 2 + TR * 2 * C + 2 * KC * NW + (C / D) * (D * D + 4) + C);
}

// grid (ceil(L / TR), G): 32 query tokens of image g
template <int D>
__global__ void __launch_bounds__(THREADS) apply_kernel(
    const float* __restrict__ x, const float* __restrict__ kv,
    const float* __restrict__ ks_g, const float* __restrict__ wq,
    const float* __restrict__ wmerge, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ n1s,
    const float* __restrict__ n1b, const float* __restrict__ n2s,
    const float* __restrict__ n2b, float* __restrict__ out, int L, int S) {
  constexpr int HS = D * D + 4;  // a head's K^T V in shared memory, padded
  extern __shared__ float smem[];
  float* xs = smem;              // [TR, C] queries
  float* qs = xs + TR * C;       // [TR, C] Q, then o wmerge / msg, then the FFN output
  float* ys = qs + TR * C;       // [TR, 2C] o (first C columns), then the hidden layer
  float* ws = ys + TR * 2 * C;   // [2, KC, NW]
  float* kvs = ws + 2 * KC * NW; // [H, D, D] (head stride HS)
  float* kss = kvs + (C / D) * HS;  // [C]
  const int tile = blockIdx.x, g = blockIdx.y;
  const int r0 = tile * TR, valid = min(TR, L - r0);
  load_rows(xs, x + ((size_t)g * L + r0) * C, TR, valid);
  const float* kvg = kv + (size_t)g * C * D;
  for (int e = threadIdx.x; e < C * D; e += THREADS)
    kvs[(e / (D * D)) * HS + e % (D * D)] = kvg[e];
  kss[threadIdx.x] = ks_g[(size_t)g * C + threadIdx.x];
  __syncthreads();
  rows_gemm(xs, C, xs, C, C, C, wq, 0, ws,
            [&](int r, int c, float v) { qs[r * C + c] = elu1(v); });
  __syncthreads();
  {  // o = Q_h K^T V_h * S / (Q_h . K_sum_h + eps): thread (row, 32 columns)
    const int r = threadIdx.x >> 3, c0 = (threadIdx.x & 7) * 32;
    const float* q = qs + r * C;
    int h_prev = -1;
    float nfac = 0.f;
    for (int c = c0; c < c0 + 32; c += 4) {
      const int h = c / D, e = c % D;
      if (h != h_prev) {
        float z = 0.f;
        for (int d = 0; d < D; ++d) z = fmaf(q[h * D + d], kss[h * D + d], z);
        nfac = (float)S / (z + kEps);
        h_prev = h;
      }
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* kvh = kvs + h * HS + e;
      for (int d = 0; d < D; ++d) {
        const float qd = q[h * D + d];
        const float4 k4 = *reinterpret_cast<const float4*>(kvh + d * D);
        o.x = fmaf(qd, k4.x, o.x);
        o.y = fmaf(qd, k4.y, o.y);
        o.z = fmaf(qd, k4.z, o.z);
        o.w = fmaf(qd, k4.w, o.w);
      }
      o.x *= nfac;
      o.y *= nfac;
      o.z *= nfac;
      o.w *= nfac;
      *reinterpret_cast<float4*>(ys + r * C + c) = o;
    }
  }
  __syncthreads();
  rows_gemm(ys, C, ys, C, C, C, wmerge, 0, ws,
            [&](int r, int c, float v) { qs[r * C + c] = v; });
  __syncthreads();
  layer_norm_rows(qs, n1s, n1b);
  __syncthreads();
  for (int half = 0; half < 2; ++half) {
    rows_gemm(xs, C, qs, C, C, 2 * C, w1, half * NW, ws,
              [&](int r, int c, float v) { ys[r * 2 * C + half * NW + c] = fmaxf(v, 0.f); });
    __syncthreads();
  }
  rows_gemm(ys, 2 * C, ys, 2 * C, 2 * C, 2 * C, w2, 0, ws,
            [&](int r, int c, float v) { qs[r * C + c] = v; });
  __syncthreads();
  layer_norm_rows(qs, n2s, n2b);
  __syncthreads();
  float* og = out + ((size_t)g * L + r0) * C;
  for (int e = threadIdx.x; e < valid * (C / 4); e += THREADS) {
    const float4 a = reinterpret_cast<const float4*>(xs)[e];
    const float4 b = reinterpret_cast<const float4*>(qs)[e];
    reinterpret_cast<float4*>(og)[e] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
}

constexpr int kD = 32;  // the head dim of the teacher's (256, 8) layers

cudaError_t run_layer(const float* x, const float* src, const float* wq, const float* wkv,
                      const float* wmerge, const float* w1, const float* w2, const float* n1s,
                      const float* n1b, const float* n2s, const float* n2b, float* part_kv,
                      float* part_ks, float* kv, float* ks, float* out, int G, int L, int S,
                      int per, int chunks, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(stats_kernel<kD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kStatsSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(apply_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             apply_smem<kD>());
  if (e != cudaSuccess) return e;
  stats_kernel<kD><<<dim3(chunks, G), THREADS, kStatsSmem, st>>>(src, wkv, S, per, part_kv,
                                                                 part_ks);
  const long n = (long)G * (C * kD + C);
  merge_kernel<kD><<<(int)((n + 255) / 256), 256, 0, st>>>(part_kv, part_ks, G, chunks, kv, ks);
  apply_kernel<kD><<<dim3((L + TR - 1) / TR, G), THREADS, apply_smem<kD>(), st>>>(
      x, kv, ks, wq, wmerge, w1, w2, n1s, n1b, n2s, n2b, out, L, S);
  return cudaGetLastError();
}

}  // namespace

FM_ERROR_STRING_ENTRY

// One encoder layer in float32. x: [G, L, C] queries, src: [G, S, C]
// keys/values (C = 256, 16-byte aligned); wq [C, C], wkv [C, 2C], wmerge
// [C, C], w1 [2C, 2C], w2 [2C, C] ([in, out] in fragment order, as
// `LayerValues` holds them); n1s, n1b, n2s, n2b [C]. The stats over src in
// `chunks` runs of `per` 32-token tiles (ops/coarse_transformer.
// f32_stats_plan); scratch part_kv [G, chunks, C D], part_ks [G, chunks,
// C]. Outputs: kv [G, C D] (each head's K^T V row-major), ks [G, C], out
// [G, L, C].
extern "C" int fm_coarse_layer_f32(const void* x, const void* src, const void* wq,
                                   const void* wkv, const void* wmerge, const void* w1,
                                   const void* w2, const void* n1s, const void* n1b,
                                   const void* n2s, const void* n2b, void* part_kv,
                                   void* part_ks, void* kv, void* ks, void* out, int G, int L,
                                   int S, int Cin, int Din, int per, int chunks, void* stream) {
  if (Cin != C || Din != kD || G <= 0 || L <= 0 || S <= 0 || per <= 0 || chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  return static_cast<int>(run_layer(f(x), f(src), f(wq), f(wkv), f(wmerge), f(w1), f(w2),
                                    f(n1s), f(n1b), f(n2s), f(n2b), m(part_kv), m(part_ks),
                                    m(kv), m(ks), m(out), G, L, S, per, chunks,
                                    static_cast<cudaStream_t>(stream)));
}
