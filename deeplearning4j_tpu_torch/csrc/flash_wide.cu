// Flash attention at head dims above 128: the forward, dQ and dK/dV.
//
// Replaces, for D > 128: deeplearning4j_tpu/ops/pallas_kernels.py,
// _flash_fwd_kernel (the pallas_call at :180), _flash_bwd_dq_kernel (:519)
// and _flash_bwd_dkv_kernel (:543). The JAX kernels take any head dim;
// flash_fwd.cu and flash_bwd.cu are instantiated at widths up to 128, and
// ops/flash_attention.py flash_plan sends every D above that here.
//
// Computes exactly what those kernels compute (see their header notes):
// s = q.k / sqrt(D) with masked logits -1e30, p = 0 where s <= -1e30, l
// clamped at 1e-20, lse = m + log(l); the backward recomputes P from lse,
// dS = P * (dO.v - delta) * scale, dQ = dS.K, dK = dS^T.Q, dV = P^T.dO. All
// in float32, written in the inputs' dtype (float32 or bfloat16).
//
// What bounds it on the H100: operations, as for the narrow kernels. This
// design does not reach that bound: it runs on the CUDA cores in float32,
// the simple form the plan needs for a head dim no configuration of the zoo
// uses (transformer_lm(V, width=512, n_heads=2) has D = 256).
//
// What the design does:
// - Output-column split. The plan gives G = ceil(D / 128) column groups;
//   block (b * h, row tile, g) writes only the output columns
//   [128 g, 128 g + 128): O in the forward, dQ in the dQ kernel, dK and dV
//   in the dK/dV kernel. Any D is taken, and a lane holds 8 accumulators
//   whatever D is.
// - The score products (Q.K^T, and dO.V^T in the backward) run over the
//   full D in every group, streamed through shared memory in slabs of 64
//   columns, so each group recomputes S (and dP): G times the score work,
//   the price of the simple design. Every group runs the same slabs in the
//   same order with the same thread mapping, so every group forms the same
//   P bitwise; lse is written by group 0 only.
// - A block is 256 threads over 16 output rows; the 16 threads of a row
//   are 16 neighbouring lanes of one warp. A thread holds 2 score entries
//   of its row (columns c and c + 16 of a 32-row tile) and 8 output columns
//   (c + 16 j). Row max and sum come from shuffles within the 16 lanes; the
//   sum is taken from the row's first lane, so every thread of a row holds
//   the same bits. Shared rows are padded (65, 33, 129 floats) so the
//   column reads of a warp hit distinct banks or broadcast.
// - Causal tiles past the block's last query (or before its first key) are
//   skipped. Ragged lengths and D are masked with zeros. Every sum runs in a
//   fixed order, with no atomics: the result is bitwise the same from run
//   to run.
// - Next lever, if a configuration comes to need it: the split-TF32
//   mma.sync of flash_fwd.cu and flash_bwd.cu on the score slabs.

#include <math.h>

#include "tf32_mma.cuh"

namespace {

using tf32mma::store;
using tf32mma::to_f32;

constexpr int BR = 16;        // output rows of a block
constexpr int BT = 32;        // rows of a streamed tile (keys, or queries)
constexpr int SL = 64;        // columns of a score slab
constexpr int GW = 128;       // output columns of a group
constexpr int THREADS = 256;  // 16 threads a row
constexpr int NJ = GW / 16;   // output columns of a thread
constexpr float NEG = -1e30f;

// All float32, so each size is the sum flash_plan computes.
struct FwdSmem {
  float a[BR][SL + 1];   // Q slab (scaled)
  float b[BT][SL + 1];   // K slab
  float p[BR][BT + 1];
  float v[BT][GW + 1];   // V tile, the group's columns
};
struct DqSmem {
  float a[2][BR][SL + 1];  // Q, dO slabs
  float b[2][BT][SL + 1];  // K, V slabs
  float ds[BR][BT + 1];
  float k[BT][GW + 1];     // K tile, the group's columns
};
struct DkvSmem {
  float a[2][BR][SL + 1];  // K, V slabs
  float b[2][BT][SL + 1];  // Q, dO slabs
  float p[BR][BT + 1];     // P^T
  float ds[BR][BT + 1];    // dS^T
  float q[BT][GW + 1];     // Q and dO tiles, the group's columns
  float g[BT][GW + 1];
};

// Rows t0 .. t0 + N - 1 and columns c0 .. c0 + NC - 1 of head (b, h) of a
// [B, T, H, D] tensor into dst[N][LDD] as float32 times `mul`; zeros past
// T and past D.
template <int N, int NC, int LDD, typename T>
__device__ __forceinline__ void stage(float (*dst)[LDD],
                                      const T* __restrict__ src, int b, int h,
                                      int H, int T_, int D, int t0, int c0,
                                      float mul) {
  for (int idx = threadIdx.x; idx < N * NC; idx += THREADS) {
    const int r = idx / NC, c = idx % NC;
    const int t = t0 + r, d = c0 + c;
    dst[r][c] = t < T_ && d < D
        ? to_f32(src[(((size_t)b * T_ + t) * H + h) * D + d]) * mul : 0.f;
  }
}

// acc[e] += sum_s a[r][s] * b[c + 16 e][s] over one slab
__device__ __forceinline__ void slab_dot(const float (*a)[SL + 1],
                                         const float (*b)[SL + 1], int r,
                                         int c, float (&acc)[2]) {
#pragma unroll 16
  for (int s = 0; s < SL; ++s) {
    const float x = a[r][s];
    acc[0] = fmaf(x, b[c][s], acc[0]);
    acc[1] = fmaf(x, b[c + 16][s], acc[1]);
  }
}

// acc[j] += sum_k w[r][k] * m[k][c + 16 j] over one tile
__device__ __forceinline__ void tile_out(const float (*w)[BT + 1],
                                         const float (*m)[GW + 1], int r,
                                         int c, float (&acc)[NJ]) {
#pragma unroll 4
  for (int k = 0; k < BT; ++k) {
    const float x = w[r][k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = fmaf(x, m[k][c + 16 * j], acc[j]);
  }
}

// the 16 lanes of a row: max, and a sum every lane holds bitwise alike
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return __shfl_sync(0xffffffffu, x, threadIdx.x & 16);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ key_mask, T* __restrict__ out,
                      float* __restrict__ lse, int BH, int H, int Tq, int Tk,
                      int D, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int n_qt = (Tq + BR - 1) / BR;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * BR;  // heaviest first
  const int b = bh / H, h = bh % H;
  const int gc0 = blockIdx.y * GW;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int row = q0 + r;

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float m = NEG, l = 0.f;
  const int k_end = causal ? min(Tk, q0 + BR) : Tk;
  for (int kb = 0; kb < k_end; kb += BT) {
    float s[2] = {0.f, 0.f};
    for (int s0 = 0; s0 < D; s0 += SL) {
      stage<BR, SL, SL + 1>(sm.a, q, b, h, H, Tq, D, q0, s0, scale);
      stage<BT, SL, SL + 1>(sm.b, k, b, h, H, Tk, D, kb, s0, 1.f);
      __syncthreads();
      slab_dot(sm.a, sm.b, r, c, s);
      __syncthreads();
    }
    float mx = NEG;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = kb + c + 16 * e;
      if (key >= Tk || (key_mask && key_mask[(size_t)b * Tk + key] <= 0.f)
          || (causal && key > row))
        s[e] = NEG;
      mx = fmaxf(mx, s[e]);
    }
    const float mn = fmaxf(m, row_max(mx));
    const float alpha = expf(m - mn);
    m = mn;
    const float p0 = s[0] <= NEG ? 0.f : expf(s[0] - mn);
    const float p1 = s[1] <= NEG ? 0.f : expf(s[1] - mn);
    l = l * alpha + row_sum(p0 + p1);
    sm.p[r][c] = p0;
    sm.p[r][c + 16] = p1;
    stage<BT, GW, GW + 1>(sm.v, v, b, h, H, Tk, D, kb, gc0, 1.f);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= alpha;
    tile_out(sm.p, sm.v, r, c, acc);
    __syncthreads();
  }
  if (row >= Tq) return;
  const float ls = fmaxf(l, 1e-20f);
  T* op = out + (((size_t)b * Tq + row) * H + h) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = gc0 + c + 16 * j;
    if (d < D) store(op + d, acc[j] / ls);
  }
  if (blockIdx.y == 0 && c == 0) lse[(size_t)bh * Tq + row] = m + logf(ls);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ key_mask, T* __restrict__ dq,
                     int BH, int H, int Tq, int Tk, int D, float scale,
                     int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int n_qt = (Tq + BR - 1) / BR;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * BR;
  const int b = bh / H, h = bh % H;
  const int gc0 = blockIdx.y * GW;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int row = q0 + r;
  const float lse_r = row < Tq ? lse[(size_t)bh * Tq + row] : 0.f;
  const float dl_r = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  const int k_end = causal ? min(Tk, q0 + BR) : Tk;
  for (int kb = 0; kb < k_end; kb += BT) {
    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
    for (int s0 = 0; s0 < D; s0 += SL) {
      stage<BR, SL, SL + 1>(sm.a[0], q, b, h, H, Tq, D, q0, s0, 1.f);
      stage<BR, SL, SL + 1>(sm.a[1], dout, b, h, H, Tq, D, q0, s0, 1.f);
      stage<BT, SL, SL + 1>(sm.b[0], k, b, h, H, Tk, D, kb, s0, 1.f);
      stage<BT, SL, SL + 1>(sm.b[1], v, b, h, H, Tk, D, kb, s0, 1.f);
      __syncthreads();
      slab_dot(sm.a[0], sm.b[0], r, c, s);
      slab_dot(sm.a[1], sm.b[1], r, c, dp);
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = kb + c + 16 * e;
      const bool masked = key >= Tk
          || (key_mask && key_mask[(size_t)b * Tk + key] <= 0.f)
          || (causal && key > row);
      const float sv = s[e] * scale;
      const float p = masked || sv <= NEG ? 0.f : expf(sv - lse_r);
      sm.ds[r][c + 16 * e] = p * (dp[e] - dl_r) * scale;
    }
    stage<BT, GW, GW + 1>(sm.k, k, b, h, H, Tk, D, kb, gc0, 1.f);
    __syncthreads();
    tile_out(sm.ds, sm.k, r, c, acc);
    __syncthreads();
  }
  if (row >= Tq) return;
  T* op = dq + (((size_t)b * Tq + row) * H + h) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = gc0 + c + 16 * j;
    if (d < D) store(op + d, acc[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ key_mask, T* __restrict__ dk,
                      T* __restrict__ dv, int BH, int H, int Tq, int Tk,
                      int D, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * BR;  // heaviest (first keys) first
  const int b = bh / H, h = bh % H;
  const int gc0 = blockIdx.y * GW;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int key = k0 + r;
  const float km_r = key < Tk
      ? (key_mask ? key_mask[(size_t)b * Tk + key] : 1.f) : 0.f;
  const float* lrow = lse + (size_t)bh * Tq;
  const float* drow = delta + (size_t)bh * Tq;

  float dka[NJ], dva[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dka[j] = dva[j] = 0.f;
  for (int qb = causal ? k0 : 0; qb < Tq; qb += BT) {
    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
    for (int s0 = 0; s0 < D; s0 += SL) {
      stage<BR, SL, SL + 1>(sm.a[0], k, b, h, H, Tk, D, k0, s0, 1.f);
      stage<BR, SL, SL + 1>(sm.a[1], v, b, h, H, Tk, D, k0, s0, 1.f);
      stage<BT, SL, SL + 1>(sm.b[0], q, b, h, H, Tq, D, qb, s0, 1.f);
      stage<BT, SL, SL + 1>(sm.b[1], dout, b, h, H, Tq, D, qb, s0, 1.f);
      __syncthreads();
      slab_dot(sm.a[0], sm.b[0], r, c, s);
      slab_dot(sm.a[1], sm.b[1], r, c, dp);
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = qb + c + 16 * e;
      const bool masked = km_r <= 0.f || i >= Tq || (causal && key > i);
      const float sv = s[e] * scale;
      const float p = masked || sv <= NEG ? 0.f : expf(sv - lrow[i]);
      sm.p[r][c + 16 * e] = p;
      sm.ds[r][c + 16 * e] = masked ? 0.f : p * (dp[e] - drow[i]) * scale;
    }
    stage<BT, GW, GW + 1>(sm.q, q, b, h, H, Tq, D, qb, gc0, 1.f);
    stage<BT, GW, GW + 1>(sm.g, dout, b, h, H, Tq, D, qb, gc0, 1.f);
    __syncthreads();
    tile_out(sm.p, sm.g, r, c, dva);
    tile_out(sm.ds, sm.q, r, c, dka);
    __syncthreads();
  }
  if (key >= Tk) return;
  const size_t off = (((size_t)b * Tk + key) * H + h) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = gc0 + c + 16 * j;
    if (d < D) {
      store(dk + off + d, dka[j]);
      store(dv + off + d, dva[j]);
    }
  }
}

// Raise the block's dynamic shared-memory limit once per instantiation
// (idempotent: a race only sets it twice).
template <typename F>
cudaError_t allow_smem(F* kernel, int smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = err == cudaSuccess;
  return err;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *km;
  void *o1, *o2;  // out; dq; or dk, dv
  float* lse_out;
  int B, H, Tq, Tk, D, groups, smem;
  float scale;
  int causal;
};

// 0: forward, 1: dQ, 2: dK/dV
template <typename T, int KIND>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int bytes = KIND == 0 ? (int)sizeof(FwdSmem)
                        : KIND == 1 ? (int)sizeof(DqSmem) : (int)sizeof(DkvSmem);
  if (a.smem != bytes || a.D < 1 || a.groups != (a.D + GW - 1) / GW)
    return cudaErrorInvalidValue;
  const int BH = a.B * a.H;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  static bool done = false;
  cudaError_t err;
  if constexpr (KIND == 0) {
    if ((err = allow_smem(flash_wide_fwd_kernel<T>, a.smem, done)) != cudaSuccess) return err;
    const dim3 grid(BH * ((a.Tq + BR - 1) / BR), a.groups);
    flash_wide_fwd_kernel<T><<<grid, THREADS, a.smem, s>>>(
        q, k, v, a.km, static_cast<T*>(a.o1), a.lse_out, BH, a.H, a.Tq, a.Tk,
        a.D, a.scale, a.causal);
  } else if constexpr (KIND == 1) {
    if ((err = allow_smem(flash_wide_dq_kernel<T>, a.smem, done)) != cudaSuccess) return err;
    const dim3 grid(BH * ((a.Tq + BR - 1) / BR), a.groups);
    flash_wide_dq_kernel<T><<<grid, THREADS, a.smem, s>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta, a.km,
        static_cast<T*>(a.o1), BH, a.H, a.Tq, a.Tk, a.D, a.scale, a.causal);
  } else {
    if ((err = allow_smem(flash_wide_dkv_kernel<T>, a.smem, done)) != cudaSuccess) return err;
    const dim3 grid(BH * ((a.Tk + BR - 1) / BR), a.groups);
    flash_wide_dkv_kernel<T><<<grid, THREADS, a.smem, s>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta, a.km,
        static_cast<T*>(a.o1), static_cast<T*>(a.o2), BH, a.H, a.Tq, a.Tk,
        a.D, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <int KIND>
int run(const Args& a, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16, KIND>(a, s)
                                  : launch<float, KIND>(a, s));
}

}  // namespace

// The signatures of flash_fwd, flash_bwd_dq and flash_bwd_dkv, with the
// plan's column groups in place of the width.
extern "C" int flash_wide_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, void* lse,
                              int B, int H, int Tq, int Tk, int D, int groups,
                              int splits, int smem, float scale, int causal,
                              int is_bf16, void* stream) {
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, nullptr, nullptr, nullptr,
               static_cast<const float*>(key_mask), out, nullptr,
               static_cast<float*>(lse), B, H, Tq, Tk, D, groups, smem, scale,
               causal};
  return run<0>(a, is_bf16, stream);
}

extern "C" int flash_wide_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* key_mask, void* dq,
                             int B, int H, int Tq, int Tk, int D, int groups,
                             int smem, float scale, int causal, int is_bf16,
                             void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(key_mask), dq, nullptr, nullptr, B, H,
               Tq, Tk, D, groups, smem, scale, causal};
  return run<1>(a, is_bf16, stream);
}

extern "C" int flash_wide_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* key_mask,
                              void* dk, void* dv, int B, int H, int Tq,
                              int Tk, int D, int groups, int smem, float scale,
                              int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(key_mask), dk, dv, nullptr, B, H, Tq,
               Tk, D, groups, smem, scale, causal};
  return run<2>(a, is_bf16, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
