// Flash-attention forward: tiled online-softmax attention that writes the
// output and the per-row log-sum-exp.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py, _flash_fwd_kernel (the
// pallas_call in _flash_forward at :180; entries flash_attention and
// masked_attention).
//
// Computes, for q, k, v in the JAX [B, T, H, D] layout and s = q.k / sqrt(D):
// masked logits set to -1e30 (causal: key position > query position; key
// mask: mask[b, t] <= 0), p = 0 wherever s <= -1e30, l clamped at 1e-20 so a
// fully masked row outputs 0, out = sum_j p_j v_j / l, lse = m + log(l), all
// in float32. lse is [B * H, Tq], row b * H + h, as in the JAX package.
//
// What bounds it on the H100: operations. Causal attention at T = 512 and
// D = 64 does 4 * D operations per (query, key) pair on 2 * D * 4 bytes per
// row, well above the float32 ridge of ~20 operations per byte.
//
// What the design does about it: one block per (batch * head, 64-query tile);
// one thread per query row keeps its scaled query and its output accumulator
// in registers, so scores and probabilities never reach device memory (the
// O(T^2) matrix never exists). K and V stream through shared memory 32 keys at
// a time and are read there as broadcasts. The online softmax rescales the
// accumulator once per tile. Under a causal mask the loop stops at the block's
// last query row: the skipped tiles would contribute p = 0 exactly, so the
// result is the same as the full loop's. Ragged Tq and Tk are masked, so any
// length is taken. This is float32 arithmetic on the CUDA cores; tensor cores
// (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Tq,
                 int Tk, float scale, int causal) {
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ float kms[BK];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int i = q0 + tid;
  const bool row_ok = i < Tq;

  float qr[D];
  float acc[D];
  const T* qp = q + (((size_t)b * Tq + (row_ok ? i : 0)) * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? to_f32(qp[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG;
  float l = 0.f;

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    for (int idx = tid; idx < BK * D; idx += BQ) {
      const int j = idx / D;
      const int d = idx % D;
      const int t = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * H + h) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (tid < BK) {
      const int t = k0 + tid;
      kms[tid] = t < Tk ? (key_mask ? key_mask[(size_t)b * Tk + t] : 1.f) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_blk = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      const bool masked = kms[j] <= 0.f || (causal && k0 + j > i);
      s[j] = masked ? NEG : dot;
      m_blk = fmaxf(m_blk, s[j]);
    }
    const float m_new = fmaxf(m, m_blk);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j] <= NEG ? 0.f : expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    const float l_safe = fmaxf(l, 1e-20f);
    T* op = out + (((size_t)b * Tq + i) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) store(op + d, acc[d] / l_safe);
    lse[(size_t)bh * Tq + i] = m + logf(l_safe);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* km, void* out, float* lse, int B, int H,
                   int Tq, int Tk, int D, float scale, int causal,
                   cudaStream_t s) {
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  switch (D) {
    case 32:
      flash_fwd_kernel<T, 32><<<grid, BQ, 0, s>>>(qq, kk, vv, km, oo, lse, H, Tq, Tk, scale, causal);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, BQ, 0, s>>>(qq, kk, vv, km, oo, lse, H, Tq, Tk, scale, causal);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* key_mask, void* out, void* lse, int B,
                         int H, int Tq, int Tk, int D, float scale, int causal,
                         int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(key_mask);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, km, out, l, B, H, Tq, Tk, D, scale, causal, s)
              : launch<float>(q, k, v, km, out, l, B, H, Tq, Tk, D, scale, causal, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
