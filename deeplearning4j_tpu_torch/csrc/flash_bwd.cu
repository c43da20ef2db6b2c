// Flash-attention backward: dQ (one kernel) and dK, dV (another), recomputing
// the probabilities from the forward's saved log-sum-exp.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py, _flash_bwd_dq_kernel
// (the pallas_call at :519) and _flash_bwd_dkv_kernel (the pallas_call at
// :543), both launched by _flash_backward (:481) from the custom_vjp of
// flash_attention and masked_attention.
//
// Computes, for q, k, v, dO in the JAX [B, T, H, D] layout, lse and
// delta = rowsum(dO * O) as [B * H, Tq] float32 (delta comes from the caller),
// scale = 1 / sqrt(D) and S = (q . k) * scale with masked logits set to -1e30
// (causal: key position > query position; key mask: mask[b, t] <= 0):
//   P  = 0 where S <= -1e30, else exp(S - lse)   (a fully masked row has
//        lse ~ -1e30, and exp(S - lse) would overflow)
//   dS = P * (dO . v - delta) * scale             (scale applied once, here)
//   dQ = sum_k dS k,  dK = sum_q dS q,  dV = sum_q P dO
// all in float32, written in the inputs' dtype (float32 or bfloat16).
//
// What bounds it on the H100: operations. Each (query, key) pair costs about
// 6 * D operations for dQ and 8 * D for dK/dV, against 4 * D * 4 bytes per
// row: far above the float32 ridge of ~20 operations per byte at T = 256.
//
// What the design does about it: two kernels, as on the TPU, and each output
// row is owned by one pair of threads of one block, so there is no atomicAdd
// and the result is the same from run to run. The two threads of a pair split
// the row's D dimensions (interleaved, thread h takes d = 2i + h), keep their
// halves in registers and add their partial dot products with one shuffle;
// both then hold the same score. The dQ kernel runs one block per
// (batch * head, 64-query tile): each pair keeps its query, dO and dQ halves
// in registers, and K/V stream through shared memory 32 keys at a time, read
// as broadcasts. The dK/dV kernel runs one block per (batch * head, 64-key
// tile): each pair keeps its k, v, dK and dV halves in registers, and Q/dO
// stream through shared memory 16 queries at a time. Under a causal mask the
// dQ kernel stops at its last query row and the dK/dV kernel starts at its
// first key's tile: the skipped tiles would give P = 0 exactly. Ragged Tq and
// Tk are masked, so any length is taken. Float32 on the CUDA cores; tensor
// cores (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // dQ kernel: queries per block (a thread pair each)
constexpr int BK = 32;    // dQ kernel: keys per streamed tile
constexpr int BKV = 64;   // dK/dV kernel: keys per block (a thread pair each)
constexpr int BQT = 16;   // dK/dV kernel: queries per streamed tile
constexpr int THREADS = 128;  // two per row in both kernels
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ key_mask, T* __restrict__ dq,
                    int H, int Tq, int Tk, float scale, int causal) {
  constexpr int DH = D / 2;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ float kms[BK];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int i = q0 + (tid >> 1);
  const bool row_ok = i < Tq;

  float qr[DH];
  float dor[DH];
  float acc[DH];
  const size_t qoff = (((size_t)b * Tq + (row_ok ? i : 0)) * H + h) * D;
#pragma unroll
  for (int e = 0; e < DH; ++e) {
    const int d = 2 * e + half;
    qr[e] = row_ok ? to_f32(q[qoff + d]) : 0.f;
    dor[e] = row_ok ? to_f32(dout[qoff + d]) : 0.f;
    acc[e] = 0.f;
  }
  const float lse_i = row_ok ? lse[(size_t)bh * Tq + i] : 0.f;
  const float delta_i = row_ok ? delta[(size_t)bh * Tq + i] : 0.f;

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    for (int idx = tid; idx < BK * D; idx += THREADS) {
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

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < DH; ++e) {
        dot = fmaf(qr[e], ks[j][2 * e + half], dot);
        dp = fmaf(dor[e], vs[j][2 * e + half], dp);
      }
      dot += __shfl_xor_sync(FULL, dot, 1);
      dp += __shfl_xor_sync(FULL, dp, 1);
      const bool masked = kms[j] <= 0.f || (causal && k0 + j > i);
      const float s = masked ? NEG : dot * scale;
      const float p = s <= NEG ? 0.f : expf(s - lse_i);
      const float ds = p * (dp - delta_i) * scale;
#pragma unroll
      for (int e = 0; e < DH; ++e) acc[e] = fmaf(ds, ks[j][2 * e + half], acc[e]);
    }
    __syncthreads();
  }

  if (row_ok) {
#pragma unroll
    for (int e = 0; e < DH; ++e) store(dq + qoff + 2 * e + half, acc[e]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ key_mask, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, float scale,
                     int causal) {
  constexpr int DH = D / 2;
  __shared__ float qs[BQT][D];
  __shared__ float dos[BQT][D];
  __shared__ float lses[BQT];
  __shared__ float deltas[BQT];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BKV;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int j = k0 + (tid >> 1);
  const bool col_ok = j < Tk;

  const size_t koff = (((size_t)b * Tk + (col_ok ? j : 0)) * H + h) * D;
  float kr[DH];
  float vr[DH];
  float dka[DH];
  float dva[DH];
#pragma unroll
  for (int e = 0; e < DH; ++e) {
    const int d = 2 * e + half;
    kr[e] = col_ok ? to_f32(k[koff + d]) : 0.f;
    vr[e] = col_ok ? to_f32(v[koff + d]) : 0.f;
    dka[e] = 0.f;
    dva[e] = 0.f;
  }
  const float km_j =
      col_ok ? (key_mask ? key_mask[(size_t)b * Tk + j] : 1.f) : 0.f;

  const int q_begin = causal ? (k0 / BQT) * BQT : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += BQT) {
    for (int idx = tid; idx < BQT * D; idx += THREADS) {
      const int r = idx / D;
      const int d = idx % D;
      const int t = q0 + r;
      float qv = 0.f, gv = 0.f;
      if (t < Tq) {
        const size_t off = (((size_t)b * Tq + t) * H + h) * D + d;
        qv = to_f32(q[off]);
        gv = to_f32(dout[off]);
      }
      qs[r][d] = qv;
      dos[r][d] = gv;
    }
    if (tid < BQT) {
      const int t = q0 + tid;
      lses[tid] = t < Tq ? lse[(size_t)bh * Tq + t] : 0.f;
      deltas[tid] = t < Tq ? delta[(size_t)bh * Tq + t] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < BQT; ++r) {
      const int i = q0 + r;
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < DH; ++e) {
        dot = fmaf(qs[r][2 * e + half], kr[e], dot);
        dp = fmaf(dos[r][2 * e + half], vr[e], dp);
      }
      dot += __shfl_xor_sync(FULL, dot, 1);
      dp += __shfl_xor_sync(FULL, dp, 1);
      const bool masked = km_j <= 0.f || i >= Tq || (causal && j > i);
      const float s = masked ? NEG : dot * scale;
      const float p = s <= NEG ? 0.f : expf(s - lses[r]);
      const float ds = p * (dp - deltas[r]) * scale;
#pragma unroll
      for (int e = 0; e < DH; ++e) {
        dva[e] = fmaf(p, dos[r][2 * e + half], dva[e]);
        dka[e] = fmaf(ds, qs[r][2 * e + half], dka[e]);
      }
    }
    __syncthreads();
  }

  if (col_ok) {
#pragma unroll
    for (int e = 0; e < DH; ++e) {
      store(dk + koff + 2 * e + half, dka[e]);
      store(dv + koff + 2 * e + half, dva[e]);
    }
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* km, void* dq, int B, int H, int Tq, int Tk,
                      int D, float scale, int causal, cudaStream_t s) {
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(dout);
  T* out = static_cast<T*>(dq);
  switch (D) {
    case 32:
      flash_bwd_dq_kernel<T, 32><<<grid, THREADS, 0, s>>>(qq, kk, vv, gg, lse, delta, km, out, H, Tq, Tk, scale, causal);
      break;
    case 64:
      flash_bwd_dq_kernel<T, 64><<<grid, THREADS, 0, s>>>(qq, kk, vv, gg, lse, delta, km, out, H, Tq, Tk, scale, causal);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* km, void* dk, void* dv, int B, int H,
                       int Tq, int Tk, int D, float scale, int causal,
                       cudaStream_t s) {
  const dim3 grid(B * H, (Tk + BKV - 1) / BKV);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(dout);
  T* ok = static_cast<T*>(dk);
  T* ov = static_cast<T*>(dv);
  switch (D) {
    case 32:
      flash_bwd_dkv_kernel<T, 32><<<grid, THREADS, 0, s>>>(qq, kk, vv, gg, lse, delta, km, ok, ov, H, Tq, Tk, scale, causal);
      break;
    case 64:
      flash_bwd_dkv_kernel<T, 64><<<grid, THREADS, 0, s>>>(qq, kk, vv, gg, lse, delta, km, ok, ov, H, Tq, Tk, scale, causal);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* key_mask, void* dq,
                            int B, int H, int Tq, int Tk, int D, float scale,
                            int causal, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* km = static_cast<const float*>(key_mask);
  const cudaError_t err =
      is_bf16 ? launch_dq<__nv_bfloat16>(q, k, v, dout, l, dl, km, dq, B, H, Tq, Tk, D, scale, causal, s)
              : launch_dq<float>(q, k, v, dout, l, dl, km, dq, B, H, Tq, Tk, D, scale, causal, s);
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* key_mask,
                             void* dk, void* dv, int B, int H, int Tq, int Tk,
                             int D, float scale, int causal, int is_bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* km = static_cast<const float*>(key_mask);
  const cudaError_t err =
      is_bf16 ? launch_dkv<__nv_bfloat16>(q, k, v, dout, l, dl, km, dk, dv, B, H, Tq, Tk, D, scale, causal, s)
              : launch_dkv<float>(q, k, v, dout, l, dl, km, dk, dv, B, H, Tq, Tk, D, scale, causal, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
