// Fused softmax cross-entropy: per-row loss and the logits' gradient.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py, _sm_xent_kernel (the
// pallas_call in softmax_cross_entropy at :678; used by ops/losses.py mcxent
// through the _fused_sm_xent_per custom_vjp).
//
// Computes, for logits x and dense labels y of shape [N, C], row by row and in
// float32: m = max x, z = sum exp(x - m), logp = x - m - log z,
// loss = -sum y * logp (float32) and grad = exp(x - m) / z - y, written in the
// logits' dtype (float32 or bfloat16). Labels may be float32 or bfloat16.
//
// What bounds it on the H100: bytes. Each element is read from the logits and
// the labels and written to the gradient, for a handful of operations.
//
// What the design does about it: one block per row, so any C is taken (a vocab
// of 50,257 loops 197 times over the block's 256 threads). The first pass
// keeps a running max and a running sum of exponentials per thread (rescaled
// when the max grows) and merges them across the block; the second pass
// re-reads the row, which a block has just brought into L1/L2, writes the
// gradient and sums the loss. Every sum runs in a fixed order, so the result
// is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// (m, s) pairs: s is a sum of exp(x - m). Merging keeps the larger max.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(THREADS)
sm_xent_kernel(const TX* __restrict__ logits, const TY* __restrict__ labels,
               float* __restrict__ loss, TX* __restrict__ grad, int C) {
  __shared__ float red_m[WARPS];
  __shared__ float red_s[WARPS];
  const size_t row = blockIdx.x;
  const TX* x = logits + row * C;
  const TY* y = labels + row * C;
  TX* g = grad + row * C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // pass 1: running max and sum of exponentials
  float m = -INFINITY, s = 0.f;
  for (int c = tid; c < C; c += THREADS) {
    const float v = to_f32(x[c]);
    if (v > m) {
      s = (m == -INFINITY ? 0.f : s * expf(m - v)) + 1.f;
      m = v;
    } else if (m != -INFINITY) {
      s += expf(v - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
  for (int w = 1; w < WARPS; ++w) merge(m, s, red_m[w], red_s[w]);
  const float log_z = logf(s);
  __syncthreads();  // red_* is reused below

  // pass 2: gradient and loss
  float acc = 0.f;
  for (int c = tid; c < C; c += THREADS) {
    const float v = to_f32(x[c]);
    const float t = to_f32(y[c]);
    const float e = expf(v - m);
    store(g + c, e / s - t);
    acc += t * (v - m - log_z);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) red_s[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < WARPS; ++w) total += red_s[w];
    loss[row] = -total;
  }
}

template <typename TX, typename TY>
cudaError_t launch(const void* logits, const void* labels, float* loss,
                   void* grad, int N, int C, cudaStream_t st) {
  sm_xent_kernel<TX, TY><<<N, THREADS, 0, st>>>(
      static_cast<const TX*>(logits), static_cast<const TY*>(labels), loss,
      static_cast<TX*>(grad), C);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sm_xent(const void* logits, const void* labels, void* loss,
                       void* grad, int N, int C, int logits_bf16,
                       int labels_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(loss);
  cudaError_t err;
  if (logits_bf16) {
    err = labels_bf16
              ? launch<__nv_bfloat16, __nv_bfloat16>(logits, labels, l, grad, N, C, st)
              : launch<__nv_bfloat16, float>(logits, labels, l, grad, N, C, st);
  } else {
    err = labels_bf16
              ? launch<float, __nv_bfloat16>(logits, labels, l, grad, N, C, st)
              : launch<float, float>(logits, labels, l, grad, N, C, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
