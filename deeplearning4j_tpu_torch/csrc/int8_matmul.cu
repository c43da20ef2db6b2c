// Weight-only int8 matmul for the decode step.
//
// Replaces: deeplearning4j_tpu/ops/quant.py, _int8_matmul_kernel (the
// pallas_call in _int8_matmul_pallas at :157; entry quantized_matmul).
//
// Computes out[m, n] = scale[n] * sum_k x[m, k] * float(q[k, n]) with float32
// accumulation and a float32 output. x is float32 or bfloat16, q is int8 in
// the JAX [K, N] layout, scale is float32 per output channel.
//
// What bounds it on the H100: bytes. Decode calls it with M = slot capacity
// (2..16), so the int8 weight (K*N bytes) is nearly all the traffic and the
// work is 2*M operations per weight byte, far below the ~20 float32 ops per
// byte at which the H100's CUDA cores, not its memory, would be the limit.
//
// What the design does about it: the dequantized weight never exists in
// device memory. Each int8 code is read once, widened in a register, and the
// per-channel scale multiplies the float32 accumulator once, at the end (the
// TPU kernel's point, quant.py:134-141). A block owns BN = 64 output columns
// and BM = 8 rows. Its 8 warps split K; each lane owns 2 neighbouring columns,
// so a warp reads 64 consecutive bytes of one weight row per step. x is staged
// through shared memory, KC = 128 values of k at a time, and read there as a
// broadcast. The warps' partial sums are reduced in shared memory in a fixed
// order, so results do not change from run to run. Ragged M, K and N are
// masked, so any shape is taken. Tensor cores and wider loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;
constexpr int BM = 8;
constexpr int WARPS = 8;
constexpr int KC = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int K, int N) {
  __shared__ float xs[BM][KC];
  __shared__ float red[WARPS][BM][BN];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * BN + lane * 2;
  const int m0 = blockIdx.y * BM;

  float acc[BM][2];
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    acc[m][0] = 0.f;
    acc[m][1] = 0.f;
  }

  for (int kc = 0; kc < K; kc += KC) {
    for (int i = tid; i < BM * KC; i += WARPS * 32) {
      const int m = i / KC;
      const int k = i % KC;
      const int gm = m0 + m;
      const int gk = kc + k;
      xs[m][k] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    __syncthreads();
    for (int k = warp; k < KC; k += WARPS) {
      const int gk = kc + k;
      if (gk >= K) break;
      const int8_t* row = q + (size_t)gk * N;
      const float w0 = n0 < N ? (float)row[n0] : 0.f;
      const float w1 = n0 + 1 < N ? (float)row[n0 + 1] : 0.f;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xv = xs[m][k];
        acc[m][0] = fmaf(xv, w0, acc[m][0]);
        acc[m][1] = fmaf(xv, w1, acc[m][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < BM; ++m) {
    red[warp][m][lane * 2] = acc[m][0];
    red[warp][m][lane * 2 + 1] = acc[m][1];
  }
  __syncthreads();
  for (int i = tid; i < BM * BN; i += WARPS * 32) {
    const int m = i / BN;
    const int c = i % BN;
    const int gm = m0 + m;
    const int gn = blockIdx.x * BN + c;
    if (gm < M && gn < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][m][c];
      out[(size_t)gm * N + gn] = s * scale[gn];
    }
  }
}

}  // namespace

extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* out, int M, int K, int N, int x_bf16,
                           void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  } else {
    int8_matmul_kernel<float><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
