// Float32 matmul whose answer for a row does not depend on the row count.
//
// Replaces no TPU kernel: the serving pin's dense products, which the JAX
// package leaves to XLA (deeplearning4j_tpu/nn/conf/layers/feedforward.py,
// policy_matmul). cuBLAS picks its algorithm (tile shape, split-K) by M, so
// one row of [M, K] @ [K, N] comes out with other float32 bits at another M.
// A serving pin that cuts a batch over data slots then parts from the whole
// pin in the last bits. This kernel is run by the pins only
// (nn/inference.py); training keeps cuBLAS.
//
// Computes C[m, n] = sum_k A[m, k] * B[k, n], A [M, K] and B [K, N]
// row-major float32, C [M, N] float32.
//
// The one rule: every output element is one chain of fmaf over k = 0, 1,
// ..., K - 1 from 0.0f, in one thread, whatever M, the block or the
// thread's place in it. No split-K, no reduction across threads, no
// data-dependent path. The K tail of the last tile is padded with zeros
// (fmaf(0, b, acc) leaves acc's value), the same at every M.
//
// What bounds it on the H100: operations. At the pin's shapes (K 256 or
// 1,024, N 256 to 1,024, M 512 to 4,096) the work is 2*M*N*K flops on
// 4*(M*K + K*N + M*N) bytes, well over the ~20 flops a byte where the
// float32 CUDA cores, not the memory, set the pace. The design is the
// classic shared-memory tiling: a block owns a 64 x 64 tile of C and walks
// K in steps of 16; its 256 threads each hold a 4 x 4 tile of
// accumulators in registers, reading 4 values of A and 4 of B from shared
// memory for 16 fmaf. A simple kernel that is right comes first: no
// tensor cores (TF32 would round the operands), no cp.async, no
// double-buffering.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
fixed_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[BK][BM];  // A's tile, k-major
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
    }
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int fixed_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fixed_matmul_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
