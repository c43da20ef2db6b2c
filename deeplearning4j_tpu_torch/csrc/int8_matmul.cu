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
// At decode sizes (64 KB to 256 KB of weight) the time is latency: how many
// loads are in flight at once, on how many SMs.
//
// What the design does about it:
// - The dequantized weight never exists in device memory. Each int8 code is
//   read once, widened in a register, and the per-channel scale multiplies
//   the float32 sum once, after the whole K (the TPU kernel's point,
//   quant.py:134-141).
// - A block owns BN = 64 output columns and BM = 4 rows of x, and one slice
//   of K. Its 128 threads are 4 along N by 32 along K: each thread loads 16
//   consecutive codes of a weight row as one 16-byte load (neighbouring
//   threads read neighbouring 16-byte chunks) and widens them in registers.
//   Where a row is not 16-byte aligned (N % 16 != 0, or an unaligned q) or
//   at the ragged N edge, the same thread reads its codes one by one.
// - Split K: the wrapper's plan (ops/quant.py, int8_matmul_plan) cuts K into
//   S slices of kc rows so that the grid (N tiles x M tiles x S) reaches the
//   SM count at every decode shape. A thread issues its weight loads of a
//   chunk first; the slice of x then goes through shared memory (16-byte
//   loads where aligned) and is read there as a broadcast.
// - The 32 thread rows of a block are summed in shared memory in a fixed
//   order. With S > 1 each block writes its partial tile to a float32
//   scratch [S, M, N]; the last block of a tile to arrive (a counter per
//   tile, reset by that block) sums the S partials in slice order, so the
//   result is bitwise the same from run to run whatever the arrival order.
// - Any M, K and N is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;
constexpr int BM = 4;
constexpr int VEC = 16;             // codes a thread loads at once
constexpr int TN = BN / VEC;        // threads along N
constexpr int THREADS = 128;
constexpr int TK = THREADS / TN;    // threads along K
constexpr int KC = 128;             // rows of x staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void widen(uint32_t word, float* w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = (float)(int8_t)(word >> (8 * i));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   float* __restrict__ part, unsigned* __restrict__ counters,
                   int M, int K, int N, int kc, int vec_q, int vec_x) {
  __shared__ __align__(16) float xs[BM][KC];
  __shared__ __align__(16) float red[TK][BM][BN];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int tk = tid / TN;
  const int nb = blockIdx.x * BN;
  const int n0 = nb + tn * VEC;
  const int m0 = blockIdx.y * BM;
  const int slice = blockIdx.z;
  const int S = gridDim.z;
  const int k_beg = slice * kc;
  const int k_stop = min(K, k_beg + kc);

  float acc[BM][VEC];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

  const bool vec = vec_q && n0 + VEC <= N;
  for (int k0 = k_beg; k0 < k_stop; k0 += KC) {
    const int len = min(KC, k_stop - k0);
    // this thread's weight rows of the chunk, in flight while x is staged
    uint4 wv[KC / TK];
#pragma unroll
    for (int i = 0; i < KC / TK; ++i) {
      const int k = tk + i * TK;
      wv[i] = (vec && k < len)
          ? __ldg(reinterpret_cast<const uint4*>(q + (size_t)(k0 + k) * N + n0))
          : make_uint4(0u, 0u, 0u, 0u);
    }
    if (vec_x && k0 % 4 == 0) {
      for (int i = tid; i < BM * (KC / 4); i += THREADS) {
        const int m = i / (KC / 4);
        const int kk = (i % (KC / 4)) * 4;
        const int gm = m0 + m;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gm < M && kk + 3 < len) {
          val = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(x) + (size_t)gm * K + k0 + kk);
        } else if (gm < M) {
          const float* xr = reinterpret_cast<const float*>(x) + (size_t)gm * K + k0;
          if (kk < len) val.x = xr[kk];
          if (kk + 1 < len) val.y = xr[kk + 1];
          if (kk + 2 < len) val.z = xr[kk + 2];
        }
        *reinterpret_cast<float4*>(&xs[m][kk]) = val;
      }
    } else {
      for (int i = tid; i < BM * KC; i += THREADS) {
        const int m = i / KC;
        const int kk = i % KC;
        const int gm = m0 + m;
        xs[m][kk] = (gm < M && kk < len) ? to_f32(x[(size_t)gm * K + k0 + kk]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KC / TK; ++i) {
      const int k = tk + i * TK;
      if (k >= len) break;
      const int8_t* row = q + (size_t)(k0 + k) * N;
      float w[VEC];
      if (vec) {
        widen(wv[i].x, w);
        widen(wv[i].y, w + 4);
        widen(wv[i].z, w + 8);
        widen(wv[i].w, w + 12);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) w[c] = n0 + c < N ? (float)row[n0 + c] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xv = xs[m][k];
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < VEC; c += 4)
      *reinterpret_cast<float4*>(&red[tk][m][tn * VEC + c]) =
          make_float4(acc[m][c], acc[m][c + 1], acc[m][c + 2], acc[m][c + 3]);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = i / BN;
    const int c = i % BN;
    const int gm = m0 + m;
    const int gn = nb + c;
    if (gm >= M || gn >= N) continue;
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < TK; ++r) s += red[r][m][c];
    if (S == 1) out[(size_t)gm * N + gn] = s * scale[gn];
    else part[((size_t)slice * M + gm) * N + gn] = s;
  }
  if (S == 1) return;

  // the last block of this tile sums the S partials in slice order
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(&counters[tile], 1u) == (unsigned)(S - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int gm = m0 + i / BN;
    const int gn = nb + i % BN;
    if (gm >= M || gn >= N) continue;
    const float* p = part + (size_t)gm * N + gn;
    const size_t stride = (size_t)M * N;
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < S; ++r) s += __ldcg(p + r * stride);
    out[(size_t)gm * N + gn] = s * scale[gn];
  }
  if (tid == 0) counters[tile] = 0u;
}

}  // namespace

extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* out, void* part, void* counters, int M, int K,
                           int N, int kc, int slices, int x_bf16,
                           void* stream) {
  if (kc < 1 || slices < 1 || (slices > 1 && (!part || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec_q = N % VEC == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int vec_x = !x_bf16 && K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  float* pp = static_cast<float*>(part);
  unsigned* cc = static_cast<unsigned*>(counters);
  if (x_bf16) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), pp, cc,
        M, K, N, kc, vec_q, 0);
  } else {
    int8_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), pp, cc,
        M, K, N, kc, vec_q, vec_x);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
