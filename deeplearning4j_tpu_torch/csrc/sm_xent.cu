// Fused softmax cross-entropy: per-row loss and the logits' gradient.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py, _sm_xent_kernel (:650;
// the pallas_call in softmax_cross_entropy at :678; used by ops/losses.py
// mcxent through the _fused_sm_xent_per custom_vjp).
//
// Computes, for logits x and dense labels y of shape [N, C], row by row and in
// float32: m = max x, z = sum exp(x - m), logp = x - m - log z,
// loss = -sum y * logp (float32) and grad = exp(x - m) / z - y, written in the
// logits' dtype (float32 or bfloat16). Labels may be float32 or bfloat16.
//
// What bounds it on the H100: bytes. Each element is read from the logits and
// the labels and written to the gradient, for a handful of operations:
// 3 * N * C * elt + 4 * N bytes at 3.35 TB/s (N = 4096, C = 256, float32:
// 12.6 MB, 0.0038 ms).
//
// What the design does about it. The route, the rows of a block, the grid and
// the vector width come from ops/softmax_xent.py sm_xent_plan; the launch
// refuses a plan it has no instantiation for.
// - A warp a row where the row fits in a lane's registers (C <= 2,048: at
//   most 64 values a lane). 8 warps a block take 8 rows; the grid covers N.
//   The row is read once into registers, a lane taking chunks l, l + 32, ...
//   of VW neighbouring elements: 16-byte loads for float32 (8-byte for
//   bfloat16) where C and the pointers allow, else element by element in the
//   same layout. The labels are loaded beside the logits, before any
//   reduction, so both are in flight at once. Max and sum come from warp
//   shuffles (no shared memory, no __syncthreads); the gradient is written
//   from registers and the loss comes from a shuffle sum. C = 256 float32 is
//   two 16-byte loads of each operand a lane; C = 64 (char_rnn) one 8-byte
//   load, every lane busy.
// - Wide rows (a vocab of 50,257) keep a block per row: a running max and
//   sum of exponentials per thread, merged across the block, then a second
//   pass over the row, which the block has just brought into L1/L2.
// Every sum runs in a fixed order (a lane's elements in chunk order, then a
// shuffle tree whose lane-0 result every lane takes), so the result is
// bitwise the same from run to run.

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

// ---------------------------------------------------------------- a warp a row
template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<2> { using type = uint16_t; };

// VW neighbouring elements at p (VW * sizeof(T) bytes aligned when vec)
template <typename T, int VW>
__device__ __forceinline__ void load(const T* p, bool vec, float* out) {
  if (vec) {
    using V = typename Vec<VW * sizeof(T)>::type;
    const V raw = __ldcs(reinterpret_cast<const V*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VW; ++k) out[k] = to_f32(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VW; ++k) out[k] = to_f32(p[k]);
  }
}

template <typename T, int VW>
__device__ __forceinline__ void save(T* p, bool vec, const float* v) {
  if (vec) {
    using V = typename Vec<VW * sizeof(T)>::type;
    V raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < VW; ++k) store(e + k, v[k]);
    __stcs(reinterpret_cast<V*>(p), raw);
  } else {
#pragma unroll
    for (int k = 0; k < VW; ++k) store(p + k, v[k]);
  }
}

// lane 0's result of a fixed shuffle tree, in every lane
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return __shfl_sync(0xffffffffu, x, 0);
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// E values a lane at most (NV chunks of VW); C % VW == 0 (the plan's rule).
// The labels' dtype is a run-time flag (uniform across the grid), which
// halves the instantiations.
template <typename TX, int VW, int E>
__global__ void __launch_bounds__(THREADS)
sm_xent_warp_kernel(const TX* __restrict__ logits, const void* __restrict__ labels,
                    int labels_bf16, float* __restrict__ loss,
                    TX* __restrict__ grad, int N, int C, int vec) {
  constexpr int NV = E / VW;
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= (size_t)N) return;  // the whole warp
  const TX* x = logits + row * C;
  const float* yf = static_cast<const float*>(labels) + row * C;
  const __nv_bfloat16* yb = static_cast<const __nv_bfloat16*>(labels) + row * C;
  TX* g = grad + row * C;
  const int chunks = C / VW;
  const bool v = vec != 0;

  float xv[NV][VW], yv[NV][VW];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int ch = lane + 32 * i;
    if (ch < chunks) {
      load<TX, VW>(x + ch * VW, v, xv[i]);
      if (labels_bf16)
        load<__nv_bfloat16, VW>(yb + ch * VW, v, yv[i]);
      else
        load<float, VW>(yf + ch * VW, v, yv[i]);
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < chunks)
#pragma unroll
      for (int k = 0; k < VW; ++k) m = fmaxf(m, xv[i][k]);
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < chunks)
#pragma unroll
      for (int k = 0; k < VW; ++k) s += expf(xv[i][k] - m);
  s = warp_sum(s);
  const float log_z = logf(s);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int ch = lane + 32 * i;
    if (ch < chunks) {
      float gv[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        gv[k] = expf(xv[i][k] - m) / s - yv[i][k];
        acc += yv[i][k] * (xv[i][k] - m - log_z);
      }
      save<TX, VW>(g + ch * VW, v, gv);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) loss[row] = -acc;
}

// -------------------------------------------------------------- a block a row
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
sm_xent_block_kernel(const TX* __restrict__ logits, const TY* __restrict__ labels,
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

// ------------------------------------------------------------------ launches
struct Plan {
  int warp_route, rows, grid, vw, per_lane;
};

template <typename TX, int VW, int E>
cudaError_t launch_warp(const void* x, const void* y, int ybf, float* loss,
                        void* g, int N, int C, int vec, int grid,
                        cudaStream_t st) {
  sm_xent_warp_kernel<TX, VW, E><<<grid, THREADS, 0, st>>>(
      static_cast<const TX*>(x), y, ybf, loss, static_cast<TX*>(g), N, C, vec);
  return cudaGetLastError();
}

template <typename TX, int VW>
cudaError_t launch_e(const void* x, const void* y, int ybf, float* loss,
                     void* g, int N, int C, int vec, const Plan& p,
                     cudaStream_t st) {
  switch (p.per_lane) {
    case 2: if constexpr (VW <= 2) return launch_warp<TX, VW, 2>(x, y, ybf, loss, g, N, C, vec, p.grid, st); break;
    case 4: return launch_warp<TX, VW, 4>(x, y, ybf, loss, g, N, C, vec, p.grid, st);
    case 8: return launch_warp<TX, VW, 8>(x, y, ybf, loss, g, N, C, vec, p.grid, st);
    case 16: return launch_warp<TX, VW, 16>(x, y, ybf, loss, g, N, C, vec, p.grid, st);
    case 32: return launch_warp<TX, VW, 32>(x, y, ybf, loss, g, N, C, vec, p.grid, st);
    case 64: return launch_warp<TX, VW, 64>(x, y, ybf, loss, g, N, C, vec, p.grid, st);
    default: break;
  }
  return cudaErrorInvalidValue;
}

template <typename TX, typename TY>
cudaError_t launch(const void* x, const void* y, float* loss, void* g, int N,
                   int C, const Plan& p, cudaStream_t st) {
  if (!p.warp_route) {
    if (p.rows != 1 || p.grid != N) return cudaErrorInvalidValue;
    sm_xent_block_kernel<TX, TY><<<N, THREADS, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const TY*>(y), loss,
        static_cast<TX*>(g), C);
    return cudaGetLastError();
  }
  if (p.rows != WARPS || p.grid != (N + WARPS - 1) / WARPS || C % p.vw != 0
      || p.per_lane < p.vw || (C / p.vw + 31) / 32 * p.vw > p.per_lane)
    return cudaErrorInvalidValue;
  // 16-byte (float32) or 8-byte (bfloat16) accesses where every row start
  // is aligned to the vector; else element by element in the same layout
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g);
  const int vec = a % (p.vw * sizeof(TX)) == 0
                  && reinterpret_cast<uintptr_t>(y) % (p.vw * sizeof(TY)) == 0;
  const int ybf = sizeof(TY) == 2;
  switch (p.vw) {
    case 1: return launch_e<TX, 1>(x, y, ybf, loss, g, N, C, vec, p, st);
    case 2: return launch_e<TX, 2>(x, y, ybf, loss, g, N, C, vec, p, st);
    case 4: return launch_e<TX, 4>(x, y, ybf, loss, g, N, C, vec, p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int sm_xent(const void* logits, const void* labels, void* loss,
                       void* grad, int N, int C, int logits_bf16,
                       int labels_bf16, int warp_route, int rows, int grid,
                       int vw, int per_lane, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(loss);
  const Plan p{warp_route, rows, grid, vw, per_lane};
  cudaError_t err;
  if (logits_bf16) {
    err = labels_bf16
              ? launch<__nv_bfloat16, __nv_bfloat16>(logits, labels, l, grad, N, C, p, st)
              : launch<__nv_bfloat16, float>(logits, labels, l, grad, N, C, p, st);
  } else {
    err = labels_bf16
              ? launch<float, __nv_bfloat16>(logits, labels, l, grad, N, C, p, st)
              : launch<float, float>(logits, labels, l, grad, N, C, p, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
