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
// The one rule: a row's arithmetic is fixed by K alone. Every output
// element is summed in this order, whatever M, the tile, the element's
// place in it or the grid:
// - K is cut into chunks of CHUNK = 32 rows from k = 0; the last chunk is
//   padded with zeros (a zero product adds exactly 0).
// - Within a chunk, one tensor-core accumulator chain starts from 0 and
//   takes the chunk's 8-deep steps in order; each step adds three split-TF32
//   products in the order hi.lo, lo.hi, hi.hi (tf32_mma.cuh: mma3's order),
//   each operand's hi rounded to nearest.
// - Each chunk's partial is added to a float32 total with an ordinary add,
//   in chunk order from 0.
// No split-K, no reduction across threads or blocks, no data-dependent path.
// The tensor core truncates its float32 accumulator after each step; one
// chain over K = 1,024 drifts past 2e-5 of float32 at unit-scale outputs,
// while chains of 32 stay well inside it (tests/test_torch_kernel_design.py
// emulates both).
//
// What bounds it on the H100: operations. At the pin's shapes (K 256 or
// 1,024, N 256 to 1,024, M 1,024 to 4,096) the work is 2*M*N*K flops on
// 4*(M*K + K*N + M*N) bytes, far above the card's ridge; run as three TF32
// passes the bound is 3 * 2*M*N*K over 495 TFLOP/s, against 2*M*N*K over
// 67 TFLOP/s on the float32 CUDA cores.
//
// What the design does about it:
// - Split TF32 on the tensor cores (mma.sync m16n8k8): each operand x is
//   split into hi = tf32(x), rounded to nearest, and lo = tf32(x - hi)
//   (split_rn below) as its fragment is read from shared memory, and
//   hi.lo + lo.hi + hi.hi keeps float32's accuracy (the dropped lo.lo is
//   below 2^-22 of the product). The three passes are
//   issued pass by pass over a warp's tiles, which gives each pass 8
//   independent products in flight and leaves every element's order as
//   above.
// - A block owns a BM x BN tile of C; its warps own WM x WN tiles of it
//   (16 x 8 mma tiles). The tile is chosen by ops/fixed_matmul.py
//   fixed_matmul_plan from N and the SM count alone, never from M, and
//   the launch refuses a plan whose shared-memory bytes differ from the
//   instantiation's. The grid is M tiles by N tiles.
// - A and B tiles of BK = 32 rows of K come in by 16-byte cp.async into a
//   ring of STAGES slots in dynamic shared memory (above 48 KB after
//   cudaFuncSetAttribute), STAGES - 1 tiles ahead of the one in use, one
//   __syncthreads a tile. A rows are padded to BK + 4 floats and B rows to
//   BN + 8, so both fragment reads (A at row g, column t; B at row t,
//   column g) hit 32 distinct banks.
// - Ragged edges: rows of A past M, columns of B past N and rows past K are
//   zero-filled by cp.async (its source-size form); when K or N is no
//   multiple of 4, or an operand is not 16-byte aligned, every element is
//   copied by a 4-byte cp.async instead, into the same layout. Rows and
//   columns past the edge are never stored.
// - wgmma and TMA are left for a later design: wgmma's TF32 form takes both
//   operands K-major from shared memory, and B arrives [K, N] row-major, so
//   it would need a transposed copy of every B tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int BK = 32;     // rows of K a stage
constexpr int CHUNK = 32;  // rows of K a tensor-core accumulator chain
constexpr int A_LD = BK + 4;
static_assert(CHUNK == BK, "a stage is one chunk: its partial is added "
                           "to the total after the stage");

template <int BM, int BN, int STAGES>
constexpr int smem_bytes() {
  return STAGES * (BM * A_LD + BK * (BN + 8)) * 4;
}

// x = hi + lo: hi is x rounded to TF32 to nearest (ties away from zero:
// add half of the 13 dropped bits' range, then drop them), lo is x - hi
// (exact) truncated to TF32. tf32_mma.cuh's split truncates hi too, which
// leaves hi + lo short of x by up to 2^-21 of it, always toward zero: a
// short dot product adds those up (a two-input graph's pin, K = 12: 1.2e-6
// from cuBLAS's float32 on the H100). Rounded, hi leaves a remainder of either sign, and hi + lo
// is within 2^-22 of x on either side. A value within 2^-12 of float32's
// largest rounds its hi to infinity.
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int BN, int WM, int WN, int STAGES, bool VEC>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
fixed_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ C, int M, int N, int K) {
  constexpr int WARPS_N = BN / WN;
  constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int B_LD = BN + 8;
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 8 == 0,
                "warp tiles of whole mma tiles cover the block");
  static_assert((BM * BK / 4) % THREADS == 0 && (BK * BN / 4) % THREADS == 0,
                "every thread copies as many 16-byte chunks");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                       // [STAGES][BM][A_LD]
  float* Bs = smem + STAGES * BM * A_LD;  // [STAGES][BK][B_LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int ktiles = (K + BK - 1) / BK;

  auto load = [&](int kt, int slot) {
    const int k0 = kt * BK;
    float* as = As + slot * BM * A_LD;
    float* bs = Bs + slot * BK * B_LD;
    if constexpr (VEC) {
#pragma unroll
      for (int it = 0; it < BM * (BK / 4) / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
        const int gm = row0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        cp_async16(as + r * A_LD + c, ok ? A + (size_t)gm * K + gk : A, ok);
      }
#pragma unroll
      for (int it = 0; it < BK * (BN / 4) / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const int gk = k0 + r, gn = col0 + c;
        const bool ok = gk < K && gn < N;
        cp_async16(bs + r * B_LD + c, ok ? B + (size_t)gk * N + gn : B, ok);
      }
    } else {
#pragma unroll 4
      for (int it = 0; it < BM * BK / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / BK, c = i % BK;
        const int gm = row0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        cp_async4(as + r * A_LD + c, ok ? A + (size_t)gm * K + gk : A, ok);
      }
#pragma unroll 4
      for (int it = 0; it < BK * BN / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / BN, c = i % BN;
        const int gk = k0 + r, gn = col0 + c;
        const bool ok = gk < K && gn < N;
        cp_async4(bs + r * B_LD + c, ok ? B + (size_t)gk * N + gn : B, ok);
      }
    }
  };

  float total[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) total[i][j][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt has landed; slot (kt - 1) % STAGES is free
    {
      const int nk = kt + STAGES - 1;
      if (nk < ktiles) load(nk, nk % STAGES);
      cp_async_commit();
    }
    const float* as = As + (kt % STAGES) * BM * A_LD + wm * A_LD;
    const float* bs = Bs + (kt % STAGES) * BK * B_LD + wn;

    // this chunk's chain, from 0
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = as + (i * 16 + g) * A_LD + kk + t;
        split_rn(p[0], ah[i][0], al[i][0]);
        split_rn(p[8 * A_LD], ah[i][1], al[i][1]);
        split_rn(p[4], ah[i][2], al[i][2]);
        split_rn(p[8 * A_LD + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = bs + (kk + t) * B_LD + j * 8 + g;
        split_rn(p[0], bh[j][0], bl[j][0]);
        split_rn(p[4 * B_LD], bh[j][1], bl[j][1]);
      }
      // mma3's order for every element: hi.lo, lo.hi, then hi.hi
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma(acc[i][j], ah[i][0], ah[i][1], ah[i][2], ah[i][3], bl[j][0],
              bl[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma(acc[i][j], al[i][0], al[i][1], al[i][2], al[i][3], bh[j][0],
              bh[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma(acc[i][j], ah[i][0], ah[i][1], ah[i][2], ah[i][3], bh[j][0],
              bh[j][1]);
    }
    // the chunk's partial into the total: an ordinary float32 add
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) total[i][j][r] += acc[i][j][r];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + wm + i * 16 + g + 8 * h;
      if (gm >= M) continue;
      float* crow = C + (size_t)gm * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int gn = col0 + wn + j * 8 + 2 * t;
        const float v0 = total[i][j][2 * h], v1 = total[i][j][2 * h + 1];
        if constexpr (VEC) {
          if (gn < N) *reinterpret_cast<float2*>(crow + gn) = make_float2(v0, v1);
        } else {
          if (gn < N) crow[gn] = v0;
          if (gn + 1 < N) crow[gn + 1] = v1;
        }
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, int STAGES, bool VEC>
cudaError_t launch_vec(const float* a, const float* b, float* c, int M,
                       int N, int K, cudaStream_t s) {
  constexpr int bytes = smem_bytes<BM, BN, STAGES>();
  // the attribute is a device's: set once on each (idempotent, so a race
  // only sets it twice)
  constexpr int MAX_DEVICES = 64;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES || !attr_set[dev]) {
    err = cudaFuncSetAttribute(
        fixed_matmul_kernel<BM, BN, WM, WN, STAGES, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) attr_set[dev] = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fixed_matmul_kernel<BM, BN, WM, WN, STAGES, VEC>
      <<<grid, (BM / WM) * (BN / WN) * 32, bytes, s>>>(a, b, c, M, N, K);
  return cudaGetLastError();
}

template <int BM, int BN, int WM, int WN, int STAGES>
cudaError_t launch(const float* a, const float* b, float* c, int M, int N,
                   int K, int smem, cudaStream_t s) {
  if (smem != smem_bytes<BM, BN, STAGES>()) return cudaErrorInvalidValue;
  if ((long long)(N + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
  // 16-byte copies need whole 16-byte chunks of rows at aligned addresses
  const bool vec = K % 4 == 0 && N % 4 == 0
                   && reinterpret_cast<uintptr_t>(a) % 16 == 0
                   && reinterpret_cast<uintptr_t>(b) % 16 == 0
                   && reinterpret_cast<uintptr_t>(c) % 8 == 0;
  return vec ? launch_vec<BM, BN, WM, WN, STAGES, true>(a, b, c, M, N, K, s)
             : launch_vec<BM, BN, WM, WN, STAGES, false>(a, b, c, M, N, K, s);
}

}  // namespace

// The tile comes from ops/fixed_matmul.py fixed_matmul_plan; a tile that is
// not instantiated here is refused. The kernel runs on `device`, made
// current for the launch when it is not (the caller's device is restored).
extern "C" int fixed_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, int bm, int bn, int wm, int wn,
                            int stages, int smem, int device, void* stream) {
  const float* aa = static_cast<const float*>(a);
  const float* bb = static_cast<const float*>(b);
  float* cc = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaErrorInvalidValue;
#define FIXED_MM_TILE(BM_, BN_, WM_, WN_, ST_)                             \
  if (bm == BM_ && bn == BN_ && wm == WM_ && wn == WN_ && stages == ST_) \
    err = launch<BM_, BN_, WM_, WN_, ST_>(aa, bb, cc, M, N, K, smem, s);  \
  else
  FIXED_MM_TILE(64, 128, 32, 64, 3)
  FIXED_MM_TILE(64, 64, 32, 32, 3)
  FIXED_MM_TILE(64, 32, 16, 32, 4)
  {}
#undef FIXED_MM_TILE
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
