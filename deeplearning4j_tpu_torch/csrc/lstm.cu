// The persistent LSTM cell, forward and backward, over a whole sequence.
//
// Replaces: deeplearning4j_tpu/ops/lstm.py, _lstm_fwd_kernel (the pallas_call
// in _pallas_forward at :486) and _lstm_bwd_kernel (the pallas_call in
// _pallas_backward at :539).
//
// Forward, for t = 0..T-1, gate order i, f, g, o, float32:
//   z = [x_t, h] Wcat + b;  zi += c pI;  zf += c pF  (with peepholes)
//   c' = sig(zf) c + sig(zi) tanh(zg);  zo += c' pO;  h' = sig(zo) tanh(c')
//   a masked step (m_t[b] <= 0) keeps h and c and still writes them out;
//   outputs ys[t] = h', cs[t] = c', and the final h, c.
// Backward, for t = T-1..0: recompute the gates from the saved h_{t-1}/c_{t-1},
// form dz_t from dh = dy_t + dh_carry and dc (a masked step passes dh and dc
// straight through to t-1), carry dh_{t-1} = dz_t RW^T + pass-through and
// dc_{t-1}, seeded from dht/dct. Then dW = sum_t [x_t, h_{t-1}]^T dz_t,
// db = sum dz, dpeep, and dx = dz W_x^T.
//
// What bounds it on the H100: neither bytes nor operations. At char_rnn's
// widths (B 32, H 200, F 64 or 200) a step is ~10 MFLOP and the whole chunk's
// bound is a few microseconds; the recurrence makes T dependent steps, each
// of which needs every block's h_{t-1}, so the time is T times the latency of
// one step: a grid-wide barrier plus an L2 round trip plus the block's share
// of the step's matmul.
//
// What the design does about it: one cooperative launch of G co-resident
// blocks runs the whole recurrence, so a step costs one grid.sync() and no
// kernel launch. Block g owns U hidden units j (U = ceil(H / SMs), so at most
// one block per SM) and keeps the i, f, g, o columns of Wcat for those units
// in shared memory for the whole sequence (the TPU kernel's resident weight);
// the cell update needs no exchange between blocks. Each step a block stages
// [x_t, h_{t-1}] (h_{t-1} from the previous step's ys row, read through L2)
// for a chunk of batch rows, computes z for its 4U columns, updates its units'
// c and h, and writes ys/cs. The backward uses the same ownership: phase (a)
// recomputes z, forms dz_t for the block's columns and stashes it [T, B, 4H];
// after one grid.sync() phase (b) forms dh_{t-1} for the block's units from
// every block's dz_t and the block's resident RW rows (a warp per output,
// lanes over the 4H columns, a shuffle sum). A second grid.sync() is not
// needed: the next step's phase (a) writes another stash slot than phase (b)
// reads. After the loop, plain launches on the same stream reduce the stash:
// a 64x64-tiled matmul for dW (two calls) and dx, and column sums for db and
// dpeep. Every sum runs in a fixed order, with no atomics, so results are the
// same from run to run. When the weight slices do not fit in shared memory
// (very wide layers) they are read from global memory (L2) instead; when
// even one batch row does not fit, or the grid cannot be co-resident, the
// launch is refused with an error.
//
// Build: grid.sync() needs a cooperative launch and, with this toolkit, no
// extra compiler flag (see ops/_cuda.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// shared memory one block may take (the card allows 227 KB)
constexpr size_t SMEM_LIMIT = 200 * 1024;
// the weight slices stay in shared memory up to this size
constexpr size_t W_SHARED_LIMIT = 128 * 1024;

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// Load the block's resident weight slices: Ws [K][4U] holds column q*H + j0 + u
// of Wcat at q*U + u; RWs [U][4H] (backward only) holds row F + j0 + u.
__device__ void load_slices(const float* __restrict__ wcat, float* Ws, float* RWs,
                            int F, int H, int U, int j0, int nu) {
  const int K = F + H, C4 = 4 * U;
  for (int idx = threadIdx.x; idx < K * C4; idx += THREADS) {
    const int k = idx / C4, c = idx % C4, q = c / U, u = c % U;
    Ws[idx] = u < nu ? wcat[(size_t)k * 4 * H + q * H + j0 + u] : 0.f;
  }
  if (RWs != nullptr) {
    for (int idx = threadIdx.x; idx < U * 4 * H; idx += THREADS) {
      const int u = idx / (4 * H), c = idx % (4 * H);
      RWs[idx] = u < nu ? wcat[(size_t)(F + j0 + u) * 4 * H + c] : 0.f;
    }
  }
}

// z = [x_t, h] W + b for staged rows xh [nb][K] and the block's 4U columns,
// into zs [nb][4U].
__device__ void block_z(const float* xh, const float* Ws, const float* __restrict__ wcat,
                        const float* __restrict__ bias, float* zs, int nb, int K,
                        int H, int U, int j0, int nu, int wsh) {
  const int C4 = 4 * U;
  for (int idx = threadIdx.x; idx < nb * C4; idx += THREADS) {
    const int r = idx / C4, c = idx % C4, q = c / U, u = c % U;
    if (u >= nu) continue;
    const int col = q * H + j0 + u;
    const float* xr = xh + (size_t)r * K;
    float acc = 0.f;
    if (wsh) {
      for (int k = 0; k < K; ++k) acc = fmaf(xr[k], Ws[k * C4 + c], acc);
    } else {
      for (int k = 0; k < K; ++k) acc = fmaf(xr[k], __ldg(&wcat[(size_t)k * 4 * H + col]), acc);
    }
    zs[idx] = acc + __ldg(&bias[col]);
  }
}

__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wcat,
                const float* __restrict__ bias, const float* __restrict__ peep,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const float* __restrict__ mask, float* ys, float* cs,
                float* h_out, float* c_out, int T, int B, int F, int H, int U,
                int rows, int wsh) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int K = F + H, C4 = 4 * U;
  const int j0 = blockIdx.x * U;
  const int nu = min(U, H - j0);
  float* Ws = smem;
  float* xh = smem + (wsh ? (size_t)K * C4 : 0);
  float* zs = xh + (size_t)rows * K;
  if (wsh) load_slices(wcat, Ws, nullptr, F, H, U, j0, nu);

  for (int t = 0; t < T; ++t) {
    // h_{t-1} of every unit: written by all blocks before the last grid.sync,
    // so read through L2 (__ldcg), never a possibly stale L1 line
    const float* hsrc = t == 0 ? h0 : ys + (size_t)(t - 1) * B * H;
    const float* csrc = t == 0 ? c0 : cs + (size_t)(t - 1) * B * H;
    for (int b0 = 0; b0 < B; b0 += rows) {
      const int nb = min(rows, B - b0);
      for (int idx = threadIdx.x; idx < nb * K; idx += THREADS) {
        const int r = idx / K, k = idx % K;
        const size_t b = b0 + r;
        xh[idx] = k < F ? __ldg(&x[((size_t)t * B + b) * F + k])
                        : __ldcg(&hsrc[b * H + k - F]);
      }
      __syncthreads();
      block_z(xh, Ws, wcat, bias, zs, nb, K, H, U, j0, nu, wsh);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nb * U; idx += THREADS) {
        const int r = idx / U, u = idx % U;
        if (u >= nu) continue;
        const int b = b0 + r, j = j0 + u;
        const float* z = zs + (size_t)r * C4;
        const float cp = __ldcg(&csrc[(size_t)b * H + j]);
        const float hp = xh[(size_t)r * K + F + j];
        float zi = z[u], zf = z[U + u], zo = z[3 * U + u];
        if (peep != nullptr) {
          zi += cp * __ldg(&peep[j]);
          zf += cp * __ldg(&peep[H + j]);
        }
        const float ig = sigm(zi), fg = sigm(zf), gg = tanhf(z[2 * U + u]);
        float cn = fg * cp + ig * gg;
        if (peep != nullptr) zo += cn * __ldg(&peep[2 * H + j]);
        float hn = sigm(zo) * tanhf(cn);
        if (!(__ldg(&mask[(size_t)t * B + b]) > 0.f)) {
          hn = hp;
          cn = cp;
        }
        const size_t at = ((size_t)t * B + b) * H + j;
        ys[at] = hn;
        cs[at] = cn;
        if (t == T - 1) {
          h_out[(size_t)b * H + j] = hn;
          c_out[(size_t)b * H + j] = cn;
        }
      }
      __syncthreads();  // xh and zs are reused by the next chunk
    }
    if (t + 1 < T) grid.sync();
  }
}

__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ hprev,
                const float* __restrict__ cprev, const float* __restrict__ wcat,
                const float* __restrict__ bias, const float* __restrict__ peep,
                const float* __restrict__ dys, const float* __restrict__ dht,
                const float* __restrict__ dct, const float* __restrict__ mask,
                float* dh, float* dc, float* dz, float* pacc, int T, int B,
                int F, int H, int U, int rows, int wsh) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int K = F + H, C4 = 4 * U, H4 = 4 * H;
  const int j0 = blockIdx.x * U;
  const int nu = min(U, H - j0);
  float* Ws = smem;
  float* RWs = smem + (size_t)K * C4;
  float* xh = smem + (wsh ? (size_t)K * C4 + (size_t)U * H4 : 0);
  float* zs = xh + (size_t)rows * K;
  if (wsh) load_slices(wcat, Ws, RWs, F, H, U, j0, nu);
  // the carries live in dh/dc (they finish as dh0/dc0); the peephole products
  // accumulate in pacc [3][B][H]; each entry belongs to this block's units
  for (int idx = threadIdx.x; idx < B * U; idx += THREADS) {
    const int b = idx / U, u = idx % U;
    if (u >= nu) continue;
    const size_t at = (size_t)b * H + j0 + u;
    dh[at] = dht[at];
    dc[at] = dct[at];
    if (peep != nullptr) {
      pacc[at] = 0.f;
      pacc[(size_t)B * H + at] = 0.f;
      pacc[(size_t)2 * B * H + at] = 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = T - 1; t >= 0; --t) {
    // (a) recompute z, form dz_t for this block's columns
    for (int b0 = 0; b0 < B; b0 += rows) {
      const int nb = min(rows, B - b0);
      for (int idx = threadIdx.x; idx < nb * K; idx += THREADS) {
        const int r = idx / K, k = idx % K;
        const size_t row = (size_t)t * B + b0 + r;
        xh[idx] = k < F ? __ldg(&x[row * F + k]) : __ldg(&hprev[row * H + k - F]);
      }
      __syncthreads();
      block_z(xh, Ws, wcat, bias, zs, nb, K, H, U, j0, nu, wsh);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nb * U; idx += THREADS) {
        const int r = idx / U, u = idx % U;
        if (u >= nu) continue;
        const int b = b0 + r, j = j0 + u;
        const size_t row = (size_t)t * B + b;
        const size_t at = (size_t)b * H + j;
        const float* z = zs + (size_t)r * C4;
        const float cp = __ldg(&cprev[row * H + j]);
        float zi = z[u], zf = z[U + u], zo = z[3 * U + u];
        float pi = 0.f, pf = 0.f, po = 0.f;
        if (peep != nullptr) {
          pi = __ldg(&peep[j]);
          pf = __ldg(&peep[H + j]);
          po = __ldg(&peep[2 * H + j]);
          zi += cp * pi;
          zf += cp * pf;
        }
        const float ig = sigm(zi), fg = sigm(zf), gg = tanhf(z[2 * U + u]);
        const float cn = fg * cp + ig * gg;
        if (peep != nullptr) zo += cn * po;
        const float og = sigm(zo);
        const float tc = tanhf(cn);
        const bool live = __ldg(&mask[row]) > 0.f;
        const float dh_t = dh[at] + __ldg(&dys[row * H + j]);
        const float dcv = dc[at];
        const float dh_act = live ? dh_t : 0.f;
        const float dh_skip = live ? 0.f : dh_t;
        const float dc_act = live ? dcv : 0.f;
        const float dc_skip = live ? 0.f : dcv;
        const float dzo = dh_act * tc * og * (1.f - og);
        float dc_t = dc_act + dh_act * og * (1.f - tc * tc);
        if (peep != nullptr) dc_t += dzo * po;
        const float dzi = dc_t * gg * ig * (1.f - ig);
        const float dzf = dc_t * cp * fg * (1.f - fg);
        const float dzg = dc_t * ig * (1.f - gg * gg);
        float* dzr = dz + row * H4;
        dzr[j] = dzi;
        dzr[H + j] = dzf;
        dzr[2 * H + j] = dzg;
        dzr[3 * H + j] = dzo;
        float dc_next = dc_t * fg + dc_skip;
        if (peep != nullptr) {
          dc_next += dzi * pi + dzf * pf;
          pacc[at] += dzi * cp;
          pacc[(size_t)B * H + at] += dzf * cp;
          pacc[(size_t)2 * B * H + at] += dzo * cn;
        }
        dc[at] = dc_next;
        dh[at] = dh_skip;  // phase (b) adds dz_t RW^T
      }
      __syncthreads();
    }
    grid.sync();
    // (b) dh_{t-1}[b, j] += sum_c dz_t[b, c] RW[j, c] for this block's units
    for (int o = warp; o < B * U; o += WARPS) {
      const int b = o / U, u = o % U;
      if (u >= nu) continue;  // uniform across the warp
      const float* dzr = dz + ((size_t)t * B + b) * H4;
      float acc = 0.f;
      if (wsh) {
        const float* rw = RWs + (size_t)u * H4;
        for (int c = lane; c < H4; c += 32) acc = fmaf(__ldcg(&dzr[c]), rw[c], acc);
      } else {
        const float* rw = wcat + (size_t)(F + j0 + u) * H4;
        for (int c = lane; c < H4; c += 32) acc = fmaf(__ldcg(&dzr[c]), __ldg(&rw[c]), acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) dh[(size_t)b * H + j0 + u] += acc;
    }
    __syncthreads();
  }
}

// C[M, N] (row-major, leading dimension ldc) = sum_p A(i, p) B(p, j), with
// A(i, p) = A[i * sai + p * sap] and B(p, j) = Bm[p * sbp + j * sbj]: 64x64
// output tiles, 16-deep slabs through shared memory, 4x4 outputs a thread,
// p summed in order.
__global__ void __launch_bounds__(THREADS)
lstm_gemm_kernel(const float* __restrict__ A, long long sai, long long sap,
            const float* __restrict__ Bm, long long sbp, long long sbj,
            float* __restrict__ C, long long ldc, int M, int N, int P) {
  __shared__ float As[16][64 + 4];
  __shared__ float Bs[16][64 + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * 64, j0 = blockIdx.x * 64;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
  for (int p0 = 0; p0 < P; p0 += 16) {
    for (int l = threadIdx.x; l < 64 * 16; l += THREADS) {
      // walk the operand's contiguous axis with neighbouring threads
      int i, p;
      if (sai == 1) { i = l % 64; p = l / 64; } else { p = l % 16; i = l / 16; }
      const int gi = i0 + i, gp = p0 + p;
      As[p][i] = (gi < M && gp < P) ? A[gi * sai + gp * sap] : 0.f;
      int j, q;
      if (sbj == 1) { j = l % 64; q = l / 64; } else { q = l % 16; j = l / 16; }
      const int gj = j0 + j, gq = p0 + q;
      Bs[q][j] = (gj < N && gq < P) ? Bm[gq * sbp + gj * sbj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = As[p][ty + 16 * r];
        b[r] = Bs[p][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gi = i0 + ty + 16 * r, gj = j0 + tx + 16 * s;
      if (gi < M && gj < N) C[gi * ldc + gj] = acc[r][s];
    }
}

// out[plane][j] = sum_r in[plane][r][j] for r < R, j < N: 32 columns a block,
// 8 row stripes summed in order, then the stripes in order.
__global__ void __launch_bounds__(THREADS)
lstm_colsum_kernel(const float* __restrict__ in, float* __restrict__ out, int R,
              int N, long long in_plane, int out_plane) {
  __shared__ float part[8][33];
  const int jx = threadIdx.x % 32, ry = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + jx;
  const float* p = in + blockIdx.y * in_plane;
  float acc = 0.f;
  if (j < N)
    for (int r = ry; r < R; r += 8) acc += p[(long long)r * N + j];
  part[ry][jx] = acc;
  __syncthreads();
  if (ry == 0 && j < N) {
    float s = part[0][jx];
    for (int k = 1; k < 8; ++k) s += part[k][jx];
    out[blockIdx.y * out_plane + j] = s;
  }
}

struct Plan {
  int units, blocks, rows_fwd, rows_bwd;
  size_t smem_fwd, smem_bwd;
  int w_shared, max_blocks;
};

cudaError_t make_plan(int B, int F, int H, Plan* p) {
  int dev, sms, coop;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  const int U = (H + sms - 1) / sms;
  const size_t K = (size_t)F + H;
  const size_t w_fwd = K * 4 * U * sizeof(float);
  const size_t w_bwd = w_fwd + (size_t)U * 4 * H * sizeof(float);
  const int wsh = w_bwd <= W_SHARED_LIMIT;
  const size_t per_row = (K + 4 * (size_t)U) * sizeof(float);
  const size_t base_f = wsh ? w_fwd : 0, base_b = wsh ? w_bwd : 0;
  if (base_b + per_row > SMEM_LIMIT) return cudaErrorInvalidValue;  // one row does not fit
  p->units = U;
  p->blocks = (H + U - 1) / U;
  p->w_shared = wsh;
  p->rows_fwd = (int)((size_t)B < (SMEM_LIMIT - base_f) / per_row ? B : (SMEM_LIMIT - base_f) / per_row);
  p->rows_bwd = (int)((size_t)B < (SMEM_LIMIT - base_b) / per_row ? B : (SMEM_LIMIT - base_b) / per_row);
  p->smem_fwd = base_f + p->rows_fwd * per_row;
  p->smem_bwd = base_b + p->rows_bwd * per_row;
  int occ_f = 0, occ_b = 0;
  if ((err = cudaFuncSetAttribute(lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)p->smem_fwd)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)p->smem_bwd)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_f, lstm_fwd_kernel, THREADS,
                                                           p->smem_fwd)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_b, lstm_bwd_kernel, THREADS,
                                                           p->smem_bwd)) != cudaSuccess)
    return err;
  p->max_blocks = (occ_f < occ_b ? occ_f : occ_b) * sms;
  // every block must be resident at once for grid.sync(): refuse, never hang
  if (p->blocks > p->max_blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

cudaError_t gemm(const float* A, long long sai, long long sap, const float* Bm,
                 long long sbp, long long sbj, float* C, long long ldc, int M,
                 int N, int P, cudaStream_t st) {
  dim3 grid((N + 63) / 64, (M + 63) / 64);
  lstm_gemm_kernel<<<grid, THREADS, 0, st>>>(A, sai, sap, Bm, sbp, sbj, C, ldc, M, N, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lstm_plan(int B, int F, int H, int* out) {
  Plan p;
  cudaError_t err = make_plan(B, F, H, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.units;
  out[1] = p.blocks;
  out[2] = p.rows_fwd;
  out[3] = p.rows_bwd;
  out[4] = (int)p.smem_fwd;
  out[5] = (int)p.smem_bwd;
  out[6] = p.w_shared;
  out[7] = p.max_blocks;
  return 0;
}

extern "C" int lstm_fwd(const void* x, const void* wcat, const void* bias,
                        const void* peep, const void* h0, const void* c0,
                        const void* mask, void* ys, void* cs, void* h_out,
                        void* c_out, int T, int B, int F, int H, int peephole,
                        void* stream) {
  Plan p;
  cudaError_t err = make_plan(B, F, H, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xa = static_cast<const float*>(x);
  const float* wa = static_cast<const float*>(wcat);
  const float* ba = static_cast<const float*>(bias);
  const float* pa = peephole ? static_cast<const float*>(peep) : nullptr;
  const float* h0a = static_cast<const float*>(h0);
  const float* c0a = static_cast<const float*>(c0);
  const float* ma = static_cast<const float*>(mask);
  float* ysa = static_cast<float*>(ys);
  float* csa = static_cast<float*>(cs);
  float* ha = static_cast<float*>(h_out);
  float* ca = static_cast<float*>(c_out);
  int U = p.units, rows = p.rows_fwd, wsh = p.w_shared;
  void* args[] = {&xa, &wa, &ba, &pa, &h0a, &c0a, &ma, &ysa, &csa, &ha, &ca,
                  &T, &B, &F, &H, &U, &rows, &wsh};
  err = cudaLaunchCooperativeKernel((const void*)lstm_fwd_kernel, dim3(p.blocks), dim3(THREADS),
                                    args, p.smem_fwd, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lstm_bwd(const void* x, const void* hprev, const void* cprev,
                        const void* wcat, const void* bias, const void* peep,
                        const void* dys, const void* dht, const void* dct,
                        const void* mask, void* dx, void* dw, void* db,
                        void* dpeep, void* dh0, void* dc0, void* dz_stash,
                        void* pacc, int T, int B, int F, int H, int peephole,
                        void* stream) {
  Plan p;
  cudaError_t err = make_plan(B, F, H, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xa = static_cast<const float*>(x);
  const float* hpa = static_cast<const float*>(hprev);
  const float* cpa = static_cast<const float*>(cprev);
  const float* wa = static_cast<const float*>(wcat);
  const float* ba = static_cast<const float*>(bias);
  const float* pa = peephole ? static_cast<const float*>(peep) : nullptr;
  const float* dya = static_cast<const float*>(dys);
  const float* dhta = static_cast<const float*>(dht);
  const float* dcta = static_cast<const float*>(dct);
  const float* ma = static_cast<const float*>(mask);
  float* dha = static_cast<float*>(dh0);
  float* dca = static_cast<float*>(dc0);
  float* dza = static_cast<float*>(dz_stash);
  float* paa = static_cast<float*>(pacc);
  int U = p.units, rows = p.rows_bwd, wsh = p.w_shared;
  void* args[] = {&xa, &hpa, &cpa, &wa, &ba, &pa, &dya, &dhta, &dcta, &ma,
                  &dha, &dca, &dza, &paa, &T, &B, &F, &H, &U, &rows, &wsh};
  err = cudaLaunchCooperativeKernel((const void*)lstm_bwd_kernel, dim3(p.blocks), dim3(THREADS),
                                    args, p.smem_bwd, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int R = T * B, H4 = 4 * H;
  float* dwa = static_cast<float*>(dw);
  // dW rows [0, F): x^T dz; rows [F, F+H): hprev^T dz
  if ((err = gemm(xa, 1, F, dza, H4, 1, dwa, H4, F, H4, R, st)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = gemm(hpa, 1, H, dza, H4, 1, dwa + (size_t)F * H4, H4, H, H4, R, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  // dx = dz W_x^T
  if ((err = gemm(dza, H4, 1, wa, 1, H4, static_cast<float*>(dx), F, R, F, H4, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  lstm_colsum_kernel<<<dim3((H4 + 31) / 32, 1), THREADS, 0, st>>>(dza, static_cast<float*>(db), R,
                                                            H4, 0, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (peephole) {
    lstm_colsum_kernel<<<dim3((H + 31) / 32, 3), THREADS, 0, st>>>(
        paa, static_cast<float*>(dpeep), B, H, (long long)B * H, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
