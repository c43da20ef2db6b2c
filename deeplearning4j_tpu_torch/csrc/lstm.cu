// The persistent LSTM cell, forward and backward, over a whole sequence.
//
// Replaces: deeplearning4j_tpu/ops/lstm.py, _lstm_fwd_kernel (the pallas_call
// in _pallas_forward at :486) and _lstm_bwd_kernel (:361; the pallas_call in
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
// bound is a few tens of microseconds; the recurrence makes T dependent
// steps, each of which needs every block's h_{t-1} (forward) or dz_t
// (backward), so the serial part costs T times the latency of one step: a
// grid-wide barrier plus an L2 round trip plus the block's share of the
// step's product.
//
// The forward takes what does not recur off the serial path too. Its plan
// (lstm_plan, made once a shape and kept by the caller) picks the route by T:
// 1. T > 1, first the hoisted product (lstm_fwd_x_kernel): zx = x W_x + b
//    for all T * B rows, into a [T, B, 4H] buffer, on the backward's 64 x 64
//    float32 tile (K = F in one pass). Then the lean recurrence
//    (lstm_fwd_kernel): one cooperative launch, block g owning U units
//    (units_for: 2 at H = 200, 100 blocks) and their 4U columns of RW in
//    shared memory, the c carry in shared memory; per step it stages
//    h_{t-1} (B x H floats, through L2: 16-byte cp.async when H % 4 == 0,
//    plain loads for a ragged H), forms z = zx_t + h_{t-1} RW, updates its
//    cells and writes ys/cs; one grid.sync() a step. The product: a warp
//    takes 4 batch rows and 2 units (8 columns) at once, lanes split the
//    H-term reduction in float4 chunks, each weight float4 serves 4 rows,
//    and the 32 sums a lane holds go through one transpose-by-halves (31
//    shuffles) that leaves sum (row, unit, gate) in its own lane, so the 4
//    gates of a cell sit in 4 neighbouring lanes for the update.
// 2. T = 1 (decode, stream): one ordinary launch of the same step
//    (lstm_step_kernel) over K = F + H with the bias, staging [x, h0]; no
//    hoist and no barrier.
// What bounds it now: the recurrence's per-step latency (the barrier, the
// L2 round trip of h_{t-1}, the short lane-split product and its shuffles),
// T times over; the hoisted product is a small float32 GEMM.
//
// The backward takes everything that does not recur off the serial path,
// in three parts on one stream:
// 1. The hoisted product (lstm_z_kernel): z = [x, hprev] Wcat + b for all
//    T * B rows at once, into the [T, B, 4H] stash, before the recurrence.
//    It depends only on what the forward saved, never on the backward's
//    carries. A register-tiled float32 GEMM: 64 x 64 output tiles, 16-deep
//    slabs through shared memory, 4 x 4 outputs a thread read as float4
//    rows, each output summed over K in order. 325 blocks at T * B = 1,600,
//    4H = 800: the whole card.
//    Bounded by the CUDA cores' float32 rate and this tile's shared-memory
//    reads, not by the recurrence.
// 2. The lean recurrence (lstm_bwd_kernel): one cooperative launch, block g
//    owning U = max(2, ceil(H / SMs)) units (100 blocks at H = 200: U = 2
//    was the fastest of 2, 4 and 8 there on the H100, PERF.md). Per step,
//    phase (a): each of the block's cells reads its z_t and c_{t-1}, forms
//    dz_t and the dc carry, and writes dz_t over z_t in place (the thread
//    that reads z[t, b, c] is the one that writes dz[t, b, c]); then one
//    grid.sync(); phase (b): dh_{t-1} = dz_t RW^T for its units, with dz_t
//    staged into shared memory by 16-byte cp.async (through L2) and a warp
//    taking 4 batch rows at once: lanes over the 4H columns as float4, each
//    RW float4 serving 4 rows, 4 x UG independent sums, a shuffle tree each.
//    The carries (dh, dc and the peephole sums) stay in shared memory. No
//    second barrier: the next step's phase (a) writes another stash slot
//    than phase (b) reads. What bounds it: phase (b)'s product,
//    shared-memory bound, grows with U (each block reads dz_t once and RW's
//    U rows for every row group), while the barrier and the staging of dz_t
//    (B * 4H floats into every block, through L2) cost about the same at 25
//    to 100 blocks.
// 3. The tail (lstm_tail_kernel, lstm_sum_kernel): dW = [x, hprev]^T dz,
//    db = 1^T dz, dx = dz W_x^T and dpeep = 1^T pacc as one launch of the
//    same tiled GEMM over all five problems, the reduced dimension (T * B,
//    4H or B) cut into fixed slices of 256 whose partials go to a scratch
//    buffer, then one launch that sums each output's partials in slice
//    order. 656 and 1,229 blocks at char_rnn's two layers: every SM. No
//    atomics. Bounded, like part 1, by the tile's float32 FMA and
//    shared-memory rate.
// Every sum runs in a fixed order, so results are the same from run to run.
// When the weight slices do not fit in shared memory (very wide layers) they
// are read from global memory (L2) instead; when even one batch row does not
// fit, or the grid cannot be co-resident, the launch is refused with an
// error, never run into a hang.
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

// ------------------------------------------------------------ the backward
// batch rows a warp takes at once in phase (b) (a lane holds RPW * UG
// sums, UG units a pass: the kernel's template argument)
constexpr int RPW = 4;
// rows of the reduced dimension in one slice of a tail product
constexpr int SLICE = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem));
}

// The recurrence: zdz holds z = [x, hprev] Wcat + b on entry (lstm_z_kernel)
// and dz on exit. The carries dh, dc and the peephole products (summed over
// time, [B][3H] in pacc) of the block's cells sit in shared memory when
// `csh` (else in dh, dc, pacc) and finish in dh, dc (dh0, dc0) and pacc.
// Every carry and every z column a block touches belongs to its own units.
// UG: units of one phase-(b) pass (2, 4 or 8: the least that holds U, 8
// beyond); WSH: RW's rows in shared memory (a shared-memory pointer the
// compiler sees, not a generic one).
template <int UG, bool WSH>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const float* __restrict__ cprev, const float* __restrict__ wcat,
                const float* __restrict__ peep, const float* __restrict__ dys,
                const float* __restrict__ dht, const float* __restrict__ dct,
                const float* __restrict__ mask, float* dh, float* dc,
                float* zdz, float* pacc, int T, int B, int F, int H, int U,
                int rows, int csh) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int H4 = 4 * H;
  const int j0 = blockIdx.x * U;
  const int nu = min(U, H - j0);
  float* RWs = smem;                                // [U][4H] when WSH
  float* dzs = smem + (WSH ? (size_t)U * H4 : 0);  // [rows][4H]
  float* carry = dzs + (size_t)rows * H4;          // [5][B][U] when csh
  if (WSH) {
    for (int idx = threadIdx.x; idx < U * H4; idx += THREADS) {
      const int u = idx / H4, c = idx % H4;
      RWs[idx] = u < nu ? wcat[(size_t)(F + j0 + u) * H4 + c] : 0.f;
    }
  }
  const float* rw = WSH ? RWs : wcat + (size_t)(F + j0) * H4;
  // carry (b, u) at dhc[b * cld + u]; peephole product q at
  // pcc[b * pld + q * pq + u]
  const size_t BU = (size_t)B * U;
  float* dhc = csh ? carry : dh + j0;
  float* dcc = csh ? carry + BU : dc + j0;
  float* pcc = csh ? carry + 2 * BU : pacc + j0;
  const int cld = csh ? U : H, pld = csh ? 3 * U : 3 * H, pq = csh ? U : H;
  for (int idx = threadIdx.x; idx < B * U; idx += THREADS) {
    const int b = idx / U, u = idx % U;
    if (u >= nu) continue;
    const size_t at = (size_t)b * H + j0 + u;
    dhc[b * cld + u] = dht[at];
    dcc[b * cld + u] = dct[at];
    float* pa = pcc + (size_t)b * pld + u;
    pa[0] = pa[pq] = pa[2 * pq] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = T - 1; t >= 0; --t) {
    // (a) dz_t of this block's cells, over z_t in place
    for (int idx = threadIdx.x; idx < B * U; idx += THREADS) {
      const int b = idx / U, u = idx % U;
      if (u >= nu) continue;
      const int j = j0 + u;
      const size_t row = (size_t)t * B + b;
      float* zr = zdz + row * H4;
      const float cp = __ldg(&cprev[row * H + j]);
      float zi = zr[j], zf = zr[H + j], zo = zr[3 * H + j];
      const float zg = zr[2 * H + j];
      const bool live = __ldg(&mask[row]) > 0.f;
      const float dy = __ldg(&dys[row * H + j]);
      float pi = 0.f, pf = 0.f, po = 0.f;
      if (peep != nullptr) {
        pi = __ldg(&peep[j]);
        pf = __ldg(&peep[H + j]);
        po = __ldg(&peep[2 * H + j]);
        zi += cp * pi;
        zf += cp * pf;
      }
      const float ig = sigm(zi), fg = sigm(zf), gg = tanhf(zg);
      const float cn = fg * cp + ig * gg;
      if (peep != nullptr) zo += cn * po;
      const float og = sigm(zo);
      const float tc = tanhf(cn);
      float* dhp = dhc + b * cld + u;
      float* dcp = dcc + b * cld + u;
      const float dh_t = *dhp + dy;
      const float dcv = *dcp;
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
      zr[j] = dzi;
      zr[H + j] = dzf;
      zr[2 * H + j] = dzg;
      zr[3 * H + j] = dzo;
      float dc_next = dc_t * fg + dc_skip;
      if (peep != nullptr) {
        dc_next += dzi * pi + dzf * pf;
        float* pa = pcc + (size_t)b * pld + u;
        pa[0] += dzi * cp;
        pa[pq] += dzf * cp;
        pa[2 * pq] += dzo * cn;
      }
      *dcp = dc_next;
      *dhp = dh_skip;  // phase (b) adds dz_t RW^T
    }
    grid.sync();
    // (b) dh_{t-1}[b, j] += sum_c dz_t[b, c] RW[j, c] for this block's units
    for (int b0 = 0; b0 < B; b0 += rows) {
      const int nb = min(rows, B - b0);
      const float* src = zdz + ((size_t)t * B + b0) * H4;
      for (int i = threadIdx.x; i < nb * H; i += THREADS)  // 16-byte chunks
        cp_async16(dzs + 4 * (size_t)i, src + 4 * (size_t)i);
      asm volatile("cp.async.wait_all;\n" ::);
      __syncthreads();
      // a warp takes RPW rows at once: each RW float4 it reads serves RPW
      // rows, each dz float4 up to UG units, RPW * UG independent sums
      for (int r0 = warp * RPW; r0 < nb; r0 += WARPS * RPW) {
        for (int ug = 0; ug < nu; ug += UG) {
          float acc[RPW][UG];
#pragma unroll
          for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
            for (int u = 0; u < UG; ++u) acc[rr][u] = 0.f;
          for (int c4 = lane; c4 < H; c4 += 32) {  // H float4 = 4H columns
            float4 d[RPW];
#pragma unroll
            for (int rr = 0; rr < RPW; ++rr)
              d[rr] = r0 + rr < nb
                  ? reinterpret_cast<const float4*>(dzs + (size_t)(r0 + rr) * H4)[c4]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int u = 0; u < UG; ++u) {
              if (ug + u < nu) {
                const float4 w =
                    reinterpret_cast<const float4*>(rw + (size_t)(ug + u) * H4)[c4];
#pragma unroll
                for (int rr = 0; rr < RPW; ++rr) {
                  acc[rr][u] = fmaf(d[rr].x, w.x, acc[rr][u]);
                  acc[rr][u] = fmaf(d[rr].y, w.y, acc[rr][u]);
                  acc[rr][u] = fmaf(d[rr].z, w.z, acc[rr][u]);
                  acc[rr][u] = fmaf(d[rr].w, w.w, acc[rr][u]);
                }
              }
            }
          }
#pragma unroll
          for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
            for (int u = 0; u < UG; ++u) {
              if (ug + u >= nu || r0 + rr >= nb) continue;  // warp-uniform
              float s = acc[rr][u];
#pragma unroll
              for (int off = 16; off > 0; off >>= 1)
                s += __shfl_xor_sync(0xffffffffu, s, off);
              if (lane == 0) dhc[(b0 + r0 + rr) * cld + ug + u] += s;
            }
        }
      }
      __syncthreads();  // dzs is restaged by the next chunk; dh is read in (a)
    }
  }
  if (csh) {
    for (int idx = threadIdx.x; idx < B * U; idx += THREADS) {
      const int b = idx / U, u = idx % U;
      if (u >= nu) continue;
      const size_t at = (size_t)b * H + j0 + u;
      dh[at] = dhc[b * cld + u];
      dc[at] = dcc[b * cld + u];
      const float* pa = pcc + (size_t)b * pld + u;
      float* po = pacc + (size_t)b * 3 * H + j0 + u;
      po[0] = pa[0];
      po[H] = pa[pq];
      po[2 * H] = pa[2 * pq];
    }
  }
}

// C[M][N] = sum_p A(i, p) B(p, j) (+ bias[j]) over p in a slice of [0, P):
// A(i, p) = A[i * sai + p * sap] for p < pa, A2[i * sai2 + (p - pa) * sap2]
// beyond ([x, hprev] side by side), or 1 where A is null (a column sum);
// B(p, j) = Bm[p * sbp + j * sbj]. With one slice (part < 0) the sum goes to
// C[i * ldc + j]; else slice s goes to the scratch at part + (s * M + i) * N
// + j, and lstm_sum_kernel adds the slices in order.
struct Gemm {
  const float* A;
  const float* A2;
  const float* Bm;
  const float* bias;
  float* C;
  long long sai, sap, sai2, sap2, sbp, sbj, ldc, part;
  int M, N, P, pa, slices, tiles_n, first;
};
constexpr int MAX_GEMMS = 5;
struct Gemms {
  Gemm g[MAX_GEMMS];
  int n;
  float* scratch;
};

// One 64 x 64 output tile of one slice: 16-deep slabs through shared memory,
// 4 x 4 outputs a thread read as float4 rows, p summed in order.
__device__ __forceinline__ void gemm_tile(const Gemm& g, int idx, float* scratch,
                                          float (*As)[68], float (*Bs)[68]) {
  const int slice = idx % g.slices, tile = idx / g.slices;
  const int i0 = tile / g.tiles_n * 64, j0 = tile % g.tiles_n * 64;
  const int pbeg = slice * SLICE;
  const int p_end = g.slices == 1 ? g.P : min(g.P, pbeg + SLICE);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
  for (int p0 = pbeg; p0 < p_end; p0 += 16) {
    const long long sai = p0 < g.pa ? g.sai : g.sai2;
    for (int l = threadIdx.x; l < 64 * 16; l += THREADS) {
      // walk each operand's contiguous axis with neighbouring threads
      int i, p;
      if (sai == 1) { i = l % 64; p = l / 64; } else { p = l % 16; i = l / 16; }
      const int gi = i0 + i, gp = p0 + p;
      float a = 0.f;
      if (gi < g.M && gp < p_end) {
        if (g.A == nullptr) a = 1.f;
        else if (gp < g.pa) a = g.A[gi * g.sai + gp * g.sap];
        else a = g.A2[gi * g.sai2 + (gp - g.pa) * g.sap2];
      }
      As[p][i] = a;
      int j, q;
      if (g.sbj == 1) { j = l % 64; q = l / 64; } else { q = l % 16; j = l / 16; }
      const int gj = j0 + j, gq = p0 + q;
      Bs[q][j] = (gj < g.N && gq < p_end) ? g.Bm[gq * g.sbp + gj * g.sbj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(&As[p][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[p][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gi = i0 + ty * 4 + r, gj = j0 + tx * 4 + s;
      if (gi >= g.M || gj >= g.N) continue;
      if (g.part < 0)
        g.C[gi * g.ldc + gj] = acc[r][s] + (g.bias ? g.bias[gj] : 0.f);
      else
        scratch[g.part + ((long long)slice * g.M + gi) * g.N + gj] = acc[r][s];
    }
}

__device__ __forceinline__ void run_gemms(const Gemms& gs) {
  __shared__ __align__(16) float As[16][68];
  __shared__ __align__(16) float Bs[16][68];
  int k = 0;
  while (k + 1 < gs.n && (int)blockIdx.x >= gs.g[k + 1].first) ++k;
  gemm_tile(gs.g[k], blockIdx.x - gs.g[k].first, gs.scratch, As, Bs);
}

// the hoisted product z = [x, hprev] Wcat + b (part 1)
__global__ void __launch_bounds__(THREADS) lstm_z_kernel(const Gemms gs) { run_gemms(gs); }

// the tail products dW, db, dx, dpeep (part 3)
__global__ void __launch_bounds__(THREADS) lstm_tail_kernel(const Gemms gs) { run_gemms(gs); }

// the tail's sliced outputs: gs.g[blockIdx.y]'s slices added in order
__global__ void __launch_bounds__(THREADS) lstm_sum_kernel(const Gemms gs) {
  const Gemm& g = gs.g[blockIdx.y];
  const long long mn = (long long)g.M * g.N;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < mn;
       e += (long long)gridDim.x * THREADS) {
    const float* p = gs.scratch + g.part + e;
    float s = p[0];
    for (int k = 1; k < g.slices; ++k) s += p[k * mn];
    g.C[(e / g.N) * g.ldc + e % g.N] = s;
  }
}

// ------------------------------------------------------------- the forward
// batch rows a warp takes at once, and units of one pass: a lane holds
// FRPW * 4 gates * FUG = 32 sums, which lane_totals hands out one a lane
constexpr int FRPW = 4;
constexpr int FUG = 2;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

struct FwdArgs {
  const float *x, *wcat, *bias, *peep, *h0, *c0, *mask, *zx;
  float *ys, *cs, *h_out, *c_out;
  int T, B, F, H, U, rows, csh, vec;
};

// Wcat's entry for row kk of a staged row ([x padded to FP, h padded to a
// multiple of 4]; FP = 0 when only h is staged) and column col; 0 in the
// padding.
__device__ __forceinline__ float w_at(const float* __restrict__ wcat, int F, int H, int FP,
                                      int kk, int col) {
  int k = kk;
  if (kk < FP) {
    if (kk >= F) return 0.f;
  } else {
    k = kk - FP;
    if (k >= H) return 0.f;
    k += F;
  }
  return __ldg(&wcat[(size_t)k * 4 * H + col]);
}

// dst[i] = f(i) for i < n by the block's threads, with 8 loads of a thread
// in flight before their stores (a loop of load-then-store waits out one L2
// round trip an element).
template <typename F>
__device__ __forceinline__ void fill(float* dst, int n, F f) {
  constexpr int BATCH = 8;
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * THREADS) {
    float v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * THREADS;
      v[j] = i < n ? f(i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * THREADS;
      if (i < n) dst[i] = v[j];
    }
  }
}

// Each lane holds 32 partial sums v[0..31]; afterwards lane l holds the
// warp's total of index l (in v[0]). A transpose by halves: at the level of
// OFF a lane keeps the half of its values whose index has the bit OFF of its
// lane number and adds its partner's copy of them, 31 shuffles in all (not
// 32 * 5), and every total is the same fixed tree over the lanes.
template <int OFF>
__device__ __forceinline__ void lane_totals(float (&v)[32], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (OFF > 1) lane_totals<OFF / 2>(v, lane);
}

// The lean step, for the route's steps: STEP (T = 1) stages [x, h0] and
// sums over K = F + H, with the bias; the recurrence stages h_{t-1} and sums
// over H, with zx_t = x_t W_x + b from lstm_fwd_x_kernel. Block g owns units
// j0 .. j0 + U - 1 and their 4U columns of Wcat (in shared memory when WSH,
// as [4U][KP] rows over the reduction). A warp takes FRPW batch rows and FUG
// units at once: each float4 of a weight column serves FRPW rows, lanes split
// the reduction in float4 chunks (chunk c at lane c % 32, in order), and
// lane_totals leaves sum (row rr, unit uu, gate q) at lane 8 rr + 4 uu + q, so
// the 4 gates of a cell sit in 4 neighbouring lanes and the cell update needs
// no shared memory. The recurrence keeps the c carry in shared memory (csh).
template <bool STEP, bool WSH>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, F = a.F, U = a.U, B = a.B, H4 = 4 * H;
  const int FP = STEP ? pad4(F) : 0;
  const int KP = FP + pad4(H);
  const int j0 = blockIdx.x * U;
  const int nu = min(U, H - j0);
  float* wsh = smem;                                       // [4U][KP] when WSH
  float* hs = smem + (WSH ? (size_t)4 * U * KP : 0);       // [rows][KP]
  float* cc = hs + (size_t)a.rows * KP;                    // [B][U] when csh
  if (WSH) {
    fill(wsh, 4 * U * KP, [&](int idx) {
      const int c = idx / KP, kk = idx % KP, q = c / U, u = c % U;
      return u < nu ? w_at(a.wcat, F, H, FP, kk, q * H + j0 + u) : 0.f;
    });
  }
  if (!STEP && a.csh) {
    for (int idx = threadIdx.x; idx < B * U; idx += THREADS) {
      const int b = idx / U, u = idx % U;
      if (u < nu) cc[idx] = __ldg(&a.c0[(size_t)b * H + j0 + u]);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rr = lane >> 3, uu = (lane >> 2) & 1, q = lane & 3;  // this lane's total
  const int T = STEP ? 1 : a.T;
  for (int t = 0; t < T; ++t) {
    // h_{t-1} of every unit: written by all blocks before the last
    // grid.sync, so read through L2 (cp.async.cg, __ldcg), never L1
    const float* hsrc = t == 0 ? a.h0 : a.ys + (size_t)(t - 1) * B * H;
    for (int b0 = 0; b0 < B; b0 += a.rows) {
      const int nb = min(a.rows, B - b0);
      if (!STEP && a.vec) {  // H % 4 == 0: the rows are whole 16-byte chunks
        const float* src = hsrc + (size_t)b0 * H;
        for (int i = threadIdx.x; i < nb * H / 4; i += THREADS)
          cp_async16(hs + 4 * (size_t)i, src + 4 * (size_t)i);
        asm volatile("cp.async.wait_all;\n" ::);
      } else {
        fill(hs, nb * KP, [&](int idx) {
          const int r = idx / KP, kk = idx % KP;
          const size_t b = b0 + r;
          if (kk < FP) return kk < F ? __ldg(&a.x[b * F + kk]) : 0.f;
          return kk - FP < H ? __ldcg(&hsrc[b * H + kk - FP]) : 0.f;
        });
      }
      __syncthreads();
      for (int r0 = warp * FRPW; r0 < nb; r0 += WARPS * FRPW) {
        for (int ug = 0; ug < nu; ug += FUG) {
          float v[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) v[i] = 0.f;
          for (int c4 = lane; c4 < KP / 4; c4 += 32) {
            float4 hv[FRPW];
#pragma unroll
            for (int r = 0; r < FRPW; ++r)
              hv[r] = r0 + r < nb ? reinterpret_cast<const float4*>(hs + (size_t)(r0 + r) * KP)[c4]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int u = 0; u < FUG; ++u) {
              if (ug + u >= nu) continue;  // warp-uniform
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                float4 w;
                if (WSH) {
                  w = reinterpret_cast<const float4*>(wsh + (size_t)(g * U + ug + u) * KP)[c4];
                } else {
                  const int col = g * H + j0 + ug + u;
                  w = make_float4(w_at(a.wcat, F, H, FP, 4 * c4, col),
                                  w_at(a.wcat, F, H, FP, 4 * c4 + 1, col),
                                  w_at(a.wcat, F, H, FP, 4 * c4 + 2, col),
                                  w_at(a.wcat, F, H, FP, 4 * c4 + 3, col));
                }
#pragma unroll
                for (int r = 0; r < FRPW; ++r) {
                  float& s = v[r * 8 + u * 4 + g];
                  s = fmaf(hv[r].x, w.x, s);
                  s = fmaf(hv[r].y, w.y, s);
                  s = fmaf(hv[r].z, w.z, s);
                  s = fmaf(hv[r].w, w.w, s);
                }
              }
            }
          }
          lane_totals<16>(v, lane);
          float z = v[0];
          const int r = r0 + rr, u = ug + uu;
          const bool ok = r < nb && u < nu;
          const int b = b0 + r, j = j0 + u;
          if (ok)
            z += STEP ? __ldg(&a.bias[q * H + j]) : __ldg(&a.zx[((size_t)t * B + b) * H4 + q * H + j]);
          const int base = lane & ~3;
          const float zi0 = __shfl_sync(0xffffffffu, z, base);
          const float zf0 = __shfl_sync(0xffffffffu, z, base + 1);
          const float zg = __shfl_sync(0xffffffffu, z, base + 2);
          const float zo0 = __shfl_sync(0xffffffffu, z, base + 3);
          if (!ok || q != 0) continue;
          const size_t at = ((size_t)t * B + b) * H + j;
          float cp;
          if (STEP) cp = __ldg(&a.c0[(size_t)b * H + j]);
          else if (a.csh) cp = cc[b * U + u];
          else cp = t == 0 ? __ldg(&a.c0[(size_t)b * H + j]) : __ldcg(&a.cs[at - (size_t)B * H]);
          const float hp = hs[(size_t)r * KP + FP + j];
          float zi = zi0, zf = zf0, zo = zo0;
          if (a.peep != nullptr) {
            zi += cp * __ldg(&a.peep[j]);
            zf += cp * __ldg(&a.peep[H + j]);
          }
          const float ig = sigm(zi), fg = sigm(zf), gg = tanhf(zg);
          float cn = fg * cp + ig * gg;
          if (a.peep != nullptr) zo += cn * __ldg(&a.peep[2 * H + j]);
          float hn = sigm(zo) * tanhf(cn);
          if (!(__ldg(&a.mask[(size_t)t * B + b]) > 0.f)) {
            hn = hp;
            cn = cp;
          }
          a.ys[at] = hn;
          a.cs[at] = cn;
          if (!STEP && a.csh) cc[b * U + u] = cn;
          if (t == T - 1) {
            a.h_out[(size_t)b * H + j] = hn;
            a.c_out[(size_t)b * H + j] = cn;
          }
        }
      }
      __syncthreads();  // hs is restaged by the next chunk or step
    }
    if constexpr (!STEP) {
      if (t + 1 < T) cg::this_grid().sync();
    }
  }
}

// the recurrence over T > 1 steps: one cooperative launch, a grid.sync() a
// step
template <bool WSH>
__global__ void __launch_bounds__(THREADS) lstm_fwd_kernel(const FwdArgs a) {
  fwd_body<false, WSH>(a);
}

// one step (T = 1: decode, stream): an ordinary launch, no barrier
template <bool WSH>
__global__ void __launch_bounds__(THREADS) lstm_step_kernel(const FwdArgs a) {
  fwd_body<true, WSH>(a);
}

// the forward's hoisted product zx = x W_x + b for every row (T > 1)
__global__ void __launch_bounds__(THREADS) lstm_fwd_x_kernel(const Gemms gs) { run_gemms(gs); }

// Append C[M][N] = A B to gs: tiles, slices (P cut in SLICE rows when
// split) and the scratch offset; returns the blocks so far. One slice writes
// C directly.
int add_gemm(Gemms* gs, long long* scratch, Gemm g, bool split = true) {
  g.tiles_n = (g.N + 63) / 64;
  g.slices = split ? (g.P + SLICE - 1) / SLICE : 1;
  if (g.slices < 1) g.slices = 1;
  g.part = -1;
  if (g.slices > 1) {
    g.part = *scratch;
    *scratch += (long long)g.slices * g.M * g.N;
  }
  const int first = gs->n ? gs->g[gs->n - 1].first
                                + (gs->g[gs->n - 1].M + 63) / 64 * gs->g[gs->n - 1].tiles_n
                                      * gs->g[gs->n - 1].slices
                          : 0;
  g.first = first;
  gs->g[gs->n++] = g;
  return first + (g.M + 63) / 64 * g.tiles_n * g.slices;
}

Gemm gemm_of(const float* A, long long sai, long long sap, const float* Bm,
              long long sbp, long long sbj, float* C, long long ldc, int M,
              int N, int P) {
  Gemm g{};
  g.A = A;
  g.sai = g.sai2 = sai;
  g.sap = g.sap2 = sap;
  g.pa = P;
  g.Bm = Bm;
  g.sbp = sbp;
  g.sbj = sbj;
  g.C = C;
  g.ldc = ldc;
  g.M = M;
  g.N = N;
  g.P = P;
  return g;
}

// The tail's problems (dW's x and hprev rows, db, dx, dpeep); returns its
// blocks and sets the scratch floats it needs. Pointers may be null when
// only the sizes are wanted.
int tail_gemms(int T, int B, int F, int H, int peephole, const float* x,
               const float* hprev, const float* wcat, const float* dz,
               const float* pacc, float* dw, float* db, float* dx,
               float* dpeep, Gemms* gs, long long* scratch) {
  const int R = T * B, H4 = 4 * H;
  gs->n = 0;
  *scratch = 0;
  add_gemm(gs, scratch, gemm_of(x, 1, F, dz, H4, 1, dw, H4, F, H4, R));
  add_gemm(gs, scratch, gemm_of(hprev, 1, H, dz, H4, 1, dw ? dw + (size_t)F * H4 : nullptr,
                                H4, H, H4, R));
  add_gemm(gs, scratch, gemm_of(nullptr, 0, 0, dz, H4, 1, db, H4, 1, H4, R));
  int blocks = add_gemm(gs, scratch, gemm_of(dz, H4, 1, wcat, 1, H4, dx, F, R, F, H4));
  if (peephole)
    blocks = add_gemm(gs, scratch, gemm_of(nullptr, 0, 0, pacc, 3 * H, 1, dpeep, 3 * H, 1,
                                           3 * H, B));
  return blocks;
}

// ------------------------------------------------------------------ plans
// Units a block, for both directions: max(2, ceil(H / SMs)) (2: the fastest
// unit count measured for both recurrences at char_rnn's H = 200 on the
// H100, PERF.md, and the forward's pass width; the one-step route shares
// the rule; more when H needs it for the grid to fit), never more than H.
constexpr int MIN_UNITS = 2;
int units_for(int H, int sms) {
  int U = (H + sms - 1) / sms;
  if (U < MIN_UNITS) U = MIN_UNITS;
  return U > H ? H : U;
}

cudaError_t device_sms(int* sms, int need_coop) {
  int dev, coop;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  return need_coop && !coop ? cudaErrorNotSupported : cudaSuccess;
}

// The forward's launch. route 1 (T > 1): the hoisted product, then the
// cooperative recurrence over K = H; route 0 (T = 1): one ordinary launch of
// the step over K = F + H. U units a block (units_for), the block's 4U weight
// columns in shared memory when they fit in 128 KB, the c carry in shared
// memory when it fits (route 1), the staged rows `rows` at a time. The caller
// keeps the plan and hands it to lstm_fwd, which only checks it.
struct FwdPlan {
  int route, units, blocks, rows;
  size_t smem;
  int w_shared, c_shared, max_blocks;
};

// staged row width: [x padded, h padded] for the step, h padded for the recurrence
int fwd_kp(int route, int F, int H) { return (route ? 0 : pad4(F)) + pad4(H); }

size_t fwd_smem(int B, int KP, int U, int rows, int wsh, int csh) {
  return ((wsh ? (size_t)4 * U * KP : 0) + (size_t)rows * KP + (csh ? (size_t)B * U : 0))
         * sizeof(float);
}

const void* fwd_kernel(int route, int wsh) {
  if (route) return wsh ? (const void*)lstm_fwd_kernel<true> : (const void*)lstm_fwd_kernel<false>;
  return wsh ? (const void*)lstm_step_kernel<true> : (const void*)lstm_step_kernel<false>;
}

cudaError_t make_fwd_plan(int T, int B, int F, int H, FwdPlan* p) {
  int sms;
  const int route = T > 1;
  cudaError_t err = device_sms(&sms, route);
  if (err != cudaSuccess) return err;
  const int U = units_for(H, sms);
  const int KP = fwd_kp(route, F, H);
  const int wsh = fwd_smem(B, KP, U, 0, 1, 0) <= W_SHARED_LIMIT;
  const int csh = route && fwd_smem(B, KP, U, 1, wsh, 1) <= SMEM_LIMIT;
  const size_t base = fwd_smem(B, KP, U, 0, wsh, csh);
  const size_t row = (size_t)KP * sizeof(float);
  if (base + row > SMEM_LIMIT) return cudaErrorInvalidValue;  // one row does not fit
  p->route = route;
  p->units = U;
  p->blocks = (H + U - 1) / U;
  p->w_shared = wsh;
  p->c_shared = csh;
  p->rows = (int)((size_t)B < (SMEM_LIMIT - base) / row ? B : (SMEM_LIMIT - base) / row);
  p->smem = fwd_smem(B, KP, U, p->rows, wsh, csh);
  const void* kernel = fwd_kernel(route, wsh);
  // the most any plan takes, so that plans of other shapes stay launchable
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)SMEM_LIMIT)) != cudaSuccess)
    return err;
  int occ = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, p->smem)) !=
      cudaSuccess)
    return err;
  p->max_blocks = occ * sms;
  // every block of the recurrence must be resident at once for grid.sync():
  // refuse, never hang
  if (route && p->blocks > p->max_blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

// The backward's launch: U = units_for(H, SMs) units a block, RW's U rows
// in shared memory when they fit in 128 KB, the cells' carries in shared
// memory when they fit, dz_t staged `rows` batch rows at a time, and the
// tail's scratch. The caller keeps the plan and hands it to lstm_bwd, which
// only checks it.

// The recurrence's instantiation for U units a block.
const void* bwd_kernel(int U, int wsh) {
  if (U <= 2) return wsh ? (const void*)lstm_bwd_kernel<2, true> : (const void*)lstm_bwd_kernel<2, false>;
  if (U <= 4) return wsh ? (const void*)lstm_bwd_kernel<4, true> : (const void*)lstm_bwd_kernel<4, false>;
  return wsh ? (const void*)lstm_bwd_kernel<8, true> : (const void*)lstm_bwd_kernel<8, false>;
}
struct BwdPlan {
  int units, blocks, rows;
  size_t smem;
  int w_shared, c_shared, max_blocks, tail_blocks;
  long long scratch;
};

// the recurrence's shared memory: RW's U rows (wsh), the carries (csh) and
// `rows` staged rows of dz_t
size_t bwd_smem(int B, int H, int U, int rows, int wsh, int csh) {
  const size_t row = (size_t)4 * H * sizeof(float);
  return (wsh ? U * row : 0) + (csh ? (size_t)5 * B * U * sizeof(float) : 0) + rows * row;
}

cudaError_t make_bwd_plan(int T, int B, int F, int H, int peephole, BwdPlan* p) {
  int sms;
  cudaError_t err = device_sms(&sms, 1);
  if (err != cudaSuccess) return err;
  const int U = units_for(H, sms);
  const size_t row = (size_t)4 * H * sizeof(float);
  const int wsh = U * row <= W_SHARED_LIMIT;
  // the carries and peephole sums of the block's cells: in shared memory
  // when they leave room for one staged row
  const int csh = bwd_smem(B, H, U, 1, wsh, 1) <= SMEM_LIMIT;
  const size_t base = bwd_smem(B, H, U, 0, wsh, csh);
  if (base + row > SMEM_LIMIT) return cudaErrorInvalidValue;  // one row does not fit
  p->units = U;
  p->blocks = (H + U - 1) / U;
  p->w_shared = wsh;
  p->c_shared = csh;
  p->rows = (int)((size_t)B < (SMEM_LIMIT - base) / row ? B : (SMEM_LIMIT - base) / row);
  p->smem = bwd_smem(B, H, U, p->rows, wsh, csh);
  int occ = 0;
  const void* kernel = bwd_kernel(U, wsh);
  // the most any plan takes, so that plans made for other shapes of the
  // same instantiation stay launchable
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)SMEM_LIMIT)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS,
                                                           p->smem)) != cudaSuccess)
    return err;
  p->max_blocks = occ * sms;
  Gemms gs;
  p->tail_blocks = tail_gemms(T, B, F, H, peephole, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr, &gs, &p->scratch);
  // every block must be resident at once for grid.sync(): refuse, never hang
  if (p->blocks > p->max_blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

extern "C" int lstm_plan(int T, int B, int F, int H, long long* out) {
  FwdPlan p;
  cudaError_t err = make_fwd_plan(T, B, F, H, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.route;
  out[1] = p.units;
  out[2] = p.blocks;
  out[3] = p.rows;
  out[4] = (long long)p.smem;
  out[5] = p.w_shared;
  out[6] = p.c_shared;
  out[7] = p.max_blocks;
  return 0;
}

// route, units, rows, w_shared, c_shared, smem: lstm_plan's for this shape,
// which the caller keeps; checked here, not worked out again. zx: [T, B, 4H]
// floats for route 1, else unused.
extern "C" int lstm_fwd(const void* x, const void* wcat, const void* bias,
                        const void* peep, const void* h0, const void* c0,
                        const void* mask, void* zx, void* ys, void* cs,
                        void* h_out, void* c_out, int T, int B, int F, int H,
                        int peephole, int route, int units, int rows,
                        int w_shared, int c_shared, long long smem, void* stream) {
  const int KP = fwd_kp(route, F, H);
  if (route != (T > 1) || units < 1 || units > H || rows < 1 || rows > B ||
      (c_shared && !route) || (route && zx == nullptr) ||
      (w_shared && fwd_smem(B, KP, units, 0, 1, 0) > W_SHARED_LIMIT) ||
      smem > (long long)SMEM_LIMIT ||
      smem != (long long)fwd_smem(B, KP, units, rows, w_shared, c_shared))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdArgs a;
  a.x = static_cast<const float*>(x);
  a.wcat = static_cast<const float*>(wcat);
  a.bias = static_cast<const float*>(bias);
  a.peep = peephole ? static_cast<const float*>(peep) : nullptr;
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.mask = static_cast<const float*>(mask);
  a.zx = static_cast<const float*>(zx);
  a.ys = static_cast<float*>(ys);
  a.cs = static_cast<float*>(cs);
  a.h_out = static_cast<float*>(h_out);
  a.c_out = static_cast<float*>(c_out);
  a.T = T;
  a.B = B;
  a.F = F;
  a.H = H;
  a.U = units;
  a.rows = rows;
  a.csh = c_shared;
  // h_{t-1} staged by 16-byte cp.async when its rows are whole chunks
  a.vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(h0) % 16 == 0;
  const dim3 grid((H + units - 1) / units);
  cudaError_t err;
  if (!route) {
    if (w_shared) lstm_step_kernel<true><<<grid, THREADS, (size_t)smem, st>>>(a);
    else lstm_step_kernel<false><<<grid, THREADS, (size_t)smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // 1. the hoisted product: zx = x W_x + b for every row, K = F in one pass
  Gemms xg;
  xg.n = 0;
  xg.scratch = nullptr;
  long long none = 0;
  Gemm g = gemm_of(a.x, F, 1, a.wcat, 4 * H, 1, static_cast<float*>(zx), 4 * H, T * B, 4 * H, F);
  g.bias = a.bias;
  const int x_blocks = add_gemm(&xg, &none, g, false);
  lstm_fwd_x_kernel<<<x_blocks, THREADS, 0, st>>>(xg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 2. the recurrence (a grid that cannot be co-resident is refused here)
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fwd_kernel(1, w_shared), grid, dim3(THREADS), args,
                                    (size_t)smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lstm_bwd_plan(int T, int B, int F, int H, int peephole, long long* out) {
  BwdPlan p;
  cudaError_t err = make_bwd_plan(T, B, F, H, peephole, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.units;
  out[1] = p.blocks;
  out[2] = p.rows;
  out[3] = (long long)p.smem;
  out[4] = p.w_shared;
  out[5] = p.c_shared;
  out[6] = p.max_blocks;
  out[7] = p.tail_blocks;
  out[8] = p.scratch;
  return 0;
}

// units, rows, w_shared, c_shared, smem, scratch_floats: lstm_bwd_plan's
// for this shape, which the caller keeps; checked here, not worked out
// again. scratch: `scratch_floats` floats.
extern "C" int lstm_bwd(const void* x, const void* hprev, const void* cprev,
                        const void* wcat, const void* bias, const void* peep,
                        const void* dys, const void* dht, const void* dct,
                        const void* mask, void* dx, void* dw, void* db,
                        void* dpeep, void* dh0, void* dc0, void* zdz,
                        void* pacc, void* scratch, int T, int B, int F, int H,
                        int peephole, int units, int rows, int w_shared,
                        int c_shared, long long smem, long long scratch_floats,
                        void* stream) {
  const size_t row = (size_t)4 * H * sizeof(float);
  if (units < 1 || units > H || rows < 1 || rows > B ||
      (w_shared && units * row > W_SHARED_LIMIT) || smem > (long long)SMEM_LIMIT ||
      smem != (long long)bwd_smem(B, H, units, rows, w_shared, c_shared))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xa = static_cast<const float*>(x);
  const float* hpa = static_cast<const float*>(hprev);
  const float* cpa = static_cast<const float*>(cprev);
  const float* wa = static_cast<const float*>(wcat);
  const float* pa = peephole ? static_cast<const float*>(peep) : nullptr;
  const float* dya = static_cast<const float*>(dys);
  const float* dhta = static_cast<const float*>(dht);
  const float* dcta = static_cast<const float*>(dct);
  const float* ma = static_cast<const float*>(mask);
  float* dha = static_cast<float*>(dh0);
  float* dca = static_cast<float*>(dc0);
  float* za = static_cast<float*>(zdz);
  float* paa = static_cast<float*>(pacc);
  const int H4 = 4 * H;

  // 1. the hoisted product: z = [x, hprev] Wcat + b for every row
  Gemms zg;
  zg.n = 0;
  zg.scratch = nullptr;
  long long none = 0;
  Gemm g = gemm_of(xa, F, 1, wa, H4, 1, za, H4, T * B, H4, F + H);
  g.A2 = hpa;
  g.sai2 = H;
  g.sap2 = 1;
  g.pa = F;
  g.bias = static_cast<const float*>(bias);
  const int z_blocks = add_gemm(&zg, &none, g, false);  // K in one pass
  lstm_z_kernel<<<z_blocks, THREADS, 0, st>>>(zg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // 2. the recurrence (a grid that cannot be co-resident is refused here)
  int U = units, csh = c_shared;
  void* args[] = {&cpa, &wa, &pa, &dya, &dhta, &dcta, &ma, &dha, &dca, &za, &paa,
                  &T, &B, &F, &H, &U, &rows, &csh};
  err = cudaLaunchCooperativeKernel(bwd_kernel(U, w_shared), dim3((H + U - 1) / U),
                                    dim3(THREADS), args, (size_t)smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // 3. the tail: every product in one launch, then the slices summed
  Gemms tg;
  long long need = 0;
  const int blocks = tail_gemms(T, B, F, H, peephole, xa, hpa, wa, za, paa,
                                static_cast<float*>(dw), static_cast<float*>(db),
                                static_cast<float*>(dx), static_cast<float*>(dpeep), &tg,
                                &need);
  if (need != scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  tg.scratch = static_cast<float*>(scratch);
  lstm_tail_kernel<<<blocks, THREADS, 0, st>>>(tg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  Gemms sg;
  sg.n = 0;
  sg.scratch = tg.scratch;
  for (int k = 0; k < tg.n; ++k)
    if (tg.g[k].part >= 0) sg.g[sg.n++] = tg.g[k];
  if (sg.n > 0) {
    lstm_sum_kernel<<<dim3(64, sg.n), THREADS, 0, st>>>(sg);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
