// Flash attention at head dims above 128: the forward, dQ and dK/dV.
//
// Replaces, for D > 128: deeplearning4j_tpu/ops/pallas_kernels.py,
// _flash_fwd_kernel (the pallas_call at :180), _flash_bwd_dq_kernel (:519)
// and _flash_bwd_dkv_kernel (:543). The JAX kernels take any head dim;
// flash_fwd.cu and flash_bwd.cu are instantiated at widths up to 128, and
// ops/flash_attention.py flash_plan sends every D above that here.
//
// Computes exactly what those kernels compute (see their header notes):
// s = q.k / sqrt(D) with masked logits -1e30, p = 0 where s <= -1e30, l
// clamped at 1e-20, lse = m + log(l); the backward recomputes P from lse,
// dS = P * (dO.v - delta) * scale, dQ = dS.K, dK = dS^T.Q, dV = P^T.dO. All
// in float32, written in the inputs' dtype (float32 or bfloat16).
//
// What bounds it on the H100: operations, as for the narrow kernels.
//
// The forward runs on the tensor cores, as flash_fwd.cu does: both products
// as split-TF32 mma.sync m16n8k8 (hi.lo + lo.hi + hi.hi, tf32_mma.cuh; a
// bfloat16 K or V is exact in TF32 and its lo pass is skipped).
// - Block (b * h, 16 query rows, column group g) writes the output columns
//   [128 g, 128 g + 128); G = ceil(D / 128) groups, any D.
// - Every group recomputes S = (Q / sqrt(D)) K^T over the full D, in
//   128-column slabs, each slab in fresh accumulators and added to S in
//   float32 in slab order. Every group runs the same slabs in the same
//   order with the same key split, so every group forms the same S, m, l
//   and P bitwise; lse is written once, by group 0. Chosen over sharing S
//   between the groups of one block: a block would then hold every group's
//   128 output columns (64 registers a lane each) or pass P through shared
//   memory with a barrier a key tile; recomputing costs G - 1 more slab
//   products, at D = 256 a third of the block's mma work.
// - A warp a key split, 4 splits at every grid (flash_plan; the setting
//   measured at the wide phase's 128 blocks), warp s taking key tiles s,
//   s + 4, ...; each warp stages its own slabs of the query rows and of a
//   32-key tile and the tile's 128 value columns (float32 by 16-byte
//   cp.async, else plain loads; rows padded to 132 floats so fragment reads
//   hit distinct banks), so warps need no block barrier until they fold
//   (m, l, O) in split order through shared memory.
// - S and P stay in registers as accumulator fragments; the online softmax
//   runs on fragment rows; P feeds P.V_g as the A operand with its keys
//   permuted alike in V. The tensor core's float32 accumulation truncates,
//   so each 8-column block of a tile's P.V_g is summed in fresh accumulators
//   and added to the rescaled output in float32.
//
// The backward (dQ, dK/dV) is still the first design, on the CUDA cores in
// float32:
// - Output-column split: block (b * h, row tile, g) writes dQ, or dK and
//   dV, in the columns [128 g, 128 g + 128); a lane holds 8 accumulators
//   whatever D is.
// - The score products (Q.K^T and dO.V^T) run over the full D in every
//   group, streamed through shared memory in slabs of 64 columns, so each
//   group recomputes S and dP: G times the score work. Every group runs the
//   same slabs in the same order, so every group forms the same P and dS.
// - A block is 256 threads over 16 output rows; the 16 threads of a row
//   are 16 neighbouring lanes of one warp. A thread holds 2 score entries
//   of its row (columns c and c + 16 of a 32-row tile) and 8 output columns
//   (c + 16 j). Shared rows are padded (65, 33, 129 floats) so the column
//   reads of a warp hit distinct banks or broadcast.
// - Lever: the split-TF32 mma.sync of the forward and of flash_bwd.cu.
// All three: causal tiles past the block's last query (or before its first
// key) are skipped; ragged lengths and D are masked with zeros; every sum
// runs in a fixed order, with no atomics: the result is bitwise the same
// from run to run.

#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32mma::store;
using tf32mma::to_f32;

constexpr int BR = 16;        // output rows of a block
constexpr int BT = 32;        // rows of a streamed tile (keys, or queries)
constexpr int SL = 64;        // columns of a score slab
constexpr int GW = 128;       // output columns of a group
constexpr int THREADS = 256;  // 16 threads a row
constexpr int NJ = GW / 16;   // output columns of a thread
constexpr float NEG = -1e30f;

// All float32, so each size is the sum flash_plan computes.
struct DqSmem {
  float a[2][BR][SL + 1];  // Q, dO slabs
  float b[2][BT][SL + 1];  // K, V slabs
  float ds[BR][BT + 1];
  float k[BT][GW + 1];     // K tile, the group's columns
};
struct DkvSmem {
  float a[2][BR][SL + 1];  // K, V slabs
  float b[2][BT][SL + 1];  // Q, dO slabs
  float p[BR][BT + 1];     // P^T
  float ds[BR][BT + 1];    // dS^T
  float q[BT][GW + 1];     // Q and dO tiles, the group's columns
  float g[BT][GW + 1];
};

// Rows t0 .. t0 + N - 1 and columns c0 .. c0 + NC - 1 of head (b, h) of a
// [B, T, H, D] tensor into dst[N][LDD] as float32 times `mul`; zeros past
// T and past D.
template <int N, int NC, int LDD, typename T>
__device__ __forceinline__ void stage(float (*dst)[LDD],
                                      const T* __restrict__ src, int b, int h,
                                      int H, int T_, int D, int t0, int c0,
                                      float mul) {
  for (int idx = threadIdx.x; idx < N * NC; idx += THREADS) {
    const int r = idx / NC, c = idx % NC;
    const int t = t0 + r, d = c0 + c;
    dst[r][c] = t < T_ && d < D
        ? to_f32(src[(((size_t)b * T_ + t) * H + h) * D + d]) * mul : 0.f;
  }
}

// acc[e] += sum_s a[r][s] * b[c + 16 e][s] over one slab
__device__ __forceinline__ void slab_dot(const float (*a)[SL + 1],
                                         const float (*b)[SL + 1], int r,
                                         int c, float (&acc)[2]) {
#pragma unroll 16
  for (int s = 0; s < SL; ++s) {
    const float x = a[r][s];
    acc[0] = fmaf(x, b[c][s], acc[0]);
    acc[1] = fmaf(x, b[c + 16][s], acc[1]);
  }
}

// acc[j] += sum_k w[r][k] * m[k][c + 16 j] over one tile
__device__ __forceinline__ void tile_out(const float (*w)[BT + 1],
                                         const float (*m)[GW + 1], int r,
                                         int c, float (&acc)[NJ]) {
#pragma unroll 4
  for (int k = 0; k < BT; ++k) {
    const float x = w[r][k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = fmaf(x, m[k][c + 16 * j], acc[j]);
  }
}

// ------------------------------------------------------------- the forward
constexpr int FR = 16;         // query rows of a forward block (one mma row group)
constexpr int FK = 32;         // keys of a forward tile
constexpr int FNB = FK / 8;    // 8-key mma blocks of a tile
constexpr int LDW = GW + 4;    // a padded row of a slab: conflict-free fragments
constexpr int SPLITS = 4;      // key splits (warps) of a forward block

// One warp's staging area (all float32, so the size is the sum flash_plan
// computes): a 128-column slab of the scaled query rows and of a key tile,
// and the group's 128 columns of the tile's values.
struct FwdWarpSmem {
  float q[FR][LDW];
  float k[FK][LDW];
  float v[FK][LDW];
};

// Rows t0 .. t0 + N - 1 and columns c0 .. c0 + 127 of head (b, h) of a
// [B, T, H, D] tensor into dst[N][LDW] as float32, by the lanes of one warp;
// zeros past T and past D. vec (float32, D % 4 == 0, 16-byte aligned):
// 16-byte cp.async, zero-filled, and the caller waits; else plain loads, 8
// in flight a lane before their stores.
template <int N, typename T>
__device__ __forceinline__ void warp_stage(float (*dst)[LDW], const T* __restrict__ src, int b,
                                           int h, int H, int T_, int D, int t0, int c0,
                                           bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    for (int idx = lane; idx < N * GW / 4; idx += 32) {
      const int r = idx / (GW / 4), c = 4 * (idx % (GW / 4));
      const int t = t0 + r, d = c0 + c;
      const bool in = t < T_ && d < D;
      tf32mma::cp_async16(&dst[r][c], in ? src + (((size_t)b * T_ + t) * H + h) * D + d : src,
                          in);
    }
    return;
  }
  constexpr int BATCH = 8;
#pragma unroll 1
  for (int j0 = 0; j0 < N * GW / 32; j0 += BATCH) {
    float x[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = lane + 32 * (j0 + j);
      const int t = t0 + idx / GW, d = c0 + idx % GW;
      x[j] = t < T_ && d < D ? to_f32(src[(((size_t)b * T_ + t) * H + h) * D + d]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = lane + 32 * (j0 + j);
      dst[idx / GW][idx % GW] = x[j];
    }
  }
}

// The A fragment of query rows g, g + 8 and columns c + t, c + t + 4 of a
// slab, times the logit scale (the product the scaled query would hold),
// split into hi and lo.
__device__ __forceinline__ void frag_q(const float (*m)[LDW], int c, int g, int t, float scale,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  tf32mma::split(m[g][c + t] * scale, hi[0], lo[0]);
  tf32mma::split(m[g + 8][c + t] * scale, hi[1], lo[1]);
  tf32mma::split(m[g][c + t + 4] * scale, hi[2], lo[2]);
  tf32mma::split(m[g + 8][c + t + 4] * scale, hi[3], lo[3]);
}

// Block (b * h, row tile, group g): 16 query rows, output columns
// [128 g, 128 g + 128), `splits` warps, warp s taking key tiles s, s + splits,
// ... (a warp stages into its own area and needs no block barrier until the
// fold). EXACT: bfloat16 inputs, K and V exact in TF32 (their lo pass skipped).
template <typename T, bool EXACT>
__global__ void __launch_bounds__(SPLITS * 32)
flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ key_mask, T* __restrict__ out,
                      float* __restrict__ lse, int BH, int H, int Tq, int Tk,
                      int D, float scale, int causal, int vec) {
  using namespace tf32mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int splits = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  FwdWarpSmem& sm = reinterpret_cast<FwdWarpSmem*>(smem_raw)[warp];
  const int n_qt = (Tq + FR - 1) / FR;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * FR;  // heaviest first
  const int b = bh / H, h = bh % H;
  const int gc0 = blockIdx.y * GW;
  const int r0 = q0 + g, r1 = r0 + 8;  // this lane's rows
  const int slabs = (D + GW - 1) / GW;

  float acc[GW / 8][4];
#pragma unroll
  for (int nd = 0; nd < GW / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m0 = NEG, m1 = NEG;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;  // this lane's share of the running sums
  const int k_end = causal ? min(Tk, q0 + FR) : Tk;
  const int n_kt = (k_end + FK - 1) / FK;
  for (int kt = warp; kt < n_kt; kt += splits) {
    const int kb = kt * FK;
    __syncwarp();  // the last tile's readers are done with this area
    warp_stage<FK>(sm.v, v, b, h, H, Tk, D, kb, gc0, vec);
    cp_async_commit();
    // S = (Q / sqrt(D)) K^T over the full D, a 128-column slab at a time:
    // each slab in fresh accumulators (hi.hi apart from the cross terms),
    // added to S in float32 in slab order. Every group runs the same slabs
    // in the same order, so every group forms the same S, m, l and P bitwise.
    float s[FNB][4];
#pragma unroll
    for (int nb = 0; nb < FNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    for (int sl = 0; sl < slabs; ++sl) {
      const int c0 = sl * GW;
      if (sl > 0) __syncwarp();
      warp_stage<FR>(sm.q, q, b, h, H, Tq, D, q0, c0, vec);
      warp_stage<FK>(sm.k, k, b, h, H, Tk, D, kb, c0, vec);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      float p[FNB][4], px[FNB][4];
#pragma unroll
      for (int nb = 0; nb < FNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nb][e] = px[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < GW / 8; ++kk) {
        if (c0 + kk * 8 >= D) continue;  // zero columns add nothing
        uint32_t ah[4], al[4];
        frag_q(sm.q, kk * 8, g, t4, scale, ah, al);
#pragma unroll
        for (int nb = 0; nb < FNB; ++nb) {
          uint32_t bh0, bl0, bh1, bl1;
          split(sm.k[nb * 8 + g][kk * 8 + t4], bh0, bl0);
          split(sm.k[nb * 8 + g][kk * 8 + t4 + 4], bh1, bl1);
          mma_split<false, EXACT>(p[nb], px[nb], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int nb = 0; nb < FNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] += p[nb][e] + px[nb][e];
    }
    // mask, then the tile's row max (4 lanes share a row)
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nb = 0; nb < FNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nb * 8 + 2 * t4 + (e & 1);
        const int row = (e & 2) ? r1 : r0;
        if (key >= Tk || (key_mask && __ldg(&key_mask[(size_t)b * Tk + key]) <= 0.f) ||
            (causal && key > row))
          s[nb][e] = NEG;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
    // P as A fragments: lane (g, t) holds P[g][2t], P[g][2t+1], P[g+8][2t],
    // P[g+8][2t+1], so k-row t stands for key 2t and k-row t + 4 for 2t + 1
    uint32_t ph[FNB][4], pl[FNB][4];
#pragma unroll
    for (int nb = 0; nb < FNB; ++nb) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mr = (e & 2) ? mn1 : mn0;
        pv[e] = s[nb][e] <= NEG ? 0.f : expf(s[nb][e] - mr);
        if (e & 2) l1 += pv[e]; else l0 += pv[e];
      }
      c_to_a(pv, ph[nb], pl[nb]);
    }
    // O = O alpha + P V_g: each 8-column block of the tile in fresh
    // accumulators (the tensor core's float32 accumulation truncates), added
    // in float32
#pragma unroll
    for (int nd = 0; nd < GW / 8; ++nd) {
      acc[nd][0] *= a0;
      acc[nd][1] *= a0;
      acc[nd][2] *= a1;
      acc[nd][3] *= a1;
      if (gc0 + nd * 8 >= D) continue;  // the group's columns past D
      float o[4] = {0.f, 0.f, 0.f, 0.f}, ox[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < FNB; ++nb) {
        const int key = nb * 8 + 2 * t4;
        uint32_t bh0, bl0, bh1, bl1;
        split(sm.v[key][nd * 8 + g], bh0, bl0);
        split(sm.v[key + 1][nd * 8 + g], bh1, bl1);
        mma_split<false, EXACT>(o, ox, ph[nb], pl[nb], bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] += o[e] + ox[e];
    }
  }

  // warps 1.. hand their state to warp 0 through their own (now idle)
  // areas; warp 0 folds them in split order
  constexpr int PER_LANE = GW / 2 + 4;
  static_assert(32 * PER_LANE <= FR * LDW + FK * LDW, "fold does not fit");
  __syncwarp();
  if (warp > 0) {
    float* mine = &sm.q[0][0] + lane * PER_LANE;
#pragma unroll
    for (int nd = 0; nd < GW / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[nd * 4 + e] = acc[nd][e];
    mine[GW / 2 + 0] = m0;
    mine[GW / 2 + 1] = m1;
    mine[GW / 2 + 2] = l0;
    mine[GW / 2 + 3] = l1;
  }
  __syncthreads();
  if (warp != 0) return;
  for (int o = 1; o < splits; ++o) {
    const float* other =
        &reinterpret_cast<FwdWarpSmem*>(smem_raw)[o].q[0][0] + lane * PER_LANE;
    const float om0 = other[GW / 2 + 0], om1 = other[GW / 2 + 1];
    const float n0 = fmaxf(m0, om0), n1 = fmaxf(m1, om1);
    const float a0 = expf(m0 - n0), b0 = expf(om0 - n0);
    const float a1 = expf(m1 - n1), b1 = expf(om1 - n1);
    l0 = l0 * a0 + other[GW / 2 + 2] * b0;
    l1 = l1 * a1 + other[GW / 2 + 3] * b1;
#pragma unroll
    for (int nd = 0; nd < GW / 8; ++nd) {
      acc[nd][0] = acc[nd][0] * a0 + other[nd * 4 + 0] * b0;
      acc[nd][1] = acc[nd][1] * a0 + other[nd * 4 + 1] * b0;
      acc[nd][2] = acc[nd][2] * a1 + other[nd * 4 + 2] * b1;
      acc[nd][3] = acc[nd][3] * a1 + other[nd * 4 + 3] * b1;
    }
    m0 = n0;
    m1 = n1;
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float ls0 = fmaxf(l0, 1e-20f), ls1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= Tq) continue;
    const float ls = half ? ls1 : ls0;
    T* op = out + (((size_t)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < GW / 8; ++nd) {
      const int d = gc0 + nd * 8 + 2 * t4;
      if (d < D) store(op + d, acc[nd][2 * half] / ls);
      if (d + 1 < D) store(op + d + 1, acc[nd][2 * half + 1] / ls);
    }
    // lse once: group 0 writes it
    if (blockIdx.y == 0 && t4 == 0) lse[(size_t)bh * Tq + row] = (half ? m1 : m0) + logf(ls);
  }
}

// ------------------------------------------------------------ the backward
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ key_mask, T* __restrict__ dq,
                     int BH, int H, int Tq, int Tk, int D, float scale,
                     int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int n_qt = (Tq + BR - 1) / BR;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * BR;
  const int b = bh / H, h = bh % H;
  const int gc0 = blockIdx.y * GW;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int row = q0 + r;
  const float lse_r = row < Tq ? lse[(size_t)bh * Tq + row] : 0.f;
  const float dl_r = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  const int k_end = causal ? min(Tk, q0 + BR) : Tk;
  for (int kb = 0; kb < k_end; kb += BT) {
    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
    for (int s0 = 0; s0 < D; s0 += SL) {
      stage<BR, SL, SL + 1>(sm.a[0], q, b, h, H, Tq, D, q0, s0, 1.f);
      stage<BR, SL, SL + 1>(sm.a[1], dout, b, h, H, Tq, D, q0, s0, 1.f);
      stage<BT, SL, SL + 1>(sm.b[0], k, b, h, H, Tk, D, kb, s0, 1.f);
      stage<BT, SL, SL + 1>(sm.b[1], v, b, h, H, Tk, D, kb, s0, 1.f);
      __syncthreads();
      slab_dot(sm.a[0], sm.b[0], r, c, s);
      slab_dot(sm.a[1], sm.b[1], r, c, dp);
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = kb + c + 16 * e;
      const bool masked = key >= Tk
          || (key_mask && key_mask[(size_t)b * Tk + key] <= 0.f)
          || (causal && key > row);
      const float sv = s[e] * scale;
      const float p = masked || sv <= NEG ? 0.f : expf(sv - lse_r);
      sm.ds[r][c + 16 * e] = p * (dp[e] - dl_r) * scale;
    }
    stage<BT, GW, GW + 1>(sm.k, k, b, h, H, Tk, D, kb, gc0, 1.f);
    __syncthreads();
    tile_out(sm.ds, sm.k, r, c, acc);
    __syncthreads();
  }
  if (row >= Tq) return;
  T* op = dq + (((size_t)b * Tq + row) * H + h) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = gc0 + c + 16 * j;
    if (d < D) store(op + d, acc[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ key_mask, T* __restrict__ dk,
                      T* __restrict__ dv, int BH, int H, int Tq, int Tk,
                      int D, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * BR;  // heaviest (first keys) first
  const int b = bh / H, h = bh % H;
  const int gc0 = blockIdx.y * GW;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int key = k0 + r;
  const float km_r = key < Tk
      ? (key_mask ? key_mask[(size_t)b * Tk + key] : 1.f) : 0.f;
  const float* lrow = lse + (size_t)bh * Tq;
  const float* drow = delta + (size_t)bh * Tq;

  float dka[NJ], dva[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dka[j] = dva[j] = 0.f;
  for (int qb = causal ? k0 : 0; qb < Tq; qb += BT) {
    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
    for (int s0 = 0; s0 < D; s0 += SL) {
      stage<BR, SL, SL + 1>(sm.a[0], k, b, h, H, Tk, D, k0, s0, 1.f);
      stage<BR, SL, SL + 1>(sm.a[1], v, b, h, H, Tk, D, k0, s0, 1.f);
      stage<BT, SL, SL + 1>(sm.b[0], q, b, h, H, Tq, D, qb, s0, 1.f);
      stage<BT, SL, SL + 1>(sm.b[1], dout, b, h, H, Tq, D, qb, s0, 1.f);
      __syncthreads();
      slab_dot(sm.a[0], sm.b[0], r, c, s);
      slab_dot(sm.a[1], sm.b[1], r, c, dp);
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = qb + c + 16 * e;
      const bool masked = km_r <= 0.f || i >= Tq || (causal && key > i);
      const float sv = s[e] * scale;
      const float p = masked || sv <= NEG ? 0.f : expf(sv - lrow[i]);
      sm.p[r][c + 16 * e] = p;
      sm.ds[r][c + 16 * e] = masked ? 0.f : p * (dp[e] - drow[i]) * scale;
    }
    stage<BT, GW, GW + 1>(sm.q, q, b, h, H, Tq, D, qb, gc0, 1.f);
    stage<BT, GW, GW + 1>(sm.g, dout, b, h, H, Tq, D, qb, gc0, 1.f);
    __syncthreads();
    tile_out(sm.p, sm.g, r, c, dva);
    tile_out(sm.ds, sm.q, r, c, dka);
    __syncthreads();
  }
  if (key >= Tk) return;
  const size_t off = (((size_t)b * Tk + key) * H + h) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = gc0 + c + 16 * j;
    if (d < D) {
      store(dk + off + d, dka[j]);
      store(dv + off + d, dva[j]);
    }
  }
}

// Raise the block's dynamic shared-memory limit once per instantiation
// (idempotent: a race only sets it twice).
template <typename F>
cudaError_t allow_smem(F* kernel, int smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = err == cudaSuccess;
  return err;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *km;
  void *o1, *o2;  // out; dq; or dk, dv
  float* lse_out;
  int B, H, Tq, Tk, D, groups, smem;
  float scale;
  int causal;
};

template <typename T>
cudaError_t launch_fwd(const Args& a, int splits, cudaStream_t s) {
  if (splits != SPLITS || a.smem != SPLITS * (int)sizeof(FwdWarpSmem) ||
      a.D < 1 || a.groups != (a.D + GW - 1) / GW)
    return cudaErrorInvalidValue;
  constexpr bool EXACT = sizeof(T) == 2;
  static bool done = false;
  cudaError_t err;
  if ((err = allow_smem(flash_wide_fwd_kernel<T, EXACT>, SPLITS * (int)sizeof(FwdWarpSmem),
                        done)) != cudaSuccess)
    return err;
  // cp.async moves float32 rows 16 bytes at a time from 16-byte aligned q,
  // k and v whose rows are whole chunks; anything else goes through plain
  // loads
  const int vec = sizeof(T) == 4 && a.D % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  const dim3 grid(a.B * a.H * ((a.Tq + FR - 1) / FR), a.groups);
  flash_wide_fwd_kernel<T, EXACT><<<grid, splits * 32, a.smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.km,
      static_cast<T*>(a.o1), a.lse_out, a.B * a.H, a.H, a.Tq, a.Tk, a.D, a.scale, a.causal, vec);
  return cudaGetLastError();
}

// 1: dQ, 2: dK/dV
template <typename T, int KIND>
cudaError_t launch_bwd(const Args& a, cudaStream_t s) {
  constexpr int bytes = KIND == 1 ? (int)sizeof(DqSmem) : (int)sizeof(DkvSmem);
  if (a.smem != bytes || a.D < 1 || a.groups != (a.D + GW - 1) / GW)
    return cudaErrorInvalidValue;
  const int BH = a.B * a.H;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  static bool done = false;
  cudaError_t err;
  if constexpr (KIND == 1) {
    if ((err = allow_smem(flash_wide_dq_kernel<T>, a.smem, done)) != cudaSuccess) return err;
    const dim3 grid(BH * ((a.Tq + BR - 1) / BR), a.groups);
    flash_wide_dq_kernel<T><<<grid, THREADS, a.smem, s>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta, a.km,
        static_cast<T*>(a.o1), BH, a.H, a.Tq, a.Tk, a.D, a.scale, a.causal);
  } else {
    if ((err = allow_smem(flash_wide_dkv_kernel<T>, a.smem, done)) != cudaSuccess) return err;
    const dim3 grid(BH * ((a.Tk + BR - 1) / BR), a.groups);
    flash_wide_dkv_kernel<T><<<grid, THREADS, a.smem, s>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta, a.km,
        static_cast<T*>(a.o1), static_cast<T*>(a.o2), BH, a.H, a.Tq, a.Tk,
        a.D, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <int KIND>
int run(const Args& a, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch_bwd<__nv_bfloat16, KIND>(a, s)
                                  : launch_bwd<float, KIND>(a, s));
}

}  // namespace

// The signatures of flash_fwd, flash_bwd_dq and flash_bwd_dkv, with the
// plan's column groups in place of the width.
extern "C" int flash_wide_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, void* lse,
                              int B, int H, int Tq, int Tk, int D, int groups,
                              int splits, int smem, float scale, int causal,
                              int is_bf16, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr,
               static_cast<const float*>(key_mask), out, nullptr,
               static_cast<float*>(lse), B, H, Tq, Tk, D, groups, smem, scale,
               causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch_fwd<__nv_bfloat16>(a, splits, s)
                                  : launch_fwd<float>(a, splits, s));
}

extern "C" int flash_wide_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* key_mask, void* dq,
                             int B, int H, int Tq, int Tk, int D, int groups,
                             int smem, float scale, int causal, int is_bf16,
                             void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(key_mask), dq, nullptr, nullptr, B, H,
               Tq, Tk, D, groups, smem, scale, causal};
  return run<1>(a, is_bf16, stream);
}

extern "C" int flash_wide_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* key_mask,
                              void* dk, void* dv, int B, int H, int Tq,
                              int Tk, int D, int groups, int smem, float scale,
                              int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(key_mask), dk, dv, nullptr, B, H, Tq,
               Tk, D, groups, smem, scale, causal};
  return run<2>(a, is_bf16, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
