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
// What bounds it on the H100: operations, as for the narrow kernels; at the
// wide training phase's shape (B * H = 8, T = 128) latency, since a block
// runs one or two streamed tiles.
//
// All three kernels run every product on the tensor cores, as flash_fwd.cu
// and flash_bwd.cu do: split-TF32 mma.sync m16n8k8 (hi.lo + lo.hi + hi.hi,
// tf32_mma.cuh; a bfloat16 operand is exact in TF32 and its lo pass is
// skipped). Their shared layout:
// - Block (b * h, 16 rows, column group g) writes the output columns
//   [128 g, 128 g + 128) of its 16 rows (queries for the forward and dQ,
//   keys for dK/dV); G = ceil(D / 128) groups, any D.
// - The scores (S, and dP in the backward) are recomputed by every group
//   over the full D, in 128-column slabs, each slab in fresh accumulators
//   and added in float32 in slab order. Every group runs the same slabs in
//   the same order with the same split of streamed tiles, so every group
//   forms the same S, P and dS bitwise. Chosen over sharing the scores
//   between the groups of one block: a block would then hold every group's
//   output columns (64 registers a lane each, 128 for dK and dV) or pass P
//   through shared memory with a barrier a tile; recomputing costs G - 1
//   more slab products of the scores.
// - A warp a split of the streamed tiles (32 keys, or 32 queries), 4 splits
//   at every grid (flash_plan; the wide phase has 128 blocks), warp s
//   taking tiles s, s + 4, ...; each warp stages its own slabs as float32
//   (float32 rows by 16-byte cp.async, bfloat16 rows by 16-byte loads, 8
//   in flight a lane; a D that leaves no whole 16-byte chunks a value at a
//   time; rows padded to 132 floats so fragment reads hit distinct banks),
//   so warps need no block barrier until they fold their partials in split
//   order through shared memory.
// - Scores stay in registers as accumulator fragments, and P (and dS) feed
//   the output product as A operands with the tile's rows permuted alike in
//   the B operand (tf32_mma.cuh). The tensor core's float32 accumulation
//   truncates, so each tile's output product is summed in fresh
//   accumulators and added to the total in float32.
// The forward: S = (Q / sqrt(D)) K^T, the online softmax on fragment rows,
// O += P.V_g; the fold merges (m, l, O) in split order.
// dQ: S = Q.K^T and dP = dO.V^T a key tile at a time, P and dS on the
// fragments, dQ_g += dS.K_g with the tile's K_g staged again into the K slab
// (the last slab is K_g already for the last group).
// dK/dV: keys as the mma rows, S^T = K.Q^T and dP^T = V.dO^T a query tile
// at a time, so P^T and dS^T are C fragments of key rows and dV_g +=
// P^T.dO_g and dK_g += dS^T.Q_g need no transpose (flash_bwd.cu's layout);
// the tile's lse and delta come in by cp.async with the first slab.
// Causal tiles past the block's last query (or before its first key) are
// skipped; ragged lengths and D are masked with zeros; every sum runs in a
// fixed order, with no atomics: the result is bitwise the same from run to
// run. tests/test_torch_kernel_design.py emulates each kernel's sum order
// on the CPU; tests/test_torch_cuda_kernels.py and chip_smoke.py hold the
// kernels against their plain versions on the card.

#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32mma::store;
using tf32mma::to_f32;

constexpr int GW = 128;       // output columns of a group, and of a slab
constexpr int LDW = GW + 4;   // a padded row of a slab: conflict-free fragments
constexpr int BR = 16;        // output rows of a block (one mma row group)
constexpr int BT = 32;        // rows of a streamed tile (keys, or queries)
constexpr int NB = BT / 8;    // 8-row mma blocks of a tile
constexpr int SPLITS = 4;     // tile splits (warps) of a block
constexpr float NEG = -1e30f;

// ------------------------------------------------------------- the forward
// One warp's staging area (all float32, so the size is the sum flash_plan
// computes): a 128-column slab of the scaled query rows and of a key tile,
// and the group's 128 columns of the tile's values.
struct FwdWarpSmem {
  float q[BR][LDW];
  float k[BT][LDW];
  float v[BT][LDW];
};

// Rows t0 .. t0 + N - 1 and columns c0 .. c0 + 127 of head (b, h) of a
// [B, T, H, D] tensor into dst[N][LDW] as float32, by the lanes of one warp;
// zeros past T and past D. vec (rows of whole 16-byte chunks, 16-byte
// aligned): float32 by 16-byte cp.async, zero-filled, and the caller waits;
// bfloat16 by 16-byte loads, 8 in flight a lane before their stores. Else
// plain loads of one value, 8 in flight a lane.
template <int N, typename T>
__device__ __forceinline__ void warp_stage(float (*dst)[LDW], const T* __restrict__ src, int b,
                                           int h, int H, int T_, int D, int t0, int c0,
                                           bool vec) {
  const int lane = threadIdx.x & 31;
  constexpr int BATCH = 8;
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      for (int idx = lane; idx < N * GW / 4; idx += 32) {
        const int r = idx / (GW / 4), c = 4 * (idx % (GW / 4));
        const int t = t0 + r, d = c0 + c;
        const bool in = t < T_ && d < D;
        tf32mma::cp_async16(&dst[r][c],
                            in ? src + (((size_t)b * T_ + t) * H + h) * D + d : src, in);
      }
    } else {  // bfloat16: 8 values a chunk, widened exactly (bits << 16)
      constexpr int CH = GW / 8;  // chunks of a row
      static_assert(N * CH % (32 * BATCH) == 0, "a lane's chunks come in whole batches");
#pragma unroll 1
      for (int j0 = 0; j0 < N * CH / 32; j0 += BATCH) {
        uint4 x[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int idx = lane + 32 * (j0 + j);
          const int t = t0 + idx / CH, d = c0 + 8 * (idx % CH);
          x[j] = t < T_ && d < D
              ? *reinterpret_cast<const uint4*>(src + (((size_t)b * T_ + t) * H + h) * D + d)
              : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int idx = lane + 32 * (j0 + j);
          float* o = &dst[idx / CH][8 * (idx % CH)];
          const uint32_t w[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[2 * e] = __uint_as_float(w[e] << 16);
            o[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
          }
        }
      }
    }
    return;
  }
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
  const int n_qt = (Tq + BR - 1) / BR;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * BR;  // heaviest first
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
  const int k_end = causal ? min(Tk, q0 + BR) : Tk;
  const int n_kt = (k_end + BT - 1) / BT;
  for (int kt = warp; kt < n_kt; kt += splits) {
    const int kb = kt * BT;
    __syncwarp();  // the last tile's readers are done with this area
    warp_stage<BT>(sm.v, v, b, h, H, Tk, D, kb, gc0, vec);
    cp_async_commit();
    // S = (Q / sqrt(D)) K^T over the full D, a 128-column slab at a time:
    // each slab in fresh accumulators (hi.hi apart from the cross terms),
    // added to S in float32 in slab order. Every group runs the same slabs
    // in the same order, so every group forms the same S, m, l and P bitwise.
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    for (int sl = 0; sl < slabs; ++sl) {
      const int c0 = sl * GW;
      if (sl > 0) __syncwarp();
      warp_stage<BR>(sm.q, q, b, h, H, Tq, D, q0, c0, vec);
      warp_stage<BT>(sm.k, k, b, h, H, Tk, D, kb, c0, vec);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      float p[NB][4], px[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nb][e] = px[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < GW / 8; ++kk) {
        if (c0 + kk * 8 >= D) continue;  // zero columns add nothing
        uint32_t ah[4], al[4];
        frag_q(sm.q, kk * 8, g, t4, scale, ah, al);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t bh0, bl0, bh1, bl1;
          split(sm.k[nb * 8 + g][kk * 8 + t4], bh0, bl0);
          split(sm.k[nb * 8 + g][kk * 8 + t4 + 4], bh1, bl1);
          mma_split<false, EXACT>(p[nb], px[nb], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] += p[nb][e] + px[nb][e];
    }
    // mask, then the tile's row max (4 lanes share a row)
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
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
    uint32_t ph[NB][4], pl[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
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
      for (int nb = 0; nb < NB; ++nb) {
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
  static_assert(32 * PER_LANE <= BR * LDW + BT * LDW, "fold does not fit");
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
// A warp's staging areas (all float32, so the sizes are the sums flash_plan
// computes). dQ: 128-column slabs of the block's query rows (Q, dO) and of
// a key tile (K, V); after the slabs, the tile's K_g in k. dK/dV: slabs of
// the block's key rows (K, V) and of a query tile (Q, dO), the tile's lse
// and delta; after the slabs, the tile's Q_g and dO_g in q and g.
struct DqWarpSmem {
  float q[BR][LDW];
  float g[BR][LDW];
  float k[BT][LDW];
  float v[BT][LDW];
};
struct DkvWarpSmem {
  float k[BR][LDW];
  float v[BR][LDW];
  float q[BT][LDW];
  float g[BT][LDW];
  float lse[BT];
  float dl[BT];
};

// acc += a.b^T over one slab (columns c0 .. c0 + 127, those past D
// skipped): the 16 rows of a as the mma rows, the 32 rows of b as its
// columns. The slab is summed in fresh accumulators (the cross terms in
// their own) and added to acc in float32, so every slab's sum is the same
// in every group.
template <bool EXACT>
__device__ __forceinline__ void slab_product(float (&acc)[NB][4], const float (*a)[LDW],
                                             const float (*b)[LDW], int c0, int D, int g,
                                             int t4) {
  using namespace tf32mma;
  float p[NB][4], px[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[nb][e] = px[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < GW / 8; ++kk) {
    if (c0 + kk * 8 >= D) continue;  // zero columns add nothing
    uint32_t ah[4], al[4];
    frag_a<LDW>(a, 0, kk * 8, g, t4, ah, al);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t bh0, bl0, bh1, bl1;
      split(b[nb * 8 + g][kk * 8 + t4], bh0, bl0);
      split(b[nb * 8 + g][kk * 8 + t4 + 4], bh1, bl1);
      mma_split<EXACT, EXACT>(p[nb], px[nb], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] += p[nb][e] + px[nb][e];
}

// total += A.B_g over one streamed tile: A is the tile's C fragments as split
// A operands (k-row t of block nb stands for tile row nb * 8 + 2t, k-row
// t + 4 for nb * 8 + 2t + 1), B_g the tile's rows in the group's columns.
// Each 8-column block is summed in fresh accumulators and added to the
// total in float32 (the tensor core's own accumulation truncates).
template <bool EXACT_B>
__device__ __forceinline__ void tile_product(float (&total)[GW / 8][4],
                                             const uint32_t (&ah)[NB][4],
                                             const uint32_t (&al)[NB][4],
                                             const float (*b)[LDW], int gc0, int D, int g,
                                             int t4) {
  using namespace tf32mma;
#pragma unroll
  for (int nd = 0; nd < GW / 8; ++nd) {
    if (gc0 + nd * 8 >= D) continue;  // the group's columns past D
    float o[4] = {0.f, 0.f, 0.f, 0.f}, ox[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int r = nb * 8 + 2 * t4;
      uint32_t bh0, bl0, bh1, bl1;
      split(b[r][nd * 8 + g], bh0, bl0);
      split(b[r + 1][nd * 8 + g], bh1, bl1);
      mma_split<false, EXACT_B>(o, ox, ah[nb], al[nb], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) total[nd][e] += o[e] + ox[e];
  }
}

// A warp's partial (16 rows x 128 columns as C fragments) into rows of
// its own staging area, for the fold.
__device__ __forceinline__ void park(float (*dst)[LDW], const float (&acc)[GW / 8][4], int g,
                                     int t4) {
#pragma unroll
  for (int nd = 0; nd < GW / 8; ++nd) {
    *reinterpret_cast<float2*>(&dst[g][nd * 8 + 2 * t4]) = make_float2(acc[nd][0], acc[nd][1]);
    *reinterpret_cast<float2*>(&dst[g + 8][nd * 8 + 2 * t4]) =
        make_float2(acc[nd][2], acc[nd][3]);
  }
}

// Block (b * h, 16 query rows, group g): dQ in the columns [128 g, 128 g +
// 128). Warp s takes key tiles s, s + 4, ...; EXACT: bfloat16 inputs, exact
// in TF32 (their lo passes skipped; dS keeps its split).
template <typename T, bool EXACT>
__global__ void __launch_bounds__(SPLITS * 32)
flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ key_mask, T* __restrict__ dq, int BH, int H,
                     int Tq, int Tk, int D, float scale, int causal, int vec) {
  using namespace tf32mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqWarpSmem* const areas = reinterpret_cast<DqWarpSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  DqWarpSmem& sm = areas[warp];
  const int n_qt = (Tq + BR - 1) / BR;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * BR;  // heaviest first
  const int b = bh / H, h = bh % H;
  const int gc0 = blockIdx.y * GW;
  const int r0 = q0 + g, r1 = r0 + 8;  // this lane's rows
  const int slabs = (D + GW - 1) / GW;
  const float lse0 = r0 < Tq ? lse[(size_t)bh * Tq + r0] : 0.f;
  const float lse1 = r1 < Tq ? lse[(size_t)bh * Tq + r1] : 0.f;
  const float dl0 = r0 < Tq ? delta[(size_t)bh * Tq + r0] : 0.f;
  const float dl1 = r1 < Tq ? delta[(size_t)bh * Tq + r1] : 0.f;
  const float* kmrow = key_mask ? key_mask + (size_t)b * Tk : nullptr;

  float acc[GW / 8][4];
#pragma unroll
  for (int nd = 0; nd < GW / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  const int k_end = causal ? min(Tk, q0 + BR) : Tk;
  const int n_kt = (k_end + BT - 1) / BT;
  for (int kt = warp; kt < n_kt; kt += SPLITS) {
    const int kb = kt * BT;
    // S = Q.K^T and dP = dO.V^T over the full D, a slab at a time, in slab
    // order: the same in every group
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    for (int sl = 0; sl < slabs; ++sl) {
      const int c0 = sl * GW;
      __syncwarp();  // the last slab's readers are done with this area
      warp_stage<BR>(sm.q, q, b, h, H, Tq, D, q0, c0, vec);
      warp_stage<BR>(sm.g, dout, b, h, H, Tq, D, q0, c0, vec);
      warp_stage<BT>(sm.k, k, b, h, H, Tk, D, kb, c0, vec);
      warp_stage<BT>(sm.v, v, b, h, H, Tk, D, kb, c0, vec);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      slab_product<EXACT>(s, sm.q, sm.k, c0, D, g, t4);
      slab_product<EXACT>(dp, sm.g, sm.v, c0, D, g, t4);
    }
    // P and dS on the fragments, as split A operands (keys permuted)
    uint32_t dh[NB][4], dlo[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nb * 8 + 2 * t4 + (e & 1);
        const int row = (e & 2) ? r1 : r0;
        const bool masked = key >= Tk || (kmrow && __ldg(&kmrow[key]) <= 0.f) ||
                            (causal && key > row);
        const float sv = s[nb][e] * scale;
        const float p = masked || sv <= NEG ? 0.f : expf(sv - ((e & 2) ? lse1 : lse0));
        ds[e] = p * (dp[nb][e] - ((e & 2) ? dl1 : dl0)) * scale;
      }
      c_to_a(ds, dh[nb], dlo[nb]);
    }
    // dQ_g += dS.K_g, the tile's K_g staged again unless g is the last
    // group: the last slab staged is K_g then. (Staged while P and dS were
    // formed, it spilled and took 20% longer on the H100 at the wide phase.)
    if (gc0 != (slabs - 1) * GW) {
      __syncwarp();  // every lane is done with the last slab
      warp_stage<BT>(sm.k, k, b, h, H, Tk, D, kb, gc0, vec);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
    }
    tile_product<EXACT>(acc, dh, dlo, sm.k, gc0, D, g, t4);
  }

  // every warp parks its partial in its query slab; the block adds the
  // partials in split order and writes the rows whole
  __syncwarp();
  park(sm.q, acc, g, t4);
  __syncthreads();
  for (int i = threadIdx.x; i < BR * GW; i += SPLITS * 32) {
    const int r = i / GW, c = i % GW;
    const int row = q0 + r, d = gc0 + c;
    if (row >= Tq || d >= D) continue;
    float x = areas[0].q[r][c];
#pragma unroll
    for (int w = 1; w < SPLITS; ++w) x += areas[w].q[r][c];
    store(dq + (((size_t)b * Tq + row) * H + h) * D + d, x);
  }
}

// Block (b * h, 16 key rows, group g): dK and dV in the columns [128 g,
// 128 g + 128). Warp s takes query tiles s, s + 4, ... from the block's
// first key under a causal mask (else from 0).
template <typename T, bool EXACT>
__global__ void __launch_bounds__(SPLITS * 32)
flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ key_mask, T* __restrict__ dk,
                      T* __restrict__ dv, int BH, int H, int Tq, int Tk, int D, float scale,
                      int causal, int vec) {
  using namespace tf32mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvWarpSmem* const areas = reinterpret_cast<DkvWarpSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  DkvWarpSmem& sm = areas[warp];
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * BR;  // heaviest (first keys) first
  const int b = bh / H, h = bh % H;
  const int gc0 = blockIdx.y * GW;
  const int j0 = k0 + g, j1 = j0 + 8;  // this lane's keys
  const int slabs = (D + GW - 1) / GW;
  const float* kmrow = key_mask ? key_mask + (size_t)b * Tk : nullptr;
  const bool live0 = j0 < Tk && !(kmrow && kmrow[j0] <= 0.f);
  const bool live1 = j1 < Tk && !(kmrow && kmrow[j1] <= 0.f);
  const float* lrow = lse + (size_t)bh * Tq;
  const float* drow = delta + (size_t)bh * Tq;

  float dka[GW / 8][4], dva[GW / 8][4];
#pragma unroll
  for (int nd = 0; nd < GW / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;
  const int q_begin = causal ? k0 : 0;
  const int n_it = Tq > q_begin ? (Tq - q_begin + BT - 1) / BT : 0;
  for (int it = warp; it < n_it; it += SPLITS) {
    const int qb = q_begin + it * BT;
    // S^T = K.Q^T and dP^T = V.dO^T, keys as rows, in slab order
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    for (int sl = 0; sl < slabs; ++sl) {
      const int c0 = sl * GW;
      __syncwarp();  // the last slab's readers are done with this area
      warp_stage<BR>(sm.k, k, b, h, H, Tk, D, k0, c0, vec);
      warp_stage<BR>(sm.v, v, b, h, H, Tk, D, k0, c0, vec);
      warp_stage<BT>(sm.q, q, b, h, H, Tq, D, qb, c0, vec);
      warp_stage<BT>(sm.g, dout, b, h, H, Tq, D, qb, c0, vec);
      if (sl == 0) {
        const int i = qb + lane;
        cp_async4(&sm.lse[lane], lrow + (i < Tq ? i : 0), i < Tq);
        cp_async4(&sm.dl[lane], drow + (i < Tq ? i : 0), i < Tq);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      slab_product<EXACT>(s, sm.k, sm.q, c0, D, g, t4);
      slab_product<EXACT>(dp, sm.v, sm.g, c0, D, g, t4);
    }
    // P^T and dS^T on the fragments, as split A operands (queries permuted)
    uint32_t ph[NB][4], pl[NB][4], dh[NB][4], dlo[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int iq = nb * 8 + 2 * t4 + (e & 1);
        const int i = qb + iq;
        const int key = (e & 2) ? j1 : j0;
        const bool masked = !((e & 2) ? live1 : live0) || i >= Tq || (causal && key > i);
        const float sv = s[nb][e] * scale;
        p[e] = masked || sv <= NEG ? 0.f : expf(sv - sm.lse[iq]);
        ds[e] = masked ? 0.f : p[e] * (dp[nb][e] - sm.dl[iq]) * scale;
      }
      c_to_a(p, ph[nb], pl[nb]);
      c_to_a(ds, dh[nb], dlo[nb]);
    }
    // dV_g += P^T.dO_g and dK_g += dS^T.Q_g, the tile's Q_g and dO_g staged
    // again unless g is the last group: the last slab staged is them then
    if (gc0 != (slabs - 1) * GW) {
      __syncwarp();  // every lane is done with the last slab
      warp_stage<BT>(sm.q, q, b, h, H, Tq, D, qb, gc0, vec);
      warp_stage<BT>(sm.g, dout, b, h, H, Tq, D, qb, gc0, vec);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
    }
    tile_product<EXACT>(dva, ph, pl, sm.g, gc0, D, g, t4);
    tile_product<EXACT>(dka, dh, dlo, sm.q, gc0, D, g, t4);
  }

  // every warp parks its partials in its key slabs; the block adds them in
  // split order and writes the rows whole
  __syncwarp();
  park(sm.k, dka, g, t4);
  park(sm.v, dva, g, t4);
  __syncthreads();
  for (int i = threadIdx.x; i < BR * GW; i += SPLITS * 32) {
    const int r = i / GW, c = i % GW;
    const int key = k0 + r, d = gc0 + c;
    if (key >= Tk || d >= D) continue;
    float xk = areas[0].k[r][c], xv = areas[0].v[r][c];
#pragma unroll
    for (int w = 1; w < SPLITS; ++w) {
      xk += areas[w].k[r][c];
      xv += areas[w].v[r][c];
    }
    const size_t off = (((size_t)b * Tk + key) * H + h) * D + d;
    store(dk + off, xk);
    store(dv + off, xv);
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
  int B, H, Tq, Tk, D, groups, splits, smem;
  float scale;
  int causal;
};

// KIND 0: the forward, 1: dQ, 2: dK/dV
template <typename T, int KIND>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int bytes = SPLITS * (KIND == 0   ? (int)sizeof(FwdWarpSmem)
                                  : KIND == 1 ? (int)sizeof(DqWarpSmem)
                                              : (int)sizeof(DkvWarpSmem));
  if (a.splits != SPLITS || a.smem != bytes || a.D < 1 || a.groups != (a.D + GW - 1) / GW)
    return cudaErrorInvalidValue;
  constexpr bool EXACT = sizeof(T) == 2;
  // rows are staged 16 bytes at a time from 16-byte aligned operands whose
  // rows are whole 16-byte chunks; anything else a value at a time
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  const int vec = a.D % (16 / (int)sizeof(T)) == 0 && ptrs % 16 == 0;
  const int BH = a.B * a.H;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  static bool done = false;
  cudaError_t err;
  if constexpr (KIND == 0) {
    if ((err = allow_smem(flash_wide_fwd_kernel<T, EXACT>, bytes, done)) != cudaSuccess)
      return err;
    const dim3 grid(BH * ((a.Tq + BR - 1) / BR), a.groups);
    flash_wide_fwd_kernel<T, EXACT><<<grid, SPLITS * 32, bytes, s>>>(
        q, k, v, a.km, static_cast<T*>(a.o1), a.lse_out, BH, a.H, a.Tq, a.Tk, a.D, a.scale,
        a.causal, vec);
  } else if constexpr (KIND == 1) {
    if ((err = allow_smem(flash_wide_dq_kernel<T, EXACT>, bytes, done)) != cudaSuccess)
      return err;
    const dim3 grid(BH * ((a.Tq + BR - 1) / BR), a.groups);
    flash_wide_dq_kernel<T, EXACT><<<grid, SPLITS * 32, bytes, s>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta, a.km, static_cast<T*>(a.o1),
        BH, a.H, a.Tq, a.Tk, a.D, a.scale, a.causal, vec);
  } else {
    if ((err = allow_smem(flash_wide_dkv_kernel<T, EXACT>, bytes, done)) != cudaSuccess)
      return err;
    const dim3 grid(BH * ((a.Tk + BR - 1) / BR), a.groups);
    flash_wide_dkv_kernel<T, EXACT><<<grid, SPLITS * 32, bytes, s>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta, a.km, static_cast<T*>(a.o1),
        static_cast<T*>(a.o2), BH, a.H, a.Tq, a.Tk, a.D, a.scale, a.causal, vec);
  }
  return cudaGetLastError();
}

template <int KIND>
int run(const Args& a, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16, KIND>(a, s)
                                  : launch<float, KIND>(a, s));
}

}  // namespace

// The signatures of flash_fwd, flash_bwd_dq and flash_bwd_dkv, with the
// plan's column groups and tile splits in place of the width.
extern "C" int flash_wide_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, void* lse,
                              int B, int H, int Tq, int Tk, int D, int groups,
                              int splits, int smem, float scale, int causal,
                              int is_bf16, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr,
               static_cast<const float*>(key_mask), out, nullptr,
               static_cast<float*>(lse), B, H, Tq, Tk, D, groups, splits, smem,
               scale, causal};
  return run<0>(a, is_bf16, stream);
}

extern "C" int flash_wide_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* key_mask, void* dq,
                             int B, int H, int Tq, int Tk, int D, int groups,
                             int splits, int smem, float scale, int causal,
                             int is_bf16, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(key_mask), dq, nullptr, nullptr, B, H,
               Tq, Tk, D, groups, splits, smem, scale, causal};
  return run<1>(a, is_bf16, stream);
}

extern "C" int flash_wide_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* key_mask,
                              void* dk, void* dv, int B, int H, int Tq,
                              int Tk, int D, int groups, int splits, int smem,
                              float scale, int causal, int is_bf16,
                              void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(key_mask), dk, dv, nullptr, B, H, Tq,
               Tk, D, groups, splits, smem, scale, causal};
  return run<2>(a, is_bf16, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
