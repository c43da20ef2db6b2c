// Flash-attention backward: dQ (one kernel) and dK, dV (another), recomputing
// the probabilities from the forward's saved log-sum-exp.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py, _flash_bwd_dq_kernel
// (the pallas_call at :519) and _flash_bwd_dkv_kernel (the pallas_call at
// :543), both launched by _flash_backward (:481) from the custom_vjp of
// flash_attention and masked_attention.
//
// Computes, for q, k, v, dO in the JAX [B, T, H, D] layout, lse and
// delta = rowsum(dO * O) as [B * H, Tq] float32 (delta comes from the caller),
// the caller's scale = 1 / sqrt(D) and S = (q . k) * scale with masked logits
// set to -1e30 (causal: key position > query position; key mask:
// mask[b, t] <= 0):
//   P  = 0 where S <= -1e30, else exp(S - lse)   (a fully masked row has
//        lse ~ -1e30, and exp(S - lse) would overflow)
//   dS = P * (dO . v - delta) * scale             (scale applied once, here)
//   dQ = sum_k dS k,  dK = sum_q dS q,  dV = sum_q P dO
// all in float32, written in the inputs' dtype (float32 or bfloat16).
//
// What bounds it on the H100: operations. Per (query, key) pair the dQ
// kernel does three products of 2 * D operations (S, dP, dQ) and the dK/dV
// kernel four (S, dP, dV, dK), each as three TF32 passes: 3 * 6 * D and
// 3 * 8 * D operations at 495 TFLOP/s, against the inputs read once and the
// outputs written once at 3.35 TB/s (q, k, v, dO, lse, delta in, dQ or dK
// and dV out). Causal, B * H = 64, T = 256, D = 64: 2.1 M pairs, 0.0049 ms
// and 0.0065 ms of TF32 work against 0.0063 and 0.0076 ms of bytes.
//
// Head dims: any D in 1..128, at widths W of 16, 32, 64 and 128 (zeros pad
// D to W in shared memory; padded output columns are never written). The
// width and the shared-memory bytes come from ops/flash_attention.py
// flash_plan; a launch refuses a plan whose bytes differ from the
// instantiation's.
//
// What the design does about it:
// - Every product runs on the tensor cores as mma.sync m16n8k8 TF32, each
//   operand split into hi and lo (hi.lo + lo.hi + hi.hi, tf32_mma.cuh):
//   float32's accuracy at TF32's rate. P and dS are formed on the
//   accumulator fragments and feed the next product as A operands through
//   the key (or query) permutation of tf32_mma.cuh, with no trip through
//   shared memory. Operands that came from bfloat16 are exact in TF32, so
//   their lo passes are skipped; P and dS keep the split.
// - dQ kernel: one block of 4 warps a (b * h, 64-query tile), a warp per 16
//   query rows. The block's Q and dO rows sit in shared memory, and K and V
//   tiles stream in by cp.async, double-buffered. Per tile a warp computes
//   S = Q.K^T and dP = dO.V^T (keys as the mma columns), then P and dS,
//   then dQ += dS.K.
// - dK/dV kernel: one block of 4 warps a (b * h, 64-key tile), a warp per
//   16 key rows. The block's K and V rows sit in shared memory, and Q, dO,
//   lse and delta tiles stream in by cp.async, double-buffered. Per tile a
//   warp computes S^T = K.Q^T and dP^T = V.dO^T with keys as the mma rows,
//   so P^T and dS^T are already C fragments of key rows, and dV += P^T.dO
//   and dK += dS^T.Q reduce over queries through the same permutation: no
//   transpose through shared memory.
// - Rows are padded to W + 4 floats, so every fragment read (row g, column
//   t; or rows 2t, 2t + 1, column g) hits 32 distinct banks. Streamed tiles
//   are 32 rows (16 at W = 128, where the dK and dV accumulators take 64 +
//   64 registers a lane and the tiles would crowd shared memory).
// - Each output row is owned by one warp and summed in a fixed order: no
//   atomics, bitwise the same from run to run. The tensor core sums one
//   streamed tile at a time into a fresh accumulator, and a float32 add
//   carries it into the row's total: the tensor core's accumulation
//   truncates, and over the 256 queries of a key it drifted past 2e-5.
// - Under a causal mask the dQ kernel stops at its last query row and the
//   dK/dV kernel starts at its first key's tile; a warp skips a tile that
//   lies wholly on the masked side (it would contribute P = 0 exactly).
//   Blocks are issued heaviest first. Ragged Tq and Tk are masked.
// - Next lever: wgmma. Its TF32 form wants both operands K-major in shared
//   memory, so K (for dQ), dO and Q (for dV, dK) would be stored transposed,
//   and the tiles would come in by TMA.

#include <math.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int ROWS = 16;             // output rows of a warp (mma M)
constexpr int WARPS = 4;
constexpr int BR = ROWS * WARPS;     // output rows of a block
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e30f;

// rows of a streamed tile
template <int W> __host__ __device__ constexpr int tile_rows() { return W >= 128 ? 16 : 32; }

// All float32, so the sizes are the sums the plan computes (no padding).
template <int W>
struct DqSmem {
  static constexpr int LD = W + 4, BK = tile_rows<W>();
  float q[BR][LD];
  float g[BR][LD];
  float k[2][BK][LD];
  float v[2][BK][LD];
  float km[2][BK];
};

template <int W>
struct DkvSmem {
  static constexpr int LD = W + 4, BQ = tile_rows<W>();
  float k[BR][LD];
  float v[BR][LD];
  float km[BR];
  float q[2][BQ][LD];
  float g[2][BQ][LD];
  float lse[2][BQ];
  float dl[2][BQ];
};

// Rows t0 .. t0 + N - 1 of head (b, h) of a [B, T, H, D] tensor into
// dst[N][LD] as float32, zeros past T and in columns D .. W - 1: cp.async
// 16 bytes a thread when vec (float32, D % 4 == 0, aligned), else plain
// loads converted.
template <int N, int W, int LD, typename T>
__device__ __forceinline__ void load_rows(float (*dst)[LD],
                                          const T* __restrict__ src, int b,
                                          int h, int H, int T_, int D, int t0,
                                          bool vec) {
  constexpr int CH = W / 4;
  for (int idx = threadIdx.x; idx < N * CH; idx += THREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    const int t = t0 + r;
    const bool ok = t < T_;
    const size_t off = (((size_t)b * T_ + (ok ? t : 0)) * H + h) * D;
    float* d = &dst[r][c];
    if (vec) {
      const bool in = ok && c < D;
      cp_async16(d, src + (in ? off + c : off), in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = ok && c + e < D ? to_f32(src[off + c + e]) : 0.f;
    }
  }
}

// N float32 entries t0 .. t0 + N - 1 of a row of length T_ (lse, delta, a
// key mask), zeros past T_; with no row (src null), `fill` up to T_.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int T_,
                                         int t0, float fill) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const int t = t0 + i;
    if (src)
      cp_async4(dst + i, src + (t < T_ ? t : 0), t < T_);
    else
      dst[i] = t < T_ ? fill : 0.f;
  }
}

// total += A . B over one streamed tile: A is NB C fragments (k-row t of
// block nb is tile row nb * 8 + 2t, k-row t + 4 row nb * 8 + 2t + 1), B the
// tile's rows in shared memory. The tensor core sums the tile into fresh
// accumulators and a float32 add (round to nearest) carries them into the
// total: the tensor core's own accumulation truncates, and a chain over
// every row of a long sequence drifts (2.4e-5 in dK/dV at T = 256). Up to
// W = 64 the cross terms get accumulators of their own, for twice the
// independent mma chains; at W = 128 the registers are not there.
template <int NB, int KD, int LD, bool EXACT_B>
__device__ __forceinline__ void tile_product(float (&total)[KD][4],
                                             const float (&a)[NB][4],
                                             const float (*b)[LD], int g,
                                             int t4) {
  constexpr bool APART = KD <= 8;
  float part[KD][4], px[APART ? KD : 1][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[nd][e] = px[APART ? nd : 0][e] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    uint32_t ah[4], al[4];
    c_to_a(a[nb], ah, al);
    const int r = nb * 8 + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      uint32_t bh0, bl0, bh1, bl1;
      split(b[r][nd * 8 + g], bh0, bl0);
      split(b[r + 1][nd * 8 + g], bh1, bl1);
      if constexpr (APART)
        mma_split<false, EXACT_B>(part[nd], px[nd], ah, al, bh0, bh1, bl0, bl1);
      else
        mma_split<false, EXACT_B>(part[nd], part[nd], ah, al, bh0, bh1, bl0,
                                  bl1);
    }
  }
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      total[nd][e] += APART ? part[nd][e] + px[nd][e] : part[nd][e];
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ key_mask, T* __restrict__ dq,
                    int BH, int H, int Tq, int Tk, int D, float scale,
                    int causal, int vec) {
  using Sm = DqSmem<W>;
  constexpr int LD = Sm::LD, BK = Sm::BK, NB = BK / 8, KD = W / 8;
  constexpr bool EXACT = sizeof(T) == 2;  // bfloat16 operands: lo = 0
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  // heaviest first: the first BH blocks take the last query tile
  const int n_qt = (Tq + BR - 1) / BR;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * BR;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp * ROWS;        // the warp's first row in the block
  const int r0 = q0 + wr + g;        // this lane's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const int warp_last = q0 + wr + ROWS - 1;
  const bool warp_live = q0 + wr < Tq;

  const int k_end = causal ? min(Tk, q0 + BR) : Tk;
  const int n_it = (k_end + BK - 1) / BK;
  const bool use_cp = vec != 0;
  const float* kmrow = key_mask ? key_mask + (size_t)b * Tk : nullptr;

  load_rows<BR, W, LD>(sm.q, q, b, h, H, Tq, D, q0, use_cp);
  load_rows<BR, W, LD>(sm.g, dout, b, h, H, Tq, D, q0, use_cp);
  if (n_it > 0) {
    load_rows<BK, W, LD>(sm.k[0], k, b, h, H, Tk, D, 0, use_cp);
    load_rows<BK, W, LD>(sm.v[0], v, b, h, H, Tk, D, 0, use_cp);
    load_vec<BK>(sm.km[0], kmrow, Tk, 0, 1.f);
  }
  cp_async_commit();

  const float lse0 = r0 < Tq ? lse[(size_t)bh * Tq + r0] : 0.f;
  const float lse1 = r1 < Tq ? lse[(size_t)bh * Tq + r1] : 0.f;
  const float dl0 = r0 < Tq ? delta[(size_t)bh * Tq + r0] : 0.f;
  const float dl1 = r1 < Tq ? delta[(size_t)bh * Tq + r1] : 0.f;
  float acc[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      const int nk = (it + 1) * BK;
      load_rows<BK, W, LD>(sm.k[buf ^ 1], k, b, h, H, Tk, D, nk, use_cp);
      load_rows<BK, W, LD>(sm.v[buf ^ 1], v, b, h, H, Tk, D, nk, use_cp);
      load_vec<BK>(sm.km[buf ^ 1], kmrow, Tk, nk, 1.f);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const int kb = it * BK;
    if (warp_live && !(causal && kb > warp_last)) {
      const float(*ks)[LD] = sm.k[buf];
      const float(*vs)[LD] = sm.v[buf];
      const float* kms = sm.km[buf];
      // S = Q.K^T and dP = dO.V^T; cross terms in their own accumulators
      float s[NB][4], sx[NB][4], dp[NB][4], dpx[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = sx[nb][e] = dp[nb][e] = dpx[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qh[4], ql[4], gh[4], gl[4];
        frag_a<LD>(sm.q, wr, kk * 8, g, t4, qh, ql);
        frag_a<LD>(sm.g, wr, kk * 8, g, t4, gh, gl);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t bh0, bl0, bh1, bl1;
          split(ks[nb * 8 + g][kk * 8 + t4], bh0, bl0);
          split(ks[nb * 8 + g][kk * 8 + t4 + 4], bh1, bl1);
          mma_split<EXACT, EXACT>(s[nb], sx[nb], qh, ql, bh0, bh1, bl0, bl1);
          split(vs[nb * 8 + g][kk * 8 + t4], bh0, bl0);
          split(vs[nb * 8 + g][kk * 8 + t4 + 4], bh1, bl1);
          mma_split<EXACT, EXACT>(dp[nb], dpx[nb], gh, gl, bh0, bh1, bl0, bl1);
        }
      }
      // P and dS on the fragments, then dQ += dS.K (keys permuted)
      float ds[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = nb * 8 + 2 * t4 + (e & 1);
          const int row = (e & 2) ? r1 : r0;
          const bool masked = kms[j] <= 0.f || (causal && kb + j > row);
          const float sv = (s[nb][e] + sx[nb][e]) * scale;
          const float p = masked || sv <= NEG
              ? 0.f : expf(sv - ((e & 2) ? lse1 : lse0));
          ds[nb][e] = p * ((dp[nb][e] + dpx[nb][e]) - ((e & 2) ? dl1 : dl0))
                      * scale;
        }
      }
      tile_product<NB, KD, LD, EXACT>(acc, ds, ks, g, t4);
    }
    __syncthreads();
  }
  cp_async_wait_all();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= Tq) continue;
    T* op = dq + (((size_t)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const int d = nd * 8 + 2 * t4;
      if (d < D) store(op + d, acc[nd][2 * half]);
      if (d + 1 < D) store(op + d + 1, acc[nd][2 * half + 1]);
    }
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ key_mask, T* __restrict__ dk,
                     T* __restrict__ dv, int BH, int H, int Tq, int Tk, int D,
                     float scale, int causal, int vec) {
  using Sm = DkvSmem<W>;
  constexpr int LD = Sm::LD, BQ = Sm::BQ, NB = BQ / 8, KD = W / 8;
  constexpr bool EXACT = sizeof(T) == 2;  // bfloat16 operands: lo = 0
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  // heaviest first: under a causal mask the first key tile sees every query
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * BR;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp * ROWS;        // the warp's first key row in the block
  const int j0 = k0 + wr + g;        // this lane's keys: j0 and j0 + 8
  const int j1 = j0 + 8;
  const int warp_first = k0 + wr;
  const bool warp_live = warp_first < Tk;

  const int q_begin = causal ? k0 : 0;  // k0 is a multiple of BQ
  const int n_it = Tq > q_begin ? (Tq - q_begin + BQ - 1) / BQ : 0;
  const bool use_cp = vec != 0;
  const float* lrow = lse + (size_t)bh * Tq;
  const float* drow = delta + (size_t)bh * Tq;

  load_rows<BR, W, LD>(sm.k, k, b, h, H, Tk, D, k0, use_cp);
  load_rows<BR, W, LD>(sm.v, v, b, h, H, Tk, D, k0, use_cp);
  load_vec<BR>(sm.km, key_mask ? key_mask + (size_t)b * Tk : nullptr, Tk, k0,
               1.f);
  if (n_it > 0) {
    load_rows<BQ, W, LD>(sm.q[0], q, b, h, H, Tq, D, q_begin, use_cp);
    load_rows<BQ, W, LD>(sm.g[0], dout, b, h, H, Tq, D, q_begin, use_cp);
    load_vec<BQ>(sm.lse[0], lrow, Tq, q_begin, 0.f);
    load_vec<BQ>(sm.dl[0], drow, Tq, q_begin, 0.f);
  }
  cp_async_commit();

  float dka[KD][4], dva[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      const int nq = q_begin + (it + 1) * BQ;
      load_rows<BQ, W, LD>(sm.q[buf ^ 1], q, b, h, H, Tq, D, nq, use_cp);
      load_rows<BQ, W, LD>(sm.g[buf ^ 1], dout, b, h, H, Tq, D, nq, use_cp);
      load_vec<BQ>(sm.lse[buf ^ 1], lrow, Tq, nq, 0.f);
      load_vec<BQ>(sm.dl[buf ^ 1], drow, Tq, nq, 0.f);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const int qb = q_begin + it * BQ;
    if (warp_live && !(causal && qb + BQ - 1 < warp_first)) {
      const float(*qs)[LD] = sm.q[buf];
      const float(*gs)[LD] = sm.g[buf];
      // S^T = K.Q^T and dP^T = V.dO^T, keys as rows; cross terms apart
      float s[NB][4], sx[NB][4], dp[NB][4], dpx[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = sx[nb][e] = dp[nb][e] = dpx[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        frag_a<LD>(sm.k, wr, kk * 8, g, t4, kh, kl);
        frag_a<LD>(sm.v, wr, kk * 8, g, t4, vh, vl);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t bh0, bl0, bh1, bl1;
          split(qs[nb * 8 + g][kk * 8 + t4], bh0, bl0);
          split(qs[nb * 8 + g][kk * 8 + t4 + 4], bh1, bl1);
          mma_split<EXACT, EXACT>(s[nb], sx[nb], kh, kl, bh0, bh1, bl0, bl1);
          split(gs[nb * 8 + g][kk * 8 + t4], bh0, bl0);
          split(gs[nb * 8 + g][kk * 8 + t4 + 4], bh1, bl1);
          mma_split<EXACT, EXACT>(dp[nb], dpx[nb], vh, vl, bh0, bh1, bl0, bl1);
        }
      }
      const float km0 = sm.km[wr + g], km1 = sm.km[wr + g + 8];
      // P^T and dS^T on the fragments, then dV += P^T.dO and dK += dS^T.Q
      // (queries permuted)
      float p[NB][4], ds[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int iq = nb * 8 + 2 * t4 + (e & 1);
          const int i = qb + iq;
          const int key = (e & 2) ? j1 : j0;
          const bool masked = ((e & 2) ? km1 : km0) <= 0.f || i >= Tq
                              || (causal && key > i);
          const float sv = (s[nb][e] + sx[nb][e]) * scale;
          p[nb][e] = masked || sv <= NEG ? 0.f : expf(sv - sm.lse[buf][iq]);
          ds[nb][e] = p[nb][e] * ((dp[nb][e] + dpx[nb][e]) - sm.dl[buf][iq])
                      * scale;
        }
      }
      tile_product<NB, KD, LD, EXACT>(dva, p, gs, g, t4);
      tile_product<NB, KD, LD, EXACT>(dka, ds, qs, g, t4);
    }
    __syncthreads();
  }
  cp_async_wait_all();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? j1 : j0;
    if (key >= Tk) continue;
    const size_t off = (((size_t)b * Tk + key) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const int d = nd * 8 + 2 * t4;
      if (d < D) {
        store(dk + off + d, dka[nd][2 * half]);
        store(dv + off + d, dva[nd][2 * half]);
      }
      if (d + 1 < D) {
        store(dk + off + d + 1, dka[nd][2 * half + 1]);
        store(dv + off + d + 1, dva[nd][2 * half + 1]);
      }
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
  void *o1, *o2;  // dq; or dk, dv
  int B, H, Tq, Tk, D, smem;
  float scale;
  int causal;
};

template <typename T, int W>
cudaError_t launch_dq_w(const Args& a, int vec, cudaStream_t s) {
  if (a.smem != (int)sizeof(DqSmem<W>)) return cudaErrorInvalidValue;
  static bool done = false;
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, W>, a.smem, done);
  if (err != cudaSuccess) return err;
  const int grid = a.B * a.H * ((a.Tq + BR - 1) / BR);
  flash_bwd_dq_kernel<T, W><<<grid, THREADS, a.smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.km, static_cast<T*>(a.o1), a.B * a.H, a.H, a.Tq, a.Tk, a.D,
      a.scale, a.causal, vec);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_dkv_w(const Args& a, int vec, cudaStream_t s) {
  if (a.smem != (int)sizeof(DkvSmem<W>)) return cudaErrorInvalidValue;
  static bool done = false;
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, W>, a.smem, done);
  if (err != cudaSuccess) return err;
  const int grid = a.B * a.H * ((a.Tk + BR - 1) / BR);
  flash_bwd_dkv_kernel<T, W><<<grid, THREADS, a.smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.km, static_cast<T*>(a.o1), static_cast<T*>(a.o2), a.B * a.H,
      a.H, a.Tq, a.Tk, a.D, a.scale, a.causal, vec);
  return cudaGetLastError();
}

template <typename T, bool DKV>
cudaError_t launch(const Args& a, int W, cudaStream_t s) {
  if (a.D < 1 || a.D > W) return cudaErrorInvalidValue;
  // cp.async moves float32 rows 16 bytes at a time from 16-byte aligned
  // operands whose rows are whole chunks; anything else through plain loads
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q)
      | reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)
      | reinterpret_cast<uintptr_t>(a.dout);
  const int vec = sizeof(T) == 4 && a.D % 4 == 0 && ptrs % 16 == 0;
  switch (W) {
    case 16: return DKV ? launch_dkv_w<T, 16>(a, vec, s) : launch_dq_w<T, 16>(a, vec, s);
    case 32: return DKV ? launch_dkv_w<T, 32>(a, vec, s) : launch_dq_w<T, 32>(a, vec, s);
    case 64: return DKV ? launch_dkv_w<T, 64>(a, vec, s) : launch_dq_w<T, 64>(a, vec, s);
    case 128: return DKV ? launch_dkv_w<T, 128>(a, vec, s) : launch_dq_w<T, 128>(a, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* key_mask, void* dq,
                            int B, int H, int Tq, int Tk, int D, int W,
                            int smem, float scale, int causal, int is_bf16,
                            void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(key_mask), dq, nullptr, B, H, Tq, Tk,
               D, smem, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16, false>(a, W, s)
                                  : launch<float, false>(a, W, s);
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* key_mask,
                             void* dk, void* dv, int B, int H, int Tq, int Tk,
                             int D, int W, int smem, float scale, int causal,
                             int is_bf16, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(key_mask), dk, dv, B, H, Tq, Tk, D,
               smem, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16, true>(a, W, s)
                                  : launch<float, true>(a, W, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
