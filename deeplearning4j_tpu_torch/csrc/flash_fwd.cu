// Flash-attention forward: tiled online-softmax attention that writes the
// output and the per-row log-sum-exp.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py, _flash_fwd_kernel (the
// pallas_call in _flash_forward at :180; entries flash_attention and
// masked_attention).
//
// Computes, for q, k, v in the JAX [B, T, H, D] layout and s = q.k / sqrt(D):
// masked logits set to -1e30 (causal: key position > query position; key
// mask: mask[b, t] <= 0), p = 0 wherever s <= -1e30, l clamped at 1e-20 so a
// fully masked row outputs 0, out = sum_j p_j v_j / l, lse = m + log(l), all
// in float32. lse is [B * H, Tq], row b * H + h, as in the JAX package.
//
// What bounds it on the H100: operations. Causal attention at T = 512 and
// D = 64 does 4 * D operations per (query, key) pair on 2 * D * 4 bytes per
// row, well above the ridge of either the CUDA cores or the tensor cores.
//
// Head dims: any D in 1..128. The kernel is instantiated at widths W of 16,
// 32, 64 and 128; a D between two is padded with zeros to the next width in
// shared memory and registers (zero columns add exactly 0 to Q.K^T and P.V,
// and the padded output columns are never written). The logit scale is the
// caller's 1/sqrt(D) of the true D. The width, the key splits and the
// shared-memory bytes come from ops/flash_attention.py flash_plan; the
// launch refuses a plan whose bytes differ from the instantiation's.
//
// What the design does about it:
// - Both products, S = Q.K^T and O += P.V, run on the tensor cores as
//   mma.sync m16n8k8 TF32 with float32 accumulation. Float32 accuracy is
//   kept by splitting every operand a into hi = tf32(a) and lo =
//   tf32(a - hi) (tf32() drops the low 13 mantissa bits) and summing
//   hi.lo + lo.hi + hi.hi: three TF32 passes, about float32's error
//   (tests/test_torch_kernel_design.py emulates it on the CPU). The
//   dropped lo.lo term is below 2^-22 of the product. The helpers are in
//   tf32_mma.cuh, shared with flash_bwd.cu.
// - One warp owns 16 query rows. S and P stay in registers as mma
//   accumulator fragments; the online softmax runs on the fragment rows,
//   with a row max across the 4 lanes of a row by two xor-shuffles. Lane
//   (g, t) holds S columns {2t, 2t+1}, while the A operand of the next mma
//   wants columns {t, t+4}: since the reduction index of P.V (the key) may
//   be permuted in P and V alike, k-row t of each 8-key step stands for key
//   2t and k-row t + 4 for key 2t + 1, and V's B fragment is read from
//   shared memory at those keys. P feeds the second mma unchanged.
// - A block is 2 groups of 16 query rows (BQ = 32 rows a block) times S
//   key splits, one warp each. Split s takes the key tiles s, s + S, ...;
//   at the end splits 1..S-1 hand (m, l, acc) to split 0 through shared
//   memory, which folds them in split order. BQ = 32 gives B * H * Tq / 32
//   blocks: 512 at the training shape, where S = 2 (4 warps a block, up to
//   3 blocks an SM); 128 at the predict shape (B * H = 8, T = 512), fewer
//   than 2 an SM, where S = 4 (8 warps a block), which doubles the warps in
//   flight and halves the longest chain of key tiles (the last causal
//   query tile). The plan picks S from the grid and the SM count. At
//   W = 128 a split's double-buffered K/V tiles take 67.6 KB, so S is 2
//   (152.6 KB a block with Q), and the scaled query waits in shared memory
//   and is split per use: held pre-split it would take 128 registers a
//   lane beside a 64-register accumulator.
// - K and V tiles of BK = 32 keys come in with cp.async (16 bytes a thread,
//   float32; bfloat16 and unaligned operands are converted through plain
//   loads), double-buffered, into rows padded to W + 4 floats, so that both
//   fragment reads (K at row g, column t; V at rows 2t, 2t + 1, column g)
//   hit 32 distinct banks.
// - Under a causal mask the key loop stops at the block's last query row,
//   and a warp skips a tile that lies wholly above its rows: the skipped
//   work would contribute p = 0 exactly. Blocks are issued heaviest first
//   (the last query tile of every batch-head first).
// - Ragged Tq and Tk are masked, so any length is taken. No atomics: the
//   result is bitwise the same from run to run.

#include <math.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int ROWS = 16;             // query rows of a warp (mma M)
constexpr int GROUPS = 2;            // row groups of a block
constexpr int BQ = ROWS * GROUPS;    // query rows of a block
constexpr int BK = 32;               // keys of a tile
constexpr int NB = BK / 8;           // 8-key mma blocks of a tile
constexpr float NEG = -1e30f;

// At W = 128 the scaled query waits in shared memory (split per use);
// below it, it is held in registers, split once.
template <int W> __host__ __device__ constexpr bool q_in_smem() { return W > 64; }

// All float32, so the size is the sum the plan computes (no padding).
template <int W, int SPLITS>
struct Smem {
  static constexpr int LD = W + 4;  // padded row: conflict-free fragments
  float k[2][SPLITS][BK][LD];
  float v[2][SPLITS][BK][LD];
  float km[2][SPLITS][BK];
  float q[q_in_smem<W>() ? BQ : 1][LD];
};

// Stage `buf` gets key tiles it * SPLITS + s, s < SPLITS; columns D .. W - 1
// and keys past Tk are zeros.
template <typename T, int W, int SPLITS>
__device__ __forceinline__ void load_stage(Smem<W, SPLITS>& sm, int buf, int it,
                                           const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const float* __restrict__ key_mask,
                                           int b, int h, int H, int Tk, int D,
                                           bool vec) {
  constexpr int THREADS = GROUPS * SPLITS * 32;
  const int tid = threadIdx.x;
  constexpr int CH = W / 4;  // 16-byte chunks of a row
  for (int idx = tid; idx < SPLITS * BK * CH; idx += THREADS) {
    const int s = idx / (BK * CH);
    const int j = (idx / CH) % BK;
    const int c = idx % CH;
    const int t = (it * SPLITS + s) * BK + j;
    const bool ok = t < Tk;
    const size_t off = (((size_t)b * Tk + (ok ? t : 0)) * H + h) * D;
    float* kd = &sm.k[buf][s][j][c * 4];
    float* vd = &sm.v[buf][s][j][c * 4];
    if (vec) {  // D % 4 == 0: a chunk lies wholly inside or past D
      const bool in = ok && c * 4 < D;
      const size_t o = in ? off + c * 4 : off;
      cp_async16(kd, k + o, in);
      cp_async16(vd, v + o, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = ok && c * 4 + e < D;
        kd[e] = in ? to_f32(k[off + c * 4 + e]) : 0.f;
        vd[e] = in ? to_f32(v[off + c * 4 + e]) : 0.f;
      }
    }
  }
  for (int idx = tid; idx < SPLITS * BK; idx += THREADS) {
    const int s = idx / BK;
    const int j = idx % BK;
    const int t = (it * SPLITS + s) * BK + j;
    sm.km[buf][s][j] =
        t < Tk ? (key_mask ? key_mask[(size_t)b * Tk + t] : 1.f) : 0.f;
  }
}

// PAD: D < W, padded with zeros. Without it D is the compile-time W, and
// the kernel compiles as it did before head dims were generalized: a
// runtime D in every address and column check slowed the D = 64 predict
// shape measurably.
template <typename T, int W, int SPLITS, bool PAD>
__global__ void __launch_bounds__(GROUPS * SPLITS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_mask,
                 T* __restrict__ out, float* __restrict__ lse, int BH, int H,
                 int Tq, int Tk, int d_arg, float scale, int causal, int vec) {
  constexpr int KD = W / 8;  // 8-wide steps over the (padded) head dim
  const int D = PAD ? d_arg : W;
  constexpr bool QS = q_in_smem<W>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Sm = Smem<W, SPLITS>;
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  // heaviest first: the first BH blocks take the last query tile
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int grp = warp % GROUPS;
  const int split_id = warp / GROUPS;
  const int r0 = q0 + grp * ROWS + g;  // this lane's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const int warp_last = q0 + grp * ROWS + ROWS - 1;

  // the scaled query: as A fragments split once (W <= 64), or in shared
  // memory (W = 128; made visible by the first barrier of the key loop)
  uint32_t qh[QS ? 1 : KD][4], ql[QS ? 1 : KD][4];
  if constexpr (QS) {
    for (int idx = threadIdx.x; idx < BQ * W; idx += GROUPS * SPLITS * 32) {
      const int r = idx / W, d = idx % W;
      const int row = q0 + r;
      sm.q[r][d] = row < Tq && d < D
          ? to_f32(q[(((size_t)b * Tq + row) * H + h) * D + d]) * scale : 0.f;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? r1 : r0;
        const int d = kk * 8 + t4 + ((e & 2) ? 4 : 0);
        const float x = row < Tq && d < D
            ? to_f32(q[(((size_t)b * Tq + row) * H + h) * D + d]) * scale : 0.f;
        split(x, qh[kk][e], ql[kk][e]);
      }
    }
  }

  float acc[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m0 = NEG, m1 = NEG;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;  // this lane's share of the running sums

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int n_kt = (k_end + BK - 1) / BK;
  const int n_it = (n_kt + SPLITS - 1) / SPLITS;
  const bool use_cp = vec != 0;

  if (n_it > 0)
    load_stage<T, W, SPLITS>(sm, 0, 0, k, v, key_mask, b, h, H, Tk, D, use_cp);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it)
      load_stage<T, W, SPLITS>(sm, buf ^ 1, it + 1, k, v, key_mask, b, h, H,
                               Tk, D, use_cp);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const int kt = it * SPLITS + split_id;
    const int kb = kt * BK;
    if (kt < n_kt && !(causal && kb > warp_last)) {
      const float(*ks)[Sm::LD] = sm.k[buf][split_id];
      const float(*vs)[Sm::LD] = sm.v[buf][split_id];
      const float* kms = sm.km[buf][split_id];

      // the cross terms and hi.hi in separate accumulators: twice the
      // independent mma chains, then one add
      float s[NB][4], sx[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = sx[nb][e] = 0.f;
      if constexpr (QS) {
        // the query fragment is read and split once per 8 columns, for
        // every key block
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t ah[4], al[4];
          frag_a<Sm::LD>(sm.q, grp * ROWS, kk * 8, g, t4, ah, al);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            uint32_t bh0, bl0, bh1, bl1;
            split(ks[nb * 8 + g][kk * 8 + t4], bh0, bl0);
            split(ks[nb * 8 + g][kk * 8 + t4 + 4], bh1, bl1);
            mma_split<false, false>(s[nb], sx[nb], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            uint32_t bh0, bl0, bh1, bl1;
            split(ks[nb * 8 + g][kk * 8 + t4], bh0, bl0);
            split(ks[nb * 8 + g][kk * 8 + t4 + 4], bh1, bl1);
            mma_split<false, false>(s[nb], sx[nb], qh[kk], ql[kk], bh0, bh1,
                                    bl0, bl1);
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] += sx[nb][e];
      // mask, then the tile's row max (4 lanes share a row)
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = nb * 8 + 2 * t4 + (e & 1);
          const int row = (e & 2) ? r1 : r0;
          const bool masked = kms[j] <= 0.f || (causal && kb + j > row);
          if (masked) s[nb][e] = NEG;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float a0 = expf(m0 - mn0);
      const float a1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int nd = 0; nd < KD; ++nd) {
        acc[nd][0] *= a0;
        acc[nd][1] *= a0;
        acc[nd][2] *= a1;
        acc[nd][3] *= a1;
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mr = (e & 2) ? mn1 : mn0;
          const float p = s[nb][e] <= NEG ? 0.f : expf(s[nb][e] - mr);
          if (e & 2) l1 += p; else l0 += p;
          split(p, ph[e], pl[e]);
        }
        // lane (g, t) holds P[g][2t], P[g][2t+1], P[g+8][2t], P[g+8][2t+1]:
        // as A fragment, k-row t is key 2t and k-row t + 4 key 2t + 1
        const uint32_t ah[4] = {ph[0], ph[2], ph[1], ph[3]};
        const uint32_t al[4] = {pl[0], pl[2], pl[1], pl[3]};
        const int key = nb * 8 + 2 * t4;
#pragma unroll
        for (int nd = 0; nd < KD; ++nd) {
          uint32_t bh0, bl0, bh1, bl1;
          split(vs[key][nd * 8 + g], bh0, bl0);
          split(vs[key + 1][nd * 8 + g], bh1, bl1);
          mma3(acc[nd], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();
  __syncthreads();

  // splits 1.. hand their state to split 0 through the (now idle) tile
  // buffers; split 0 folds them in split order
  constexpr int PER_LANE = KD * 4 + 4;
  static_assert((SPLITS - 1) * GROUPS * 32 * PER_LANE * sizeof(float)
                    <= sizeof(sm.k), "exchange does not fit");
  float* xch = &sm.k[0][0][0][0];
  if (split_id > 0) {
    float* mine = xch + (((size_t)(split_id - 1) * GROUPS + grp) * 32 + lane) * PER_LANE;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[nd * 4 + e] = acc[nd][e];
    mine[KD * 4 + 0] = m0;
    mine[KD * 4 + 1] = m1;
    mine[KD * 4 + 2] = l0;
    mine[KD * 4 + 3] = l1;
  }
  __syncthreads();
  if (split_id != 0) return;
  for (int o = 1; o < SPLITS; ++o) {
    const float* other = xch + (((size_t)(o - 1) * GROUPS + grp) * 32 + lane) * PER_LANE;
    const float om0 = other[KD * 4 + 0], om1 = other[KD * 4 + 1];
    const float n0 = fmaxf(m0, om0), n1 = fmaxf(m1, om1);
    const float a0 = expf(m0 - n0), b0 = expf(om0 - n0);
    const float a1 = expf(m1 - n1), b1 = expf(om1 - n1);
    l0 = l0 * a0 + other[KD * 4 + 2] * b0;
    l1 = l1 * a1 + other[KD * 4 + 3] * b1;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
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
  const float ls0 = fmaxf(l0, 1e-20f);
  const float ls1 = fmaxf(l1, 1e-20f);
  // columns D .. W - 1 are padding: never written
  if (r0 < Tq) {
    T* op = out + (((size_t)b * Tq + r0) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const int d = nd * 8 + 2 * t4;
      if (d < D) store(op + d, acc[nd][0] / ls0);
      if (d + 1 < D) store(op + d + 1, acc[nd][1] / ls0);
    }
    if (t4 == 0) lse[(size_t)bh * Tq + r0] = m0 + logf(ls0);
  }
  if (r1 < Tq) {
    T* op = out + (((size_t)b * Tq + r1) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const int d = nd * 8 + 2 * t4;
      if (d < D) store(op + d, acc[nd][2] / ls1);
      if (d + 1 < D) store(op + d + 1, acc[nd][3] / ls1);
    }
    if (t4 == 0) lse[(size_t)bh * Tq + r1] = m1 + logf(ls1);
  }
}

template <typename T, int W, int SPLITS, bool PAD>
cudaError_t launch_pad(const T* q, const T* k, const T* v, const float* km,
                       T* out, float* lse, int B, int H, int Tq, int Tk,
                       int D, int smem, float scale, int causal, int vec,
                       cudaStream_t s) {
  static bool attr_set = false;  // idempotent: a race only sets it twice
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, W, SPLITS, PAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int grid = B * H * ((Tq + BQ - 1) / BQ);
  flash_fwd_kernel<T, W, SPLITS, PAD><<<grid, GROUPS * SPLITS * 32, smem, s>>>(
      q, k, v, km, out, lse, B * H, H, Tq, Tk, D, scale, causal, vec);
  return cudaGetLastError();
}

template <typename T, int W, int SPLITS>
cudaError_t launch_w(const T* q, const T* k, const T* v, const float* km,
                     T* out, float* lse, int B, int H, int Tq, int Tk, int D,
                     int smem, float scale, int causal, int vec,
                     cudaStream_t s) {
  if (smem != (int)sizeof(Smem<W, SPLITS>)) return cudaErrorInvalidValue;
  if (D == W)
    return launch_pad<T, W, SPLITS, false>(q, k, v, km, out, lse, B, H, Tq, Tk, D, smem, scale, causal, vec, s);
  return launch_pad<T, W, SPLITS, true>(q, k, v, km, out, lse, B, H, Tq, Tk, D, smem, scale, causal, vec, s);
}

// The plan (ops/flash_attention.py flash_plan) picks the width and the key
// splits: 2 splits (4 warps, 70 KB at W = 64, up to 3 blocks an SM) when
// the grid gives every SM 2 blocks or more, else 4 (8 warps, 139 KB, 1
// block an SM), which doubles the warps in flight and halves the longest
// chain of key tiles where there are too few blocks to fill the card (the
// predict shape: 128 blocks); always 2 at W = 128. Both combine in split
// order, so a shape on a given card always takes the same one.
template <typename T, int W>
cudaError_t launch_splits(const T* q, const T* k, const T* v, const float* km,
                          T* out, float* lse, int B, int H, int Tq, int Tk,
                          int D, int splits, int smem, float scale, int causal,
                          int vec, cudaStream_t s) {
  if (splits == 2)
    return launch_w<T, W, 2>(q, k, v, km, out, lse, B, H, Tq, Tk, D, smem, scale, causal, vec, s);
  if constexpr (W <= 64) {
    if (splits == 4)
      return launch_w<T, W, 4>(q, k, v, km, out, lse, B, H, Tq, Tk, D, smem, scale, causal, vec, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* km, void* out, float* lse, int B, int H,
                   int Tq, int Tk, int D, int W, int splits, int smem,
                   float scale, int causal, cudaStream_t s) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  if (D < 1 || D > W) return cudaErrorInvalidValue;
  // cp.async moves float32 rows 16 bytes at a time from 16-byte aligned
  // k and v whose rows are whole chunks; anything else is converted
  // through plain loads
  const int vec = sizeof(T) == 4 && D % 4 == 0
                  && (reinterpret_cast<uintptr_t>(k) % 16 == 0)
                  && (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  switch (W) {
    case 16:
      return launch_splits<T, 16>(qq, kk, vv, km, oo, lse, B, H, Tq, Tk, D, splits, smem, scale, causal, vec, s);
    case 32:
      return launch_splits<T, 32>(qq, kk, vv, km, oo, lse, B, H, Tq, Tk, D, splits, smem, scale, causal, vec, s);
    case 64:
      return launch_splits<T, 64>(qq, kk, vv, km, oo, lse, B, H, Tq, Tk, D, splits, smem, scale, causal, vec, s);
    case 128:
      return launch_splits<T, 128>(qq, kk, vv, km, oo, lse, B, H, Tq, Tk, D, splits, smem, scale, causal, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* key_mask, void* out, void* lse, int B,
                         int H, int Tq, int Tk, int D, int W, int splits,
                         int smem, float scale, int causal, int is_bf16,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(key_mask);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, km, out, l, B, H, Tq, Tk, D, W, splits, smem, scale, causal, s)
              : launch<float>(q, k, v, km, out, l, B, H, Tq, Tk, D, W, splits, smem, scale, causal, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
