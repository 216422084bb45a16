// K2 and K3: the flash-attention backward, as two kernels.
//
// K2 replaces ray_tpu/ops/attention.py::_bwd_dkv_kernel and K3 replaces
// ray_tpu/ops/attention.py::_bwd_dq_kernel (both launched by
// _flash_bwd_pallas). delta = rowsum(dO * O) is computed by the caller in
// torch, as the reference does before its kernels.
//
// Both recompute p = exp(s * scale - lse) from the saved lse, with the same
// masks as K1 (keys past Tk, end-aligned causal: query row i sees keys
// <= i + Tk - Tq), then dP = dO V^T and dS = p * (dP - delta) * scale.
// K2: one block per (bh, 64-key tile), lowest key tiles first; it loops
// over q tiles from the first one on or below the diagonal and accumulates
// dV += p^T dO and dK += dS^T Q. K3: one block per (bh, 64-row q tile),
// highest q tiles first; it loops over k tiles up to the causal limit and
// accumulates dQ += dS K. Each output has one writer: no atomics, and the
// result is deterministic.
//
// Bound on an H100 SXM at the main path (BH 32, T 2048, D 128, bf16,
// causal): operations. K2 does 8 D flops per visible (q, k) pair, 68.7
// GFLOP, 69 us at 989 TFLOP/s; K3 does 6 D, 51.5 GFLOP, 52 us. Each moves
// about 85 MB, 25 us at 3.35 TB/s.
//
// bf16 inputs run on Hopper kernels (dkv_sm90, dq_sm90; hopper.cuh), one
// warpgroup of 128 threads per block:
// - every product is a wgmma: s and dP (K2 computes their transposes,
//   keys by q rows) from shared memory, both operands K-major; dV, dK and
//   dQ with p or dS from registers and dO, Q or K read MN-major through
//   the descriptor, so no transposed copy is made;
// - s and dP stay in registers: masks, p and dS are computed on each
//   accumulator element where it lies, and the accumulator becomes the
//   bf16 A operand of the next product directly;
// - p and dS are rounded to bf16 once, as PyTorch's flash backward does:
//   each of dV, dK and dQ is one product;
// - TMA loads each 64-row tile of Q and dO (K2) or K and V (K3) into a
//   ring of NSTAGE stages on mbarriers, NSTAGE - 1 tiles ahead of the one
//   in use; rows past T and columns past D read as zeros. lse and delta
//   (per q row) go to registers (K3) or, one stage ahead, to shared memory
//   beside their stage (K2, where they are per column of s^T).
// A head dim D <= 64 runs in a 64-wide instance and 64 < D <= 128 in a
// 128-wide one, on zero-filled columns; stores write the D real ones.
//
// float32 inputs keep the WMMA kernels (dkv_f32, dq_f32, flash_common.cuh):
// every operand split into bf16 hi + lo, about 16 bits of mantissa, for
// the precision that float32 callers are held to.
//
// What the Hopper design leaves on the table: a producer warp with
// setmaxnreg instead of the consumers issuing TMA, deeper rings, two
// consumer warpgroups or persistent blocks so that one tile's softmax
// overlaps another's products, and a fused backward (atomic dQ) that would
// compute s and dP once instead of once in each kernel (10 D instead of
// 14 D flops per pair).
#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash {

// ------------------------------------------------------------ float32: WMMA

__host__ __device__ constexpr int dkv_smem_bytes(int dp) {
  return 8 * tile_bytes(dp) + 2 * STILE_BYTES + 4 * PTILE_BYTES + 2 * ROWS_BYTES;
}
__host__ __device__ constexpr int dq_smem_bytes(int dp) {
  return 8 * tile_bytes(dp) + 2 * STILE_BYTES + 2 * PTILE_BYTES + 2 * ROWS_BYTES;
}
// The outputs are staged in the s and dP buffers once the loop is done.
static_assert(BQ * out_ld(DMAX) * 4 <= 2 * STILE_BYTES, "output staging");

// From the s and dP tiles of q rows q0.. and keys k0..: p and dS, split
// into bf16 hi and lo, with p = 0 outside the masks and for q rows past Tq.
// p is not stored where p_hi is null.
__device__ __forceinline__ void probs_and_ds(
    bf16* p_hi, bf16* p_lo, bf16* ds_hi, bf16* ds_lo, const float* s,
    const float* dp, const float* lses, const float* deltas, int q0, int k0,
    int tq, int tk, float scale, int causal) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = tk - tq;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, col = k0 + c;
      const bool visible = row < tq && col < tk && (!causal || col <= row + off);
      const float p = visible ? expf(s[r * SLD + c] * scale - lses[r]) : 0.f;
      if (p_hi) put_split(p_hi, p_lo, r * PLD + c, p);
      put_split(ds_hi, ds_lo, r * PLD + c, p * (dp[r * SLD + c] - deltas[r]) * scale);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
    dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int tq, int tk, int d,
            float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = pad_dim(d), ld = tile_ld(dp), nb = dp / 16;
  Carver sm{smem};
  bf16* k_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* k_lo = sm.take<bf16>(tile_bytes(dp));
  bf16* v_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* v_lo = sm.take<bf16>(tile_bytes(dp));
  bf16* q_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* q_lo = sm.take<bf16>(tile_bytes(dp));
  bf16* do_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* do_lo = sm.take<bf16>(tile_bytes(dp));
  float* s = sm.take<float>(STILE_BYTES);
  float* dps = sm.take<float>(STILE_BYTES);
  bf16* p_hi = sm.take<bf16>(PTILE_BYTES);
  bf16* p_lo = sm.take<bf16>(PTILE_BYTES);
  bf16* ds_hi = sm.take<bf16>(PTILE_BYTES);
  bf16* ds_lo = sm.take<bf16>(PTILE_BYTES);
  float* lses = sm.take<float>(ROWS_BYTES);
  float* deltas = sm.take<float>(ROWS_BYTES);

  const int nk = (tk + BK - 1) / BK;
  const int bh = blockIdx.x / nk;
  // Lowest k tiles first: under the causal mask they have the most q rows.
  const int k0 = (blockIdx.x % nk) * BK;
  q += static_cast<size_t>(bh) * tq * d;
  dout += static_cast<size_t>(bh) * tq * d;
  lse += static_cast<size_t>(bh) * tq;
  delta += static_cast<size_t>(bh) * tq;
  k += static_cast<size_t>(bh) * tk * d;
  v += static_cast<size_t>(bh) * tk * d;

  load_tile(k_hi, k_lo, k, k0, tk, d, dp);
  load_tile(v_hi, v_lo, v, k0, tk, d, dp);
  AccTile dk_acc, dv_acc;  // [64 keys][dp]
  dk_acc.zero();
  dv_acc.zero();

  // Key k0 is first seen by q row k0 - (tk - tq).
  const int qstart = causal ? max(0, k0 - (tk - tq)) / BQ * BQ : 0;
  for (int q0 = qstart; q0 < tq; q0 += BQ) {
    __syncthreads();  // the previous tile's q, do, p and dS are no longer read
    load_tile(q_hi, q_lo, q, q0, tq, d, dp);
    load_tile(do_hi, do_lo, dout, q0, tq, d, dp);
    load_rows(lses, lse, q0, tq);
    load_rows(deltas, delta, q0, tq);
    __syncthreads();
    mma_tile<wmma::row_major, wmma::col_major>(s, SLD, {q_hi, q_lo, ld},
                                               {k_hi, k_lo, ld}, BK / 16, nb);
    mma_tile<wmma::row_major, wmma::col_major>(dps, SLD, {do_hi, do_lo, ld},
                                               {v_hi, v_lo, ld}, BK / 16, nb);
    __syncthreads();
    probs_and_ds(p_hi, p_lo, ds_hi, ds_lo, s, dps, lses, deltas, q0, k0, tq,
                 tk, scale, causal);
    __syncthreads();
    // dV += p^T dO, dK += dS^T Q: p and dS are [q][k], read transposed.
    dv_acc.add<wmma::col_major, wmma::row_major>({p_hi, p_lo, PLD},
                                                 {do_hi, do_lo, ld}, nb, BQ / 16);
    dk_acc.add<wmma::col_major, wmma::row_major>({ds_hi, ds_lo, PLD},
                                                 {q_hi, q_lo, ld}, nb, BQ / 16);
  }

  float* stage = s;  // [64][out_ld(dp)], over s and dps
  const int old = out_ld(dp);
  __syncthreads();
  dk_acc.store(stage, old, nb);
  __syncthreads();
  store_tile(dk + static_cast<size_t>(bh) * tk * d, stage, old, k0, tk, d);
  __syncthreads();
  dv_acc.store(stage, old, nb);
  __syncthreads();
  store_tile(dv + static_cast<size_t>(bh) * tk * d, stage, old, k0, tk, d);
}

__global__ void __launch_bounds__(NTHREADS)
    dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int tq, int tk, int d, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = pad_dim(d), ld = tile_ld(dp), nb = dp / 16;
  Carver sm{smem};
  bf16* q_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* q_lo = sm.take<bf16>(tile_bytes(dp));
  bf16* do_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* do_lo = sm.take<bf16>(tile_bytes(dp));
  bf16* k_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* k_lo = sm.take<bf16>(tile_bytes(dp));
  bf16* v_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* v_lo = sm.take<bf16>(tile_bytes(dp));
  float* s = sm.take<float>(STILE_BYTES);
  float* dps = sm.take<float>(STILE_BYTES);
  bf16* ds_hi = sm.take<bf16>(PTILE_BYTES);
  bf16* ds_lo = sm.take<bf16>(PTILE_BYTES);
  float* lses = sm.take<float>(ROWS_BYTES);
  float* deltas = sm.take<float>(ROWS_BYTES);

  const int nq = (tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;
  q += static_cast<size_t>(bh) * tq * d;
  dout += static_cast<size_t>(bh) * tq * d;
  lse += static_cast<size_t>(bh) * tq;
  delta += static_cast<size_t>(bh) * tq;
  k += static_cast<size_t>(bh) * tk * d;
  v += static_cast<size_t>(bh) * tk * d;

  load_tile(q_hi, q_lo, q, q0, tq, d, dp);
  load_tile(do_hi, do_lo, dout, q0, tq, d, dp);
  load_rows(lses, lse, q0, tq);
  load_rows(deltas, delta, q0, tq);
  AccTile dq_acc;  // [64 q rows][dp]
  dq_acc.zero();

  const int kend = causal ? min(tk, q0 + BQ + (tk - tq)) : tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's k, v and dS are no longer read
    load_tile(k_hi, k_lo, k, k0, tk, d, dp);
    load_tile(v_hi, v_lo, v, k0, tk, d, dp);
    __syncthreads();
    mma_tile<wmma::row_major, wmma::col_major>(s, SLD, {q_hi, q_lo, ld},
                                               {k_hi, k_lo, ld}, BK / 16, nb);
    mma_tile<wmma::row_major, wmma::col_major>(dps, SLD, {do_hi, do_lo, ld},
                                               {v_hi, v_lo, ld}, BK / 16, nb);
    __syncthreads();
    probs_and_ds(nullptr, nullptr, ds_hi, ds_lo, s, dps, lses, deltas, q0, k0,
                 tq, tk, scale, causal);
    __syncthreads();
    dq_acc.add<wmma::row_major, wmma::row_major>({ds_hi, ds_lo, PLD},
                                                 {k_hi, k_lo, ld}, nb, BK / 16);
  }

  float* stage = s;  // [64][out_ld(dp)], over s and dps
  const int old = out_ld(dp);
  __syncthreads();
  dq_acc.store(stage, old, nb);
  __syncthreads();
  store_tile(dq + static_cast<size_t>(bh) * tq * d, stage, old, q0, tq, d);
}

// ------------------------------------------------------------ bf16: Hopper

constexpr int NSTAGE = 2;       // ring depth for the streamed tiles
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of K2 at head width DI: K and V stay, Q and dO stream
// through the ring, with lse * log2(e) and delta of each stage's q rows.
template <int DI>
struct DkvSmem {
  static constexpr int TILE = BQ * DI * 2;  // a [64][DI] bf16 tile, DI / 64 boxes
  alignas(1024) unsigned char k[TILE];
  alignas(1024) unsigned char v[TILE];
  alignas(1024) unsigned char q[NSTAGE][TILE];
  alignas(1024) unsigned char dout[NSTAGE][TILE];
  float lse[NSTAGE][BQ];
  float delta[NSTAGE][BQ];
  uint64_t kv_full;
  uint64_t full[NSTAGE];
};

// Shared memory of K3: Q and dO stay, K and V stream through the ring.
template <int DI>
struct DqSmem {
  static constexpr int TILE = BQ * DI * 2;
  alignas(1024) unsigned char q[TILE];
  alignas(1024) unsigned char dout[TILE];
  alignas(1024) unsigned char k[NSTAGE][TILE];
  alignas(1024) unsigned char v[NSTAGE][TILE];
  uint64_t qdo_full;
  uint64_t full[NSTAGE];
};

// Dynamic shared memory of a launch: the layout, and room to align it.
template <typename Smem>
constexpr int smem_bytes() {
  return sizeof(Smem) + 1024;
}

// Writes rows row0 + r < n, columns < d, of an m64nN accumulator as bf16
// to the [n][d] matrix out.
template <int N>
__device__ __forceinline__ void store_acc(bf16* __restrict__ out, const float (&acc)[N / 2],
                                          int row0, int n, int d) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * w + l / 4 + 8 * h, col = 8 * j + 2 * (l % 4);
      if (row < n && col < d)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * d + col) =
            hopper::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

template <int DI>
__global__ void __launch_bounds__(WG_THREADS, 1)
    dkv_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int nbh, int tq, int tk, int d,
             float scale, int causal) {
  using namespace hopper;
  using Smem = DkvSmem<DI>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  // Lowest key tiles first, across all heads: under the causal mask they
  // have the most q rows.
  const int bh = blockIdx.x % nbh, k0 = blockIdx.x / nbh * BK;
  const int off = tk - tq;
  // Key k0 is first seen by q row k0 - off.
  const int qt0 = causal ? max(0, k0 - off) / BQ : 0;
  const int n = (tq + BQ - 1) / BQ - qt0;  // q tiles to visit
  lse += static_cast<size_t>(bh) * tq;
  delta += static_cast<size_t>(bh) * tq;

  auto load_q_tile = [&](int s, int it) {  // one thread
    mbar_arrive_expect_tx(&sm.full[s], 2 * Smem::TILE);
    tma_load_tile<DI>(sm.q[s], &tm_q, &sm.full[s], (qt0 + it) * BQ, bh);
    tma_load_tile<DI>(sm.dout[s], &tm_do, &sm.full[s], (qt0 + it) * BQ, bh);
  };
  // Thread t's share of tile it's rows: lse * log2(e) (t < 64) or delta.
  auto row_stat = [&](int it) {
    const int row = (qt0 + it) * BQ + t % BQ;
    if (it >= n || row >= tq) return 0.f;
    return t < BQ ? lse[row] * LOG2E : delta[row];
  };
  auto put_row_stat = [&](int s, float x) {
    if (t < BQ) sm.lse[s][t] = x;
    else sm.delta[s][t - BQ] = x;
  };

  if (t == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < NSTAGE; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(&sm.kv_full, 2 * Smem::TILE);
    tma_load_tile<DI>(sm.k, &tm_k, &sm.kv_full, k0, bh);
    tma_load_tile<DI>(sm.v, &tm_v, &sm.kv_full, k0, bh);
    for (int s = 0; s < NSTAGE && s < n; ++s) load_q_tile(s, s);
  }
  for (int s = 0; s < NSTAGE; ++s) put_row_stat(s, row_stat(s));
  __syncthreads();

  float dk_acc[DI / 2], dv_acc[DI / 2];  // [64 keys][DI]
#pragma unroll
  for (int i = 0; i < DI / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  // This thread's accumulator rows (keys, + 8 for odd i / 2) and columns
  // (q rows, + 8 j + i % 2).
  const int r0 = 16 * w + l / 4, c0 = 2 * (l % 4);
  mbar_wait(&sm.kv_full, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it % NSTAGE, q0 = (qt0 + it) * BQ;
    const float next_stat = row_stat(it + NSTAGE);  // in flight over this tile
    mbar_wait(&sm.full[s], (it / NSTAGE) & 1);

    // s^T = K Q^T and dP^T = V dO^T, [64 keys][64 q rows].
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DI / 16; ++ks)
      wgmma_ss_n64<0, 0>(st, desc_k_major(sm.k, ks), desc_k_major(sm.q[s], ks), ks);
#pragma unroll
    for (int ks = 0; ks < DI / 16; ++ks)
      wgmma_ss_n64<0, 0>(dpt, desc_k_major(sm.v, ks), desc_k_major(sm.dout[s], ks), ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // p^T and dS^T in place; lse and delta are per column.
    const bool unmasked = q0 + BQ <= tq && (!causal || k0 + BK - 1 <= q0 + off);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(&sm.lse[s][8 * j + c0]);
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[s][8 * j + c0]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = exp2_approx(fmaf(st[i], scale_log2, -(e % 2 ? ls.y : ls.x)));
        if (!unmasked) {
          const int key = k0 + r0 + 8 * (e / 2), row = q0 + 8 * j + c0 + e % 2;
          if (row >= tq || (causal && key > row + off)) p = 0.f;
        }
        dpt[i] = p * (dpt[i] - (e % 2 ? dl.y : dl.x)) * scale;
        st[i] = p;
      }
    }

    // dV += p^T dO and dK += dS^T Q, with dO and Q read MN-major.
    uint32_t pa[4][4], dsa[4][4];
    acc_to_a<64>(st, pa);
    acc_to_a<64>(dpt, dsa);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks)
      wgmma_rs<DI, 1>(dv_acc, pa[ks], desc_mn_major(sm.dout[s], ks));
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks)
      wgmma_rs<DI, 1>(dk_acc, dsa[ks], desc_mn_major(sm.q[s], ks));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    __syncthreads();  // stage s is no longer read: refill it
    if (it + NSTAGE < n) {
      put_row_stat(s, next_stat);
      if (t == 0) load_q_tile(s, it + NSTAGE);
    }
  }

  store_acc<DI>(dk + static_cast<size_t>(bh) * tk * d, dk_acc, k0, tk, d);
  store_acc<DI>(dv + static_cast<size_t>(bh) * tk * d, dv_acc, k0, tk, d);
}

template <int DI>
__global__ void __launch_bounds__(WG_THREADS, 1)
    dq_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, int nbh, int tq, int tk, int d, float scale, int causal) {
  using namespace hopper;
  using Smem = DqSmem<DI>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  // Highest q tiles first, across all heads: under the causal mask they
  // see the most keys.
  const int nq = (tq + BQ - 1) / BQ;
  const int bh = blockIdx.x % nbh, q0 = (nq - 1 - blockIdx.x / nbh) * BQ;
  const int off = tk - tq;
  const int kend = causal ? min(tk, q0 + BQ + off) : tk;
  const int n = kend > 0 ? (kend + BK - 1) / BK : 0;  // k tiles to visit

  auto load_kv_tile = [&](int s, int it) {  // one thread
    mbar_arrive_expect_tx(&sm.full[s], 2 * Smem::TILE);
    tma_load_tile<DI>(sm.k[s], &tm_k, &sm.full[s], it * BK, bh);
    tma_load_tile<DI>(sm.v[s], &tm_v, &sm.full[s], it * BK, bh);
  };

  if (t == 0) {
    mbar_init(&sm.qdo_full, 1);
    for (int s = 0; s < NSTAGE; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(&sm.qdo_full, 2 * Smem::TILE);
    tma_load_tile<DI>(sm.q, &tm_q, &sm.qdo_full, q0, bh);
    tma_load_tile<DI>(sm.dout, &tm_do, &sm.qdo_full, q0, bh);
    for (int s = 0; s < NSTAGE && s < n; ++s) load_kv_tile(s, s);
  }

  // This thread's accumulator rows (q rows r0 + 8 h) and columns (keys,
  // c0 + 8 j + i % 2); lse and delta of its rows stay in registers.
  const int r0 = 16 * w + l / 4, c0 = 2 * (l % 4);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    lse_r[h] = row < tq ? lse[static_cast<size_t>(bh) * tq + row] * LOG2E : 0.f;
    delta_r[h] = row < tq ? delta[static_cast<size_t>(bh) * tq + row] : 0.f;
  }
  float dq_acc[DI / 2];  // [64 q rows][DI]
#pragma unroll
  for (int i = 0; i < DI / 2; ++i) dq_acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  mbar_wait(&sm.qdo_full, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it % NSTAGE, k0 = it * BK;
    mbar_wait(&sm.full[s], (it / NSTAGE) & 1);

    // s = Q K^T and dP = dO V^T, [64 q rows][64 keys].
    float sa[32], dpa[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DI / 16; ++ks)
      wgmma_ss_n64<0, 0>(sa, desc_k_major(sm.q, ks), desc_k_major(sm.k[s], ks), ks);
#pragma unroll
    for (int ks = 0; ks < DI / 16; ++ks)
      wgmma_ss_n64<0, 0>(dpa, desc_k_major(sm.dout, ks), desc_k_major(sm.v[s], ks), ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(dpa);

    // dS in place of dP.
    const bool unmasked = k0 + BK <= tk && (!causal || k0 + BK - 1 <= q0 + off);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      float p = exp2_approx(fmaf(sa[i], scale_log2, -lse_r[h]));
      if (!unmasked) {
        const int row = q0 + r0 + 8 * h, key = k0 + 8 * (i / 4) + c0 + i % 2;
        if (key >= tk || (causal && key > row + off)) p = 0.f;
      }
      dpa[i] = p * (dpa[i] - delta_r[h]) * scale;
    }

    // dQ += dS K, with K read MN-major.
    uint32_t dsa[4][4];
    acc_to_a<64>(dpa, dsa);
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_rs<DI, 1>(dq_acc, dsa[ks], desc_mn_major(sm.k[s], ks));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);

    __syncthreads();  // stage s is no longer read: refill it
    if (t == 0 && it + NSTAGE < n) load_kv_tile(s, it + NSTAGE);
  }

  store_acc<DI>(dq + static_cast<size_t>(bh) * tq * d, dq_acc, q0, tq, d);
}

// The four tensor maps of q, k, v and dout, [bh][t][d] each.
__host__ inline cudaError_t encode_qkvdo(CUtensorMap (&m)[4], const void* q, const void* k,
                                         const void* v, const void* dout, int bh, int tq,
                                         int tk, int d) {
  cudaError_t err = hopper::encode_tiles(&m[0], q, bh, tq, d);
  if (err == cudaSuccess) err = hopper::encode_tiles(&m[1], k, bh, tk, d);
  if (err == cudaSuccess) err = hopper::encode_tiles(&m[2], v, bh, tk, d);
  if (err == cudaSuccess) err = hopper::encode_tiles(&m[3], dout, bh, tq, d);
  return err;
}

template <int DI>
int launch_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                    int tk, int d, float scale, int causal, cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = encode_qkvdo(m, q, k, v, dout, bh, tq, tk, d);
  if (err != cudaSuccess) return err;
  const int smem = smem_bytes<DkvSmem<DI>>();
  err = cudaFuncSetAttribute(dkv_sm90<DI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nk = (tk + BK - 1) / BK;
  dkv_sm90<DI><<<bh * nk, WG_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), bh, tq, tk, d, scale, causal);
  return cudaGetLastError();
}

template <int DI>
int launch_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int tq, int tk, int d,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = encode_qkvdo(m, q, k, v, dout, bh, tq, tk, d);
  if (err != cudaSuccess) return err;
  const int smem = smem_bytes<DqSmem<DI>>();
  err = cudaFuncSetAttribute(dq_sm90<DI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (tq + BQ - 1) / BQ;
  dq_sm90<DI><<<bh * nq, WG_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), bh, tq, tk, d, scale, causal);
  return cudaGetLastError();
}

int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                   int tk, int d, float scale, int causal, cudaStream_t stream) {
  const int smem = dkv_smem_bytes(pad_dim(d));
  cudaError_t err =
      cudaFuncSetAttribute(dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nk = (tk + BK - 1) / BK;
  dkv_f32<<<bh * nk, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), tq,
      tk, d, scale, causal);
  return cudaGetLastError();
}

int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int bh, int tq, int tk, int d,
                  float scale, int causal, cudaStream_t stream) {
  const int smem = dq_smem_bytes(pad_dim(d));
  cudaError_t err =
      cudaFuncSetAttribute(dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (tq + BQ - 1) / BQ;
  dq_f32<<<bh * nq, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), tq, tk, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// Both return a cudaError_t; the caller checks shapes, types and alignment.
// bf16 runs the Hopper kernels (64 or 128 columns wide), float32 the WMMA
// ones.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, float scale, int causal,
                             int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return flash::launch_dkv_f32(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale,
                                 causal, s);
  if (d <= 64)
    return flash::launch_dkv_sm90<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale,
                                      causal, s);
  return flash::launch_dkv_sm90<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale,
                                     causal, s);
}

// Dynamic shared memory per block of the bf16 K2 (is_dq 0) or K3 at head
// dim d, for reports beside ptxas's registers.
extern "C" int flash_bwd_sm90_smem_bytes(int d, int is_dq) {
  using namespace flash;
  if (is_dq) return d <= 64 ? smem_bytes<DqSmem<64>>() : smem_bytes<DqSmem<128>>();
  return d <= 64 ? smem_bytes<DkvSmem<64>>() : smem_bytes<DkvSmem<128>>();
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int tq,
                            int tk, int d, float scale, int causal,
                            int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return flash::launch_dq_f32(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, causal, s);
  if (d <= 64)
    return flash::launch_dq_sm90<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale,
                                     causal, s);
  return flash::launch_dq_sm90<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale,
                                    causal, s);
}
