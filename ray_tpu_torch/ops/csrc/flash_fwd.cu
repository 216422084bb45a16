// K1: flash-attention forward, (o, lse) = attention(q, k, v).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_fwd_pallas). One block per (bh, 64-row q tile); a loop over 64-key
// tiles takes the place of the TPU grid's sequential k axis, and stopping it
// at the tile's causal limit takes the place of the pl.when block skip.
// Online softmax over (m, l, acc) in float; keys past Tk and keys after
// row i + Tk - Tq (the end-aligned causal mask) are masked with the finite
// NEG_INF. The loop always starts at key tile 0, which holds key 0, visible
// to every row when Tq <= Tk, so m is finite after the first tile and a
// later, fully masked tile adds exp(NEG_INF - m) = 0. o is written in the
// input type, lse = m + log(l) in float (natural log), with l = 1 where
// l == 0. As in the TPU kernel, p is rounded to the input type for p v,
// while l sums p in float.
//
// Bound on an H100 SXM: at the main path (BH 32, T 2048, D 128, bf16,
// causal) the kernel does 4 D flops per visible (q, k) pair, 34.4 GFLOP,
// 35 us at 989 TFLOP/s, and moves 67 MB, 20 us at 3.35 TB/s: compute-bound.
//
// bf16 inputs run on a Hopper kernel (fwd_sm90; hopper.cuh), one warpgroup
// of 128 threads per block, blocks ordered highest q tile first across all
// heads (under the causal mask those see the most keys):
// - TMA loads the Q tile once, and the K and V tiles into a ring of NSTAGE
//   stages on mbarriers, NSTAGE - 1 tiles ahead of the one in use; rows
//   past T and columns past D read as zeros within their own head;
// - s = Q K^T is a wgmma from shared memory, both operands K-major, and
//   stays in registers: the masks apply on each accumulator element where
//   it lies (tiles wholly inside the masks skip them), and the row max and
//   sum reduce over the four lanes that share a row;
// - exponentials are exp2 of s * scale * log2(e), m is kept in that unit,
//   and lse is converted back to the natural log at the end;
// - p, rounded to bf16 once, is the register A operand of o += p V, with V
//   read MN-major through the descriptor; o is rescaled by the row's
//   correction before each product;
// - o is written once from registers, lse once per row: one writer per
//   output, so the result is bitwise deterministic.
// A head dim D <= 64 runs in a 64-wide instance and 64 < D <= 128 in a
// 128-wide one, on zero-filled columns; stores write the D real ones.
//
// float32 inputs keep the WMMA kernel (fwd_f32, flash_common.cuh): every
// operand split into bf16 hi + lo, about 16 bits of mantissa.
//
// What the Hopper design leaves on the table: TMA is started by a consumer
// thread instead of a producer warp, and each block has one consumer
// warpgroup on a 64-row q tile, so only the other blocks on the SM fill
// the gaps between its products. Two other designs measured on an H100
// at the main path (tests/csrc/kernel_variants.cu) were not taken:
// starting the next tile's s product before the current tile's softmax
// (FA3's intra-warpgroup overlap) was slower at both widths (0.13 against
// 0.09 ms at D 128), and a 128-row q tile on two warpgroups sharing each
// K/V stage was 5% faster at D 128 but 25% slower at D 64.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash {

// ------------------------------------------------------------ float32: WMMA

__host__ __device__ constexpr int fwd_smem_bytes(int dp) {
  return 2 * (3 * tile_bytes(dp) + PTILE_BYTES) + max_of(STILE_BYTES, otile_bytes(dp));
}

__global__ void __launch_bounds__(NTHREADS)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o,
            float* __restrict__ lse, int tq, int tk, int d, float scale,
            int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = pad_dim(d), ld = tile_ld(dp), nb = dp / 16, old = out_ld(dp);
  Carver sm{smem};
  bf16* q_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* q_lo = sm.take<bf16>(tile_bytes(dp));
  bf16* k_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* k_lo = sm.take<bf16>(tile_bytes(dp));
  bf16* v_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* v_lo = sm.take<bf16>(tile_bytes(dp));
  bf16* p_hi = sm.take<bf16>(PTILE_BYTES);
  bf16* p_lo = sm.take<bf16>(PTILE_BYTES);
  // s [64][SLD], then, once p is out, the p v product [64][old].
  float* f = sm.take<float>(max_of(STILE_BYTES, otile_bytes(dp)));

  const int nq = (tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  // Highest q tiles first: under the causal mask they have the most keys.
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = tk - tq;
  q += static_cast<size_t>(bh) * tq * d;
  k += static_cast<size_t>(bh) * tk * d;
  v += static_cast<size_t>(bh) * tk * d;

  load_tile(q_hi, q_lo, q, q0, tq, d, dp);

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  // The tile's last row, q0 + 63, sees keys up to q0 + 63 + off.
  const int kend = causal ? min(tk, q0 + BQ + off) : tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's k, v, p and f are no longer read
    load_tile(k_hi, k_lo, k, k0, tk, d, dp);
    load_tile(v_hi, v_lo, v, k0, tk, d, dp);
    __syncthreads();
    mma_tile<wmma::row_major, wmma::col_major>(f, SLD, {q_hi, q_lo, ld},
                                               {k_hi, k_lo, ld}, BK / 16, nb);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      float s[4], mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool visible = col < tk && (!causal || col <= row + off);
        s[j] = visible ? f[r * SLD + tx + 16 * j] * scale : NEG_INF;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = __expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[j] - m_new);
        put_split(p_hi, p_lo, r * PLD + tx + 16 * j, p);
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mma_tile<wmma::row_major, wmma::row_major>(f, old, {p_hi, p_lo, PLD},
                                               {v_hi, v_lo, ld}, nb, BK / 16);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        if (c < d) acc[i][j] += f[(ty + 16 * i) * old + c];
      }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < tq)
      lse[static_cast<size_t>(bh) * tq + row] = m[i] + logf(l_safe);
    if (row >= tq) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[(static_cast<size_t>(bh) * tq + row) * d + c] = acc[i][j] / l_safe;
    }
  }
}

int launch_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int tq, int tk, int d, float scale, int causal, cudaStream_t stream) {
  const int smem = fwd_smem_bytes(pad_dim(d));
  cudaError_t err =
      cudaFuncSetAttribute(fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (tq + BQ - 1) / BQ;
  fwd_f32<<<bh * nq, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), tq, tk, d, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16: Hopper

constexpr int NSTAGE = 2;  // ring depth for the K and V tiles
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of K1 at head width DI: Q stays, K and V stream through
// the ring.
template <int DI>
struct FwdSmem {
  static constexpr int TILE = BQ * DI * 2;  // a [64][DI] bf16 tile, DI / 64 boxes
  alignas(1024) unsigned char q[TILE];
  alignas(1024) unsigned char k[NSTAGE][TILE];
  alignas(1024) unsigned char v[NSTAGE][TILE];
  uint64_t q_full;
  uint64_t full[NSTAGE];
};

template <int DI>
__global__ void __launch_bounds__(hopper::WG_THREADS, 1)
    fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
             float* __restrict__ lse, int nbh, int tq, int tk, int d, float scale, int causal) {
  using namespace hopper;
  using Smem = FwdSmem<DI>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  // Highest q tiles first, across all heads.
  const int nq = (tq + BQ - 1) / BQ;
  const int bh = blockIdx.x % nbh, q0 = (nq - 1 - blockIdx.x / nbh) * BQ;
  const int off = tk - tq;
  // The tile's last row, q0 + 63, sees keys up to q0 + 63 + off.
  const int kend = causal ? min(tk, q0 + BQ + off) : tk;
  const int n = kend > 0 ? (kend + BK - 1) / BK : 0;  // k tiles to visit

  auto load_kv_tile = [&](int s, int it) {  // one thread
    mbar_arrive_expect_tx(&sm.full[s], 2 * Smem::TILE);
    tma_load_tile<DI>(sm.k[s], &tm_k, &sm.full[s], it * BK, bh);
    tma_load_tile<DI>(sm.v[s], &tm_v, &sm.full[s], it * BK, bh);
  };

  if (t == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(&sm.q_full, Smem::TILE);
    tma_load_tile<DI>(sm.q, &tm_q, &sm.q_full, q0, bh);
    for (int s = 0; s < NSTAGE && s < n; ++s) load_kv_tile(s, s);
  }

  // This thread's accumulator rows (q rows r0 + 8 h) and columns (keys,
  // c0 + 8 j + i % 2). Per row: the running max m of s * scale * log2(e),
  // and this thread's share of the running sum l (its four lanes' shares
  // are added at the end).
  const int r0 = 16 * w + lane / 4, c0 = 2 * (lane % 4);
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o_acc[DI / 2];  // [64 q rows][DI]
#pragma unroll
  for (int i = 0; i < DI / 2; ++i) o_acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  mbar_wait(&sm.q_full, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it % NSTAGE, k0 = it * BK;
    mbar_wait(&sm.full[s], (it / NSTAGE) & 1);

    // s = Q K^T, [64 q rows][64 keys].
    float sa[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DI / 16; ++ks)
      wgmma_ss_n64<0, 0>(sa, desc_k_major(sm.q, ks), desc_k_major(sm.k[s], ks), ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);

    // Scaled and masked in place, then the rows' new max, their
    // corrections, and p in place of s; l sums the float p.
    const bool unmasked = k0 + BK <= tk && (!causal || k0 + BK - 1 <= q0 + off);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      float x = sa[i] * scale_log2;
      if (!unmasked) {
        const int row = q0 + r0 + 8 * h, key = k0 + 8 * (i / 4) + c0 + i % 2;
        if (key >= tk || (causal && key > row + off)) x = NEG_INF;
      }
      sa[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2_approx(m_r[h] - mx[h]);
      m_r[h] = mx[h];
      l_r[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      sa[i] = exp2_approx(sa[i] - m_r[h]);
      l_r[h] += sa[i];
    }
#pragma unroll
    for (int i = 0; i < DI / 2; ++i) o_acc[i] *= corr[(i / 2) % 2];

    // o += p V, with p rounded to bf16 and V read MN-major.
    uint32_t pa[4][4];
    acc_to_a<64>(sa, pa);
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_rs<DI, 1>(o_acc, pa[ks], desc_mn_major(sm.v[s], ks));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);

    __syncthreads();  // stage s is no longer read: refill it
    if (t == 0 && it + NSTAGE < n) load_kv_tile(s, it + NSTAGE);
  }

  // The rows' sums over their four lanes, l = 1 where l == 0; lse in the
  // natural log, written by one lane per row.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l_r[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (sum == 0.f) sum = 1.f;
    inv[h] = 1.f / sum;
    const int row = q0 + r0 + 8 * h;
    if (lane % 4 == 0 && row < tq)
      lse[static_cast<size_t>(bh) * tq + row] = m_r[h] * LN2 + logf(sum);
  }
#pragma unroll
  for (int i = 0; i < DI / 2; ++i) o_acc[i] *= inv[(i / 2) % 2];
  store_acc<DI>(o + static_cast<size_t>(bh) * tq * d, o_acc, d, q0, tq, 0, d);
}

template <int DI>
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int tq, int tk, int d, float scale, int causal, cudaStream_t stream) {
  CUtensorMap m[3];
  cudaError_t err = hopper::encode_tiles(&m[0], q, bh, tq, d);
  if (err == cudaSuccess) err = hopper::encode_tiles(&m[1], k, bh, tk, d);
  if (err == cudaSuccess) err = hopper::encode_tiles(&m[2], v, bh, tk, d);
  if (err != cudaSuccess) return err;
  const int smem = hopper::smem_bytes<FwdSmem<DI>>();
  err = cudaFuncSetAttribute(fwd_sm90<DI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (tq + BQ - 1) / BQ;
  fwd_sm90<DI><<<bh * nq, hopper::WG_THREADS, smem, stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), static_cast<float*>(lse), bh, tq, tk, d, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace flash

// Returns a cudaError_t; the caller checks shapes, types and alignment.
// bf16 runs the Hopper kernel (64 or 128 columns wide), float32 the WMMA
// one.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int tq, int tk, int d, float scale,
                         int causal, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return flash::launch_fwd_f32(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
  if (d <= 64)
    return flash::launch_fwd_sm90<64>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
  return flash::launch_fwd_sm90<128>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
}

// Dynamic shared memory per block of the bf16 K1 at head dim d, for
// reports beside ptxas's registers.
extern "C" int flash_fwd_sm90_smem_bytes(int d) {
  using namespace flash;
  return d <= 64 ? hopper::smem_bytes<FwdSmem<64>>() : hopper::smem_bytes<FwdSmem<128>>();
}

