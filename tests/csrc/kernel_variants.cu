// Designs of the bf16 K1 and K5 that were measured against the kernels as
// built and not taken, for tests/test_torch_variants.py to hold bitwise
// against them and time beside them. Built as one library with the
// sources of both kernels.
//
// K1 (fwd_overlap): the next tile's s product is started before this tile's
// softmax and runs beside this tile's p V (FA3's intra-warpgroup overlap).
// K1 (fwd_pair): a 128-row q tile on two consumer warpgroups that share
// each K/V stage. Both do the built kernel's arithmetic in its order.
// K5 (tgmm_variant<NST, PIPE, BY_SIZE, NWG>): NST ring stages; PIPE keeps
// the last stage's products in flight while the stage before is refilled;
// BY_SIZE takes the experts largest first (as built) or in id order (the
// simple grid); NWG consumer warpgroups, a (64 NWG) x 128 output tile.
// K4 (gmm_variant<TRANS, NJ, RASTER>): NJ m64n128 accumulators per
// warpgroup, a 128 x (128 NJ) output tile (NJ 2: 4 stages, one block per
// SM); RASTER runs the blocks in groups of GM_GROUP m tiles, m fastest
// within a group, so that the blocks reading one column strip of rhs[e]
// run together. Both sum as the built kernel does. The WMMA kernel the
// bf16 K4 replaced (gmm_kernel<bf16>) is timed beside them; it sums in
// another order.
#include "flash_fwd.cu"
#include "gmm.cu"

namespace variants {

using namespace flash;

template <int DI>
__global__ void __launch_bounds__(hopper::WG_THREADS, 1)
    fwd_overlap(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                float* __restrict__ lse, int nbh, int tq, int tk, int d, float scale,
                int causal) {
  using namespace hopper;
  using Smem = FwdSmem<DI>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int nq = (tq + BQ - 1) / BQ;
  const int bh = blockIdx.x % nbh, q0 = (nq - 1 - blockIdx.x / nbh) * BQ;
  const int off = tk - tq;
  const int kend = causal ? min(tk, q0 + BQ + off) : tk;
  const int n = kend > 0 ? (kend + BK - 1) / BK : 0;

  auto load_kv_tile = [&](int s, int it) {
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
  const int r0 = 16 * w + lane / 4, c0 = 2 * (lane % 4);
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o_acc[DI / 2];
#pragma unroll
  for (int i = 0; i < DI / 2; ++i) o_acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  auto start_s = [&](float (&sa)[32], int s) {
#pragma unroll
    for (int ks = 0; ks < DI / 16; ++ks)
      wgmma_ss_n64<0, 0>(sa, desc_k_major(sm.q, ks), desc_k_major(sm.k[s], ks), ks);
    wgmma_commit();
  };
  auto softmax = [&](float (&sa)[32], int k0, float (&corr)[2]) {
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
  };
  mbar_wait(&sm.q_full, 0);

  float sa[32], corr[2];
  uint32_t pa[4][4];
  if (n > 0) {
    mbar_wait(&sm.full[0], 0);
    wgmma_fence();
    start_s(sa, 0);
    wgmma_wait<0>();
    fence_regs(sa);
    softmax(sa, 0, corr);
    acc_to_a<64>(sa, pa);
  }
  for (int it = 0; it < n; ++it) {
    const int s = it % NSTAGE, s1 = (it + 1) % NSTAGE;
    const bool more = it + 1 < n;
    if (more) mbar_wait(&sm.full[s1], ((it + 1) / NSTAGE) & 1);
    fence_regs(o_acc);
    wgmma_fence();
    if (more) start_s(sa, s1);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) wgmma_rs<DI, 1>(o_acc, pa[ks], desc_mn_major(sm.v[s], ks));
    wgmma_commit();
    if (more) {
      wgmma_wait<1>();
      fence_regs(sa);
      softmax(sa, (it + 1) * BK, corr);
    }
    wgmma_wait<0>();
    fence_regs(o_acc);
    if (more) {
#pragma unroll
      for (int i = 0; i < DI / 2; ++i) o_acc[i] *= corr[(i / 2) % 2];
      acc_to_a<64>(sa, pa);
    }
    __syncthreads();
    if (t == 0 && it + NSTAGE < n) load_kv_tile(s, it + NSTAGE);
  }

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
int launch_fwd_overlap(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int tq, int tk, int d, float scale, int causal) {
  CUtensorMap m[3];
  cudaError_t err = hopper::encode_tiles(&m[0], q, bh, tq, d);
  if (err == cudaSuccess) err = hopper::encode_tiles(&m[1], k, bh, tk, d);
  if (err == cudaSuccess) err = hopper::encode_tiles(&m[2], v, bh, tk, d);
  if (err != cudaSuccess) return err;
  const int smem = hopper::smem_bytes<FwdSmem<DI>>();
  err = cudaFuncSetAttribute(fwd_overlap<DI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (tq + BQ - 1) / BQ;
  fwd_overlap<DI><<<bh * nq, hopper::WG_THREADS, smem>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), static_cast<float*>(lse), bh, tq, tk, d, scale,
      causal);
  return cudaGetLastError();
}

// K1 on a 128-row q tile: two consumer warpgroups, one per 64 rows, share
// each K/V stage; a warpgroup skips the key tiles wholly past its rows'
// causal limit (and all tiles when its rows are past Tq).
template <int DI>
struct PairSmem {
  static constexpr int TILE = BQ * DI * 2;
  alignas(1024) unsigned char q[2][TILE];
  alignas(1024) unsigned char k[NSTAGE][TILE];
  alignas(1024) unsigned char v[NSTAGE][TILE];
  uint64_t q_full;
  uint64_t full[NSTAGE];
};

template <int DI>
__global__ void __launch_bounds__(2 * hopper::WG_THREADS, 2)
    fwd_pair(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
             float* __restrict__ lse, int nbh, int tq, int tk, int d, float scale, int causal) {
  using namespace hopper;
  using Smem = PairSmem<DI>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int t = threadIdx.x, wg = t / WG_THREADS, w = t % WG_THREADS / 32, lane = t % 32;
  const int nq = (tq + 2 * BQ - 1) / (2 * BQ);
  const int bh = blockIdx.x % nbh, qb = (nq - 1 - blockIdx.x / nbh) * 2 * BQ;
  const int q0 = qb + wg * BQ;  // this warpgroup's rows
  const int off = tk - tq;
  const int kend_block = causal ? min(tk, qb + 2 * BQ + off) : tk;
  const int n = kend_block > 0 ? (kend_block + BK - 1) / BK : 0;
  const int kend = causal ? min(tk, q0 + BQ + off) : tk;
  const int n_mine = q0 < tq && kend > 0 ? (kend + BK - 1) / BK : 0;

  auto load_kv_tile = [&](int s, int it) {
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
    mbar_arrive_expect_tx(&sm.q_full, 2 * Smem::TILE);
    tma_load_tile<DI>(sm.q[0], &tm_q, &sm.q_full, qb, bh);
    tma_load_tile<DI>(sm.q[1], &tm_q, &sm.q_full, qb + BQ, bh);
    for (int s = 0; s < NSTAGE && s < n; ++s) load_kv_tile(s, s);
  }
  const int r0 = 16 * w + lane / 4, c0 = 2 * (lane % 4);
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o_acc[DI / 2];
#pragma unroll
  for (int i = 0; i < DI / 2; ++i) o_acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  mbar_wait(&sm.q_full, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it % NSTAGE, k0 = it * BK;
    mbar_wait(&sm.full[s], (it / NSTAGE) & 1);
    if (it < n_mine) {
      float sa[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DI / 16; ++ks)
        wgmma_ss_n64<0, 0>(sa, desc_k_major(sm.q[wg], ks), desc_k_major(sm.k[s], ks), ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
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
    }
    __syncthreads();  // stage s is no longer read by either warpgroup
    if (t == 0 && it + NSTAGE < n) load_kv_tile(s, it + NSTAGE);
  }

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
int launch_fwd_pair(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int tq, int tk, int d, float scale, int causal) {
  CUtensorMap m[3];
  cudaError_t err = hopper::encode_tiles(&m[0], q, bh, tq, d);
  if (err == cudaSuccess) err = hopper::encode_tiles(&m[1], k, bh, tk, d);
  if (err == cudaSuccess) err = hopper::encode_tiles(&m[2], v, bh, tk, d);
  if (err != cudaSuccess) return err;
  const int smem = hopper::smem_bytes<PairSmem<DI>>();
  err = cudaFuncSetAttribute(fwd_pair<DI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (tq + 2 * BQ - 1) / (2 * BQ);
  fwd_pair<DI><<<bh * nq, 2 * hopper::WG_THREADS, smem>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), static_cast<float*>(lse), bh, tq, tk, d, scale,
      causal);
  return cudaGetLastError();
}

template <int NST, int NWG>
struct TgmmSmem {
  alignas(1024) unsigned char lhs[NST][NWG * hopper::BOX_BYTES];
  alignas(1024) unsigned char dout[NST][2 * hopper::BOX_BYTES];
  uint64_t full[NST];
};

template <int NST, bool PIPE, bool BY_SIZE, int NWG>
__global__ void __launch_bounds__(NWG * 128, NWG == 2 && NST <= 3 ? 2 : 1)
    tgmm_variant(const __grid_constant__ CUtensorMap tm_lhs,
                 const __grid_constant__ CUtensorMap tm_dout, const int* __restrict__ tile_group,
                 bf16* __restrict__ out, int m, int k, int n, int num_groups, int block_m) {
  using namespace hopper;
  using grouped::BN;
  using grouped::TG_ROWS;
  constexpr int THREADS = NWG * 128;
  extern __shared__ unsigned char smem_raw[];
  TgmmSmem<NST, NWG>& sm = *reinterpret_cast<TgmmSmem<NST, NWG>*>(align_1024(smem_raw));
  const int t = threadIdx.x, wg = t / WG_THREADS;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * 64 * NWG;
  const int ntiles = m / block_m, per_tile = block_m / TG_ROWS;
  int e = blockIdx.z;
  if constexpr (BY_SIZE) {
    int* tiles_of = reinterpret_cast<int*>(&sm + 1);
    for (int g = t; g < num_groups; g += THREADS) tiles_of[g] = 0;
    __syncthreads();
    for (int i = t; i < ntiles; i += THREADS) {
      const int g = tile_group[i];
      if (g >= 0 && g < num_groups) atomicAdd(&tiles_of[g], 1);
    }
    __syncthreads();
    for (int g = t; g < num_groups; g += THREADS) {
      int rank = 0;
      for (int u = 0; u < num_groups; ++u)
        rank += tiles_of[u] > tiles_of[g] || (tiles_of[u] == tiles_of[g] && u < g);
      if (rank == static_cast<int>(blockIdx.z)) tiles_of[num_groups] = g;
    }
    __syncthreads();
    e = tiles_of[num_groups];
  }
  int count = 0;
  for (int base = 0; base < ntiles; base += THREADS)
    count += __syncthreads_count(base + t < ntiles && tile_group[base + t] == e);
  const int n_stages = count * per_tile;

  int tile = -1, sub = per_tile;
  auto load_stage = [&](int s) {
    if (sub == per_tile) {
      do ++tile;
      while (tile_group[tile] != e);
      sub = 0;
    }
    const int row = tile * block_m + TG_ROWS * sub++;
    mbar_arrive_expect_tx(&sm.full[s], (NWG + 2) * BOX_BYTES);
    tma_load_tile<64 * NWG>(sm.lhs[s], &tm_lhs, &sm.full[s], row, 0, row0);
    tma_load_tile<BN>(sm.dout[s], &tm_dout, &sm.full[s], row, 0, col0);
  };
  if (t == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0)
    for (int s = 0; s < NST && s < n_stages; ++s) load_stage(s);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_stages; ++it) {
    const int s = it % NST;
    mbar_wait(&sm.full[s], (it / NST) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TG_ROWS / 16; ++ks)
      wgmma_ss_n128<1, 1>(acc, desc_mn_major(sm.lhs[s] + wg * BOX_BYTES, ks),
                          desc_mn_major(sm.dout[s], ks), 1);
    wgmma_commit();
    if constexpr (PIPE) {
      wgmma_wait<1>();
      __syncthreads();
      if (t == 0 && it >= 1 && it - 1 + NST < n_stages) load_stage((it - 1) % NST);
    } else {
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();
      if (t == 0 && it + NST < n_stages) load_stage(s);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  store_acc<BN>(out + static_cast<size_t>(e) * k * n, acc, n, row0 + 64 * wg, k, col0, n);
}

template <int NST, bool PIPE, bool BY_SIZE, int NWG>
int launch_tgmm_variant(const void* lhs, const void* dout, const void* tile_group, void* out,
                        int m, int k, int n, int num_groups, int block_m) {
  CUtensorMap tm_lhs, tm_dout;
  cudaError_t err = hopper::encode_tiles(&tm_lhs, lhs, 1, m, k);
  if (err == cudaSuccess) err = hopper::encode_tiles(&tm_dout, dout, 1, m, n);
  if (err != cudaSuccess) return err;
  const int smem =
      hopper::smem_bytes<TgmmSmem<NST, NWG>>() + (BY_SIZE ? 4 * (num_groups + 1) : 0);
  err = cudaFuncSetAttribute(tgmm_variant<NST, PIPE, BY_SIZE, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + grouped::BN - 1) / grouped::BN, (k + 64 * NWG - 1) / (64 * NWG),
                  num_groups);
  tgmm_variant<NST, PIPE, BY_SIZE, NWG><<<grid, NWG * 128, smem>>>(
      tm_lhs, tm_dout, static_cast<const int*>(tile_group), static_cast<bf16*>(out), m, k, n,
      num_groups, block_m);
  return cudaGetLastError();
}


constexpr int GM_GROUP = 8;  // m tiles per group of the RASTER order

template <int NST, int NJ>
struct GmmSmem {
  alignas(1024) unsigned char lhs[NST][2 * hopper::BOX_BYTES];
  alignas(1024) unsigned char rhs[NST][2 * NJ * hopper::BOX_BYTES];
  uint64_t full[NST];
};

template <bool TRANS, int NJ, bool RASTER>
__global__ void __launch_bounds__(2 * hopper::WG_THREADS, NJ == 1 ? 2 : 1)
    gmm_variant(const __grid_constant__ CUtensorMap tm_lhs,
                const __grid_constant__ CUtensorMap tm_rhs, const int* __restrict__ tile_group,
                bf16* __restrict__ out, int m, int k, int n, int num_groups, int block_m) {
  using namespace hopper;
  constexpr int NST = NJ == 1 ? 3 : 4, BNV = 128 * NJ;
  using Smem = GmmSmem<NST, NJ>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int t = threadIdx.x, wg = t / WG_THREADS;
  int col0, row0;
  if constexpr (RASTER) {
    const int mt = m / 128, per_group = GM_GROUP * ((n + BNV - 1) / BNV);
    const int first = blockIdx.x / per_group * GM_GROUP, r = blockIdx.x % per_group;
    const int rows = min(GM_GROUP, mt - first);
    row0 = (first + r % rows) * 128;
    col0 = r / rows * BNV;
  } else {
    col0 = blockIdx.x * BNV;
    row0 = blockIdx.y * 128;
  }
  const int e = min(max(tile_group[row0 / block_m], 0), num_groups - 1);
  const int n_stages = (k + 63) / 64;

  auto load_stage = [&](int s, int it) {
    const int k0 = it * 64;
    mbar_arrive_expect_tx(&sm.full[s], (2 + 2 * NJ) * BOX_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_load_3d(sm.lhs[s] + h * BOX_BYTES, &tm_lhs, &sm.full[s], k0, row0 + 64 * h, 0);
    if constexpr (TRANS) {
#pragma unroll
      for (int h = 0; h < 2 * NJ; ++h)
        tma_load_3d(sm.rhs[s] + h * BOX_BYTES, &tm_rhs, &sm.full[s], k0, col0 + 64 * h, e);
    } else {
      tma_load_tile<BNV>(sm.rhs[s], &tm_rhs, &sm.full[s], k0, e, col0);
    }
  };
  if (t == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0)
    for (int s = 0; s < NST && s < n_stages; ++s) load_stage(s, s);

  float acc[NJ][64];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
  for (int it = 0; it < n_stages; ++it) {
    const int s = it % NST;
    mbar_wait(&sm.full[s], (it / NST) & 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) fence_regs(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t a = desc_k_major(sm.lhs[s] + wg * BOX_BYTES, ks);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const unsigned char* b = sm.rhs[s] + 2 * j * BOX_BYTES;
        if constexpr (TRANS) wgmma_ss_n128<0, 0>(acc[j], a, desc_k_major(b, ks), 1);
        else wgmma_ss_n128<0, 1>(acc[j], a, desc_mn_major(b, ks), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    __syncthreads();
    if (t == 0 && it >= 1 && it - 1 + NST < n_stages) load_stage((it - 1) % NST, it - 1 + NST);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    fence_regs(acc[j]);
    store_acc<128>(out, acc[j], n, row0 + 64 * wg, m, col0 + 128 * j, n);
  }
}

template <bool TRANS, int NJ, bool RASTER>
int launch_gmm_variant(const void* lhs, const void* rhs, const void* tile_group, void* out, int m,
                       int k, int n, int num_groups, int block_m) {
  CUtensorMap tm_lhs, tm_rhs;
  cudaError_t err = hopper::encode_tiles(&tm_lhs, lhs, 1, m, k);
  if (err == cudaSuccess)
    err = TRANS ? hopper::encode_tiles(&tm_rhs, rhs, num_groups, n, k)
                : hopper::encode_tiles(&tm_rhs, rhs, num_groups, k, n);
  if (err != cudaSuccess) return err;
  constexpr int NST = NJ == 1 ? 3 : 4;
  const int smem = hopper::smem_bytes<GmmSmem<NST, NJ>>();
  err = cudaFuncSetAttribute(gmm_variant<TRANS, NJ, RASTER>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nt = (n + 128 * NJ - 1) / (128 * NJ), mt = m / 128;
  const dim3 grid = RASTER ? dim3(nt * mt) : dim3(nt, mt);
  gmm_variant<TRANS, NJ, RASTER><<<grid, 2 * hopper::WG_THREADS, smem>>>(
      tm_lhs, tm_rhs, static_cast<const int*>(tile_group), static_cast<bf16*>(out), m, k, n,
      num_groups, block_m);
  return cudaGetLastError();
}

template <bool TRANS>
int launch_gmm_by_variant(int variant, const void* lhs, const void* rhs, const void* tile_group,
                       void* out, int m, int k, int n, int num_groups, int block_m) {
  switch (variant) {
    case 0: return launch_gmm_variant<TRANS, 2, false>(lhs, rhs, tile_group, out, m, k, n, num_groups, block_m);
    case 1: return launch_gmm_variant<TRANS, 1, true>(lhs, rhs, tile_group, out, m, k, n, num_groups, block_m);
    case 2: return grouped::launch_gmm<bf16, TRANS>(lhs, rhs, tile_group, out, m, k, n, num_groups, block_m, 0);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace variants

// Each launches one variant on the default stream and returns a cudaError_t.
extern "C" int fwd_overlap(const void* q, const void* k, const void* v, void* o, void* lse,
                           int bh, int tq, int tk, int d, float scale, int causal) {
  if (d <= 64) return variants::launch_fwd_overlap<64>(q, k, v, o, lse, bh, tq, tk, d, scale, causal);
  return variants::launch_fwd_overlap<128>(q, k, v, o, lse, bh, tq, tk, d, scale, causal);
}

extern "C" int fwd_pair(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                        int tq, int tk, int d, float scale, int causal) {
  if (d <= 64) return variants::launch_fwd_pair<64>(q, k, v, o, lse, bh, tq, tk, d, scale, causal);
  return variants::launch_fwd_pair<128>(q, k, v, o, lse, bh, tq, tk, d, scale, causal);
}

// variant: 0 the simple grid (experts in id order); 1 as built, with the
// last stage's products kept in flight; 2 that with 4 stages (one block
// per SM); 3 that on a 256 x 128 tile of 4 warpgroups.
extern "C" int tgmm_variant(const void* lhs, const void* dout, const void* tile_group, void* out,
                            int m, int k, int n, int num_groups, int block_m, int variant) {
  using namespace variants;
  switch (variant) {
    case 0: return launch_tgmm_variant<3, false, false, 2>(lhs, dout, tile_group, out, m, k, n, num_groups, block_m);
    case 1: return launch_tgmm_variant<3, true, true, 2>(lhs, dout, tile_group, out, m, k, n, num_groups, block_m);
    case 2: return launch_tgmm_variant<4, true, true, 2>(lhs, dout, tile_group, out, m, k, n, num_groups, block_m);
    case 3: return launch_tgmm_variant<4, true, true, 4>(lhs, dout, tile_group, out, m, k, n, num_groups, block_m);
    default: return cudaErrorInvalidValue;
  }
}

// variant: 0 the 128 x 256 tile (4 stages, one block per SM); 1 the blocks
// in groups of 8 m tiles, m fastest; 2 the WMMA kernel the bf16 K4
// replaced. transpose_rhs as for gmm (the dlhs form).
extern "C" int gmm_variant(const void* lhs, const void* rhs, const void* tile_group, void* out,
                           int m, int k, int n, int num_groups, int block_m, int transpose_rhs,
                           int variant) {
  using namespace variants;
  if (transpose_rhs)
    return launch_gmm_by_variant<true>(variant, lhs, rhs, tile_group, out, m, k, n, num_groups, block_m);
  return launch_gmm_by_variant<false>(variant, lhs, rhs, tile_group, out, m, k, n, num_groups, block_m);
}
