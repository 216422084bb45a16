// K2 and K3: the flash-attention backward, as two kernels.
//
// K2 replaces ray_tpu/ops/attention.py::_bwd_dkv_kernel and K3 replaces
// ray_tpu/ops/attention.py::_bwd_dq_kernel (both launched by
// _flash_bwd_pallas). delta = rowsum(dO * O) is computed by the caller in
// torch, as the reference does before its kernels.
//
// Both recompute p = exp(s * scale - lse) from the saved lse, with the same
// masks as K1 (keys past Tk, end-aligned causal), then
//   dP = dO V^T,  dS = p * (dP - delta) * scale.
// K2: one block per (bh, 64-key tile); it loops over q tiles from the first
// one on or below the diagonal and accumulates dV += p^T dO and
// dK += dS^T Q in tensor-core accumulators. K3: one block per (bh, 64-row q
// tile); it loops over k tiles up to the causal limit and accumulates
// dQ += dS K. Each output has one writer, so there are no atomics and the
// result is deterministic.
//
// Products run on the tensor cores (flash_common.cuh). s and dP take bf16
// inputs exactly. The reference takes do, v and q in float against a float
// p and dS; here p and dS are split into bf16 hi + lo, about 16 bits of
// mantissa, far below the bf16 rounding of the outputs.
//
// Bound on an H100 SXM at the main path (BH 32, T 2048, D 128, bf16,
// causal): K2 does 8 D flops per visible (q, k) pair, 68.7 GFLOP, 69 us at
// 989 TFLOP/s; K3 does 6 D, 51.5 GFLOP, 52 us. Each moves about 85 MB,
// 25 us at 3.35 TB/s: both are compute-bound.
//
// What this simple design leaves on the table: as in K1, WMMA through
// shared memory instead of wgmma on register-resident tiles, loads with no
// overlap with compute, one block of 8 warps per SM (K2 holds 145 KB of
// shared memory); the split p and dS double the cost of the products that
// take them; and s and dP are computed twice, once in each kernel. A fused
// backward with atomic dQ is later work.
#include "flash_common.cuh"

namespace flash {

__host__ __device__ constexpr int dkv_smem_bytes(int dp, bool split) {
  return (split ? 2 : 1) * 4 * tile_bytes(dp) + 2 * STILE_BYTES +
         4 * PTILE_BYTES + 2 * ROWS_BYTES;
}
__host__ __device__ constexpr int dq_smem_bytes(int dp, bool split) {
  return (split ? 2 : 1) * 4 * tile_bytes(dp) + 2 * STILE_BYTES +
         2 * PTILE_BYTES + 2 * ROWS_BYTES;
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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int d,
               float scale, int causal) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = pad_dim(d), ld = tile_ld(dp), nb = dp / 16;
  Carver sm{smem};
  bf16* k_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* k_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
  bf16* v_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* v_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
  bf16* q_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* q_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
  bf16* do_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* do_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int tq, int tk, int d, float scale,
              int causal) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = pad_dim(d), ld = tile_ld(dp), nb = dp / 16;
  Carver sm{smem};
  bf16* q_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* q_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
  bf16* do_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* do_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
  bf16* k_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* k_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
  bf16* v_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* v_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
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

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int tq, int tk, int d, float scale, int causal,
               cudaStream_t stream) {
  const int smem = dkv_smem_bytes(pad_dim(d), std::is_same<T, float>::value);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nk = (tk + BK - 1) / BK;
  dkv_kernel<T><<<bh * nk, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int tq,
              int tk, int d, float scale, int causal, cudaStream_t stream) {
  const int smem = dq_smem_bytes(pad_dim(d), std::is_same<T, float>::value);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (tq + BQ - 1) / BQ;
  dq_kernel<T><<<bh * nq, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// Both return a cudaError_t; the caller checks shapes, types and alignment.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, float scale, int causal,
                             int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return flash::launch_dkv<flash::bf16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                          tq, tk, d, scale, causal, s);
  return flash::launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, tq,
                                  tk, d, scale, causal, s);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int tq,
                            int tk, int d, float scale, int causal,
                            int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return flash::launch_dq<flash::bf16>(q, k, v, dout, lse, delta, dq, bh, tq,
                                         tk, d, scale, causal, s);
  return flash::launch_dq<float>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                                 scale, causal, s);
}
