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
// input type, lse = m + log(l) in float, with l = 1 where l == 0.
//
// s = q k^T and p v run on the tensor cores (flash_common.cuh). As in the
// TPU kernel, p is rounded to the input type for p v (bf16 here; a float
// input keeps p to about 16 bits, as hi + lo), while l sums p in float.
//
// Bound on an H100 SXM: at the main path (BH 32, T 2048, D 128, bf16,
// causal) the kernel does 4 D flops per visible (q, k) pair, 34.4 GFLOP,
// 35 us at 989 TFLOP/s, and moves 67 MB, 20 us at 3.35 TB/s: compute-bound.
//
// What this simple design leaves on the table: WMMA through shared memory
// instead of wgmma on register-resident tiles (s and p v make a round trip
// through shared memory every tile, and the softmax runs in a separate
// thread layout), tile loads that are plain 16-byte loads with no cp.async
// or TMA and no overlap with compute, and 64 x 64 tiles with one block of
// 8 warps per (bh, q tile).
#include "flash_common.cuh"

namespace flash {

__host__ __device__ constexpr int fwd_smem_bytes(int dp, bool split) {
  return (split ? 2 : 1) * (3 * tile_bytes(dp) + PTILE_BYTES) +
         max_of(STILE_BYTES, otile_bytes(dp));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int tq, int tk, int d, float scale,
               int causal) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = pad_dim(d), ld = tile_ld(dp), nb = dp / 16, old = out_ld(dp);
  Carver sm{smem};
  bf16* q_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* q_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
  bf16* k_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* k_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
  bf16* v_hi = sm.take<bf16>(tile_bytes(dp));
  bf16* v_lo = SPLIT ? sm.take<bf16>(tile_bytes(dp)) : nullptr;
  bf16* p_hi = sm.take<bf16>(PTILE_BYTES);
  bf16* p_lo = SPLIT ? sm.take<bf16>(PTILE_BYTES) : nullptr;
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
      if (c < d)
        o[(static_cast<size_t>(bh) * tq + row) * d + c] = from_f<T>(acc[i][j] / l_safe);
    }
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int tq, int tk, int d, float scale,
               int causal, cudaStream_t stream) {
  const int smem = fwd_smem_bytes(pad_dim(d), std::is_same<T, float>::value);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (tq + BQ - 1) / BQ;
  fwd_kernel<T><<<bh * nq, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// Returns a cudaError_t; the caller checks shapes, types and alignment.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int tq, int tk, int d, float scale,
                         int causal, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return flash::launch_fwd<flash::bf16>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                          causal, s);
  return flash::launch_fwd<float>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                  causal, s);
}
