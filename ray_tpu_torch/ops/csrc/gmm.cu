// K4 and K5: the grouped matmuls of the sparse-MoE dispatch.
//
// K4 (gmm) replaces ray_tpu/ops/gmm.py::_gmm_kernel (launched by _gmm_pallas):
//   out[t*block_m : (t+1)*block_m] = lhs[t*block_m : (t+1)*block_m] @ rhs[tile_group[t]]
// for lhs [M, K] and rhs [E, K, N]. With transpose_rhs, rhs is [E, N, K] and
// each expert's matrix is read transposed: that is the backward's dlhs,
// which the reference gets from the same kernel on rhs.transpose(0, 2, 1).
// K5 (tgmm) replaces ray_tpu/ops/gmm.py::_tgmm_kernel (launched by
// _tgmm_pallas):
//   out[e] = sum over m tiles t with tile_group[t] == e of lhs_t^T dout_t
// for lhs [M, K] and dout [M, N], out [E, K, N]: the backward's drhs.
//
// Both take float or bfloat16 inputs of one type, accumulate in float and
// write in the input type. Dims: M % block_m == 0, block_m % 128 == 0, and K
// and N multiples of 8 (16-byte loads); the caller checks shapes, types and
// alignment. tile_group holds int32 group ids in [0, E); K4 clamps an id
// outside that range, as a JAX index would be clamped.
//
// Design. A block has 256 threads (8 warps, 4 x 2) and owns one 128 x 128
// output tile; each warp owns 32 x 64 of it as 2 x 4 WMMA accumulators
// (16 x 16 x 16, bf16 in, float out). The contraction runs in stages of 32:
// each stage is read from device memory into registers while the tensor
// cores work on the previous one from shared memory. A float operand is
// split in bf16 hi + lo as in flash_common.cuh (a.hi b.hi + a.lo b.hi +
// a.hi b.lo, about 16 bits of mantissa). Edges past K and N load as zeros
// and are not written.
// - K4: one block per (128-row tile, 128-column tile). The row tile lies in
//   one layout tile of block_m rows, so the block reads its own expert index
//   tile_group[row / block_m]: that replaces the TPU's scalar prefetch.
// - K5: the TPU carries a float accumulator across the sequential m axis of
//   its grid and flushes it at group boundaries. Hopper's blocks run in no
//   order, so here one block owns one output tile (expert, k tile, n tile),
//   loops over the m tiles whose tile_group is its expert (a scan of
//   tile_group inside the kernel, no host sync) and writes its tile once.
//   Each output has one writer: no atomics, and the result is deterministic.
//   An expert with no tiles gets zeros, where the reference leaves its block
//   unwritten (NaN).
//
// Bound on an H100 SXM at the main path (mixtral-small, batch 2, sequence
// 2048, top-2 of 8: 8192 (token, expert) pairs in M = 9216 layout rows): a
// gate or up projection, K 1024 and N 3584, does 2 M K N = 67.6 GFLOP, 68 us
// at 989 TFLOP/s, and moves 144 MB, 43 us at 3.35 TB/s; the down projection
// (K 3584, N 1024), dlhs and drhs are the same work. Every launch is bound by
// operations.
//
// What this simple design leaves on the table: WMMA through shared memory
// instead of wgmma, register-staged loads instead of TMA or cp.async with a
// deeper pipeline, no persistent blocks (K5's blocks differ in work by the
// size of their expert), and 3 products for each float stage.
#include "flash_common.cuh"

namespace grouped {

using flash::bf16;
using flash::FragC;
namespace wmma = nvcuda::wmma;

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 32;         // contraction depth per stage
constexpr int NTHREADS = 256;  // 8 warps, 4 (rows) x 2 (columns)
constexpr int FM = 2, FN = 4;  // 16 x 16 accumulators per warp: 32 x 64
// bf16 elements added to each shared row: rows stay 16-byte aligned and
// WMMA's 32-byte fragment alignment holds.
constexpr int PAD = 8;
// Every operand tile ([128][32 + PAD] or [32][128 + PAD]) fits this many
// bf16 elements; sizes in bytes are rounded to 128.
constexpr int TILE_BYTES = flash::aligned(BM * (BK + PAD) * 2);
constexpr int STAGE_BYTES = (NTHREADS / 32) * 16 * 16 * 4;  // one float 16 x 16 per warp

__host__ __device__ constexpr int smem_bytes(bool split) {
  return (split ? 4 : 2) * TILE_BYTES + STAGE_BYTES;
}

// An R x C region of a row-major matrix on its way to shared memory: read
// into registers as it is (16 bytes per 8 values of bf16, 32 of float),
// then written as bf16 hi, and for float also lo, in rows of C + PAD.
template <typename T, int R, int C>
struct Stage {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int CPR = C / 8;                // chunks of 8 per row
  static constexpr int N = R * CPR / NTHREADS;     // chunks per thread
  static constexpr int W = SPLIT ? 2 : 1;          // 16-byte words per chunk
  static_assert(R * CPR % NTHREADS == 0, "whole chunks per thread");
  uint4 v[N][W];

  // Rows r0 + r < nrows and columns c0 + c < ncols of src (row stride ld);
  // zeros elsewhere. ncols is a multiple of 8, so a chunk is all in or out.
  __device__ __forceinline__ void fetch(const T* __restrict__ src, int ld, int r0, int c0,
                                        int nrows, int ncols) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      const int r = r0 + idx / CPR, c = c0 + (idx % CPR) * 8;
      if (r < nrows && c < ncols) {
        const uint4* p = reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * ld + c);
#pragma unroll
        for (int w = 0; w < W; ++w) v[i][w] = p[w];
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) v[i][w] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  __device__ __forceinline__ void stash(bf16* hi, bf16* lo) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      const int off = (idx / CPR) * (C + PAD) + (idx % CPR) * 8;
      if constexpr (!SPLIT) {
        *reinterpret_cast<uint4*>(hi + off) = v[i][0];
      } else {
        const unsigned u[8] = {v[i][0].x, v[i][0].y, v[i][0].z, v[i][0].w,
                               v[i][1].x, v[i][1].y, v[i][1].z, v[i][1].w};
        flash::Pack8 h, l;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = __uint_as_float(u[2 * e]), x1 = __uint_as_float(u[2 * e + 1]);
          h.h2[e] = __floats2bfloat162_rn(x0, x1);
          const float2 f = __bfloat1622float2(h.h2[e]);
          l.h2[e] = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
        }
        *reinterpret_cast<uint4*>(hi + off) = h.u;
        *reinterpret_cast<uint4*>(lo + off) = l.u;
      }
    }
  }
};

template <typename LA, typename LB>
__device__ __forceinline__ void mma_pass(FragC (&acc)[FM][FN], const bf16* a, int lda,
                                         const bf16* b, int ldb, int ks) {
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[FM];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb[FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
    wmma::load_matrix_sync(fa[i], flash::block_at<LA>(a, lda, wr * FM + i, ks), lda);
#pragma unroll
  for (int j = 0; j < FN; ++j)
    wmma::load_matrix_sync(fb[j], flash::block_at<LB>(b, ldb, ks, wc * FN + j), ldb);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
}

// acc += A B over one stage: A [BM][BK] and B [BK][BN] in shared memory,
// stored in layouts LA and LB (flash::block_at), with lo parts for float.
template <typename LA, typename LB, bool SPLIT>
__device__ __forceinline__ void mma_stage(FragC (&acc)[FM][FN], const bf16* a_hi,
                                          const bf16* a_lo, int lda, const bf16* b_hi,
                                          const bf16* b_lo, int ldb) {
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    mma_pass<LA, LB>(acc, a_hi, lda, b_hi, ldb, ks);
    if constexpr (SPLIT) {
      mma_pass<LA, LB>(acc, a_lo, lda, b_hi, ldb, ks);
      mma_pass<LA, LB>(acc, a_hi, lda, b_lo, ldb, ks);
    }
  }
}

// Writes the block's accumulators to out (row stride ldo) at (row0, col0),
// rows < nrows and columns < ncols, through each warp's float 16 x 16 in
// shared memory: every lane writes 8 consecutive values of one row.
template <typename T>
__device__ __forceinline__ void store_acc(FragC (&acc)[FM][FN], float* stage,
                                          T* __restrict__ out, int ldo, int row0, int col0,
                                          int nrows, int ncols) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wr = warp / 2, wc = warp % 2;
  float* mine = stage + warp * 256;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(mine, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + (wr * FM + i) * 16 + r, gc = col0 + (wc * FN + j) * 16 + c;
      if (gr < nrows && gc < ncols) {
        float x[8];
        flash::load8(x, mine + r * 16 + c);
        flash::store8(out + static_cast<size_t>(gr) * ldo + gc, x);
      }
      __syncwarp();
    }
}

template <typename T>
struct Smem {
  bf16 *a_hi, *a_lo, *b_hi, *b_lo;
  float* stage;
  __device__ explicit Smem(unsigned char* base) {
    constexpr bool SPLIT = std::is_same<T, float>::value;
    flash::Carver sm{base};
    a_hi = sm.take<bf16>(TILE_BYTES);
    a_lo = SPLIT ? sm.take<bf16>(TILE_BYTES) : nullptr;
    b_hi = sm.take<bf16>(TILE_BYTES);
    b_lo = SPLIT ? sm.take<bf16>(TILE_BYTES) : nullptr;
    stage = sm.take<float>(STAGE_BYTES);
  }
};

__device__ __forceinline__ void zero(FragC (&acc)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// K4. Grid (n tiles, m tiles). out [m][n] = lhs [m][k] @ rhs[e] with rhs[e]
// [k][n], or [n][k] read transposed when TRANS.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(NTHREADS)
    gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ tile_group, T* __restrict__ out, int m, int k, int n,
               int num_groups, int block_m) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  using LB = typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
  using StageB = typename std::conditional<TRANS, Stage<T, BN, BK>, Stage<T, BK, BN>>::type;
  constexpr int LDA = BK + PAD, LDB = TRANS ? BK + PAD : BN + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> s(smem);

  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int e = min(max(tile_group[row0 / block_m], 0), num_groups - 1);
  rhs += static_cast<size_t>(e) * k * n;

  Stage<T, BM, BK> sa;
  StageB sb;
  auto fetch = [&](int k0) {
    sa.fetch(lhs, k, row0, k0, m, k);
    if constexpr (TRANS) sb.fetch(rhs, k, col0, k0, n, k);
    else sb.fetch(rhs, n, k0, col0, k, n);
  };
  FragC acc[FM][FN];
  zero(acc);
  fetch(0);
  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();  // the previous stage is no longer read
    sa.stash(s.a_hi, s.a_lo);
    sb.stash(s.b_hi, s.b_lo);
    __syncthreads();
    if (k0 + BK < k) fetch(k0 + BK);
    mma_stage<wmma::row_major, LB, SPLIT>(acc, s.a_hi, s.a_lo, LDA, s.b_hi, s.b_lo, LDB);
  }
  store_acc(acc, s.stage, out, n, row0, col0, m, n);
}

// K5. Grid (n tiles, k tiles, experts). out[e] [k][n] = sum over the rows of
// expert e's m tiles of lhs^T [k][rows] @ dout [rows][n]. lhs rows are staged
// as they are, [BK rows][BM of k], and read as A in column-major order.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
                const int* __restrict__ tile_group, T* __restrict__ out, int m, int k, int n,
                int block_m) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LDA = BM + PAD, LDB = BN + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> s(smem);

  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM, e = blockIdx.z;
  const int ntiles = m / block_m;
  // The stage after the one at row m0 (or the first for m0 < 0): the next
  // BK rows of the same tile, else the first row of the next tile of e; -1
  // at the end. Every thread reads the same ids, so the loop is uniform.
  auto next = [&](int m0) -> int {
    if (m0 >= 0 && (m0 + BK) % block_m != 0) return m0 + BK;
    for (int t = m0 < 0 ? 0 : (m0 + BK) / block_m; t < ntiles; ++t)
      if (tile_group[t] == e) return t * block_m;
    return -1;
  };

  Stage<T, BK, BM> sa;
  Stage<T, BK, BN> sb;
  auto fetch = [&](int m0) {
    sa.fetch(lhs, k, m0, row0, m, k);
    sb.fetch(dout, n, m0, col0, m, n);
  };
  FragC acc[FM][FN];
  zero(acc);
  int cur = next(-1);
  if (cur >= 0) fetch(cur);
  while (cur >= 0) {
    __syncthreads();  // the previous stage is no longer read
    sa.stash(s.a_hi, s.a_lo);
    sb.stash(s.b_hi, s.b_lo);
    __syncthreads();
    const int nxt = next(cur);
    if (nxt >= 0) fetch(nxt);
    mma_stage<wmma::col_major, wmma::row_major, SPLIT>(acc, s.a_hi, s.a_lo, LDA, s.b_hi,
                                                       s.b_lo, LDB);
    cur = nxt;
  }
  store_acc(acc, s.stage, out + static_cast<size_t>(e) * k * n, n, row0, col0, k, n);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, bool TRANS>
int launch_gmm(const void* lhs, const void* rhs, const void* tile_group, void* out, int m,
               int k, int n, int num_groups, int block_m, cudaStream_t stream) {
  const int smem = smem_bytes(std::is_same<T, float>::value);
  cudaError_t err = allow_smem(gmm_kernel<T, TRANS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, m / BM);
  gmm_kernel<T, TRANS><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs),
      static_cast<const int*>(tile_group), static_cast<T*>(out), m, k, n, num_groups, block_m);
  return cudaGetLastError();
}

template <typename T>
int launch_tgmm(const void* lhs, const void* dout, const void* tile_group, void* out, int m,
                int k, int n, int num_groups, int block_m, cudaStream_t stream) {
  const int smem = smem_bytes(std::is_same<T, float>::value);
  cudaError_t err = allow_smem(tgmm_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (k + BM - 1) / BM, num_groups);
  tgmm_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(dout),
      static_cast<const int*>(tile_group), static_cast<T*>(out), m, k, n, block_m);
  return cudaGetLastError();
}

}  // namespace grouped

// Each returns a cudaError_t; the caller checks shapes, types and alignment.
extern "C" int gmm(const void* lhs, const void* rhs, const void* tile_group, void* out, int m,
                   int k, int n, int num_groups, int block_m, int transpose_rhs, int is_bf16,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return transpose_rhs
               ? grouped::launch_gmm<flash::bf16, true>(lhs, rhs, tile_group, out, m, k, n,
                                                         num_groups, block_m, s)
               : grouped::launch_gmm<flash::bf16, false>(lhs, rhs, tile_group, out, m, k, n,
                                                          num_groups, block_m, s);
  return transpose_rhs ? grouped::launch_gmm<float, true>(lhs, rhs, tile_group, out, m, k, n,
                                                          num_groups, block_m, s)
                       : grouped::launch_gmm<float, false>(lhs, rhs, tile_group, out, m, k, n,
                                                           num_groups, block_m, s);
}

extern "C" int tgmm(const void* lhs, const void* dout, const void* tile_group, void* out,
                    int m, int k, int n, int num_groups, int block_m, int is_bf16,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return grouped::launch_tgmm<flash::bf16>(lhs, dout, tile_group, out, m, k, n, num_groups,
                                             block_m, s);
  return grouped::launch_tgmm<float>(lhs, dout, tile_group, out, m, k, n, num_groups, block_m,
                                     s);
}
