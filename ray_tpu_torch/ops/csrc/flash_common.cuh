// Shared pieces of the WMMA kernels: the float32 kernels of flash_fwd.cu
// and flash_bwd.cu (their bf16 kernels use hopper.cuh), and gmm.cu's.
//
// Layout: every tensor is [BH, T, D], contiguous and 16-byte aligned,
// D <= 128 and D % 8 == 0, in float or bfloat16. lse and delta are [BH, Tq]
// float.
//
// A block has 256 threads (8 warps) and works on 64-row tiles. Products run
// on the tensor cores through WMMA (16 x 16 x 16, bf16 in, float out), on
// tiles held in shared memory as bf16 with the head dim padded with zeros to
// dp, a multiple of 16. A float operand is split in two bf16 tiles, hi and
// lo = x - hi, and a product takes a.hi b.hi + a.lo b.hi + a.hi b.lo: about
// 16 bits of mantissa, where the dropped a.lo b.lo term is 2^-16 of the
// product. bf16 inputs have no lo part; their products are exact in float.
//
// Elementwise work (masks, softmax, dS) runs in a thread layout: thread
// (tx = threadIdx.x % 16, ty = threadIdx.x / 16) owns rows ty + 16 i (i < 4)
// of a tile and columns tx + 16 j. The 16 threads that share a row are one
// half-warp, so a row reduction is four shuffles. Products reach this layout
// through float tiles in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace flash {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int DMAX = 128;       // largest head dim
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int RPT = BQ / 16;    // tile rows per thread
constexpr int CPT = DMAX / 16;  // head-dim columns per thread
// The reference's finite mask value: exp(NEG_INF - m) is 0 for any finite
// m, where -inf would give exp(-inf - -inf) = NaN.
constexpr float NEG_INF = -1e30f;
// The bf16 Hopper kernels take exponentials in base 2, of s * scale * LOG2E.
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }
// Head dim padded to the MMA's 16.
__host__ __device__ constexpr int pad_dim(int d) { return round_up(d, 16); }
// Row strides. A bf16 [64][dp] tile is 16 bytes wider than dp, a float
// [64][64] score tile 16 floats wider, a float [64][dp] output tile rounded
// to 32 floats and 16 wider: the strides WMMA takes (bf16 multiples of 8,
// float multiples of 4), and the two half-warps reading one column pair of
// a float tile hit disjoint banks.
__host__ __device__ constexpr int tile_ld(int dp) { return dp + 8; }
constexpr int PLD = BK + 8;   // bf16 [64][64] tile (p, dS)
constexpr int SLD = BK + 16;  // float [64][64] tile (s, dP)
__host__ __device__ constexpr int out_ld(int dp) { return round_up(dp, 32) + 16; }
// Shared-memory sizes, each rounded to 128 bytes so every buffer meets
// WMMA's 32-byte alignment.
__host__ __device__ constexpr int aligned(int bytes) { return round_up(bytes, 128); }
__host__ __device__ constexpr int tile_bytes(int dp) { return aligned(BQ * tile_ld(dp) * 2); }
constexpr int PTILE_BYTES = aligned(BQ * PLD * 2);
constexpr int STILE_BYTES = aligned(BQ * SLD * 4);
__host__ __device__ constexpr int otile_bytes(int dp) { return aligned(BQ * out_ld(dp) * 4); }
constexpr int ROWS_BYTES = aligned(BQ * 4);

// Hands out consecutive buffers of a kernel's dynamic shared memory.
struct Carver {
  unsigned char* p;
  template <typename U> __device__ U* take(int bytes) {
    U* r = reinterpret_cast<U*>(p);
    p += bytes;
    return r;
  }
};

// A product operand in shared memory: bf16 tiles hi and, for a split float
// operand, lo (else nullptr), with row stride ld.
struct Operand {
  const bf16* hi;
  const bf16* lo;
  int ld;
};

union Pack8 {
  uint4 u;
  __nv_bfloat162 h2[4];
};

// Eight consecutive values as float, in 16-byte loads.
__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(float (&x)[8], const bf16* p) {
  Pack8 pk;
  pk.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(pk.h2[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&x)[8]) {
  Pack8 pk;
#pragma unroll
  for (int e = 0; e < 4; ++e) pk.h2[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = pk.u;
}

// Copies rows [row0, row0 + 64) of an [n][d] matrix into the bf16 tile hi
// and, if lo is given, the rounding remainder into lo. Rows past n and
// columns d..dp are zero. Eight values (16 bytes of bf16) per step.
template <typename T>
__device__ void load_tile(bf16* hi, bf16* lo, const T* __restrict__ src, int row0,
                          int n, int d, int dp) {
  const int ld = tile_ld(dp), chunks = dp / 8;
  for (int i = threadIdx.x; i < BQ * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const int g = row0 + r;
    float x[8];
    if (g < n && c < d) {
      load8(x, src + static_cast<size_t>(g) * d + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    Pack8 h, l;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h.h2[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
      const float2 f = __bfloat1622float2(h.h2[e]);
      l.h2[e] = __floats2bfloat162_rn(x[2 * e] - f.x, x[2 * e + 1] - f.y);
    }
    *reinterpret_cast<uint4*>(hi + r * ld + c) = h.u;
    if (lo) *reinterpret_cast<uint4*>(lo + r * ld + c) = l.u;
  }
}

// Copies rows [row0, row0 + 64) of a [n] vector; entries past n are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int n) {
  if (threadIdx.x < BQ) {
    const int g = row0 + threadIdx.x;
    dst[threadIdx.x] = g < n ? src[g] : 0.f;
  }
}

// Writes rows row0 + r < n, columns < d, of a float [64][ldo] tile to out.
template <typename T>
__device__ void store_tile(T* __restrict__ out, const float* tile, int ldo, int row0,
                           int n, int d) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < BQ * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const int g = row0 + r;
    if (g >= n) continue;
    float x[8];
    load8(x, tile + r * ldo + c);
    store8(out + static_cast<size_t>(g) * d + c, x);
  }
}

// Sum or max over the 16 threads of a half-warp (one tile row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int w = 8; w; w >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int w = 8; w; w >>= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// Stores p as bf16 hi (and lo = p - hi, if lo is given) at index i.
__device__ __forceinline__ void put_split(bf16* hi, bf16* lo, int i, float p) {
  const bf16 h = __float2bfloat16(p);
  hi[i] = h;
  if (lo) lo[i] = __float2bfloat16(p - __bfloat162float(h));
}

// The 16 x 16 block (r, c) of an operand of layout L. A row_major operand
// is stored as it is, [rows][ld]; a col_major one transposed, [cols][ld].
template <typename L>
__device__ __forceinline__ const bf16* block_at(const bf16* m, int ld, int r, int c) {
  if constexpr (std::is_same<L, wmma::row_major>::value) return m + r * 16 * ld + c * 16;
  else return m + c * 16 * ld + r * 16;
}

template <typename LA, typename LB>
__device__ __forceinline__ void mma_add(FragC& acc, const bf16* a, int lda, const bf16* b,
                                        int ldb, int rb, int cb, int ksteps) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
  for (int ks = 0; ks < ksteps; ++ks) {
    wmma::load_matrix_sync(fa, block_at<LA>(a, lda, rb, ks), lda);
    wmma::load_matrix_sync(fb, block_at<LB>(b, ldb, ks, cb), ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// acc += A B on output block (rb, cb), over 16 ksteps-deep: a.hi b.hi, then
// a.lo b.hi and a.hi b.lo where the operands have lo parts.
template <typename LA, typename LB>
__device__ __forceinline__ void mma_split(FragC& acc, Operand a, Operand b, int rb, int cb,
                                          int ksteps) {
  mma_add<LA, LB>(acc, a.hi, a.ld, b.hi, b.ld, rb, cb, ksteps);
  if (a.lo) mma_add<LA, LB>(acc, a.lo, a.ld, b.hi, b.ld, rb, cb, ksteps);
  if (b.lo) mma_add<LA, LB>(acc, a.hi, a.ld, b.lo, b.ld, rb, cb, ksteps);
}

// out[64][16 nbn] (float, row stride ldo) = A B; the warps take the 4 x nbn
// output blocks in turn.
template <typename LA, typename LB>
__device__ void mma_tile(float* out, int ldo, Operand a, Operand b, int nbn, int ksteps) {
  for (int blk = threadIdx.x / 32; blk < 4 * nbn; blk += NWARPS) {
    const int rb = blk / nbn, cb = blk - rb * nbn;
    FragC c;
    wmma::fill_fragment(c, 0.f);
    mma_split<LA, LB>(c, a, b, rb, cb, ksteps);
    wmma::store_matrix_sync(out + rb * 16 * ldo + cb * 16, c, ldo, wmma::mem_row_major);
  }
}

// A [64][dp] float accumulator held in registers across a loop: warp w owns
// output blocks w + 8 m.
constexpr int FPW = (BQ / 16) * (DMAX / 16) / NWARPS;
struct AccTile {
  FragC f[FPW];

  __device__ void zero() {
#pragma unroll
    for (int m = 0; m < FPW; ++m) wmma::fill_fragment(f[m], 0.f);
  }

  // += A B, with 16 nbn output columns.
  template <typename LA, typename LB>
  __device__ void add(Operand a, Operand b, int nbn, int ksteps) {
#pragma unroll
    for (int m = 0; m < FPW; ++m) {
      const int blk = threadIdx.x / 32 + NWARPS * m;
      if (blk < 4 * nbn) mma_split<LA, LB>(f[m], a, b, blk / nbn, blk % nbn, ksteps);
    }
  }

  __device__ void store(float* out, int ldo, int nbn) {
#pragma unroll
    for (int m = 0; m < FPW; ++m) {
      const int blk = threadIdx.x / 32 + NWARPS * m;
      if (blk < 4 * nbn)
        wmma::store_matrix_sync(out + (blk / nbn) * 16 * ldo + (blk % nbn) * 16, f[m], ldo,
                                wmma::mem_row_major);
    }
  }
};

}  // namespace flash

// Every library carries its own copy: each .cu is built alone.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
