// One-block probes of the hopper.cuh building blocks (TMA with the
// 128-byte swizzle, wgmma descriptors, accumulator and register-operand
// layouts), for tests/test_torch_hopper.py to hold against torch.matmul.
// Inputs are bf16 matrices: A [64][64], B [N][64] (mode 0), [64][N]
// (mode 1) or [64][64], and B2 [64][N].
// MODE 0: C[64][N] = A B^T, A [64][64] and B [N (rows)][64 (K)] K-major
//         (SS; at N 128 B is two 64-row boxes stacked, K4's dlhs product).
// MODE 1: C[64][N] = A B, B [64 (K)][N] MN-major (SS, trans-b; at N 128
//         K4's forward product).
// MODE 2: C[64][N] = bf16(A B^T) B2, B2 [64 (K)][N] MN-major (SS, then RS).
// MODE 3: C[64][128] = A^T B2, A [64 (K)][64 (M)] and B2 [64 (K)][128 (N)]
//         both MN-major (SS at N 128, both transpose bits; K5's product).
#include "hopper.cuh"
using namespace hopper;

// d[N / 2] (+)= A B at N 64 or 128, A K-major, TRANS_B 1 for an MN-major B.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64<0, TRANS_B>(d, a, b, accumulate);
  else wgmma_ss_n128<0, TRANS_B>(d, a, b, accumulate);
}

template <int N, int MODE>
__global__ void probe(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tb2, float* c) {
  extern __shared__ unsigned char raw[];
  unsigned char* a = align_1024(raw);
  unsigned char* b = a + BOX_BYTES;
  unsigned char* b2 = b + 2 * BOX_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b2 + 2 * BOX_BYTES);
  const int t = threadIdx.x;
  if (t == 0) { mbar_init(bar, 1); mbar_fence_init(); }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(bar, (MODE >= 2 ? 2 + N / 64 : 1 + N / 64) * BOX_BYTES);
    tma_load_tile<64>(a, &ta, bar, 0, 0);
    if constexpr (MODE == 0)
      for (int r = 0; r < N / 64; ++r) tma_load_tile<64>(b + r * BOX_BYTES, &tb, bar, 64 * r, 0);
    else if constexpr (MODE == 1)
      tma_load_tile<N>(b, &tb, bar, 0, 0);
    else
      tma_load_tile<64>(b, &tb, bar, 0, 0);
    if (MODE >= 2) tma_load_tile<N>(b2, &tb2, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  float acc[N / 2];
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  float x[32];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (MODE == 3)
      wgmma_ss_n128<1, 1>(acc, desc_mn_major(a, ks), desc_mn_major(b2, ks), ks);
    else if constexpr (MODE == 2)
      wgmma_ss_n64<0, 0>(x, desc_k_major(a, ks), desc_k_major(b, ks), ks);
    else
      wgmma_ss<N, MODE>(acc, desc_k_major(a, ks), MODE == 1 ? desc_mn_major(b, ks)
                                                            : desc_k_major(b, ks), ks);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(x);
  fence_regs(acc);
  if constexpr (MODE == 2) {
    uint32_t xa[4][4];
    acc_to_a<64>(x, xa);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<N, 1>(acc, xa[ks], desc_mn_major(b2, ks));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  const int w = t / 32, l = t % 32;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * w + l / 4 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    c[row * N + col] = acc[i];
  }
}

template <int N, int MODE>
int run(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mb2, float* c) {
  const int smem = 5 * BOX_BYTES + 1024 + 64;
  cudaError_t err = cudaFuncSetAttribute(probe<N, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  probe<N, MODE><<<1, 128, smem>>>(ma, mb, mb2, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cudaDeviceSynchronize();
}

// Runs one probe on the default stream and waits for it; returns a
// cudaError_t.
extern "C" int probe_run(int mode, int n, const void* a, const void* b, const void* b2, float* c) {
  CUtensorMap ma, mb, mb2;
  cudaError_t err = encode_tiles(&ma, a, 1, 64, 64);
  if (err == cudaSuccess)
    err = encode_tiles(&mb, b, 1, mode == 0 ? n : 64, mode == 1 ? n : 64);
  if (err == cudaSuccess) err = encode_tiles(&mb2, mode >= 2 ? b2 : a, 1, 64, mode >= 2 ? n : 64);
  if (err != cudaSuccess) return err;
  if (n != 64 && n != 128) return cudaErrorInvalidValue;
  if (mode == 0) return n == 64 ? run<64, 0>(ma, mb, mb2, c) : run<128, 0>(ma, mb, mb2, c);
  if (mode == 1) return n == 64 ? run<64, 1>(ma, mb, mb2, c) : run<128, 1>(ma, mb, mb2, c);
  if (mode == 3) return n == 128 ? run<128, 3>(ma, mb, mb2, c) : cudaErrorInvalidValue;
  if (n == 64) return run<64, 2>(ma, mb, mb2, c);
  return run<128, 2>(ma, mb, mb2, c);
}
