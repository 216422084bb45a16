// One-block probes of the hopper.cuh building blocks (TMA with the
// 128-byte swizzle, wgmma descriptors, accumulator and register-operand
// layouts), for tests/test_torch_hopper.py to hold against torch.matmul.
// Inputs are bf16 [64][64] (A, B) and [64][N] (B2) matrices.
// MODE 0: C[64][64] = A B^T, A and B [64][64] K-major (SS).
// MODE 1: C[64][64] = A B, B [64 (K)][64 (N)] MN-major (SS, trans-b).
// MODE 2: C[64][N] = bf16(A B^T) B2, B2 [64 (K)][N] MN-major (SS, then RS).
#include "hopper.cuh"
using namespace hopper;

template <int N, int MODE>
__global__ void probe(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tb2, float* c) {
  extern __shared__ unsigned char raw[];
  unsigned char* a = align_1024(raw);
  unsigned char* b = a + BOX_BYTES;
  unsigned char* b2 = b + BOX_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b2 + 2 * BOX_BYTES);
  const int t = threadIdx.x;
  if (t == 0) { mbar_init(bar, 1); mbar_fence_init(); }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(bar, (MODE == 2 ? 2 + N / 64 : 2) * BOX_BYTES);
    tma_load_tile<64>(a, &ta, bar, 0, 0);
    tma_load_tile<64>(b, &tb, bar, 0, 0);
    if (MODE == 2) tma_load_tile<N>(b2, &tb2, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  float acc[N / 2];
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  float x[32];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (MODE == 1) wgmma_ss_n64<0, 1>(x, desc_k_major(a, ks), desc_mn_major(b, ks), ks);
    else wgmma_ss_n64<0, 0>(x, desc_k_major(a, ks), desc_k_major(b, ks), ks);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(x);
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
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = x[i];
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
  const int smem = 4 * BOX_BYTES + 1024 + 64;
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
  if (err == cudaSuccess) err = encode_tiles(&mb, b, 1, 64, 64);
  if (err == cudaSuccess) err = encode_tiles(&mb2, mode == 2 ? b2 : b, 1, 64, mode == 2 ? n : 64);
  if (err != cudaSuccess) return err;
  if (mode == 0) return run<64, 0>(ma, mb, mb2, c);
  if (mode == 1) return run<64, 1>(ma, mb, mb2, c);
  if (n == 64) return run<64, 2>(ma, mb, mb2, c);
  return run<128, 2>(ma, mb, mb2, c);
}
