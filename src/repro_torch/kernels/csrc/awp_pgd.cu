// K1: fused AWP projected-gradient step  Z = Θ + η·(W − Θ)·C  with the
// residual norm ‖(W − Θ)·C‖_F taken from the f32 accumulator.
//
// Replaces: src/repro/kernels/awp_pgd.py, awp_pgd_step (pallas_call at
// :145) and its batched form _step_batched (pallas_call at :90).
//
// Bound on an H100: 2·B·M·K² floating-point operations against 67 TFLOP/s of
// f32 outside the tensor cores. Operands move M·K·8 + K²·4 + M·K·4 bytes,
// so at every shape of the compression path (M ≥ 512, K ≥ 2048) the kernel
// is compute-bound. TF32 tensor cores would be 7× faster but keep ~10 bits
// of mantissa, which moves the PGD stop rule (tol 1e-4 on ‖∇f‖/‖W‖).
//
// Design: a tiled SIMT SGEMM. Each 256-thread block owns a 128×128 output
// tile and walks K in steps of 16. The left tile is loaded as W − Θ (the
// subtraction is folded into the load, as in the TPU kernel), the right
// tile is C; both sit in shared memory and every thread accumulates an
// 8×8 register block with IEEE f32 FMAs. Thread (ty, tx) owns rows
// ty + 16·i and columns tx + 16·j, so a warp reads two broadcast words of
// the left tile and 16 consecutive words of the right tile — no bank
// conflicts. The epilogue writes Z = Θ + η·acc with η read from device
// memory (no host sync), as a rounded product then a rounded sum — not
// contracted into one FMA, so it rounds as the plain version's two
// elementwise ops do; with the same sequential FMA chain over K as an
// unsplit cuBLAS SGEMM, Z is then bit-equal to the plain version. Each
// block writes Σacc² over its tile into a
// (B, tiles_m, tiles_n) partials buffer: a fixed-order tree reduction,
// no atomics, so the norm is deterministic. gridDim.z is the batch.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = 256;   // 16 × 16 threads, each TM × TN outputs

__global__ void __launch_bounds__(THREADS)
awp_pgd_step_kernel(const float* __restrict__ w,
                    const float* __restrict__ theta,
                    const float* __restrict__ c,
                    const float* __restrict__ eta,
                    float* __restrict__ z,
                    float* __restrict__ partials,
                    int M, int K) {
  __shared__ float As[BK][BM];     // (W − Θ) tile, k-major
  __shared__ float Bs[BK][BN];     // C tile
  __shared__ float red[THREADS];

  const int b = blockIdx.z;
  const int N = K;
  const size_t mk = (size_t)M * K;
  w += b * mk;
  theta += b * mk;
  c += (size_t)b * K * K;
  z += b * mk;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // left tile: 128 rows × 16 k, 8 values a thread, consecutive threads
    // on consecutive k
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int kk = idx % BK;
      const int r = idx / BK;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      float v = 0.0f;
      if (gm < M && gk < K) {
        const size_t o = (size_t)gm * K + gk;
        v = w[o] - theta[o];
      }
      As[kk][r] = v;
    }
    // right tile: 16 k × 128 columns, consecutive threads on columns
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int col = idx % BN;
      const int kk = idx / BN;
      const int gk = k0 + kk;
      const int gn = n0 + col;
      Bs[kk][col] = (gk < K && gn < N) ? c[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float e = eta[b];
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        const size_t o = (size_t)gm * N + gn;
        z[o] = __fadd_rn(theta[o], __fmul_rn(e, acc[i][j]));
        sq = fmaf(acc[i][j], acc[i][j], sq);
      }
    }
  }
  red[tid] = sq;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) {
    const int tiles = gridDim.x * gridDim.y;
    partials[(size_t)b * tiles + blockIdx.y * gridDim.x + blockIdx.x] = red[0];
  }
}

}  // namespace

extern "C" int awp_pgd_tile_m() { return BM; }
extern "C" int awp_pgd_tile_n() { return BN; }

// w, theta, z: (B, M, K); c: (B, K, K); eta: (B,); partials: (B, ⌈M/128⌉,
// ⌈K/128⌉). All f32, contiguous, on the device. Returns cudaGetLastError().
extern "C" int awp_pgd_step_f32(const float* w, const float* theta,
                                const float* c, const float* eta, float* z,
                                float* partials, int B, int M, int K,
                                void* stream) {
  dim3 grid((K + BN - 1) / BN, (M + BM - 1) / BM, B);
  awp_pgd_step_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      w, theta, c, eta, z, partials, M, K);
  return (int)cudaGetLastError();
}
