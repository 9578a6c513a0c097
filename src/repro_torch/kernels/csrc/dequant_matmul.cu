// K4: fused int4 dequant-matmul  y (M, N) = x (M, K) · dequant(W)ᵀ  with W
// nibble-packed (N, K/2) uint8 (low nibble = even k) and per-(row, group)
// f32 scale and zero (N, K/group); f32 accumulation.
//
// Replaces: src/repro/kernels/dequant_matmul.py, dequant_matmul
// (pallas_call at :78).
//
// Bound on an H100: at decode (M ≤ 8) memory — the packed weight and its
// scales, N·K/2 + 8·N·K/group bytes at 3.35 TB/s; at prefill (M = 512)
// the 2·M·N·K f32 operations at 67 TFLOP/s outside the tensor cores.
//
// Design: two kernels behind one entry point, both dequantizing in
// registers or shared memory so the weight never exists as floats in
// device memory.
//  * M ≤ 8 (decode): a GEMV. One warp per output column n streams that
//    weight row as 32-bit words (8 codes each, 128 contiguous bytes per
//    warp step), dequantizes each code as (code − zero)·scale with its
//    group's parameters, and FMAs it against the M activation rows (small
//    enough to stay in L1/L2). A shuffle reduction finishes each dot.
//  * otherwise (prefill): a tiled SIMT GEMM. A 256-thread block owns a
//    64×64 output tile and walks K in steps of 32: the x tile is copied to
//    shared memory, the weight tile is unpacked and dequantized on its way
//    into shared memory, and each thread accumulates a 4×4 register block.
// The dequantized value is computed exactly as the reference computes it
// ((code − zero)·scale in f32), so only the summation order differs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// ---------------------------------------------------------------- GEMV
constexpr int GEMV_COLS = THREADS / 32;   // output columns per block

template <int MT>
__global__ void __launch_bounds__(THREADS)
dequant_gemv_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, float* __restrict__ y,
                    int N, int K, int group) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_COLS + (threadIdx.x >> 5);
  if (n >= N) return;
  const int G = K / group;
  const unsigned* wrow =
      reinterpret_cast<const unsigned*>(packed + (size_t)n * (K / 2));
  const float* srow = scale + (size_t)n * G;
  const float* zrow = zero + (size_t)n * G;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.0f;

  const int words = K / 8;
  for (int wi = lane; wi < words; wi += 32) {
    const unsigned word = wrow[wi];
    const int k = wi * 8;
    const int gi = k / group;
    const float s = srow[gi];
    const float zp = zrow[gi];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float code = (float)((word >> (4 * t)) & 0xFu);
      const float wv = (code - zp) * s;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        acc[m] = fmaf(x[(size_t)m * K + k + t], wv, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float v = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) y[(size_t)m * N + n] = v;
  }
}

// ---------------------------------------------------------------- GEMM
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;

__global__ void __launch_bounds__(THREADS)
dequant_gemm_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, float* __restrict__ y,
                    int M, int N, int K, int group) {
  __shared__ float Xs[BK][BM];
  __shared__ float Ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int G = K / group;
  const int half_k = K / 2;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int kk = idx % BK;
      const int r = idx / BK;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      Xs[kk][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
    // weight tile: 64 rows × 16 bytes (32 codes), one byte a thread-step
#pragma unroll
    for (int l = 0; l < (BN * BK / 2) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int bi = idx % (BK / 2);
      const int r = idx / (BK / 2);
      const int gn = n0 + r;
      const int gk = k0 + 2 * bi;
      float lo = 0.0f, hi = 0.0f;
      if (gn < N && gk < K) {
        const unsigned byte = packed[(size_t)gn * half_k + gk / 2];
        const int gi = gk / group;
        const float s = scale[(size_t)gn * G + gi];
        const float zp = zero[(size_t)gn * G + gi];
        lo = ((float)(byte & 0xFu) - zp) * s;
        // k and k + 1 can straddle a group edge only for odd group sizes
        const int gi1 = (gk + 1) / group;
        const float s1 = scale[(size_t)gn * G + gi1];
        const float zp1 = zero[(size_t)gn * G + gi1];
        hi = ((float)(byte >> 4) - zp1) * s1;
      }
      Ws[2 * bi][r] = lo;
      Ws[2 * bi + 1][r] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) y[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <int MT>
void launch_gemv(const float* x, const uint8_t* packed, const float* scale,
                 const float* zero, float* y, int N, int K, int group,
                 cudaStream_t stream) {
  const unsigned blocks = (unsigned)((N + GEMV_COLS - 1) / GEMV_COLS);
  dequant_gemv_kernel<MT><<<blocks, THREADS, 0, stream>>>(
      x, packed, scale, zero, y, N, K, group);
}

// The GEMV reads the packed row as 32-bit words of 8 codes that must not
// straddle a group: M ≤ 8, K and group multiples of 8, 4-byte alignment.
bool uses_gemv(int M, int K, int group, const void* packed) {
  return M >= 1 && M <= 8 && K % 8 == 0 && group % 8 == 0 &&
         ((uintptr_t)packed % 4) == 0;
}

}  // namespace

// x: (M, K) f32; packed: (N, K/2) uint8; scale, zero: (N, K/group) f32;
// y: (M, N) f32. Contiguous, on the device; K even, K % group == 0.
// Returns cudaGetLastError().
extern "C" int dequant_matmul_f32(const float* x, const uint8_t* packed,
                                  const float* scale, const float* zero,
                                  float* y, int M, int N, int K, int group,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (uses_gemv(M, K, group, packed)) {
    switch (M) {
      case 1: launch_gemv<1>(x, packed, scale, zero, y, N, K, group, s); break;
      case 2: launch_gemv<2>(x, packed, scale, zero, y, N, K, group, s); break;
      case 3: launch_gemv<3>(x, packed, scale, zero, y, N, K, group, s); break;
      case 4: launch_gemv<4>(x, packed, scale, zero, y, N, K, group, s); break;
      case 5: launch_gemv<5>(x, packed, scale, zero, y, N, K, group, s); break;
      case 6: launch_gemv<6>(x, packed, scale, zero, y, N, K, group, s); break;
      case 7: launch_gemv<7>(x, packed, scale, zero, y, N, K, group, s); break;
      default: launch_gemv<8>(x, packed, scale, zero, y, N, K, group, s); break;
    }
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    dequant_gemm_kernel<<<grid, THREADS, 0, s>>>(x, packed, scale, zero, y, M,
                                                N, K, group);
  }
  return (int)cudaGetLastError();
}
