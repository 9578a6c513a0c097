// K2: row-wise hard thresholding H_k — keep the k largest |z| of each row,
// exactly k, ties broken by lower index (the semantics of jax.lax.top_k).
//
// Replaces: src/repro/kernels/topk_mask.py, topk_row (pallas_call at :61).
//
// Bound on an H100: memory. The function reads each element once and
// writes it once, 8·rows·d bytes at 3.35 TB/s; its few integer operations
// per element are far below the compute roof.
//
// Design: the TPU kernel runs 40 bisection sweeps over a row held in VMEM.
// Here one block owns one row and runs an exact radix select on the bit
// pattern of |z| (for non-negative floats the uint32 pattern is monotone):
// four passes, one 8-bit digit each from the top, each streaming the row
// from global memory into a 256-bin shared-memory histogram of the
// elements still matching the threshold's prefix. Streaming instead of
// staging the row keeps rows of any length (d = 73728 in the largest
// configuration) in one kernel; after the first pass the row is served
// from L1/L2. The keep pass writes every element above the threshold plus
// the first (k − count above) elements equal to it, ranked in index order
// by a block-wide prefix scan carried across chunks of the row. The
// wrapper handles k ≤ 0 and k ≥ d, as core/projections.py does.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ unsigned mag_key(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__global__ void __launch_bounds__(THREADS)
topk_row_kernel(const float* __restrict__ z, float* __restrict__ out, int d,
                int k) {
  __shared__ unsigned hist[256];
  __shared__ unsigned s_prefix;
  __shared__ unsigned s_rank;
  __shared__ int warp_sums[WARPS];
  __shared__ int s_carry;

  const float* zr = z + (size_t)blockIdx.x * d;
  float* outr = out + (size_t)blockIdx.x * d;
  const int tid = threadIdx.x;

  unsigned prefix = 0u;      // threshold bits fixed so far
  unsigned pmask = 0u;       // which bits of prefix are fixed
  unsigned rank = (unsigned)k;  // rank of the threshold among matching keys

  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = tid; i < 256; i += THREADS) hist[i] = 0u;
    __syncthreads();
    for (int i = tid; i < d; i += THREADS) {
      const unsigned key = mag_key(zr[i]);
      if ((key & pmask) == prefix) atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      unsigned above = 0u;
      int digit = 0;
      for (int dg = 255; dg >= 0; --dg) {
        const unsigned h = hist[dg];
        if (above + h >= rank) {
          digit = dg;
          break;
        }
        above += h;
      }
      s_prefix = prefix | ((unsigned)digit << shift);
      s_rank = rank - above;
    }
    __syncthreads();
    prefix = s_prefix;
    rank = s_rank;
    pmask |= 0xffu << shift;
  }
  // prefix is now the k-th largest key; `rank` of the elements equal to it
  // are kept (the leftmost ones)
  const unsigned thr = prefix;
  const int keep_eq = (int)rank;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  if (tid == 0) s_carry = 0;
  __syncthreads();

  for (int base = 0; base < d; base += THREADS) {
    const int i = base + tid;
    float v = 0.0f;
    unsigned key = 0u;
    int eq = 0;
    if (i < d) {
      v = zr[i];
      key = mag_key(v);
      eq = key == thr;
    }
    int x = eq;  // inclusive scan of eq within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int ws = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, ws, o);
        if (lane >= o) ws += y;
      }
      warp_sums[lane] = ws;  // inclusive over warps
    }
    __syncthreads();
    const int before = s_carry + (wid > 0 ? warp_sums[wid - 1] : 0);
    if (i < d) {
      const bool keep = key > thr || (eq && before + x <= keep_eq);
      outr[i] = keep ? v : 0.0f;
    }
    __syncthreads();
    if (tid == 0) s_carry += warp_sums[WARPS - 1];
    __syncthreads();
  }
}

}  // namespace

// z, out: (rows, d) f32, contiguous, on the device; 0 < k < d.
// Returns cudaGetLastError().
extern "C" int topk_row_f32(const float* z, float* out, int rows, int d, int k,
                            void* stream) {
  topk_row_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(z, out, d, k);
  return (int)cudaGetLastError();
}
