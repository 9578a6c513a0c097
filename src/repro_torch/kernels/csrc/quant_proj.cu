// K3: group-wise asymmetric INT-b quantize-dequantize — the projection
// Proj_{C_INTb} of AWP's quantization recipe and its RTN initializer.
//
// Replaces: src/repro/kernels/quant_proj.py, quant_project (pallas_call at
// :46).
//
// Bound on an H100: memory. Each element is read once and written once,
// 8·rows·d bytes at 3.35 TB/s; a few divisions per element are far below
// the compute roof.
//
// Design: one warp per (row, group). Groups are contiguous runs of the
// row-major matrix, so warp w owns elements [w·group, (w+1)·group); at
// group 128 each lane holds four values, read and written coalesced. The
// min and max are reduced with warp shuffles, then every value goes
// through exactly the reference formula in the reference's order:
//   scale = max((max − min) · inv_qmax, 1e-8)
//   zero  = clip(rint(−min / scale), 0, qmax)
//   q     = clip(rint(z / scale) + zero, 0, qmax)
//   out   = (q − zero) · scale
// with IEEE division (__fdiv_rn) and rintf (half to even), so the result
// is bit-identical to core/projections.py. inv_qmax is 1/qmax rounded to
// f32: the reference's compiled code multiplies by that reciprocal where
// its source divides by the constant qmax (see inv_qmax in
// repro_torch/core/projections.py). Nothing here may be built with
// --use_fast_math.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
quant_project_kernel(const float* __restrict__ z, float* __restrict__ out,
                     long long n_groups, int group, float qmax,
                     float inv_qmax) {
  const long long warp =
      ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_groups) return;
  const float* zg = z + warp * group;
  float* og = out + warp * group;

  float mx = -INFINITY;
  float mn = INFINITY;
  for (int i = lane; i < group; i += 32) {
    const float v = zg[i];
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  const float scale = fmaxf(__fmul_rn(mx - mn, inv_qmax), 1e-8f);
  const float zero = fminf(fmaxf(rintf(__fdiv_rn(-mn, scale)), 0.0f), qmax);
  for (int i = lane; i < group; i += 32) {
    const float q =
        fminf(fmaxf(rintf(__fdiv_rn(zg[i], scale)) + zero, 0.0f), qmax);
    og[i] = (q - zero) * scale;
  }
}

}  // namespace

// z, out: (rows, d) f32, contiguous, on the device; d % group == 0.
// Returns cudaGetLastError().
extern "C" int quant_project_f32(const float* z, float* out, int rows, int d,
                                 int group, int bits, void* stream) {
  const long long n_groups = (long long)rows * (d / group);
  const long long threads = n_groups * 32;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  const float qmax = (float)((1 << bits) - 1);
  const float inv_qmax = 1.0f / qmax;   // host IEEE f32 division
  quant_project_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      z, out, n_groups, group, qmax, inv_qmax);
  return (int)cudaGetLastError();
}
