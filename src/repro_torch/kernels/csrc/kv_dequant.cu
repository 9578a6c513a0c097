// K5: INT8 KV-cache dequant — the attention-read side of the quantized
// slot cache. out (R, K) f32 = (code − zero) · scale, with per-(row, group)
// f16 scale and zero (R, K/group); the caller folds (layers·)slots·tokens
// into rows and heads into K (K = Hk·D).
//
// Replaces: src/repro/kernels/kv_dequant.py, kv_dequant (pallas_call at
// :48).
//
// Bound on an H100: memory. The codes are read once (R·K bytes), the two
// planes once (4·R·K/group bytes) and the floats written once (4·R·K
// bytes), at 3.35 TB/s; one subtract and one multiply an element are far
// below the compute roof.
//
// Design: one thread per 4 codes — a 4-byte uchar4 load and a 16-byte
// float4 store, coalesced across the warp. The group size is a multiple
// of 4, so a thread's 4 codes share one group: it loads that group's scale
// and zero once, as f32. Each value is computed as the reference does,
// (float(code) − float(zero)) · float(scale), rounded after the subtract
// and after the multiply (__fsub_rn, __fmul_rn: no contraction into an
// FMA), so the result is bit-exact with the plain version and with JAX.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
kv_dequant_kernel(const uchar4* __restrict__ codes,
                  const __half* __restrict__ scale,
                  const __half* __restrict__ zero, float4* __restrict__ out,
                  long long n4, int K, int group) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n4) return;
  const long long e = i * 4;
  const long long row = e / K;
  const int col = (int)(e - row * K);
  const long long gi = row * (K / group) + col / group;
  const float s = __half2float(scale[gi]);
  const float z = __half2float(zero[gi]);
  const uchar4 c = codes[i];
  float4 o;
  o.x = __fmul_rn(__fsub_rn((float)c.x, z), s);
  o.y = __fmul_rn(__fsub_rn((float)c.y, z), s);
  o.z = __fmul_rn(__fsub_rn((float)c.z, z), s);
  o.w = __fmul_rn(__fsub_rn((float)c.w, z), s);
  out[i] = o;
}

}  // namespace

// codes (R, K) uint8 (4-byte aligned), scale/zero (R, K/group) f16, out
// (R, K) f32, all contiguous on the device; K % group == 0, group % 4 == 0.
// Returns cudaGetLastError().
extern "C" int kv_dequant_u8(const void* codes, const void* scale,
                             const void* zero, float* out, int R, int K,
                             int group, void* stream) {
  const long long n4 = (long long)R * K / 4;
  const unsigned blocks = (unsigned)((n4 + THREADS - 1) / THREADS);
  kv_dequant_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uchar4*>(codes),
      reinterpret_cast<const __half*>(scale),
      reinterpret_cast<const __half*>(zero), reinterpret_cast<float4*>(out),
      n4, K, group);
  return (int)cudaGetLastError();
}
