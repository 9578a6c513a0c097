"""What bounds K4x's expert GEMV on one CUDA card.

  python scripts/k4x_probe.py

Two measurements behind the design note of ``dequant_matmul.cu``'s
expert GEMV (``gemvx``), each built by ``nvcc`` into ``build/k4x_probe/``:

- Streaming: 8 warps a block, one block an SM, copy a (rows, 2048-byte)
  uint8 stack (qwen3-moe's 128 wg experts, 403 MB) through a two-stage
  ``cp.async`` ring, each warp 64 rows at a time, in runs of 32, 64 and
  128 bytes a row a stage, and nothing else. Prints TB/s for each run.
- The chunk loop alone: the kernel's own ``gx_chunk`` (the source file is
  compiled with a benchmark kernel appended) over codes, scales, zeros and
  x already in shared memory, no copies and no barrier, one block of 8
  warps an SM, at M = 1 and 8. Prints TFLOP/s (2·M FMAs' worth a code and
  column), beside the card's f32 FMA rate from a loop of independent
  ``fmaf`` chains.

Needs a card and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``); imports
nothing of JAX.
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "dequant_matmul.cu"
OUT = ROOT / "build" / "k4x_probe"
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                    "nvcc")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

STREAM = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void cp16(void* d, const void* s) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(d)), "l"(s)
               : "memory");
}
template <int SEG>
__global__ void __launch_bounds__(256, 1)
stream(const uint8_t* p, long long rows, int row_bytes, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* ring = smem + warp * 2 * 64 * SEG;
  const long long tasks = rows / 64;
  const long long t0 = tasks * blockIdx.x / gridDim.x;
  const long long t1 = tasks * (blockIdx.x + 1) / gridDim.x;
  const int steps = row_bytes / SEG;
  float acc = 0.f;
  long long it = t0 + warp;
  int is = 0;
  auto issue = [&](unsigned char* slot) {
    if (it < t1) {
      for (int i = lane; i < 64 * SEG / 16; i += 32) {
        const int r = i / (SEG / 16), c = i % (SEG / 16);
        cp16(slot + 16 * i, p + (it * 64 + r) * (long long)row_bytes
                                + is * SEG + 16 * c);
      }
      if (++is == steps) { is = 0; it += 8; }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  issue(ring);
  int cs = 0;
  for (long long t = t0 + warp; t < t1; t += 8)
    for (int st = 0; st < steps; ++st, ++cs) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
      acc += *reinterpret_cast<const float*>(ring + (cs % 2) * 64 * SEG
                                             + 4 * lane);
      issue(ring + ((cs + 1) % 2) * 64 * SEG);
    }
  if (acc == 1234.5f) out[0] = acc;
}
template <int SEG>
float run(const uint8_t* p, long long rows, int row_bytes, float* out) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int smem = 8 * 2 * 64 * SEG;
  cudaFuncSetAttribute(stream<SEG>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stream<SEG><<<sms, 256, smem>>>(p, rows, row_bytes, out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 10; ++r)
    stream<SEG><<<sms, 256, smem>>>(p, rows, row_bytes, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return cudaGetLastError() == cudaSuccess ? ms / 10 : -1.f;
}
extern "C" float stream_ms(const uint8_t* p, long long rows, int row_bytes,
                           int seg, float* out) {
  switch (seg) {
    case 32: return run<32>(p, rows, row_bytes, out);
    case 64: return run<64>(p, rows, row_bytes, out);
    default: return run<128>(p, rows, row_bytes, out);
  }
}
"""

# appended to a copy of dequant_matmul.cu: its chunk loop alone
CHUNK = r"""
template <int MT>
__global__ void __launch_bounds__(GX_THREADS, 1)
probe_chunk_kernel(float* out, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int words = (4 * MT * GX_KS + GX_WARPS * GX_WARP_CODE_BYTES) / 4;
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    reinterpret_cast<unsigned*>(smem)[i] =
        0x3F800000u ^ (i * 2654435761u & 0x00FF00FFu);
  __syncthreads();
  const float* xs = reinterpret_cast<const float*>(smem);
  const unsigned char* w = smem + 4 * MT * GX_KS +
                           (threadIdx.x / 32) * GX_WARP_CODE_BYTES;
  float acc[GX_C][MT], s[GX_C], z[GX_C], zb[GX_C];
  for (int c = 0; c < GX_C; ++c) {
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.0f;
    s[c] = xs[lane + c];
    z[c] = 3.0f + lane % 2;
    zb[c] = 8388608.0f + z[c];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int j = it % GX_PIECES;
    uint4 wv[GX_C];
#pragma unroll
    for (int c = 0; c < GX_C; ++c)
      wv[c] = *reinterpret_cast<const uint4*>(w + gx_piece(lane + 32 * c, j));
    gx_chunk<MT, true>(acc, wv, s, z, zb, xs + 32 * j);
  }
  float t = 0.f;
  for (int c = 0; c < GX_C; ++c)
    for (int m = 0; m < MT; ++m) t += acc[c][m];
  if (t == 1234.5f) out[0] = t;
}
template <int MT>
float probe(float* out, int iters) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int smem = 4 * MT * GX_KS + GX_WARPS * GX_WARP_CODE_BYTES;
  cudaFuncSetAttribute(probe_chunk_kernel<MT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe_chunk_kernel<MT><<<sms, GX_THREADS, smem>>>(out, iters);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  probe_chunk_kernel<MT><<<sms, GX_THREADS, smem>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
__global__ void fma_peak(float* out, int iters, float a, float b) {
  float c[16];
  for (int i = 0; i < 16; ++i) c[i] = threadIdx.x * 0.001f + i;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = fmaf(c[i], a, b);
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += c[i];
  if (s == 1234.5f) out[0] = s;
}
}  // namespace

extern "C" float probe_chunk_ms(int m, int iters, float* out) {
  return m == 8 ? probe<8>(out, iters) : probe<1>(out, iters);
}
extern "C" int probe_chunk_geometry(int* dims) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  dims[0] = sms; dims[1] = GX_WARPS; dims[2] = GX_C;
  return 0;
}
extern "C" float fma_peak_tflops(float* out) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int iters = 4096, threads = 256, blocks = 8 * sms;
  fma_peak<<<blocks, threads>>>(out, iters, 0.999f, 0.001f);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 5; ++r)
    fma_peak<<<blocks, threads>>>(out, iters, 0.999f, 0.001f);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return 2.0f * 16 * iters * (float)threads * blocks * 5 / (ms * 1e-3f)
         / 1e12f;
}
namespace {
"""


def build(name, source):
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(source)
    subprocess.run([NVCC, *FLAGS, "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def main():
    if not torch.cuda.is_available():
        sys.exit("k4x_probe: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True).stdout
    print(f"[k4x probe] {card.strip()}", flush=True)
    out = torch.zeros(4, device="cuda")

    lib = build("stream", STREAM)
    lib.stream_ms.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.stream_ms.restype = ctypes.c_float
    rows, row_bytes = 128 * 1536, 2048      # the wg stack: K = 4096 codes
    codes = torch.randint(0, 256, (rows, row_bytes), dtype=torch.uint8,
                          device="cuda")
    for seg in (32, 64, 128):
        ms = lib.stream_ms(codes.data_ptr(), rows, row_bytes, seg,
                           out.data_ptr())
        print(f"[k4x probe] streaming {rows} rows of {row_bytes} bytes in "
              f"runs of {seg} bytes a row a stage: {ms:.4f} ms, "
              f"{codes.numel() / ms / 1e9:.2f} TB/s", flush=True)
    del codes

    # the kernel's anonymous namespace is closed around the appended code
    lib = build("chunk", SRC.read_text().replace(
        "}  // namespace\n", CHUNK + "}  // namespace\n", 1))
    lib.probe_chunk_ms.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.probe_chunk_ms.restype = ctypes.c_float
    lib.fma_peak_tflops.argtypes = [ctypes.c_void_p]
    lib.fma_peak_tflops.restype = ctypes.c_float
    dims = (ctypes.c_int * 3)()
    lib.probe_chunk_geometry(dims)
    sms, warps, cols = dims
    peak = lib.fma_peak_tflops(out.data_ptr())
    print(f"[k4x probe] f32 FMA loop: {peak:.2f} TFLOP/s", flush=True)
    iters = 4096
    for m in (1, 8):
        ms = lib.probe_chunk_ms(m, iters, out.data_ptr())
        flops = 2.0 * sms * 32 * warps * iters * 32 * cols * m
        print(f"[k4x probe] the chunk loop alone, M = {m} ({warps} warps "
              f"an SM, {cols} columns a lane): {ms:.4f} ms, "
              f"{flops / ms / 1e9:.2f} TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
