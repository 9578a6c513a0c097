// K1: fused AWP projected-gradient step  Z = Θ + η·(W − Θ)·C  with the
// residual norm ‖(W − Θ)·C‖_F taken from the f32 accumulators. K1b is the
// same kernel over a batch of B items (grid y), each with its own η, C and
// partials.
//
// Replaces: src/repro/kernels/awp_pgd.py, awp_pgd_step (pallas_call at
// :145) and its batched form _step_batched (pallas_call at :90).
//
// Bound on an H100: 2·B·M·K² floating-point operations against 67 TFLOP/s of
// f32 outside the tensor cores. Operands move M·K·8 + K²·4 + M·K·4 bytes a
// item, so at every shape of the compression path (M ≥ 512, K ≥ 2048) the
// kernel is compute-bound. TF32 (or 3xTF32) would change the bits and move
// the PGD stop rule (tol 1e-4 on ‖∇f‖/‖W‖), and f32 has no wgmma, so this is
// a SIMT SGEMM.
//
// The math, which every variant keeps: each output is one fmaf chain in k
// order from k = 0, starting at +0 (no split-K, no second accumulator), the
// order of an unsplit cuBLAS SGEMM. Zero-filled operands past the M, N and K
// edges add +0·0 terms, which leave an accumulator that started at +0
// unchanged. The epilogue writes Z = Θ + η·acc as a rounded product then a
// rounded sum (__fmul_rn, __fadd_rn: never contracted into one FMA), with η
// read from device memory. So Z is bit-equal to the plain version under
// unsplit cuBLAS. Each block writes Σacc² over its tile (per-thread fmaf
// chains, a fixed shuffle tree, the 8 warps summed in order) to a
// (B, tiles_m, tiles_n) partials buffer that the wrapper sums: no atomics.
//
// Design, as built (kernels/ops.py, awp_pgd_tiles, picks the variant):
// - Tiles. Variant 0: a 128 × 128 output tile, BK = 8; a thread owns 8 × 8
//   outputs; 2 blocks an SM (≤ 128 registers). Variant 1: 64 × 128, BK =
//   16; a thread owns 4 × 8 outputs; for grids where 128 × 128 tiles leave
//   SMs idle (M = 512: 64 blocks on 132 SMs). 256 threads, 8 warps: 4 along
//   M, 2 along N. A thread's outputs are MSUB × 2 sub-tiles of 4 × 4
//   consecutive rows and columns (warp lanes 8 along N, 4 along M), so a k
//   step reads MSUB + 2 LDS.128 (4 for 64 FMAs in variant 0).
// - Pipeline: a ring of 4 stages in dynamic shared memory, each a BK-deep
//   tile of W, Θ (row-major, as in device memory) and C, filled with
//   cp.async.cg 16-byte copies (one commit group a tile, cp.async.wait_group
//   2). The copies for tile t + 3 are issued at the first k step of tile t;
//   tiles t + 1 .. t + 3 are in flight while tile t's FMAs run. Each thread
//   keeps running pointers to its copies' sources, so a tile's copies cost
//   a few integer adds.
// - W − Θ stays fused: each thread subtracts the 4-k chunk of W and Θ it
//   copied itself and stores the difference k-major into a double-buffered
//   (BK, BM + 4) tile, halfway through the previous tile's k steps. The
//   transposition needs a pass through registers anyway; from shared memory
//   it runs under the FMAs and holds no staging registers, which the 64
//   accumulators need. The + 4 padding makes the transposed stores
//   conflict-free (a warp covers 16 rows × 2 chunks; row stride ≡ 4 banks
//   mod 32) and keeps rows 16-byte aligned for LDS.128.
// - Register double-buffered fragments: the LDS.128s of k step kk + 1 issue
//   before the FMAs of kk; the one __syncthreads a tile sits before the last
//   k step's FMAs, which hide the first fragments of the next tile. FMAs run
//   row by row, serpentine along the columns, so consecutive FMAs share an
//   operand (register reuse).
// - Grid order: the linear block index walks groups of 16 row tiles, row
//   tiles fastest inside a group, so blocks that run together share column
//   panels of C (268 MB at wd) and row panels of W and Θ in the 50 MB L2.
//   The batch index is grid y, outermost.
// - Epilogue: Θ read and Z written as float4.
// - Scalar-copy instantiation (VEC = false): the same kernel with 4-byte
//   cp.async copies, zero-filled past the edges, and scalar epilogue
//   accesses, for K % 4 ≠ 0 or an operand not 16-byte aligned (the wrapper
//   decides; it never falls back to the plain version on the card).
// Resources (ptxas of CUDA 12.8 for sm_90a; chip_smoke.py prints them at
// every build, with awp_pgd_smem_bytes): variant 0 125 registers (123 in
// the scalar-copy instantiation), 57,600 B of dynamic shared memory;
// variant 1 113 (102) registers, 74,240 B; no spills; 32 B of static
// shared memory each. Two blocks of either fit an SM.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BN = 128;
constexpr int GROUP_M = 16;   // row tiles per raster group

template <int MSUB, int BK_, bool VEC_>
struct Cfg {
  static constexpr int BM = 64 * MSUB;
  static constexpr int BK = BK_;
  static constexpr int STAGES = 4;
  static constexpr bool VEC = VEC_;
  static constexpr int TM = 4 * MSUB;            // rows a thread owns
  static constexpr int TN = 8;                   // columns a thread owns
  static constexpr int LDA = BM + 4;             // k-major (W − Θ) row
  static constexpr int TILE_A = BM * BK;         // W or Θ tile, [BK/8][BM][8]
  static constexpr int TILE_C = BK * BN;         // C tile, [BK][BN]
  static constexpr int SLOT = 2 * TILE_A + TILE_C;
  static constexpr int AS = BK * LDA;
  static constexpr size_t SMEM = (size_t)(STAGES * SLOT + 2 * AS) * 4;
  static constexpr int ACH = TILE_A / (4 * THREADS);   // W chunks a thread
  static constexpr int CCH = TILE_C / (4 * THREADS);   // C chunks a thread
  static constexpr int TRANSPOSE_AT = BK / 2 - 1;      // k step of the pass
  static_assert(TILE_A % (4 * THREADS) == 0 && TILE_C % (4 * THREADS) == 0,
                "whole 16-byte chunks a thread");
  static_assert(BK % 8 == 0, "BK");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy, zero-filled when !pred (src then unread)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 4 consecutive floats from src (the first `valid` of them inside the
// operand; the scalar-copy instantiation only) into shared memory at dst,
// zero-filling the rest; `safe` is a valid address to name when nothing is
// read
__device__ __forceinline__ void copy4_scalar(float* dst, const float* src,
                                             int valid, const float* safe) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cp4(dst + j, j < valid ? src + j : safe, j < valid);
}

template <class C>
__global__ void __launch_bounds__(THREADS, 2)
awp_pgd_step_kernel(const float* __restrict__ w,
                    const float* __restrict__ theta,
                    const float* __restrict__ c,
                    const float* __restrict__ eta,
                    float* __restrict__ z,
                    float* __restrict__ partials,
                    int M, int K) {
  constexpr int BM = C::BM, BK = C::BK, TM = C::TM, TN = C::TN,
                LDA = C::LDA, S = C::STAGES;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[THREADS / 32];
  float* ring = smem;                          // S slots of W, Θ, C
  float* as = smem + S * C::SLOT;              // 2 × (BK, LDA)

  const int N = K;
  const int b = blockIdx.y;
  const size_t mk = (size_t)M * K;
  w += b * mk;
  theta += b * mk;
  c += (size_t)b * K * K;
  z += b * mk;

  // grouped raster: row tiles fastest inside groups of GROUP_M row tiles
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int lin = blockIdx.x;
  const int group = lin / (GROUP_M * tiles_n);
  const int first = group * GROUP_M;
  const int gsize = min(tiles_m - first, GROUP_M);
  const int in_group = lin - group * GROUP_M * tiles_n;
  const int tile_m = first + in_group % gsize;
  const int tile_n = in_group / gsize;
  const int m0 = tile_m * BM;
  const int n0 = tile_n * BN;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // The W/Θ chunks this thread copies and transposes: row ar, k 4·aq..+3
  // of the tile. A warp covers 16 rows × 2 chunks (32 contiguous bytes a
  // row in device memory, 512 contiguous bytes in the ring).
  int a_slot[C::ACH], a_t[C::ACH], a_k[C::ACH];
  const float* gw[C::ACH];
  const float* gth[C::ACH];
  bool a_ok[C::ACH];
#pragma unroll
  for (int l = 0; l < C::ACH; ++l) {
    const int q = tid + l * THREADS;
    const int wq = q / 32, ln = q % 32;
    const int aq = (ln & 1) + 2 * (wq % (BK / 8));
    const int ar = 16 * (wq / (BK / 8)) + (ln >> 1);
    a_slot[l] = (aq >> 1) * BM * 8 + ar * 8 + (aq & 1) * 4;
    a_t[l] = 4 * aq * LDA + ar;
    a_k[l] = 4 * aq;
    a_ok[l] = m0 + ar < M;
    const size_t off = (size_t)(a_ok[l] ? m0 + ar : 0) * K + 4 * aq;
    gw[l] = w + off;
    gth[l] = theta + off;
  }
  // the C chunks: a warp copies 512 contiguous bytes of one k row
  int c_slot[C::CCH], c_k[C::CCH], c_cols[C::CCH];
  const float* gc[C::CCH];
#pragma unroll
  for (int l = 0; l < C::CCH; ++l) {
    const int idx = tid + l * THREADS;
    c_k[l] = idx / (BN / 4);
    const int col = 4 * (idx % (BN / 4));
    c_slot[l] = 2 * C::TILE_A + c_k[l] * BN + col;
    c_cols[l] = N - n0 - col;                  // valid columns from col on
    gc[l] = c + (size_t)c_k[l] * N + (c_cols[l] > 0 ? n0 + col : 0);
  }
  const int num_tiles = (K + BK - 1) / BK;
  const size_t c_step = (size_t)BK * N;
  int k_issue = 0;

  // the copies of the next tile into `slot`; the sources move on by BK
  auto issue = [&](float* slot) {
#pragma unroll
    for (int l = 0; l < C::ACH; ++l) {
      float* dw = slot + a_slot[l];
      float* dt = slot + C::TILE_A + a_slot[l];
      if constexpr (C::VEC) {
        const bool ok = a_ok[l] && k_issue + a_k[l] < K;
        cp16(dw, ok ? gw[l] : w, ok);
        cp16(dt, ok ? gth[l] : w, ok);
      } else {
        const int va = a_ok[l] ? K - k_issue - a_k[l] : 0;
        copy4_scalar(dw, gw[l], va, w);
        copy4_scalar(dt, gth[l], va, w);
      }
      gw[l] += BK;
      gth[l] += BK;
    }
#pragma unroll
    for (int l = 0; l < C::CCH; ++l) {
      float* dc = slot + c_slot[l];
      const bool k_ok = k_issue + c_k[l] < K;
      if constexpr (C::VEC) {
        const bool ok = k_ok && c_cols[l] > 0;
        cp16(dc, ok ? gc[l] : c, ok);
      } else {
        copy4_scalar(dc, gc[l], k_ok ? c_cols[l] : 0, c);
      }
      gc[l] += c_step;
    }
    k_issue += BK;
  };

  // W − Θ of this thread's own chunks (landed: cp.async.wait_group makes a
  // thread's copies visible to it) into a k-major buffer
  auto transpose = [&](const float* slot, float* dst_buf) {
#pragma unroll
    for (int l = 0; l < C::ACH; ++l) {
      const float4 wv = *reinterpret_cast<const float4*>(slot + a_slot[l]);
      const float4 tv =
          *reinterpret_cast<const float4*>(slot + C::TILE_A + a_slot[l]);
      float* dst = dst_buf + a_t[l];
      dst[0] = __fsub_rn(wv.x, tv.x);
      dst[LDA] = __fsub_rn(wv.y, tv.y);
      dst[2 * LDA] = __fsub_rn(wv.z, tv.z);
      dst[3 * LDA] = __fsub_rn(wv.w, tv.w);
    }
  };

  // this thread's outputs: rows row0 + 16·s + i, columns col0 + 32·s + j
  const int row0 = (warp / 2) * (16 * (TM / 4)) + (lane / 8) * 4;
  const int col0 = (warp % 2) * 64 + (lane % 8) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float fa[2][TM], fb[2][TN];
  auto load_frag = [&](int buf, const float* a_buf, const float* slot,
                       int kk) {
    const float* at = a_buf + kk * LDA + row0;
    const float* ct = slot + 2 * C::TILE_A + kk * BN + col0;
#pragma unroll
    for (int s = 0; s < TM / 4; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(at + 16 * s);
      fa[buf][4 * s] = v.x; fa[buf][4 * s + 1] = v.y;
      fa[buf][4 * s + 2] = v.z; fa[buf][4 * s + 3] = v.w;
    }
#pragma unroll
    for (int s = 0; s < TN / 4; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(ct + 32 * s);
      fb[buf][4 * s] = v.x; fb[buf][4 * s + 1] = v.y;
      fb[buf][4 * s + 2] = v.z; fb[buf][4 * s + 3] = v.w;
    }
  };

  // ring slots: the one being filled, the one transposed next, the one
  // whose C this tile reads; (W − Θ) buffers: this tile's and the next
  float* slot_fill = ring;
  float* slot_next = ring;
  float* slot_cur = ring;
  float* a_cur = as;
  float* a_next = as + C::AS;
  auto advance = [&](float*& p) {
    p = p == ring + (S - 1) * C::SLOT ? ring : p + C::SLOT;
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < num_tiles) issue(slot_fill);
    cp_commit();
    advance(slot_fill);
  }
  cp_wait<S - 2>();                  // tile 0 landed (own copies)
  transpose(slot_next, a_cur);
  advance(slot_next);
  __syncthreads();
  load_frag(0, a_cur, slot_cur, 0);

#pragma unroll 1
  for (int t = 0; t < num_tiles; ++t) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk == 0) {
        // into the slot of tile t − 1, whose reads all ended before the
        // barrier at the end of tile t − 1
        if (t + S - 1 < num_tiles) issue(slot_fill);
        cp_commit();
        advance(slot_fill);
      }
      if (kk == C::TRANSPOSE_AT) {
        cp_wait<S - 2>();            // own copies of tile t + 1 landed
        if (t + 1 < num_tiles) transpose(slot_next, a_next);
        advance(slot_next);
      }
      if (kk < BK - 1) {
        load_frag((kk + 1) & 1, a_cur, slot_cur, kk + 1);
      } else {
        // everyone's copies of tile t + 1 and its (W − Θ) are in place
        // (each thread waited for its own), and every read of tile t is
        // in registers
        __syncthreads();
        float* done = a_cur;
        a_cur = a_next;
        a_next = done;
        advance(slot_cur);
        if (t + 1 < num_tiles) load_frag(0, a_cur, slot_cur, 0);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          const int j = i % 2 ? TN - 1 - jj : jj;
          acc[i][j] = fmaf(fa[kk & 1][i], fb[kk & 1][j], acc[i][j]);
        }
    }
  }

  const float e = eta[b];
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + row0 + 16 * (i / 4) + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int s = 0; s < TN / 4; ++s) {
      const int gn = n0 + col0 + 32 * s;
      const size_t o = (size_t)gm * N + gn;
      const float* r = acc[i] + 4 * s;
      if constexpr (C::VEC) {
        if (gn < N) {
          const float4 th = *reinterpret_cast<const float4*>(theta + o);
          float4 out;
          out.x = __fadd_rn(th.x, __fmul_rn(e, r[0]));
          out.y = __fadd_rn(th.y, __fmul_rn(e, r[1]));
          out.z = __fadd_rn(th.z, __fmul_rn(e, r[2]));
          out.w = __fadd_rn(th.w, __fmul_rn(e, r[3]));
          *reinterpret_cast<float4*>(z + o) = out;
#pragma unroll
          for (int j = 0; j < 4; ++j) sq = fmaf(r[j], r[j], sq);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gn + j < N) {
            z[o + j] = __fadd_rn(theta[o + j], __fmul_rn(e, r[j]));
            sq = fmaf(r[j], r[j], sq);
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) total += red[i];
    partials[((size_t)b * tiles_m + tile_m) * tiles_n + tile_n] = total;
  }
}

template <class C>
int launch(const float* w, const float* theta, const float* c,
           const float* eta, float* z, float* partials, int B, int M, int K,
           cudaStream_t stream) {
  // attributes set once per instantiation and device
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (dev >= 64 || !(ready >> dev & 1ull)) {
    cudaError_t err = cudaFuncSetAttribute(
        awp_pgd_step_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          awp_pgd_step_kernel<C>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready |= 1ull << dev;
  }
  const int tiles = ((M + C::BM - 1) / C::BM) * ((K + BN - 1) / BN);
  dim3 grid(tiles, B);
  awp_pgd_step_kernel<C><<<grid, THREADS, C::SMEM, stream>>>(
      w, theta, c, eta, z, partials, M, K);
  return (int)cudaGetLastError();
}

// variant index (kernels/ops.py, AWP_PGD_TILES) -> (MSUB, BK)
using V0 = Cfg<2, 8, true>;
using V1 = Cfg<1, 16, true>;
using V0s = Cfg<2, 8, false>;
using V1s = Cfg<1, 16, false>;

}  // namespace

// Dynamic shared memory of a variant's kernel in bytes, -1 if unknown.
extern "C" int awp_pgd_smem_bytes(int variant) {
  return variant == 0 ? (int)V0::SMEM : variant == 1 ? (int)V1::SMEM : -1;
}

// w, theta, z: (B, M, K); c: (B, K, K); eta: (B,); partials: (B, tiles_m,
// tiles_n) for the variant's tile (0: 128 × 128, 1: 64 × 128). All f32,
// contiguous, on the device. vec: K % 4 == 0 and every operand 16-byte
// aligned (else the scalar-copy instantiation). Returns cudaGetLastError(),
// or the error of a refused attribute.
extern "C" int awp_pgd_step_f32(const float* w, const float* theta,
                                const float* c, const float* eta, float* z,
                                float* partials, int B, int M, int K,
                                int variant, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    return vec ? launch<V0>(w, theta, c, eta, z, partials, B, M, K, s)
               : launch<V0s>(w, theta, c, eta, z, partials, B, M, K, s);
  if (variant == 1)
    return vec ? launch<V1>(w, theta, c, eta, z, partials, B, M, K, s)
               : launch<V1s>(w, theta, c, eta, z, partials, B, M, K, s);
  return (int)cudaErrorInvalidValue;
}
