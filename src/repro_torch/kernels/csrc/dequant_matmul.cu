// K4: fused int4 dequant-matmul  y (M, N) = x (M, K) · dequant(W)ᵀ  with W
// nibble-packed (N, K/2) uint8 (low nibble = even k) and per-(row, group)
// f32 scale and zero (N, K/group); f32 accumulation. The weight never exists
// as floats in device memory: each code becomes ((float)code − zero) · scale
// (a rounded difference, then a rounded product) on its way into registers
// or shared memory, the value the plain version dequantizes.
//
// Replaces: src/repro/kernels/dequant_matmul.py, dequant_matmul
// (pallas_call at :78).
//
// K4x, the same product over a stack of E experts (W (E, N, K/2), scale and
// zero (E, N, K/group)), replaces that pallas_call under jax.vmap over the
// expert axis (src/repro/models/layers.py:58-59, expert_apply): one launch
// with the experts on the grid (the tile's y, the GEMV's z, so the GEMV's
// cluster along y is unchanged). Every expert's x is the same (T, K)
// activation (stride 0: the MoE up and gate projections) or its own rows
// at any row and expert stride (the down projection's strided (E, T, f)
// view of the (T, E, f) activations, read without a copy), and y is written
// at any row and expert stride, so the shared form writes the reference's
// (T, E, N) layout directly. Each expert's sums are K4's, in K4's order.
// Its bound is K4's over the stack: at decode (M = 8) the 403 MB of codes
// and 50 MB of scales and zeros of one qwen3-moe wg or wu.
//
// Bound on an H100 (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
// - the GEMV (M <= 8, the decode steps) reads N·K/2 bytes of codes and
//   8·N·K/group of scales and zeros against 2·M·N·K operations: at N = 8192,
//   K = 2048 the bytes take 2.8 µs and the operations 0.5 µs a row, so it is
//   bound by bytes at M <= 5 and by operations above;
// - the tile (M > 8, prefill and chunks) is bound by its 2·M·N·K operations
//   from M of a few dozen up. TF32 (or 3xTF32) would change the bits the
//   engines' first tokens rest on, and f32 has no wgmma, so it is a SIMT
//   SGEMM.
//
// The math of the tile, which every tile variant keeps: each output is one
// fmaf chain in k order from k = 0, starting at +0 (no split-K, no second
// accumulator), the order of an unsplit cuBLAS SGEMM, so under unsplit
// cuBLAS y is bit-equal to the plain version (dequantize, then x·Wᵀ).
// Zero-filled operands past the M, N and K edges add +0·0 terms. The
// expert GEMV keeps that order; the GEMV sums in another (below),
// deterministically: the same inputs give the same bits from launch to
// launch.
//
// Design of the tile (kernels/ops.py, dequant_matmul_tiles, picks the
// variant by shape; variants 0..3: 128 × 128, 64 × 128 and 64 × 64 outputs
// a block of 256 threads, 32 × 32 a block of 64 threads for grids too small
// to fill the card), after K1 (awp_pgd.cu) with the dequantize in place of
// W − Θ:
// - Both operands are k-contiguous, so both go through a per-thread
//   transform pass into k-major (BK, rows + 4) buffers: x copied and
//   transposed, the packed weight unpacked, dequantized and transposed.
//   BK = 32, so one 16-byte copy is 32 codes of one weight row, and each
//   (row, group) scale and zero is copied once a k-tile (a k-tile never
//   straddles a group, whose size is a multiple of 32).
// - Both raw operands stream into a 2-slot cp.async.cg ring (16 bytes a
//   copy) in dynamic shared memory. Each thread transforms only the chunks
//   it copied itself, so a slot is private to its copiers: the copies for
//   tile t + 2 go out at the first k step of tile t, into the slot tile t
//   came in by, and tile t + 1 is transformed at the middle k step of
//   tile t, into the other half of the double-buffered k-major buffers.
// - Register double-buffered fragments and one __syncthreads a tile, before
//   the last k step's FMAs; serpentine FMAs; a thread owns 4·MSUB × 4·NSUB
//   outputs as sub-tiles of 4 × 4 (WM × WN warps of 4 × 8 lanes). Each
//   thread copies x for one row, so its passes differ by constant offsets.
// - Grouped raster: row tiles fastest inside groups of 16, so blocks that
//   run together share panels of x and W in the L2.
// - Scalar-copy instantiation (VEC = false) for operands that are not
//   16-byte aligned, K % 32 ≠ 0, a group that is not a multiple of 32 or
//   N % 4 ≠ 0 (no float4 stores):
//   4-byte copies of x, the codes, scales and zeros read by the transform
//   pass, the same tiles and sum order.
//
// Design of the GEMV (M <= 8; variants 4..7 split K over 1, 2, 4 or 8
// blocks of a thread-block cluster):
// - A block owns 64 output columns and its cluster rank's share of K, in
//   k-tiles of 256 codes. Each k-tile of the 64 weight rows (128 bytes a
//   row), of x (M × 256 floats) and of the rows' scales and zeros streams
//   into a 4-slot cp.async ring, coalesced (a warp copies four whole
//   128-byte row segments); one __syncthreads a tile.
// - Lane l computes columns l and l + 32 over the 32 codes of its warp's
//   slice of each k-tile: it reads its two 16-byte code words from shared
//   memory (rows padded to 144 bytes: conflict-free), unpacks them with
//   byte permutes (2^23 + code as float bits, minus 2^23: exact, with no
//   integer-to-float conversion), dequantizes, and reads x as shared-memory
//   broadcasts (every lane of a warp reads the same float4), so one x value
//   feeds both columns and one code feeds every row of x.
// - Each lane's k-ordered partial sums are added across the 8 warps in
//   warp order, then across the cluster's blocks in rank order through
//   distributed shared memory: a fixed order, no atomics.
// - The split is the least that gives every SM a block (N = 8192: 2; N =
//   2048 and 512: 8, the largest portable cluster, 64 blocks at N = 512).
//   Its floor is latency, not bytes: at N = 8192 it moves 0.6–0.7 TB/s.
// Design of the expert GEMV (variant 8, "gemvx"; M <= 8, picked for stacks
// that fill the card: qwen3-moe's 128 experts at decode). Bound: at M = 8
// the 2·E·M·N·K operations (12.9 GFLOP, 0.192 ms at 67 TFLOP/s) outweigh
// the 453 MB of codes, scales and zeros (0.135 ms); at M <= 4 the bytes.
// The GEMV above, with the experts on grid z, ran 3,072–8,192 blocks of 64
// columns at 29–39% of that, for three reasons: every block staged x's
// k-tile beside its codes (as many bytes of x as of codes over a launch),
// every block paid a ring prologue and a cross-warp reduction for 6–16
// k-tiles of work, and a lane's issue mix (four dequantize operations a
// code, one x float4 for 8 FMAs) capped its FMA share. What this design
// does about each:
// - Persistent blocks, one an SM, of 8 warps walk rounds of 8 tasks; a
//   task is 64 output columns of one expert over all of K, a warp's: lane
//   l owns columns l and l + 32 and keeps one fmaf chain per output, in k
//   order from +0 — the tile's order and bits, with no reduction across
//   warps or blocks. y is written straight from the accumulators.
// - A block's 8 warps stream 512 weight rows through a two-stage
//   cp.async ring of 256 codes a stage (eight lanes copy a row's 128
//   bytes: whole sectors, and HBM streams 128-byte runs a row at 2.76
//   TB/s where 32-byte runs reach 1.79; scripts/k4x_probe.py on an H100
//   at 700 W), with x's (M, 256) k-tile once a
//   stage for the block: x is 1/8 of the staged bytes at M = 8, not as
//   many as the codes. One __syncthreads a stage; the ring runs across
//   rounds, so a task's first stage lands while the last one's computes.
// - Each row's scales and zeros come in windows of 8 groups (32 bytes of
//   each array, whole sectors), once a window, not once a k-tile:
//   scattered 4-byte copies of 512 rows cost an L2 sector each.
// - Dequantize in two f32 operations: where every zero of a group is an
//   integer of magnitude <= 2^23 (the quantizer's: round, then clamp to
//   [0, qmax]), (2^23 + code) − (2^23 + zero) is exact, so one rounded
//   product with the scale gives the plain version's value; a warp vote a
//   group takes the three-operation form for any other zero.
// What still bounds it at M = 8 is the lane's issue: a code costs a byte
// permute, a subtraction and a product for M FMAs, and an x float4 feeds
// 8 FMAs, so FMAs are about 64% of the loop's instructions by its count;
// the chunk loop alone runs at 28 TFLOP/s at M = 8 where a loop of FMAs
// reaches 64 (scripts/k4x_probe.py; chip_smoke.py prints the kernel's
// times beside its bound).
// Resources (ptxas of CUDA 12.8 for sm_90a; chip_smoke.py prints them at
// every build): tiles 128, 128, 96 and 96 registers (128, 99, 79, 79 in
// the scalar-copy instantiations), 106,496, 73,728, 54,272 and 28,160 B of
// dynamic shared memory; the GEMV 48–80 registers and 89,088 B at M = 8;
// the expert GEMV up to 220 registers and 212,992 B at M = 8.
// No spills but 12 B in the 128 × 128 scalar-copy instantiation.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy, zero-filled when !pred (src then unread)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
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

// ((float)code − zero) · scale for the code in byte i of e (each byte of e
// a nibble): __byte_perm builds the float bits of 2^23 + code, and
// subtracting 2^23 gives (float)code exactly
__device__ __forceinline__ float deq(unsigned e, int i, float z, float s) {
  const float code =
      __fsub_rn(__uint_as_float(__byte_perm(e, 0x4B000000u, 0x7540 | i)),
                8388608.0f);
  return __fmul_rn(__fsub_rn(code, z), s);
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------- tile
constexpr int BK = 32;
constexpr int GROUP_M = 16;   // row tiles per raster group

// WM × WN warps, each 4 × 8 lanes of 4·MSUB × 4·NSUB outputs
template <int WM, int WN, int MSUB, int NSUB, bool VEC_>
struct Tile {
  static constexpr int NT = 32 * WM * WN;        // threads a block
  static constexpr int BM = 16 * WM * MSUB;
  static constexpr int BN = 32 * WN * NSUB;
  static constexpr bool VEC = VEC_;
  static constexpr int TM = 4 * MSUB;            // rows a thread owns
  static constexpr int TN = 4 * NSUB;            // columns a thread owns
  static constexpr int LDA = BM + 4;             // k-major x row
  static constexpr int LDB = BN + 4;             // k-major W row
  static constexpr int XCH = BM * BK / (4 * NT);        // x chunks a thread
  static constexpr int RAW_X = BM * BK * 4;      // bytes: [BK/8][BM][8] f32
  static constexpr int RAW_W = BN * 16;          // bytes: a 16-byte chunk a row
  static constexpr int RAW_SZ = BN * 8;          // bytes: (scale, zero) a row
  static constexpr int SLOT = RAW_X + RAW_W + RAW_SZ;
  static constexpr int AS = BK * LDA;            // floats
  static constexpr int BS = BK * LDB;            // floats
  static constexpr size_t SMEM = (size_t)2 * SLOT + (size_t)2 * (AS + BS) * 4;
  static constexpr int TRANSFORM_AT = BK / 2 - 1;
  static_assert(XCH * 4 * NT == BM * BK, "whole x chunks a thread");
  static_assert(BN <= NT, "a weight row a thread");
};

template <class C>
__global__ void __launch_bounds__(C::NT, 2)
dequant_gemm_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, float* __restrict__ y,
                    int M, int N, int K, int group, long long ldx,
                    long long sx, long long ldy, long long sy) {
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, TN = C::TN,
                LDA = C::LDA, LDB = C::LDB;
  // expert blockIdx.y of a stack: its x rows (stride 0 when shared), its
  // weight, scales and zeros, its y rows
  {
    const size_t e = blockIdx.y;
    const size_t G = (size_t)(K / group);
    x += e * sx;
    packed += e * (size_t)N * (size_t)(K / 2);
    scale += e * (size_t)N * G;
    zero += e * (size_t)N * G;
    y += e * sy;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* slots = smem;                               // 2 raw slots
  float* as = reinterpret_cast<float*>(smem + 2 * C::SLOT);  // 2 × (BK, LDA)
  float* bs = as + 2 * C::AS;                                // 2 × (BK, LDB)

  // grouped raster: row tiles fastest inside groups of GROUP_M row tiles
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int lin = blockIdx.x;
  const int grp = lin / (GROUP_M * tiles_n);
  const int first = grp * GROUP_M;
  const int gsize = min(tiles_m - first, GROUP_M);
  const int in_group = lin - grp * GROUP_M * tiles_n;
  const int m0 = (first + in_group % gsize) * BM;
  const int n0 = (in_group / gsize) * BN;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = K / group;
  const size_t half_k = (size_t)(K / 2);

  // The x chunks this thread copies and transposes: row ar of the tile,
  // k 4·aq..+3 with aq = aq0 + 2·PSTEP·l in pass l. A warp covers 16 rows
  // × 2 chunks (conflict-free transposed stores: the row stride LDA is 4
  // banks mod 32); the block's warps cover the row blocks of 16, then the
  // 4 chunk pairs of a row, which its passes walk.
  constexpr int RB = BM / 16;                   // row blocks of 16
  constexpr int PSTEP = C::NT / 32 / RB;        // chunk pairs a pass moves on
  static_assert(C::NT / 32 % RB == 0 && PSTEP * C::XCH == BK / 8,
                "passes cover a row's chunk pairs");
  const int ar = 16 * (warp % RB) + (lane >> 1);
  const int aq0 = (lane & 1) + 2 * (warp / RB);
  const bool x_ok = m0 + ar < M;
  const int x_slot0 = (aq0 >> 1) * BM * 8 + ar * 8 + (aq0 & 1) * 4;
  const int x_t0 = 4 * aq0 * LDA + ar;
  const float* gx = x + (x_ok ? m0 + ar : 0) * ldx + 4 * aq0;
  // the weight row this thread copies, dequantizes and transposes (threads
  // tid < BN): its codes, scales and zeros
  const bool w_role = tid < BN;
  const bool w_ok = w_role && n0 + tid < N;
  const size_t w_row = (size_t)(w_ok ? n0 + tid : 0);
  const uint8_t* gw = packed + w_row * half_k;
  const float* gs = scale + w_row * G;
  const float* gz = zero + w_row * G;
  const int num_tiles = (K + BK - 1) / BK;
  int k_issue = 0;

  // the copies of the next k-tile into `slot`
  auto issue = [&](unsigned char* slot) {
    float* rx = reinterpret_cast<float*>(slot);
#pragma unroll
    for (int l = 0; l < C::XCH; ++l) {
      float* dst = rx + x_slot0 + l * PSTEP * BM * 8;
      const float* src = gx + 8 * PSTEP * l;
      if constexpr (C::VEC) {
        cp16(dst, x_ok ? src : x, x_ok);
      } else {
        const int valid = x_ok ? K - k_issue - 4 * aq0 - 8 * PSTEP * l : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cp4(dst + j, j < valid ? src + j : x, j < valid);
      }
    }
    gx += BK;
    if constexpr (C::VEC) {
      if (w_role) {
        const int gi = k_issue / group;
        cp16(slot + C::RAW_X + 16 * tid, w_ok ? gw : packed, w_ok);
        float* sz = reinterpret_cast<float*>(slot + C::RAW_X + C::RAW_W);
        cp4(sz + 2 * tid, w_ok ? gs + gi : scale, w_ok);
        cp4(sz + 2 * tid + 1, w_ok ? gz + gi : zero, w_ok);
        gw += BK / 2;
      }
    }
    k_issue += BK;
  };

  // this thread's own chunks of a landed slot into k-major buffers: x
  // transposed, the weight row unpacked, dequantized, transposed; k0 is
  // the tile's first k (the scalar-copy instantiation reads the codes,
  // scales and zeros from device memory here)
  auto transform = [&](const unsigned char* slot, float* a_dst, float* b_dst,
                       int k0) {
    const float* rx = reinterpret_cast<const float*>(slot);
#pragma unroll
    for (int l = 0; l < C::XCH; ++l) {
      const float4 v = *reinterpret_cast<const float4*>(
          rx + x_slot0 + l * PSTEP * BM * 8);
      float* dst = a_dst + x_t0 + 8 * PSTEP * l * LDA;
      dst[0] = v.x;
      dst[LDA] = v.y;
      dst[2 * LDA] = v.z;
      dst[3 * LDA] = v.w;
    }
    if (!w_role) return;
    float* dst = b_dst + tid;
    if constexpr (C::VEC) {
      const uint4 wv = *reinterpret_cast<const uint4*>(slot + C::RAW_X +
                                                        16 * tid);
      const float* sz =
          reinterpret_cast<const float*>(slot + C::RAW_X + C::RAW_W);
      const float s = sz[2 * tid], z = sz[2 * tid + 1];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned w = word_of(wv, q);
        const unsigned e0 = w & 0x0F0F0F0Fu;         // codes k, k+2, k+4, k+6
        const unsigned e1 = (w >> 4) & 0x0F0F0F0Fu;  // k+1, k+3, k+5, k+7
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dst[(8 * q + 2 * j) * LDB] = deq(e0, j, z, s);
          dst[(8 * q + 2 * j + 1) * LDB] = deq(e1, j, z, s);
        }
      }
    } else {
      const uint8_t* row = packed + w_row * half_k;
      for (int kk = 0; kk < BK; ++kk) {
        const int k = k0 + kk;
        float v = 0.0f;
        if (w_ok && k < K) {
          const unsigned byte = row[k / 2];
          const unsigned code = (k & 1) ? byte >> 4 : byte & 0xFu;
          const int gi = k / group;
          v = __fmul_rn(__fsub_rn((float)code, gz[gi]), gs[gi]);
        }
        dst[kk * LDB] = v;
      }
    }
  };

  // this thread's outputs: rows row0 + 16·s + i, columns col0 + 32·s + j
  constexpr int WN = BN / (8 * TN);              // warps along N
  const int row0 = (warp / WN) * (16 * (TM / 4)) + (lane / 8) * 4;
  const int col0 = (warp % WN) * (32 * (TN / 4)) + (lane % 8) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float fa[2][TM], fb[2][TN];
  auto load_frag = [&](int buf, const float* a_buf, const float* b_buf,
                       int kk) {
    const float* at = a_buf + kk * LDA + row0;
    const float* bt = b_buf + kk * LDB + col0;
#pragma unroll
    for (int s = 0; s < TM / 4; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(at + 16 * s);
      fa[buf][4 * s] = v.x; fa[buf][4 * s + 1] = v.y;
      fa[buf][4 * s + 2] = v.z; fa[buf][4 * s + 3] = v.w;
    }
#pragma unroll
    for (int s = 0; s < TN / 4; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(bt + 32 * s);
      fb[buf][4 * s] = v.x; fb[buf][4 * s + 1] = v.y;
      fb[buf][4 * s + 2] = v.z; fb[buf][4 * s + 3] = v.w;
    }
  };

  unsigned char* slot0 = slots;
  unsigned char* slot1 = slots + C::SLOT;
  float* a_cur = as;
  float* a_next = as + C::AS;
  float* b_cur = bs;
  float* b_next = bs + C::BS;

  issue(slot0);                      // tile 0
  cp_commit();
  if (num_tiles > 1) issue(slot1);   // tile 1
  cp_commit();
  cp_wait<1>();                      // tile 0 landed (own copies)
  transform(slot0, a_cur, b_cur, 0);
  __syncthreads();
  load_frag(0, a_cur, b_cur, 0);

#pragma unroll 1
  for (int t = 0; t < num_tiles; ++t) {
    // tile t came in by slot t % 2, tile t + 1 by the other
    unsigned char* slot_t = (t & 1) ? slot1 : slot0;
    unsigned char* slot_n = (t & 1) ? slot0 : slot1;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk == 0) {
        // tile t's raw chunks were transformed (by their copiers) before
        if (t + 2 < num_tiles) issue(slot_t);
        cp_commit();
      }
      if (kk == C::TRANSFORM_AT) {
        cp_wait<1>();                // own copies of tile t + 1 landed
        if (t + 1 < num_tiles)
          transform(slot_n, a_next, b_next, (t + 1) * BK);
      }
      if (kk < BK - 1) {
        load_frag((kk + 1) & 1, a_cur, b_cur, kk + 1);
      } else {
        // tile t + 1 is in the k-major buffers (each thread wrote its own
        // part), and every read of tile t's buffers is in registers
        __syncthreads();
        float* done = a_cur;
        a_cur = a_next;
        a_next = done;
        done = b_cur;
        b_cur = b_next;
        b_next = done;
        if (t + 1 < num_tiles) load_frag(0, a_cur, b_cur, 0);
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + row0 + 16 * (i / 4) + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int s = 0; s < TN / 4; ++s) {
      const int gn = n0 + col0 + 32 * s;
      const long long o = gm * ldy + gn;
      const float* r = acc[i] + 4 * s;
      if constexpr (C::VEC) {
        if (gn < N)
          *reinterpret_cast<float4*>(y + o) = make_float4(r[0], r[1], r[2],
                                                          r[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) y[o + j] = r[j];
      }
    }
  }
}

// ---------------------------------------------------------------- GEMV
constexpr int GV_KT = 256;      // codes a k-tile: 8 warps × 32
constexpr int GV_COLS = 64;     // output columns a block: 32 lanes × 2
constexpr int GV_WROW = 144;    // bytes a weight row takes in a slot
constexpr int GV_STAGES = 4;
// groups a k-tile can touch (a group is 32 codes or more), and the floats
// a row's scales then zeros take in a slot: an odd stride, so the lanes'
// reads of 32 rows are conflict-free
constexpr int GV_GPT = GV_KT / 32 + 1;
constexpr int GV_SZROW = 2 * GV_GPT + 1;

template <int MT>
struct Gemv {
  static constexpr int W_BYTES = GV_COLS * GV_WROW;
  static constexpr int X_BYTES = MT * GV_KT * 4;
  static constexpr int SZ_BYTES = GV_COLS * GV_SZROW * 4;
  static constexpr int SLOT = W_BYTES + X_BYTES + SZ_BYTES;
  static constexpr size_t SMEM = (size_t)GV_STAGES * SLOT;
  static constexpr int XCH = (MT * GV_KT / 4 + THREADS - 1) / THREADS;
  static_assert(8 * MT * GV_COLS * 4 <= (int)SMEM, "reduction buffer fits");
};

template <int MT>
__global__ void __launch_bounds__(THREADS)
dequant_gemv_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, float* __restrict__ y,
                    int N, int K, int group, int split, long long ldx,
                    long long sx, long long ldy, long long sy) {
  using C = Gemv<MT>;
  // expert blockIdx.z of a stack, as in the tile
  {
    const size_t e = blockIdx.z;
    const size_t G = (size_t)(K / group);
    x += e * sx;
    packed += e * (size_t)N * (size_t)(K / 2);
    scale += e * (size_t)N * G;
    zero += e * (size_t)N * G;
    y += e * sy;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * GV_COLS;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = split > 1 ? (int)cluster.block_rank() : 0;
  const int kspan = K / split;
  const int kb = rank * kspan;
  const int ke = kb + kspan;
  const int num_tiles = (kspan + GV_KT - 1) / GV_KT;
  const int G = K / group;
  const size_t half_k = (size_t)(K / 2);

  // the groups the k-tile at k0 touches: g0 .. g0 + gpt − 1
  auto groups = [&](int k0, int& g0) {
    g0 = k0 / group;
    return (min(k0 + GV_KT, ke) - 1) / group - g0 + 1;
  };

  // the copies of the k-tile starting at k0 into `slot`: 64 weight rows ×
  // 8 chunks (a warp: 4 rows × 128 contiguous bytes), MT rows of x × 64
  // chunks (a warp: 512 contiguous bytes), and each row's scales then
  // zeros of the tile's groups
  auto issue = [&](unsigned char* slot, int k0) {
#pragma unroll
    for (int l = 0; l < GV_COLS * 8 / THREADS; ++l) {
      const int q = tid + l * THREADS;
      const int r = q >> 3, c = q & 7;
      const bool ok = n0 + r < N && k0 + 32 * c < ke;
      cp16(slot + r * GV_WROW + 16 * c,
           ok ? packed + (size_t)(n0 + r) * half_k + k0 / 2 + 16 * c : packed,
           ok);
    }
    float* xs = reinterpret_cast<float*>(slot + C::W_BYTES);
#pragma unroll
    for (int l = 0; l < C::XCH; ++l) {
      const int q = tid + l * THREADS;
      if (q < MT * GV_KT / 4) {
        const int m = q >> 6, c = q & 63;
        const bool ok = k0 + 4 * c < ke;
        cp16(xs + m * GV_KT + 4 * c, ok ? x + m * ldx + k0 + 4 * c : x, ok);
      }
    }
    int g0;
    const int gpt = groups(k0, g0);
    float* sz = reinterpret_cast<float*>(slot + C::W_BYTES + C::X_BYTES);
    for (int q = tid; q < GV_COLS * 2 * gpt; q += THREADS) {
      const int r = q / (2 * gpt), rem = q % (2 * gpt);
      const int arr = rem / gpt, gl = rem % gpt;
      const bool ok = n0 + r < N;
      const float* src = (arr ? zero : scale) + (size_t)(n0 + r) * G + g0 + gl;
      cp4(sz + r * GV_SZROW + arr * GV_GPT + gl, ok ? src : scale, ok);
    }
  };

  float acc[2][MT];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.0f;

#pragma unroll
  for (int s = 0; s < GV_STAGES - 1; ++s) {
    if (s < num_tiles) issue(smem + s * C::SLOT, kb + s * GV_KT);
    cp_commit();
  }

#pragma unroll 1
  for (int t = 0; t < num_tiles; ++t) {
    cp_wait<GV_STAGES - 2>();          // own copies of tile t landed
    __syncthreads();                   // everyone's; tile t − 1 read
    if (t + GV_STAGES - 1 < num_tiles)
      issue(smem + ((t + GV_STAGES - 1) % GV_STAGES) * C::SLOT,
            kb + (t + GV_STAGES - 1) * GV_KT);
    cp_commit();
    const int k0 = kb + t * GV_KT;
    if (k0 + 32 * warp >= ke) continue;   // past the block's share of K

    const unsigned char* slot = smem + (t % GV_STAGES) * C::SLOT;
    int g0;
    groups(k0, g0);
    const int gl = (k0 + 32 * warp) / group - g0;
    const float* sz =
        reinterpret_cast<const float*>(slot + C::W_BYTES + C::X_BYTES);
    uint4 wv[2];
    float s[2], z[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lane + 32 * r;
      wv[r] = *reinterpret_cast<const uint4*>(slot + row * GV_WROW +
                                              16 * warp);
      s[r] = sz[row * GV_SZROW + gl];
      z[r] = sz[row * GV_SZROW + GV_GPT + gl];
    }
    const float* xs =
        reinterpret_cast<const float*>(slot + C::W_BYTES) + 32 * warp;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned e0[2], e1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const unsigned w = word_of(wv[r], q);
        e0[r] = w & 0x0F0F0F0Fu;
        e1[r] = (w >> 4) & 0x0F0F0F0Fu;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // codes k = 8q + 4h .. + 3 of the chunk
        float wf[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          wf[r][0] = deq(e0[r], 2 * h, z[r], s[r]);
          wf[r][1] = deq(e1[r], 2 * h, z[r], s[r]);
          wf[r][2] = deq(e0[r], 2 * h + 1, z[r], s[r]);
          wf[r][3] = deq(e1[r], 2 * h + 1, z[r], s[r]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + m * GV_KT + 8 * q + 4 * h);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            acc[r][m] = fmaf(xv.x, wf[r][0], acc[r][m]);
            acc[r][m] = fmaf(xv.y, wf[r][1], acc[r][m]);
            acc[r][m] = fmaf(xv.z, wf[r][2], acc[r][m]);
            acc[r][m] = fmaf(xv.w, wf[r][3], acc[r][m]);
          }
        }
      }
    }
  }

  // the 8 warps' partial sums in warp order, then the cluster's blocks'
  // in rank order
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [8][MT][GV_COLS]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      red[(warp * MT + m) * GV_COLS + lane + 32 * r] = acc[r][m];
  __syncthreads();
  constexpr int OUTS = MT * GV_COLS;
  for (int o = tid; o < OUTS; o += THREADS) {
    float v = red[o];
#pragma unroll
    for (int w = 1; w < 8; ++w) v = __fadd_rn(v, red[w * OUTS + o]);
    red[o] = v;
  }
  if (split == 1) {
    for (int o = tid; o < OUTS; o += THREADS) {
      const int n = n0 + o % GV_COLS;
      if (n < N) y[(o / GV_COLS) * ldy + n] = red[o];
    }
    return;
  }
  cluster.sync();                      // every block's sums in place
  const int per = OUTS / split;
  for (int o = rank * per + tid; o < (rank + 1) * per; o += THREADS) {
    float v = *cluster.map_shared_rank(red + o, 0);
    for (int q = 1; q < split; ++q)
      v = __fadd_rn(v, *cluster.map_shared_rank(red + o, q));
    const int n = n0 + o % GV_COLS;
    if (n < N) y[(o / GV_COLS) * ldy + n] = v;
  }
  cluster.sync();                      // no block leaves while read
}

// ---------------------------------------------------------- expert GEMV
constexpr int GX_WARPS = 8;
constexpr int GX_THREADS = 32 * GX_WARPS;
constexpr int GX_C = 2;              // columns a lane
constexpr int GX_COLS = 32 * GX_C;   // columns a task, a warp's
constexpr int GX_KS = 256;           // codes a stage: 128 bytes a row
constexpr int GX_PIECES = GX_KS / 32;   // 16-byte pieces a row, a stage
constexpr int GX_ROWS = GX_WARPS * GX_COLS;        // weight rows a block
constexpr int GX_WARP_CODE_BYTES = GX_COLS * GX_KS / 2;
constexpr int GX_WIN = GX_PIECES;    // groups a row's scale window holds
constexpr int GX_WIN_BYTES = 2 * GX_ROWS * GX_WIN * 4;   // scales, zeros
constexpr size_t GX_MAX_SMEM = 232448;   // a block's dynamic shared memory

// A stage: x's k-tile (M, GX_KS) f32, then every warp's 64 rows' codes
// (128 bytes a row, 16-byte pieces swizzled). Two stages, then two
// windows of the rows' scales then zeros, GX_WIN groups a row (a window
// spans group / 32 stages).
__host__ __device__ inline int gemvx_stage_bytes(int M) {
  return 4 * M * GX_KS + GX_WARPS * GX_WARP_CODE_BYTES;
}
__host__ __device__ inline size_t gemvx_smem(int M) {
  return (size_t)2 * gemvx_stage_bytes(M) + 2 * GX_WIN_BYTES;
}

// The work of a launch in rounds of up to 8 tasks (a task: 64 columns of
// one expert over all of K; warp w takes a round's task w). Shared x:
// block b takes the tasks [E·T·b / B, E·T·(b + 1) / B) (T = ⌈N/64⌉ an
// expert) in rounds of 8 from its first; per-expert x: each expert's
// tasks make ⌈T/8⌉ rounds of their own, and block b takes the rounds
// [R·b / B, R·(b + 1) / B), so a round's warps read one x.
struct GxPlan {
  int E, T, per_e, blocks;
  bool shared;
  __host__ __device__ GxPlan(int E_, int N, bool shared_x, int blocks_)
      : E(E_), T((N + GX_COLS - 1) / GX_COLS),
        per_e((T + GX_WARPS - 1) / GX_WARPS), blocks(blocks_),
        shared(shared_x) {}
  __host__ __device__ int units() const {   // tasks (shared) or rounds
    return shared ? E * T : E * per_e;
  }
  // block b's first and last unit and its rounds
  __host__ __device__ int rounds_of(int b, int& u0, int& u1) const {
    const long long u = units();
    u0 = (int)(u * b / blocks);
    u1 = (int)(u * (b + 1) / blocks);
    return shared ? (u1 - u0 + GX_WARPS - 1) / GX_WARPS : u1 - u0;
  }
  // warp w's task in the block's round i: its expert and first column,
  // false if none; xe: the expert whose x the round reads
  __device__ bool task(int u0, int u1, int i, int w, int& e, int& n0,
                       int& xe) const {
    int t;
    if (shared) {
      t = u0 + GX_WARPS * i + w;
      xe = 0;
      if (t >= u1) return false;
    } else {
      const int r = u0 + i;
      xe = r / per_e;
      const int j = (r - xe * per_e) * GX_WARPS + w;
      if (j >= T) return false;
      t = xe * T + j;
    }
    e = t / T;
    n0 = (t - e * T) * GX_COLS;
    return true;
  }
};

// one dequantized code: FAST subtracts 2^23 + zero from 2^23 + code (exact
// for an integer zero, checked by the caller); else the plain three steps
template <bool FAST>
__device__ __forceinline__ float gx_deq(unsigned e, int i, float zb, float z,
                                        float s) {
  const float biased =
      __uint_as_float(__byte_perm(e, 0x4B000000u, 0x7540 | i));
  if constexpr (FAST) return __fmul_rn(__fsub_rn(biased, zb), s);
  return __fmul_rn(__fsub_rn(__fsub_rn(biased, 8388608.0f), z), s);
}

// one 32-code chunk of the lane's GX_C columns into its accumulators:
// column c's codes wv[c], scale s[c], zero z[c], zb[c] = 2^23 + z[c]; xk
// is x's first k of the chunk in shared memory, rows GX_KS apart. One x
// float4 feeds 4·GX_C FMAs.
template <int MT, bool FAST>
__device__ __forceinline__ void gx_chunk(float (&acc)[GX_C][MT],
                                         const uint4 (&wv)[GX_C],
                                         const float (&s)[GX_C],
                                         const float (&z)[GX_C],
                                         const float (&zb)[GX_C],
                                         const float* xk) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned e0[GX_C], e1[GX_C];
#pragma unroll
    for (int c = 0; c < GX_C; ++c) {
      const unsigned w = word_of(wv[c], q);
      e0[c] = w & 0x0F0F0F0Fu;          // codes 8q, +2, +4, +6
      e1[c] = (w >> 4) & 0x0F0F0F0Fu;   // 8q + 1, +3, +5, +7
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // codes 8q + 4hh .. + 3 of the chunk
      float wf[GX_C][4];
#pragma unroll
      for (int c = 0; c < GX_C; ++c) {
        wf[c][0] = gx_deq<FAST>(e0[c], 2 * hh, zb[c], z[c], s[c]);
        wf[c][1] = gx_deq<FAST>(e1[c], 2 * hh, zb[c], z[c], s[c]);
        wf[c][2] = gx_deq<FAST>(e0[c], 2 * hh + 1, zb[c], z[c], s[c]);
        wf[c][3] = gx_deq<FAST>(e1[c], 2 * hh + 1, zb[c], z[c], s[c]);
      }
      const float* xq = xk + 8 * q + 4 * hh;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xq + m * GX_KS);
#pragma unroll
        for (int c = 0; c < GX_C; ++c) {
          acc[c][m] = fmaf(xv.x, wf[c][0], acc[c][m]);
          acc[c][m] = fmaf(xv.y, wf[c][1], acc[c][m]);
          acc[c][m] = fmaf(xv.z, wf[c][2], acc[c][m]);
          acc[c][m] = fmaf(xv.w, wf[c][3], acc[c][m]);
        }
      }
    }
  }
}

// byte offset of row r's 16-byte piece p among a warp's codes: GX_KS / 2
// bytes a row, pieces swizzled so that 8 lanes reading one piece of 8
// rows, and 8 lanes copying consecutive pieces, touch 8 different bank
// groups
__device__ __forceinline__ int gx_piece(int r, int p) {
  return r * (GX_KS / 2) + ((p ^ ((r / (8 / GX_PIECES)) % GX_PIECES)) << 4);
}

template <int MT>
__global__ void __launch_bounds__(GX_THREADS, 1)
dequant_gemvx_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ packed,
                     const float* __restrict__ scale,
                     const float* __restrict__ zero, float* __restrict__ y,
                     int E, int N, int K, int group, long long ldx,
                     long long sx, long long ldy, long long sy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int stage_bytes = gemvx_stage_bytes(MT);
  const int code_off = 4 * MT * GX_KS + warp * GX_WARP_CODE_BYTES;
  // this warp's rows of the windows, [row][GX_WIN] scales; the zeros
  // GX_ROWS · GX_WIN floats after
  float* const windows =
      reinterpret_cast<float*>(smem + 2 * (size_t)stage_bytes) +
      warp * GX_COLS * GX_WIN;
  constexpr int WIN_FLOATS = GX_WIN_BYTES / 4;
  const GxPlan plan(E, N, sx == 0, gridDim.x);
  int u0, u1;
  const int rounds = plan.rounds_of(blockIdx.x, u0, u1);
  const int steps = (K + GX_KS - 1) / GX_KS;
  const int G = K / group;
  const int per_win = group / 32;    // stages a window of GX_WIN groups
  const size_t half_k = (size_t)(K / 2);
  // 16-byte copies of the windows: G % 4 == 0 and both arrays aligned
  const bool sz_vec =
      G % 4 == 0 && ((reinterpret_cast<uintptr_t>(scale) |
                      reinterpret_cast<uintptr_t>(zero)) & 15) == 0;
  // this lane's copies: codes of rows cr + (32 / GX_PIECES)·i, piece cp
  const int cr = lane / GX_PIECES, cp = lane % GX_PIECES;

  // The copier runs one stage ahead of the compute: its round and stage,
  // that round's task for this warp and its x, the windows entered
  int ci = 0, cst = 0, cseq = 0;
  bool clive = false;
  int cn = 0;                          // columns of the task
  const uint8_t* code_src = packed;
  size_t sz_row = 0;                   // this lane's first row's groups
  const float* cx = x;
  auto enter = [&](int i) {
    int e = 0, n0 = 0, xe = 0;
    clive = i < rounds && plan.task(u0, u1, i, warp, e, n0, xe);
    cx = x + (size_t)xe * sx;
    if (!clive) return;
    cn = N - n0;
    const size_t row = (size_t)e * N + n0;
    code_src = packed + (row + cr) * half_k + 16 * cp;
    sz_row = (row + lane) * G;
  };
  // the copies of the copier's stage into slot `b`: x's k-tile by the
  // block, the warp's rows' codes (eight lanes a row's 128 bytes), and on
  // entering a window each lane's rows' GX_WIN scales and zeros
  auto issue = [&](int b) {
    if (ci >= rounds) return;
    unsigned char* slot = smem + (size_t)b * stage_bytes;
    const int k0 = cst * GX_KS;
    for (int i = tid; i < MT * GX_KS / 4; i += GX_THREADS) {
      const int m = i / (GX_KS / 4), c = i % (GX_KS / 4);
      const bool ok = k0 + 4 * c < K;
      cp16(slot + 16 * i, ok ? cx + m * ldx + k0 + 4 * c : x, ok);
    }
    const bool new_win = cst % per_win == 0;
    if (clive) {
      unsigned char* w = slot + code_off;
      const bool kok = k0 + 32 * cp < K;
      constexpr int ROWS_A_COPY = 32 / GX_PIECES;
#pragma unroll
      for (int i = 0; i < GX_COLS / ROWS_A_COPY; ++i) {
        const int r = cr + ROWS_A_COPY * i;
        const bool ok = kok && r < cn;
        cp16(w + gx_piece(r, cp),
             ok ? code_src + (size_t)(ROWS_A_COPY * i) * half_k + k0 / 2
                : packed,
             ok);
      }
      if (new_win) {
        const int g0 = (cst / per_win) * GX_WIN;
        float* ws = windows + (cseq & 1) * WIN_FLOATS + lane * GX_WIN;
#pragma unroll
        for (int c = 0; c < GX_C; ++c) {
          const bool rok = lane + 32 * c < cn;
          const size_t src = sz_row + (size_t)(32 * c) * G + g0;
          float* ds = ws + 32 * c * GX_WIN;
          float* dz = ds + GX_ROWS * GX_WIN;
          if (sz_vec) {
#pragma unroll
            for (int p = 0; p < GX_WIN; p += 4) {
              const bool ok = rok && g0 + p < G;
              cp16(ds + p, ok ? scale + src + p : scale, ok);
              cp16(dz + p, ok ? zero + src + p : zero, ok);
            }
          } else {
#pragma unroll
            for (int p = 0; p < GX_WIN; ++p) {
              const bool ok = rok && g0 + p < G;
              cp4(ds + p, ok ? scale + src + p : scale, ok);
              cp4(dz + p, ok ? zero + src + p : zero, ok);
            }
          }
        }
      }
    }
    if (new_win) ++cseq;
    if (++cst == steps) {
      cst = 0;
      enter(++ci);
    }
  };

  // the stage sequence: the block's rounds, `steps` stages each
  enter(0);
  issue(0);
  cp_commit();
  int b = 0, wseq = 0;
  for (int i = 0; i < rounds; ++i) {
    int e = 0, n0 = 0, xe = 0;
    const bool live = plan.task(u0, u1, i, warp, e, n0, xe);
    float acc[GX_C][MT];
#pragma unroll
    for (int c = 0; c < GX_C; ++c)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[c][m] = 0.0f;
    // the lane's rows' window, the chunk's group in it and the chunks
    // left in that group; the rows' scales, zeros and 2^23 + zeros
    const float* win = windows;
    int gl = -1, left = 0;
    float s[GX_C], z[GX_C], zb[GX_C];
    bool fast = true;
#pragma unroll 1
    for (int st = 0; st < steps; ++st) {
      cp_wait<0>();                      // this thread's copies of the stage
      __syncthreads();                   // everyone's; the other slot free
      issue(b ^ 1);
      cp_commit();
      const unsigned char* slot = smem + (size_t)b * stage_bytes;
      b ^= 1;
      if (st % per_win == 0) {
        win = windows + (wseq++ & 1) * WIN_FLOATS + lane * GX_WIN;
        gl = -1;
        left = 0;
      }
      if (!live) continue;
      const float* xs = reinterpret_cast<const float*>(slot);
      const unsigned char* w = slot + code_off;
      const int chunks = min(GX_KS, K - st * GX_KS) / 32;
      for (int j = 0; j < chunks;) {
        if (left == 0) {
          ++gl;
          left = per_win;
          bool integral = true;
#pragma unroll
          for (int c = 0; c < GX_C; ++c) {
            s[c] = win[32 * c * GX_WIN + gl];
            z[c] = win[(GX_ROWS + 32 * c) * GX_WIN + gl];
            zb[c] = __fadd_rn(z[c], 8388608.0f);
            integral = integral && z[c] == rintf(z[c]) &&
                       fabsf(z[c]) <= 8388608.0f;
          }
          fast = __all_sync(0xffffffffu, integral);
        }
        // the chunks of this group
        const int end = j + min(left, chunks - j);
        left -= end - j;
#pragma unroll 1
        for (; j < end; ++j) {
          uint4 wv[GX_C];
#pragma unroll
          for (int c = 0; c < GX_C; ++c)
            wv[c] = *reinterpret_cast<const uint4*>(
                w + gx_piece(lane + 32 * c, j));
          if (fast)
            gx_chunk<MT, true>(acc, wv, s, z, zb, xs + 32 * j);
          else
            gx_chunk<MT, false>(acc, wv, s, z, zb, xs + 32 * j);
        }
      }
    }
    if (!live) continue;
    float* ye = y + (size_t)e * sy;
#pragma unroll
    for (int c = 0; c < GX_C; ++c) {
      const int n = n0 + lane + 32 * c;
      if (n < N)
#pragma unroll
        for (int m = 0; m < MT; ++m) ye[m * ldy + n] = acc[c][m];
    }
  }
  cp_wait<0>();
}

// Dynamic shared memory attributes, set once per kernel and device
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned long long& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (ready >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ready |= 1ull << dev;
  return err;
}

// The strides of a launch over E experts: x's rows and experts (0: every
// expert reads the same x), y's rows and experts. One expert with x
// (M, K) and y (M, N) contiguous is K4's plain product.
struct Strides {
  int E;
  long long ldx, sx, ldy, sy;
};

template <class C>
int launch_tile(const float* x, const uint8_t* packed, const float* scale,
                const float* zero, float* y, int M, int N, int K, int group,
                Strides st, cudaStream_t stream) {
  static unsigned long long ready = 0;
  cudaError_t err = allow_smem(dequant_gemm_kernel<C>, C::SMEM, ready);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
  dequant_gemm_kernel<C><<<dim3(tiles, st.E), C::NT, C::SMEM, stream>>>(
      x, packed, scale, zero, y, M, N, K, group, st.ldx, st.sx, st.ldy,
      st.sy);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_gemv(const float* x, const uint8_t* packed, const float* scale,
                const float* zero, float* y, int N, int K, int group,
                int split, Strides st, cudaStream_t stream) {
  static unsigned long long ready = 0;
  cudaError_t err = allow_smem(dequant_gemv_kernel<MT>, Gemv<MT>::SMEM, ready);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + GV_COLS - 1) / GV_COLS),
                     (unsigned)split, (unsigned)st.E);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Gemv<MT>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dequant_gemv_kernel<MT>, x, packed, scale,
                           zero, y, N, K, group, split, st.ldx, st.sx, st.ldy,
                           st.sy);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// tile variant index (kernels/ops.py, DEQUANT_TILES): 128 × 128, 64 × 128,
// 64 × 64 (256 threads), 32 × 32 (64 threads)
template <bool VEC> using V0 = Tile<4, 2, 2, 2, VEC>;
template <bool VEC> using V1 = Tile<4, 2, 1, 2, VEC>;
template <bool VEC> using V2 = Tile<4, 2, 1, 1, VEC>;
template <bool VEC> using V3 = Tile<2, 1, 1, 1, VEC>;

template <bool VEC>
int launch_tile_variant(int variant, const float* x, const uint8_t* packed,
                        const float* scale, const float* zero, float* y,
                        int M, int N, int K, int group, Strides st,
                        cudaStream_t s) {
  switch (variant) {
    case 0: return launch_tile<V0<VEC>>(x, packed, scale, zero, y, M, N, K,
                                        group, st, s);
    case 1: return launch_tile<V1<VEC>>(x, packed, scale, zero, y, M, N, K,
                                        group, st, s);
    case 2: return launch_tile<V2<VEC>>(x, packed, scale, zero, y, M, N, K,
                                        group, st, s);
    case 3: return launch_tile<V3<VEC>>(x, packed, scale, zero, y, M, N, K,
                                        group, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int MT>
int launch_gemvx(const float* x, const uint8_t* packed, const float* scale,
                 const float* zero, float* y, int N, int K, int group,
                 Strides st, cudaStream_t stream) {
  static unsigned long long ready = 0;
  static int sms[64] = {};           // SMs of each device, read once
  const size_t smem = gemvx_smem(MT);
  const GxPlan whole(st.E, N, st.sx == 0, 1);
  if (smem > GX_MAX_SMEM || group % 32 ||
      (long long)st.E * whole.T >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dequant_gemvx_kernel<MT>, GX_MAX_SMEM, ready);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) sms[dev] = n_sm;
  }
  // one block an SM, no more than there are tasks (shared x) or rounds
  const int blocks = whole.units() < n_sm ? whole.units() : n_sm;
  dequant_gemvx_kernel<MT><<<blocks, GX_THREADS, smem, stream>>>(
      x, packed, scale, zero, y, st.E, N, K, group, st.ldx, st.sx, st.ldy,
      st.sy);
  return (int)cudaGetLastError();
}

constexpr int TILE_VARIANTS = 4;
constexpr int SPLITS[] = {1, 2, 4, 8};
constexpr int NUM_SPLITS = 4;
constexpr int GEMVX_VARIANT = TILE_VARIANTS + NUM_SPLITS;

}  // namespace

// Dynamic shared memory in bytes of a variant's kernel at M rows (the
// GEMV's and the expert GEMV's depend on M), -1 if unknown.
extern "C" int dequant_matmul_smem_bytes(int variant, int M) {
  switch (variant) {
    case 0: return (int)V0<true>::SMEM;
    case 1: return (int)V1<true>::SMEM;
    case 2: return (int)V2<true>::SMEM;
    case 3: return (int)V3<true>::SMEM;
    default: break;
  }
  if (variant == GEMVX_VARIANT && M >= 1 && M <= 8)
    return (int)gemvx_smem(M);
  if (variant >= TILE_VARIANTS + NUM_SPLITS || M < 1 || M > 8) return -1;
  switch (M) {
    case 1: return (int)Gemv<1>::SMEM;
    case 2: return (int)Gemv<2>::SMEM;
    case 3: return (int)Gemv<3>::SMEM;
    case 4: return (int)Gemv<4>::SMEM;
    case 5: return (int)Gemv<5>::SMEM;
    case 6: return (int)Gemv<6>::SMEM;
    case 7: return (int)Gemv<7>::SMEM;
    default: return (int)Gemv<8>::SMEM;
  }
}

// K4x: for each of E experts, y_e (M, N) = x_e (M, K) · dequant(W_e)ᵀ
// with W stacked (E, N, K/2) uint8 and scale, zero (E, N, K/group) f32,
// contiguous. x_e's row m is x + e·sx + m·ldx (sx = 0: one x for every
// expert), y_e's row m is y + e·sy + m·ldy, rows contiguous. K even, K %
// group == 0. variant: 0..3 a tile (kernels/ops.py, DEQUANT_TILES), 4..7
// the GEMV with K split over a cluster of DEQUANT_SPLITS[variant − 4]
// blocks (M <= 8, vec, K % (32 · split) == 0), 8 the expert GEMV (M <= 8,
// vec; sx == 0 takes x as shared by every expert). vec: K % 32 == 0,
// group % 32 == 0, N
// % 4 == 0, x and packed 16-byte aligned and ldx, sx, ldy, sy multiples of
// 4 (else the tile's scalar-copy instantiation). Experts run on the grid's
// y (tile) or z (GEMV) axis, or in the expert GEMV's tasks: one launch
// for the stack. Returns
// cudaGetLastError(), or the error of a refused attribute or launch.
extern "C" int dequant_matmul_experts_f32(
    const float* x, const uint8_t* packed, const float* scale,
    const float* zero, float* y, int E, int M, int N, int K, int group,
    long long ldx, long long sx, long long ldy, long long sy, int variant,
    int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E < 1 || E > 65535) return (int)cudaErrorInvalidValue;
  const Strides st = {E, ldx, sx, ldy, sy};
  if (variant < TILE_VARIANTS)
    return vec ? launch_tile_variant<true>(variant, x, packed, scale, zero, y,
                                           M, N, K, group, st, s)
               : launch_tile_variant<false>(variant, x, packed, scale, zero,
                                            y, M, N, K, group, st, s);
  if (variant == GEMVX_VARIANT) {
    if (!vec || M < 1 || M > 8) return (int)cudaErrorInvalidValue;
    switch (M) {
      case 1: return launch_gemvx<1>(x, packed, scale, zero, y, N, K, group, st, s);
      case 2: return launch_gemvx<2>(x, packed, scale, zero, y, N, K, group, st, s);
      case 3: return launch_gemvx<3>(x, packed, scale, zero, y, N, K, group, st, s);
      case 4: return launch_gemvx<4>(x, packed, scale, zero, y, N, K, group, st, s);
      case 5: return launch_gemvx<5>(x, packed, scale, zero, y, N, K, group, st, s);
      case 6: return launch_gemvx<6>(x, packed, scale, zero, y, N, K, group, st, s);
      case 7: return launch_gemvx<7>(x, packed, scale, zero, y, N, K, group, st, s);
      default: return launch_gemvx<8>(x, packed, scale, zero, y, N, K, group, st, s);
    }
  }
  const int vi = variant - TILE_VARIANTS;
  if (vi >= NUM_SPLITS || !vec || M < 1 || M > 8 ||
      K % (32 * SPLITS[vi]) != 0)
    return (int)cudaErrorInvalidValue;
  const int sp = SPLITS[vi];
  switch (M) {
    case 1: return launch_gemv<1>(x, packed, scale, zero, y, N, K, group, sp, st, s);
    case 2: return launch_gemv<2>(x, packed, scale, zero, y, N, K, group, sp, st, s);
    case 3: return launch_gemv<3>(x, packed, scale, zero, y, N, K, group, sp, st, s);
    case 4: return launch_gemv<4>(x, packed, scale, zero, y, N, K, group, sp, st, s);
    case 5: return launch_gemv<5>(x, packed, scale, zero, y, N, K, group, sp, st, s);
    case 6: return launch_gemv<6>(x, packed, scale, zero, y, N, K, group, sp, st, s);
    case 7: return launch_gemv<7>(x, packed, scale, zero, y, N, K, group, sp, st, s);
    default: return launch_gemv<8>(x, packed, scale, zero, y, N, K, group, sp, st, s);
  }
}

// K4: x: (M, K) f32; packed: (N, K/2) uint8; scale, zero: (N, K/group)
// f32; y: (M, N) f32. Contiguous, on the device: K4x's one expert, with
// its variants and conditions.
extern "C" int dequant_matmul_f32(const float* x, const uint8_t* packed,
                                  const float* scale, const float* zero,
                                  float* y, int M, int N, int K, int group,
                                  int variant, int vec, void* stream) {
  return dequant_matmul_experts_f32(x, packed, scale, zero, y, 1, M, N, K,
                                    group, K, 0, N, 0, variant, vec, stream);
}
