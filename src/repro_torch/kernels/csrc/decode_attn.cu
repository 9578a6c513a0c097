// K6 and K6p: flash-decode attention over the serving KV cache. One query
// token per row b attends that row's cache history [0, lengths[b]):
//   out (B, H, D) = softmax(q · Kᵀ / √D) · V
// with grouped-query heads (head h reads KV head h / g, g = H / Hk).
//
// - K6, slot layout (entry decode_attn): K and V are (B, T, Hk, D) f32 or
//   bf16, or INT8 codes with per-(token, head, group) f16 scale and zero
//   planes (B, T, Hk, D/group), expanded inside the tile.
// - K6p, paged layout (entry decode_attn_paged): K and V are one layer's
//   page pools (P, page, Hk, D) of the same kinds (planes (P, page, Hk,
//   D/group)), routed through a block table (B, n_pages) int32 in device
//   memory. Position t of row b lives at page table[b, t / page], clipped
//   to [0, P − 1] (the sentinel entry P clips to P − 1 and is never read:
//   it lies past the row's length), offset t % page. The row attends
//   [0, min(lengths[b], n_pages·page)).
//
// Replaces: src/repro/kernels/decode_attn.py, flash_decode (pallas_call at
// :225), slot layout (K6) and paged layout with `table` (K6p, :163-185).
//
// Bound on an H100: memory. Each live token's K and V rows are read once
// (2·Hk·D·elem bytes a token, plus 8·Hk·D/group for the INT8 planes) at
// 3.35 TB/s; 4·H·D operations a token are far below the compute roof.
// Tokens at or past a row's length are never loaded.
//
// Design: one block per (row b, KV head), serving its g query heads, so
// each K/V tile is read from device memory once per group. The block walks
// the row's tiles of block_t tokens only up to lengths[b]; each tile is
// staged through shared memory in sub-tiles of 64 tokens (rows padded to
// D + 1 floats, so neither the score loop nor the P·V loop has bank
// conflicts). Per tile, as the TPU kernel:
//   s = (q · k) · (1/√D);  m_new = max(m, max s);  p = exp(s − m_new)
//   corr = exp(m − m_new);  l = l·corr + Σp;  acc = acc·corr + p · V
// from the finite start m = −1e30, with the products and sums of the
// carries rounded separately as the reference rounds them. INT8 values are
// (code − zero)·scale, rounded as K5 rounds them. The emit guard is the
// reference's: l == 0 exactly (a length-0 row) gives zeros, and a NaN l
// (poisoned cache rows) reaches the output, which the engine's
// non-finite-logit guard relies on. The lengths stay in device memory.
//
// K6p is the same body with page addressing in the stage function (the
// PAGED template flag): each staged token reads its page index from the
// row's table (L1-cached) and loads its K or V row from that page. The
// reference's paged tile is one page (16 tokens at the default page size);
// here a tile is block_t tokens (256 by default: 16 pages), staged 64
// tokens at a time, as on the slot layout, so the online softmax carries
// once per 256 tokens and the two layouts give the same bits on the same
// tokens. Pages past ceil(len / page) are never read.
//
// One block per (b, KV head) is B·Hk blocks: 64 at B = 8, Hk = 8, half of
// the 132 SMs. A split over T (flash-decoding) is left to a later change.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 64;          // tokens staged in shared memory at once
constexpr int MAX_G = 32;        // query heads per KV head
constexpr int MAX_ACC = 4;       // (head, d) outputs a thread owns: g·D ≤ 1024
constexpr float NEG_INIT = -1e30f;

enum KvKind { KV_F32 = 0, KV_BF16 = 1, KV_U8 = 2 };

// Four consecutive values of one (token, head) row starting at element e
// (e % 4 == 0) as floats; ge is the group index of element e.
template <int KIND>
__device__ __forceinline__ float4 load4(const void* base, const __half* sc,
                                        const __half* zp, size_t e,
                                        size_t ge) {
  float4 o;
  if constexpr (KIND == KV_F32) {
    o = reinterpret_cast<const float4*>(base)[e / 4];
  } else if constexpr (KIND == KV_BF16) {
    const uint2 raw = reinterpret_cast<const uint2*>(base)[e / 4];
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    o.x = __low2float(lo);
    o.y = __high2float(lo);
    o.z = __low2float(hi);
    o.w = __high2float(hi);
  } else {
    const uchar4 c = reinterpret_cast<const uchar4*>(base)[e / 4];
    const float s = __half2float(sc[ge]);
    const float z = __half2float(zp[ge]);
    o.x = __fmul_rn(__fsub_rn((float)c.x, z), s);
    o.y = __fmul_rn(__fsub_rn((float)c.y, z), s);
    o.z = __fmul_rn(__fsub_rn((float)c.z, z), s);
    o.w = __fmul_rn(__fsub_rn((float)c.w, z), s);
  }
  return o;
}

// Stage tokens [tok0, tok0 + n) of row b, KV head hk into dst (SUB rows of
// D + 1 floats). Slot layout: row b's T positions. Paged layout: position
// p lives at page tbl[p / page] (row b's table entries, clipped to
// [0, P − 1]), offset p % page.
template <int KIND, bool PAGED>
__device__ __forceinline__ void stage(float* dst, const void* src,
                                      const __half* sc, const __half* zp,
                                      const int* tbl, int b, int hk,
                                      int tok0, int n, int T, int P,
                                      int page, int Hk, int D, int group) {
  const int q4 = D / 4;
  const int dg = KIND == KV_U8 ? D / group : 1;
  for (int i = threadIdx.x; i < n * q4; i += THREADS) {
    const int t = i / q4;
    const int d = (i - t * q4) * 4;
    size_t row;
    if constexpr (PAGED) {
      const int pos = tok0 + t;
      const int pi = pos / page;
      const int pg = min(max(__ldg(tbl + pi), 0), P - 1);
      row = ((size_t)pg * page + (pos - pi * page)) * Hk + hk;
    } else {
      row = ((size_t)b * T + tok0 + t) * Hk + hk;
    }
    const size_t ge = KIND == KV_U8 ? row * dg + d / group : 0;
    const float4 x = load4<KIND>(src, sc, zp, row * D + d, ge);
    float* out = dst + t * (D + 1) + d;
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
}

template <int KIND, bool PAGED>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const float* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v,
                   const int* __restrict__ lengths,
                   const int* __restrict__ table,
                   const __half* __restrict__ ks,
                   const __half* __restrict__ kz,
                   const __half* __restrict__ vs,
                   const __half* __restrict__ vz, float* __restrict__ out,
                   int T, int n_pages, int P, int page, int H, int Hk, int D,
                   int group, int bt, float sm_scale) {
  extern __shared__ float smem[];
  __shared__ float m_sh[MAX_G], l_sh[MAX_G], corr_sh[MAX_G];
  const int b = blockIdx.x / Hk;
  const int hk = blockIdx.x - b * Hk;
  const int G = H / Hk;
  const int GD = G * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* q_s = smem;                  // G·D
  float* s_s = q_s + GD;              // G·bt scores, then probabilities
  float* kv_s = s_s + G * bt;         // SUB·(D + 1)

  const int* tbl = PAGED ? table + (size_t)b * n_pages : nullptr;
  const int len = min(max(lengths[b], 0), T);
  const float* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  for (int i = tid; i < GD; i += THREADS) q_s[i] = qb[i];
  if (tid < G) {
    m_sh[tid] = NEG_INIT;
    l_sh[tid] = 0.0f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) acc[j] = 0.0f;
  __syncthreads();

  for (int start = 0; start < len; start += bt) {
    const int n = min(bt, len - start);
    // scores of the tile's live tokens
    for (int s0 = 0; s0 < n; s0 += SUB) {
      const int ns = min(SUB, n - s0);
      stage<KIND, PAGED>(kv_s, k, ks, kz, tbl, b, hk, start + s0, ns, T, P,
                         page, Hk, D, group);
      __syncthreads();
      for (int i = tid; i < G * SUB; i += THREADS) {
        const int gi = i / SUB;
        const int t = i - gi * SUB;
        if (t < ns) {
          const float* qr = q_s + gi * D;
          const float* kr = kv_s + t * (D + 1);
          float dot = 0.0f;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          s_s[gi * bt + s0 + t] = __fmul_rn(dot, sm_scale);
        }
      }
      __syncthreads();
    }
    // online-softmax statistics: one warp per query head
    for (int gi = warp; gi < G; gi += WARPS) {
      float* sr = s_s + gi * bt;
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_sh[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(__fsub_rn(sr[t], m_new));
        sr[t] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      if (lane == 0) {
        const float corr = expf(__fsub_rn(m_prev, m_new));
        corr_sh[gi] = corr;
        l_sh[gi] = __fadd_rn(__fmul_rn(l_sh[gi], corr), sum);
        m_sh[gi] = m_new;
      }
    }
    __syncthreads();
    // P · V of the tile
    float pv[MAX_ACC];
#pragma unroll
    for (int j = 0; j < MAX_ACC; ++j) pv[j] = 0.0f;
    for (int s0 = 0; s0 < n; s0 += SUB) {
      const int ns = min(SUB, n - s0);
      stage<KIND, PAGED>(kv_s, v, vs, vz, tbl, b, hk, start + s0, ns, T, P,
                         page, Hk, D, group);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < MAX_ACC; ++j) {
        const int i = tid + j * THREADS;
        if (i < GD) {
          const int gi = i / D;
          const int d = i - gi * D;
          const float* pr = s_s + gi * bt + s0;
          float a = pv[j];
          for (int t = 0; t < ns; ++t) a = fmaf(pr[t], kv_s[t * (D + 1) + d], a);
          pv[j] = a;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < MAX_ACC; ++j) {
      const int i = tid + j * THREADS;
      if (i < GD)
        acc[j] = __fadd_rn(__fmul_rn(acc[j], corr_sh[i / D]), pv[j]);
    }
    // the next tile's first __syncthreads orders these corr_sh reads
    // before the statistics pass rewrites corr_sh
  }

  float* ob = out + ((size_t)b * H + (size_t)hk * G) * D;
#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) {
    const int i = tid + j * THREADS;
    if (i < GD) {
      const float l = l_sh[i / D];
      ob[i] = (l == 0.0f) ? 0.0f : __fdiv_rn(acc[j], l);
    }
  }
}

template <int KIND, bool PAGED>
int launch(const float* q, const void* k, const void* v, const int* lengths,
           const int* table, const void* ks, const void* kz, const void* vs,
           const void* vz, float* out, int B, int T, int n_pages, int P,
           int page, int H, int Hk, int D, int group, int bt,
           cudaStream_t stream) {
  const int G = H / Hk;
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)G * bt +
                                       (size_t)SUB * (D + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<KIND, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  decode_attn_kernel<KIND, PAGED><<<B * Hk, THREADS, smem, stream>>>(
      q, k, v, lengths, table, reinterpret_cast<const __half*>(ks),
      reinterpret_cast<const __half*>(kz), reinterpret_cast<const __half*>(vs),
      reinterpret_cast<const __half*>(vz), out, T, n_pages, P, page, H, Hk, D,
      group, bt, sm_scale);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int dispatch(int kind, const float* q, const void* k, const void* v,
             const int* lengths, const int* table, const void* ks,
             const void* kz, const void* vs, const void* vz, float* out,
             int B, int T, int n_pages, int P, int page, int H, int Hk, int D,
             int group, int bt, cudaStream_t s) {
  switch (kind) {
    case KV_F32:
      return launch<KV_F32, PAGED>(q, k, v, lengths, table, ks, kz, vs, vz,
                                   out, B, T, n_pages, P, page, H, Hk, D,
                                   group, bt, s);
    case KV_BF16:
      return launch<KV_BF16, PAGED>(q, k, v, lengths, table, ks, kz, vs, vz,
                                    out, B, T, n_pages, P, page, H, Hk, D,
                                    group, bt, s);
    case KV_U8:
      return launch<KV_U8, PAGED>(q, k, v, lengths, table, ks, kz, vs, vz,
                                  out, B, T, n_pages, P, page, H, Hk, D,
                                  group, bt, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K6. q (B, H, D) f32; k, v (B, T, Hk, D) of kind 0 (f32), 1 (bf16) or 2
// (uint8 codes, with k/v scale and zero (B, T, Hk, D/group) f16; null
// otherwise); lengths (B,) int32; out (B, H, D) f32. All contiguous on the
// device, k and v 16-byte aligned; D % 4 == 0, H % Hk == 0,
// H/Hk ≤ 32, (H/Hk)·D ≤ 1024, 1 ≤ bt ≤ T. Returns cudaGetLastError().
extern "C" int decode_attn(const float* q, const void* k, const void* v,
                           const int* lengths, const void* k_scale,
                           const void* k_zero, const void* v_scale,
                           const void* v_zero, float* out, int B, int T,
                           int H, int Hk, int D, int group, int bt, int kind,
                           void* stream) {
  return dispatch<false>(kind, q, k, v, lengths, nullptr, k_scale, k_zero,
                         v_scale, v_zero, out, B, T, 0, 0, 1, H, Hk, D,
                         group, bt, (cudaStream_t)stream);
}

// K6p. k, v are one layer's pools (P, page, Hk, D) of the same kinds (INT8
// planes (P, page, Hk, D/group)); table (B, n_pages) int32, entries
// clipped to [0, P − 1]; row b attends [0, min(lengths[b], n_pages·page)).
// The other operands and limits are K6's, with 1 ≤ bt ≤ n_pages·page.
extern "C" int decode_attn_paged(const float* q, const void* k,
                                 const void* v, const int* table,
                                 const int* lengths, const void* k_scale,
                                 const void* k_zero, const void* v_scale,
                                 const void* v_zero, float* out, int B,
                                 int P, int page, int n_pages, int H, int Hk,
                                 int D, int group, int bt, int kind,
                                 void* stream) {
  return dispatch<true>(kind, q, k, v, lengths, table, k_scale, k_zero,
                        v_scale, v_zero, out, B, n_pages * page, n_pages, P,
                        page, H, Hk, D, group, bt, (cudaStream_t)stream);
}
