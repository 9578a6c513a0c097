// K6 and K6p: flash-decode attention over the serving KV cache. One query
// token per row b attends that row's cache history [0, lengths[b]):
//   out (B, H, D) = softmax(q · Kᵀ / √D) · V
// with grouped-query heads (head h reads KV head h / g, g = H / Hk).
//
// - K6, slot layout (entry decode_attn): K and V are (B, T, Hk, D) f32 or
//   bf16, or INT8 codes with per-(token, head, group) f16 scale and zero
//   planes (B, T, Hk, D/group), expanded by the consumer.
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
// Design: split each row over its tokens (flash-decoding). The wrapper's
// plan (ops.decode_attn_splits, from host-known sizes only: B, Hk, T and
// block_t) cuts [0, T) into `splits` chunks of `chunk` tokens; the grid is
// (B·Hk) × splits blocks of 8 warps, one per (row b, KV head, chunk),
// serving the KV head's g query heads. A block whose chunk starts at or
// past its row's length loads nothing and exits (its partial would be the
// empty one, m = −1e30, l = 0, acc = 0, which adds exact zeros).
//
// Inside a block the chunk is cut into pieces of `pt` tokens (32 for INT8
// and bf16 at D ≤ 64, fewer for wide rows: at most 8 KB of K, V and planes
// a piece); warp w takes pieces w, w + 8, ... Each warp streams its pieces
// through a private ring of 1 or 2 shared-memory slots with 4-, 8- or
// 16-byte cp.async copies (two when a warp has more than one piece: the
// next piece is in flight while the current one is scored), so a warp
// waits on nothing but its own copies and __syncwarp(): one block barrier
// in all, at the end. K6p reads each page index of a piece once (one lane
// a page) and hands it to the piece's tokens by shuffle; the index is
// clipped to [0, P − 1]. INT8 scale and zero planes are copied once per
// (token, head, group). Rows in shared memory are padded to an odd number
// of 16-byte units (lt mod 2·lt units when lt lanes share a token) so the
// score loads have no bank conflicts.
//
// Per piece, in IEEE f32 (no fast math), with m, l, acc the warp's carry:
// - scores: one lane per token (lt lanes when a piece has 32/lt tokens),
//   the token's row dequantized once in registers — INT8 values are
//   (code − zero)·scale, each op rounded as K5 rounds it, with each
//   token's V scale and zero turned to floats once for P·V — and dotted
//   with the query rows (shared memory, broadcast, zero past D) for 4 or
//   8 heads at a time:
//   s = (q · k)·(1/√D), one fmaf chain over d (the lt lanes' chains then
//   summed by a fixed xor butterfly);
// - statistics, the heads side by side: m_new = max(m, max s) (fmaxf: a
//   NaN score drops out of m and poisons p, l and acc instead),
//   p = exp(s − m_new), corr = exp(m − m_new), l = l·corr + Σp (xor
//   butterfly over the tokens);
// - P·V: each lane owns 4 dims of every head (a generic form for D > 128
//   or g > 4: a few (head, 4-dim) outputs, 16 registers of 4 floats a
//   lane, or 32 where 16 cannot hold a lane's outputs — nemotron-4-340b's
//   g = 12 at D = 192 takes 24 — so every head shape of the arch configs
//   runs in one block a (row, KV head, chunk)) and ts token lanes share
//   the piece; acc = acc·corr, then one fmaf chain over the lane's
//   tokens; the ts partials are summed by a xor butterfly at the end.
// The 8 warps' carries then merge in warp order, and the block's partial
// (m, l, acc) goes to the workspace; a merge pass launched from the same
// entry (only when splits > 1; a row with one live split is emitted by its
// block, as with one split in all; launched as a programmatic dependent,
// so it is scheduled while the split pass drains and waits for it)
// combines the row's live splits in split order, with no atomics:
//   m = max m_s;  l = Σ l_s·exp(m_s − m);  acc = Σ acc_s·exp(m_s − m)
//   out = l == 0 ? 0 : acc / l
// each product and sum rounded separately. A length-0 row gives exact
// zeros; a NaN in a row's cache reaches l and acc of that KV head's query
// heads, and only those. K6p is the same body with page addressing in the
// copy; both layouts run the same plan at the same token positions, so
// they give the same bits on the same tokens at any page size. The
// lengths and the table stay in device memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_MAX = 8 * 1024;    // bytes of K, V and planes a piece
constexpr float NEG_INIT = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

enum KvKind { KV_F32 = 0, KV_BF16 = 1, KV_U8 = 2 };

struct Params {
  const float* q;
  const unsigned char* k;
  const unsigned char* v;
  const int* lengths;
  const int* table;
  const __half* pl[4];       // k scale, k zero, v scale, v zero (INT8)
  float* out;
  float* ws;                 // (B·Hk, splits, 2g + g·D) partials
  int T, n_pages, P, page, H, Hk, D, G, group, dg, chunk, splits;
  float sm_scale;
  // the piece: row bytes, padded row stride, 16-byte units a row, copy
  // unit and copies a row, plane words a (token, plane), tokens a piece,
  // log2 of the lanes a token, bytes a ring slot
  int rb, rbs, nch, cu, upr, pw, pt, lt_sh, stage;
  int nstage;                // ring slots a warp (1 or 2)
  int planes4;               // planes 4-byte aligned: cp.async copies
  int qpg, qpg_sh;           // quads a group, its log2 (or −1)
  int one_group;             // every 16-code chunk inside one group
  int ps;                    // heads a row of p, m, l (g rounded up)
  int qs;                    // floats a row of q in shared memory (whole
                             // 16-byte chunks of K, zero past D)
  // P·V lanes: log2 of the dim lanes and head lanes, token lanes, dims
  // and heads a lane, accumulators a lane (nd·nh)
  int nl_sh, hs_sh, ts, nd, nh, na;
  // shared memory: q, rings (then the warps' acc), parities, p, m/l/corr
  int off_ring, off_par, off_p, off_stat, off_vsz, smem;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int CU>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if constexpr (CU == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(CU), "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ((float)code − zero)·scale for the 4 codes of c, each op rounded as K5
// rounds it (g: scale, zero): __byte_perm builds the float bits of
// 2^23 + code, and subtracting 2^23 is exact
__device__ __forceinline__ float4 dq4(unsigned c, const float2& g) {
  float o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float f = __fsub_rn(
        __uint_as_float(__byte_perm(c, 0x4B000000u, 0x7540 | i)),
        8388608.0f);
    o[i] = __fmul_rn(__fsub_rn(f, g.y), g.x);
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

// quad qd (4 values) of a 16-byte chunk as floats (g: INT8's group)
template <int KIND>
__device__ __forceinline__ float4 chunk_quad(const uint4& r, int qd,
                                             const float2& g) {
  float4 o;
  if constexpr (KIND == KV_F32) {
    o = make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                    __uint_as_float(r.z), __uint_as_float(r.w));
  } else if constexpr (KIND == KV_BF16) {
    const unsigned a = qd == 0 ? r.x : r.z;
    const unsigned b = qd == 0 ? r.y : r.w;
    o = make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                    __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
  } else {
    o = dq4(qd == 0 ? r.x : qd == 1 ? r.y : qd == 2 ? r.z : r.w, g);
  }
  return o;
}

// one quad at p (16-byte f32, 8-byte bf16 or 4-byte INT8 aligned)
template <int KIND>
__device__ __forceinline__ float4 load_quad(const unsigned char* p,
                                            const float2& g) {
  if constexpr (KIND == KV_F32) {
    return *reinterpret_cast<const float4*>(p);
  } else if constexpr (KIND == KV_BF16) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  } else {
    return dq4(*reinterpret_cast<const unsigned*>(p), g);
  }
}

__device__ __forceinline__ int group_of(const Params& p, int quad) {
  return p.qpg_sh >= 0 ? quad >> p.qpg_sh : quad / p.qpg;
}

// Copy the units u = part, part + lt, ... of one row into smem
template <int CU>
__device__ __forceinline__ void copy_row(unsigned char* dst,
                                         const unsigned char* src, int upr,
                                         int part, int lt) {
  for (int u = part; u < upr; u += lt) cp_async<CU>(dst + u * CU, src + u * CU, CU);
}

// Issue the copies of the piece [p0, p0 + n) into ring slot `slot`: the
// lt lanes of token lane >> lt_sh copy its K and V rows and (INT8) its four
// plane rows; `tv` is this lane's table entry for K6p (lane j: the
// piece's j-th page) and `par` receives each token's plane parity.
template <int KIND, bool PAGED>
__device__ __forceinline__ void issue(const Params& p, unsigned char* slot,
                                      int* par, int b, int hk, int p0, int n,
                                      int tv, int lane) {
  const int lt = 1 << p.lt_sh;
  const int tl = lane >> p.lt_sh;
  const int part = lane & (lt - 1);
  const int pos = p0 + min(tl, n - 1);
  size_t row;
  if constexpr (PAGED) {
    const int first = p0 / p.page;
    const int pi = pos / p.page;
    const int pg = __shfl_sync(FULL, tv, pi - first);
    row = ((size_t)pg * p.page + (pos - pi * p.page)) * p.Hk + hk;
  } else {
    row = ((size_t)b * p.T + pos) * p.Hk + hk;
  }
  if (tl >= n) return;
  unsigned char* kd = slot + tl * p.rbs;
  unsigned char* vd = slot + (p.pt + tl) * p.rbs;
  const unsigned char* ks = p.k + row * p.rb;
  const unsigned char* vs = p.v + row * p.rb;
  if (p.cu == 16) {
    copy_row<16>(kd, ks, p.upr, part, lt);
    copy_row<16>(vd, vs, p.upr, part, lt);
  } else if (p.cu == 8) {
    copy_row<8>(kd, ks, p.upr, part, lt);
    copy_row<8>(vd, vs, p.upr, part, lt);
  } else {
    copy_row<4>(kd, ks, p.upr, part, lt);
    copy_row<4>(vd, vs, p.upr, part, lt);
  }
  if constexpr (KIND == KV_U8) {
    // plane row e .. e + dg − 1 (halves): 4-byte words w0 .. wl, the last
    // one cut to 2 bytes when the row ends inside it; halves land at
    // parity e & 1 of the slot
    unsigned char* pd = slot + 2 * p.pt * p.rbs + tl * 16 * p.pw;
    const size_t e = row * p.dg;
    if (p.planes4) {
      const size_t w0 = e >> 1, wl = (e + p.dg - 1) >> 1;
      const int tail = (int)((e + p.dg) & 1);
      for (int a = 0; a < 4; ++a) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(p.pl[a]);
        for (int w = part; w < p.pw; w += lt) {
          const size_t wk = w0 + w;
          if (wk <= wl)
            cp_async<4>(pd + (a * p.pw + w) * 4, src + 4 * wk,
                        (wk == wl && tail) ? 2 : 4);
        }
      }
      if (part == 0) par[tl] = (int)(e & 1);
    } else {
      for (int a = 0; a < 4; ++a) {
        __half* hd = reinterpret_cast<__half*>(pd + a * p.pw * 4);
        for (int j = part; j < p.dg; j += lt) hd[j] = p.pl[a][e + j];
      }
      if (part == 0) par[tl] = 0;
    }
  }
}

// This lane's table entry for the piece starting at p0 (lane j: the
// piece's j-th page, clipped to [0, P − 1]); 0 for lanes past its pages.
__device__ __forceinline__ int table_lane(const Params& p, int b, int p0,
                                          int n, int lane) {
  const int first = p0 / p.page;
  const int last = (p0 + n - 1) / p.page;
  if (lane > last - first) return 0;
  const int e = __ldg(p.table + (size_t)b * p.n_pages + first + lane);
  return min(max(e, 0), p.P - 1);
}

// NH > 0: the fast form, NH heads a lane; NH < 0: the generic form with
// −NH (head, 4-dim) accumulators a lane.
template <int KIND, bool PAGED, int GH, int NH>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bh / p.Hk;
  const int hk = bh - b * p.Hk;
  const int G = p.G, D = p.D, D4 = D / 4, PS = p.ps;
  const int len = min(max(p.lengths[b], 0), p.T);
  const int c0 = split * p.chunk;
  // the merge pass may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ob = p.out + ((size_t)b * p.H + (size_t)hk * G) * D;
  if (c0 >= len) {                     // an empty split: nothing to load
    if (p.splits == 1)
      for (int i = tid; i < G * D; i += THREADS) ob[i] = 0.0f;
    return;
  }
  // a row with one live split is emitted here, as with one split in all
  // (the merge pass skips it: merging one partial gives the same bits)
  const bool emit = p.splits == 1 || len <= p.chunk;
  const int c1 = min(c0 + p.chunk, len);

  // q (PS rows of qs floats, zero past G and D), then per warp: ring,
  // parities, p, m/l/corr, and (INT8) each token's V scale and zero
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + p.off_ring + warp * p.nstage * p.stage;
  int* par_w = reinterpret_cast<int*>(smem + p.off_par) + warp * 2 * p.pt;
  float* p_w = reinterpret_cast<float*>(smem + p.off_p) + warp * p.pt * PS;
  float* st_m = reinterpret_cast<float*>(smem + p.off_stat) + warp * 3 * PS;
  float* st_l = st_m + PS;
  float* st_c = st_l + PS;
  float2* vsz = reinterpret_cast<float2*>(smem + p.off_vsz) +
                warp * p.pt * p.dg;

  const int pieces = (c1 - c0 + p.pt - 1) / p.pt;
  const int mine = pieces > warp ? (pieces - warp + WARPS - 1) / WARPS : 0;
  const int lt = 1 << p.lt_sh;
  const int tl = lane >> p.lt_sh;
  const int part = lane & (lt - 1);
  constexpr int QPC = KIND == KV_U8 ? 4 : KIND == KV_BF16 ? 2 : 1;
  constexpr int QB = KIND == KV_U8 ? 4 : KIND == KV_BF16 ? 8 : 16;
  constexpr int NA = NH > 0 ? NH : -NH;
  // P·V lanes: dim lane dl, head lane hsl, token lane tsl
  const int dl = lane & ((1 << p.nl_sh) - 1);
  const int hsl = (lane >> p.nl_sh) & ((1 << p.hs_sh) - 1);
  const int tsl = lane >> (p.nl_sh + p.hs_sh);

  float4 acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);

  auto start_of = [&](int i) { return c0 + (warp + WARPS * i) * p.pt; };
  auto count_of = [&](int i) { return min(p.pt, c1 - start_of(i)); };

  // prologue: the warp's first nstage pieces in flight, one copy group
  // each (empty past the warp's pieces), so piece i's group is always
  // nstage − 1 groups behind the newest
  for (int s = 0; s < p.nstage; ++s) {
    if (s < mine) {
      const int p0 = start_of(s), n = count_of(s);
      const int tv = PAGED ? table_lane(p, b, p0, n, lane) : 0;
      issue<KIND, PAGED>(p, ring + s * p.stage, par_w + s * p.pt, b, hk, p0,
                         n, tv, lane);
    }
    cp_commit();
  }
  // q and the carries, while the first pieces are in flight
  const float* qb = p.q + ((size_t)b * p.H + (size_t)hk * G) * D;
  for (int i = tid; i < PS * p.qs; i += THREADS) {
    const int h = i / p.qs, e = i - h * p.qs;
    q_s[i] = h < G && e < D ? qb[h * D + e] : 0.0f;
  }
  for (int i = lane; i < PS; i += 32) {
    st_m[i] = NEG_INIT;
    st_l[i] = 0.0f;
    st_c[i] = 0.0f;
  }
  __syncthreads();

  for (int i = 0; i < mine; ++i) {
    const int slot_i = i % p.nstage;
    const int p0 = start_of(i), n = count_of(i);
    const bool more = i + p.nstage < mine;
    // the table entries of the piece this slot takes next, read early
    const int tv_next = (PAGED && more)
        ? table_lane(p, b, start_of(i + p.nstage), count_of(i + p.nstage),
                     lane)
        : 0;
    if (p.nstage == 1) cp_wait<0>(); else cp_wait<1>();
    __syncwarp();
    const unsigned char* kslot = ring + slot_i * p.stage;
    const unsigned char* vslot = kslot + p.pt * p.rbs;
    const __half* pslot = reinterpret_cast<const __half*>(
        kslot + 2 * p.pt * p.rbs);
    const int* par = par_w + slot_i * p.pt;

    // ---- scores and statistics, GH heads at a time. The codes of a
    // partial last chunk past D count as zeros and q rows are zero past D
    // and G, so the loops have no branches
    const bool valid = tl < n;
    const unsigned char* krow = kslot + (valid ? tl : 0) * p.rbs;
    const __half* kpl = pslot + (valid ? tl : 0) * 8 * p.pw;  // scale, zero
    const int kpar = KIND == KV_U8 ? par[valid ? tl : 0] : 0;
    if constexpr (KIND == KV_U8) {
      // the token's V scale and zero as floats, once, for P·V
      if (valid) {
        const __half* vpl = kpl + 4 * p.pw;
        for (int g = part; g < p.dg; g += lt)
          vsz[tl * p.dg + g] = make_float2(
              __half2float(vpl[kpar + g]),
              __half2float(vpl[2 * p.pw + kpar + g]));
      }
    }
    for (int h0 = 0; h0 < G; h0 += GH) {
      float s[GH];
#pragma unroll
      for (int j = 0; j < GH; ++j) s[j] = 0.0f;
#pragma unroll 2
      for (int c = part; c < p.nch; c += lt) {
        uint4 raw = *reinterpret_cast<const uint4*>(krow + 16 * c);
        if constexpr (KIND != KV_F32) {
          const int left = D4 - c * QPC;        // quads of D in the chunk
          if (left < QPC) {
            constexpr int W = 4 / QPC;          // 32-bit words a quad
            raw.y = left * W > 1 ? raw.y : 0u;
            raw.z = left * W > 2 ? raw.z : 0u;
            raw.w = left * W > 3 ? raw.w : 0u;
          }
        }
        float4 kq[QPC];
        float2 gq = make_float2(0.f, 0.f);
        if constexpr (KIND == KV_U8) {
          if (p.one_group) {
            const int gi = group_of(p, c * QPC);
            gq = make_float2(__half2float(kpl[kpar + gi]),
                             __half2float(kpl[2 * p.pw + kpar + gi]));
          }
        }
#pragma unroll
        for (int qd = 0; qd < QPC; ++qd) {
          if constexpr (KIND == KV_U8) {
            if (!p.one_group) {
              const int gi = group_of(p, min(c * QPC + qd, D4 - 1));
              gq = make_float2(__half2float(kpl[kpar + gi]),
                               __half2float(kpl[2 * p.pw + kpar + gi]));
            }
          }
          kq[qd] = chunk_quad<KIND>(raw, qd, gq);
        }
        // a quad's q for all GH heads loaded together, then its FMAs, so
        // the loads' latency overlaps
        const float* qr = q_s + h0 * p.qs + 4 * QPC * c;
#pragma unroll
        for (int qd = 0; qd < QPC; ++qd) {
          float4 qq[GH];
#pragma unroll
          for (int j = 0; j < GH; ++j)
            qq[j] = *reinterpret_cast<const float4*>(qr + j * p.qs + 4 * qd);
#pragma unroll
          for (int j = 0; j < GH; ++j) {
            s[j] = fmaf(qq[j].x, kq[qd].x, s[j]);
            s[j] = fmaf(qq[j].y, kq[qd].y, s[j]);
            s[j] = fmaf(qq[j].z, kq[qd].z, s[j]);
            s[j] = fmaf(qq[j].w, kq[qd].w, s[j]);
          }
        }
      }
      for (int o = 1; o < lt; o <<= 1) {
#pragma unroll
        for (int j = 0; j < GH; ++j)
          s[j] = __fadd_rn(s[j], __shfl_xor_sync(FULL, s[j], o));
      }
      // the GH heads' statistics side by side: max over the tokens, p,
      // sum; heads past G get p = 0 and keep corr = 0
      float mx[GH], sum[GH];
#pragma unroll
      for (int j = 0; j < GH; ++j) {
        s[j] = valid ? __fmul_rn(s[j], p.sm_scale) : -INFINITY;
        mx[j] = s[j];
      }
      for (int o = lt; o < 32; o <<= 1) {
#pragma unroll
        for (int j = 0; j < GH; ++j)
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], o));
      }
#pragma unroll
      for (int j = 0; j < GH; ++j) {
        mx[j] = fmaxf(st_m[h0 + j], mx[j]);             // m_new
        s[j] = valid && h0 + j < G ? expf(__fsub_rn(s[j], mx[j])) : 0.0f;
        sum[j] = s[j];
      }
      for (int o = lt; o < 32; o <<= 1) {
#pragma unroll
        for (int j = 0; j < GH; ++j)
          sum[j] = __fadd_rn(sum[j], __shfl_xor_sync(FULL, sum[j], o));
      }
      if (valid && part == 0) {
#pragma unroll
        for (int j = 0; j < GH; j += 4)
          *reinterpret_cast<float4*>(p_w + tl * PS + h0 + j) =
              make_float4(s[j], s[j + 1], s[j + 2], s[j + 3]);
      }
      float corr[GH];
#pragma unroll
      for (int j = 0; j < GH; ++j) {
        corr[j] = expf(__fsub_rn(st_m[h0 + j], mx[j]));
        sum[j] = __fadd_rn(__fmul_rn(st_l[h0 + j], corr[j]), sum[j]);
      }
      __syncwarp();                     // every lane has read m and l
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < GH; ++j) {
          if (h0 + j < G) {
            st_l[h0 + j] = sum[j];
            st_m[h0 + j] = mx[j];
            st_c[h0 + j] = corr[j];
          }
        }
      }
    }
    __syncwarp();

    // ---- P·V: acc = acc·corr, then one fmaf chain over the lane's tokens
    if constexpr (NH > 0) {
      // each lane: 4 dims (dl) of every head, tokens tsl, tsl + ts, ...;
      // heads past G have p = 0 and corr = 0
      const int d4 = min(dl, D4 - 1);
      const int gv = KIND == KV_U8 ? group_of(p, d4) : 0;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const float c = st_c[j];
        acc[j].x = __fmul_rn(acc[j].x, c);
        acc[j].y = __fmul_rn(acc[j].y, c);
        acc[j].z = __fmul_rn(acc[j].z, c);
        acc[j].w = __fmul_rn(acc[j].w, c);
      }
#pragma unroll 2
      for (int t = tsl; t < n; t += p.ts) {
        float2 gq = make_float2(0.f, 0.f);
        if constexpr (KIND == KV_U8) gq = vsz[t * p.dg + gv];
        const float4 vq = load_quad<KIND>(vslot + t * p.rbs + d4 * QB, gq);
        const float* pr = p_w + t * PS;
#pragma unroll
        for (int j4 = 0; j4 < NH; j4 += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + j4);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[j4 + u].x = fmaf(pj[u], vq.x, acc[j4 + u].x);
            acc[j4 + u].y = fmaf(pj[u], vq.y, acc[j4 + u].y);
            acc[j4 + u].z = fmaf(pj[u], vq.z, acc[j4 + u].z);
            acc[j4 + u].w = fmaf(pj[u], vq.w, acc[j4 + u].w);
          }
        }
      }
    } else {
      // any (g, D): each lane owns nd·nh (4-dim, head) outputs
      int ii = 0, jj = 0;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        if (a < p.na) {
          const int h = hsl + (jj << p.hs_sh);
          const float c = h < G ? st_c[h] : 0.0f;
          acc[a].x = __fmul_rn(acc[a].x, c);
          acc[a].y = __fmul_rn(acc[a].y, c);
          acc[a].z = __fmul_rn(acc[a].z, c);
          acc[a].w = __fmul_rn(acc[a].w, c);
        }
        if (++jj == p.nh) { jj = 0; ++ii; }
      }
      for (int t = tsl; t < n; t += p.ts) {
        const unsigned char* vrow = vslot + t * p.rbs;
        const float* pt_row = p_w + t * PS;
        float4 vq = make_float4(0.f, 0.f, 0.f, 0.f);
        ii = 0;
        jj = 0;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          if (a < p.na) {
            const int d4 = dl + (ii << p.nl_sh);
            if (jj == 0 && d4 < D4) {
              float2 gq = make_float2(0.f, 0.f);
              if constexpr (KIND == KV_U8) gq = vsz[t * p.dg + group_of(p, d4)];
              vq = load_quad<KIND>(vrow + d4 * QB, gq);
            }
            const int h = hsl + (jj << p.hs_sh);
            if (d4 < D4 && h < G) {
              const float pr = pt_row[h];
              acc[a].x = fmaf(pr, vq.x, acc[a].x);
              acc[a].y = fmaf(pr, vq.y, acc[a].y);
              acc[a].z = fmaf(pr, vq.z, acc[a].z);
              acc[a].w = fmaf(pr, vq.w, acc[a].w);
            }
          }
          if (++jj == p.nh) { jj = 0; ++ii; }
        }
      }
    }
    __syncwarp();
    if (more) {
      const int i2 = i + p.nstage;
      issue<KIND, PAGED>(p, ring + slot_i * p.stage, par_w + slot_i * p.pt,
                         b, hk, start_of(i2), count_of(i2), tv_next, lane);
    }
    cp_commit();
  }

  // the ts token lanes' partials, by a fixed xor butterfly
  for (int o = 1 << (p.nl_sh + p.hs_sh); o < 32; o <<= 1) {
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      if (NH > 0 || a < p.na) {
        acc[a].x = __fadd_rn(acc[a].x, __shfl_xor_sync(FULL, acc[a].x, o));
        acc[a].y = __fadd_rn(acc[a].y, __shfl_xor_sync(FULL, acc[a].y, o));
        acc[a].z = __fadd_rn(acc[a].z, __shfl_xor_sync(FULL, acc[a].z, o));
        acc[a].w = __fadd_rn(acc[a].w, __shfl_xor_sync(FULL, acc[a].w, o));
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                     // every ring drained: reuse for acc
  float* accw = reinterpret_cast<float*>(smem + p.off_ring);
  if (tsl == 0) {
    float* aw = accw + warp * G * D;
    if constexpr (NH > 0) {
      if (dl < D4)
#pragma unroll
        for (int j = 0; j < NH; ++j)
          if (j < G)
            *reinterpret_cast<float4*>(aw + j * D + 4 * dl) = acc[j];
    } else {
      int ii = 0, jj = 0;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        if (a < p.na) {
          const int d4 = dl + (ii << p.nl_sh);
          const int h = hsl + (jj << p.hs_sh);
          if (d4 < D4 && h < G)
            *reinterpret_cast<float4*>(aw + h * D + 4 * d4) = acc[a];
        }
        if (++jj == p.nh) { jj = 0; ++ii; }
      }
    }
  }
  __syncthreads();

  // the warps' carries, merged in warp order
  const float* stat = reinterpret_cast<const float*>(smem + p.off_stat);
  float* wsb = emit ? nullptr
      : p.ws + ((size_t)bh * p.splits + split) * (2 * G + G * D);
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int h = idx / D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, stat[w * 3 * PS + h]);
    float l = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(__fsub_rn(stat[w * 3 * PS + h], m));
      l = __fadd_rn(l, __fmul_rn(stat[w * 3 * PS + PS + h], e));
      a = __fadd_rn(a, __fmul_rn(accw[w * G * D + idx], e));
    }
    if (emit) {
      ob[idx] = (l == 0.0f) ? 0.0f : __fdiv_rn(a, l);
    } else {
      wsb[2 * G + idx] = a;
      if (idx - h * D == 0) {
        wsb[h] = m;
        wsb[G + h] = l;
      }
    }
  }
}

// The row's live splits, merged in split order: each split's m and l,
// then each (split, head) weight exp(m_s − m), staged in shared memory.
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const float* __restrict__ ws,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int T, int H, int Hk, int G, int D, int chunk,
                    int splits) {
  extern __shared__ float wsm[];       // m, l, e (splits·G each), l (G)
  const int bh = blockIdx.x;
  const int b = bh / Hk;
  const int hk = bh - b * Hk;
  const int len = min(max(lengths[b], 0), T);
  const int live = (len + chunk - 1) / chunk;
  const int per = 2 * G + G * D;
  // launched as a programmatic dependent of the split pass: wait here
  // until that grid has finished and its partials are visible (every
  // block waits, so this grid ends after the split pass)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (live == 1) return;               // the split pass emitted the row
  const float* base = ws + (size_t)bh * splits * per;
  float* ob = out + ((size_t)b * H + (size_t)hk * G) * D;
  float* m_s = wsm;
  float* l_s = wsm + splits * G;
  float* e_s = l_s + splits * G;
  float* lh = e_s + splits * G;
  for (int i = threadIdx.x; i < live * G; i += THREADS) {
    const int sp = i / G, h = i - sp * G;
    m_s[i] = base[sp * per + h];
    l_s[i] = base[sp * per + G + h];
  }
  __syncthreads();
  for (int h = threadIdx.x; h < G; h += THREADS) {
    float m = -INFINITY;
    for (int sp = 0; sp < live; ++sp) m = fmaxf(m, m_s[sp * G + h]);
    float l = 0.0f;
    for (int sp = 0; sp < live; ++sp) {
      const float e = expf(__fsub_rn(m_s[sp * G + h], m));
      e_s[sp * G + h] = e;
      l = __fadd_rn(l, __fmul_rn(l_s[sp * G + h], e));
    }
    lh[h] = l;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int h = idx / D;
    float a = 0.0f;
#pragma unroll 4
    for (int sp = 0; sp < live; ++sp)
      a = __fadd_rn(a, __fmul_rn(base[sp * per + 2 * G + idx],
                                 e_s[sp * G + h]));
    const float l = lh[h];
    ob[idx] = (l == 0.0f) ? 0.0f : __fdiv_rn(a, l);
  }
}

int log2_exact(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return (1 << s) == x ? s : -1;
}

int pow2_ceil(int x) {
  int v = 1;
  while (v < x) v <<= 1;
  return v;
}

int round16(int x) { return (x + 15) & ~15; }

// The piece, the P·V lanes and the shared-memory layout for a launch.
// Returns the form: FORM_FAST (D ≤ 128 and g ≤ 4: scores 4 heads at a
// time, a lane owns 4 dims of every head, template <4, 4>), else the
// generic form (scores 8 heads at a time, p.nh heads a lane) with 16
// accumulators a lane (template <8, −16>) where they hold the plan, or 32
// (template <8, −32>: nemotron-4-340b's g = 12 at D = 192).
enum Form { FORM_FAST = 0, FORM_16 = 1, FORM_32 = 2 };

int layout(Params& p, int kind) {
  const int elem = kind == KV_F32 ? 4 : kind == KV_BF16 ? 2 : 1;
  p.rb = p.D * elem;
  p.nch = (p.rb + 15) / 16;
  p.cu = p.rb % 16 == 0 ? 16 : p.rb % 8 == 0 ? 8 : 4;
  p.upr = p.rb / p.cu;
  p.dg = kind == KV_U8 ? p.D / p.group : 0;
  p.pw = kind == KV_U8 ? p.dg / 2 + 1 : 0;
  bool al = true;
  for (int a = 0; a < 4; ++a)
    al = al && (reinterpret_cast<uintptr_t>(p.pl[a]) % 4 == 0);
  p.planes4 = al ? 1 : 0;
  p.qpg = kind == KV_U8 ? p.group / 4 : 1;
  p.qpg_sh = log2_exact(p.qpg);
  p.one_group = kind == KV_U8 && p.group % 16 == 0;
  // the most tokens a piece (32, 16, ..., 1) within STAGE_MAX; a token's
  // row padded to nchs 16-byte units with nchs ≡ lt (mod 2·lt), lt < 8
  for (p.pt = 32;; p.pt >>= 1) {
    const int lt = 32 / p.pt;
    int nchs = p.nch;
    if (lt < 8)
      while (nchs % (2 * lt) != lt) ++nchs;
    p.rbs = 16 * nchs;
    p.stage = round16(p.pt * (2 * p.rbs + 16 * p.pw));
    p.lt_sh = log2_exact(lt);
    if (p.stage <= STAGE_MAX || p.pt == 1) break;
  }
  // two ring slots when a warp has more than one piece of a chunk
  const int per_warp = (p.chunk + p.pt * WARPS - 1) / (p.pt * WARPS);
  p.nstage = per_warp > 1 ? 2 : 1;
  // P·V lanes: nl dim lanes (4 dims each), then hs head lanes × ts token
  // lanes. Fast form: hs = 1, every head in the lane; generic: the most
  // token lanes that keep nd·nh ≤ 16 accumulators, else one token lane
  // and up to 32 (dispatch refuses a plan past that)
  const int d4 = p.D / 4;
  const int nl = d4 >= 32 ? 32 : pow2_ceil(d4);
  const int r = 32 / nl;
  p.nd = (d4 + nl - 1) / nl;
  p.nl_sh = log2_exact(nl);
  const bool fast = p.D <= 128 && p.G <= 4;
  const int gh = fast ? 4 : 8;
  int ts = r;
  if (!fast)
    for (; ts > 1; ts >>= 1)
      if (p.nd * ((p.G + r / ts - 1) / (r / ts)) <= 16) break;
  p.ts = ts;
  p.hs_sh = log2_exact(r / ts);
  p.nh = fast ? gh : (p.G + r / ts - 1) / (r / ts);
  p.na = p.nd * p.nh;
  p.ps = (p.G + gh - 1) / gh * gh;
  p.qs = 16 / elem * p.nch;
  // shared memory
  const int ring = WARPS * p.nstage * p.stage;
  const int accw = WARPS * p.G * p.D * 4;
  p.off_ring = round16(p.ps * p.qs * 4);
  p.off_par = p.off_ring + round16(ring > accw ? ring : accw);
  p.off_p = p.off_par + round16(WARPS * 2 * p.pt * 4);
  p.off_stat = p.off_p + WARPS * p.pt * p.ps * 4;
  p.off_vsz = round16(p.off_stat + WARPS * 3 * p.ps * 4);
  p.smem = p.off_vsz + WARPS * p.pt * p.dg * 8;
  return fast ? FORM_FAST : p.na <= 16 ? FORM_16 : FORM_32;
}

template <int KIND, bool PAGED, int GH, int NH>
int launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = decode_split_kernel<KIND, PAGED, GH, NH>;
  // the dynamic shared-memory limit, raised once per instantiation and
  // device (again only for a launch that needs more than the last one set)
  static int limit[64] = {};
  int dev = 0;
  const cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (p.smem > 48 * 1024 && (dev >= 64 || p.smem > limit[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) limit[dev] = p.smem;
  }
  kernel<<<dim3(B * p.Hk, p.splits), THREADS, p.smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  // the merge pass, a programmatic dependent launch: its blocks start
  // while the split pass drains (one launch gap less) and wait for it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.Hk);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes =
      sizeof(float) * (3 * (size_t)p.splits * p.G + p.G);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_merge_kernel,
                                 (const float*)p.ws, p.lengths, p.out, p.T,
                                 p.H, p.Hk, p.G, p.D, p.chunk, p.splits);
}

template <int KIND, bool PAGED>
int forms(const Params& p, int B, int form, cudaStream_t s) {
  if (form == FORM_FAST) return launch<KIND, PAGED, 4, 4>(p, B, s);
  if (form == FORM_16) return launch<KIND, PAGED, 8, -16>(p, B, s);
  return launch<KIND, PAGED, 8, -32>(p, B, s);
}

template <bool PAGED>
int dispatch(Params& p, int B, int kind, cudaStream_t s) {
  if (kind < KV_F32 || kind > KV_U8) return (int)cudaErrorInvalidValue;
  const int form = layout(p, kind);
  if (p.na > 32) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case KV_F32:
      return forms<KV_F32, PAGED>(p, B, form, s);
    case KV_BF16:
      return forms<KV_BF16, PAGED>(p, B, form, s);
    default:
      return forms<KV_U8, PAGED>(p, B, form, s);
  }
}

Params make_params(const float* q, const void* k, const void* v,
                   const int* lengths, const void* ks, const void* kz,
                   const void* vs, const void* vz, float* out, void* ws,
                   int H, int Hk, int D, int group, int chunk, int splits) {
  Params p{};
  p.q = q;
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.lengths = lengths;
  p.pl[0] = static_cast<const __half*>(ks);
  p.pl[1] = static_cast<const __half*>(kz);
  p.pl[2] = static_cast<const __half*>(vs);
  p.pl[3] = static_cast<const __half*>(vz);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.H = H;
  p.Hk = Hk;
  p.D = D;
  p.G = H / Hk;
  p.group = group;
  p.chunk = chunk;
  p.splits = splits;
  p.sm_scale = (float)(1.0 / sqrt((double)D));
  return p;
}

}  // namespace

// K6. q (B, H, D) f32; k, v (B, T, Hk, D) of kind 0 (f32), 1 (bf16) or 2
// (uint8 codes, with k/v scale and zero (B, T, Hk, D/group) f16; null
// otherwise); lengths (B,) int32; out (B, H, D) f32; ws the merge
// workspace, (B·Hk·splits·(2g + g·D)) f32 when splits > 1 (else unused).
// All contiguous on the device, k and v 16-byte aligned; D % 4 == 0,
// H % Hk == 0, g = H/Hk ≤ 32, and layout()'s P·V plan within 32
// accumulators a lane, ⌈D/4 / nl⌉·⌈g / (32 / nl)⌉ ≤ 32 with nl =
// min(32, pow2_ceil(D/4)) (kernels/ops.py, decode_attn_supported: g·D up
// to 4096 at D = 64 or 128, 3072 at D = 192, 2048 at D = 256); the plan
// (chunk, splits) covers
// [0, T) with (splits − 1)·chunk < max(T, 1) ≤ splits·chunk. Returns
// cudaGetLastError().
extern "C" int decode_attn(const float* q, const void* k, const void* v,
                           const int* lengths, const void* k_scale,
                           const void* k_zero, const void* v_scale,
                           const void* v_zero, float* out, void* ws, int B,
                           int T, int H, int Hk, int D, int group, int chunk,
                           int splits, int kind, void* stream) {
  Params p = make_params(q, k, v, lengths, k_scale, k_zero, v_scale, v_zero,
                         out, ws, H, Hk, D, group, chunk, splits);
  p.T = T;
  p.page = 1;
  return dispatch<false>(p, B, kind, (cudaStream_t)stream);
}

// K6p. k, v are one layer's pools (P, page, Hk, D) of the same kinds (INT8
// planes (P, page, Hk, D/group)); table (B, n_pages) int32, entries
// clipped to [0, P − 1]; row b attends [0, min(lengths[b], n_pages·page)).
// The other operands and limits are K6's, with T = n_pages·page in the
// plan.
extern "C" int decode_attn_paged(const float* q, const void* k,
                                 const void* v, const int* table,
                                 const int* lengths, const void* k_scale,
                                 const void* k_zero, const void* v_scale,
                                 const void* v_zero, float* out, void* ws,
                                 int B, int P, int page, int n_pages, int H,
                                 int Hk, int D, int group, int chunk,
                                 int splits, int kind, void* stream) {
  Params p = make_params(q, k, v, lengths, k_scale, k_zero, v_scale, v_zero,
                         out, ws, H, Hk, D, group, chunk, splits);
  p.table = table;
  p.T = n_pages * page;
  p.n_pages = n_pages;
  p.P = P;
  p.page = page;
  return dispatch<true>(p, B, kind, (cudaStream_t)stream);
}
