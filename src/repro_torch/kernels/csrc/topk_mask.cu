// K2: row-wise hard thresholding H_k — keep the k largest |z| of each row,
// zero the rest, ties broken by lower index (the semantics of jax.lax.top_k
// and of the reference's jnp path, repro/core/projections.py:39).
//
// Replaces: src/repro/kernels/topk_mask.py, topk_row (pallas_call at :61).
//
// Keep-set, bit for bit the plain version's (core/projections.py): the
// threshold thr is the k-th largest |z| with NaN ranked above +inf (any
// sign or payload); an element is kept when |z| > thr, or |z| == thr among
// the leftmost (k − #(|z| > thr)) such, in IEEE comparisons. So NaN counts
// toward k but is never kept, a NaN threshold keeps nothing, and −0.0 ties
// with +0.0.
//
// Bound on an H100: memory. The function reads each element once and
// writes it once, 8·rows·d bytes at 3.35 TB/s; its few integer operations
// per element are far below the compute roof.
//
// Design. One block owns one row and runs an exact radix select on the
// 31-bit key |z| (for non-negative floats, and NaN above inf, the uint32
// pattern is monotone): digits of 11, 10 and 10 bits from the top.
// - The row is read from device memory once: a held form keeps it in
//   registers (32 floats a thread in 16-byte slots) for every pass — 64
//   threads a row up to d = 2048, at most 128 registers a thread so that 8
//   rows share an SM; 256 threads up to d = 8192. Longer rows (73728 is
//   nemotron-4-340b's d_ff) take the streaming form, which runs the same
//   passes over the row from L2, 8192 elements at a time.
// - Pass 0 histograms every key's top 11 bits into 2048 shared-memory
//   bins. The compiler makes each increment a warp-aggregated
//   ATOMS.POPC.INC, so equal keys in a warp (the exponent-heavy first
//   digit, ties) cost one update. The loops over elements have no
//   branches: an element outside the row counts in a spare bin.
// - The threshold's bin is found by warp 0 in two parallel levels: each
//   lane sums a run of bins, a shuffle suffix sum and one ballot pick the
//   lane, then the same over that lane's bins. No thread walks bins.
// - The keys of that bin (about 4% of a normal row) are then copied into
//   shared memory, each thread's place taken by a warp scan, and the
//   remaining passes read the copy, not the row. If the copy's keys are
//   all equal (ties, a plateau) the threshold is known; if pass 1 leaves
//   one key, pass 2 is skipped. A bin larger than the copy (an all-equal
//   long row) runs its passes over the row instead.
// - The keep pass writes every element above the threshold that is not
//   NaN, plus the leftmost (rank + NaN count) elements equal to it. Only
//   when some ties must be dropped are they ranked in index order: each
//   thread counts its ties a slot, four slots to a word of 8-bit fields,
//   one warp scan a word, and the warps' totals in shared memory.
// - Loads and stores are 16 bytes a thread, coalesced (slot j of thread t
//   holds elements 4(j·threads + t) .. +3); a scalar-copy instantiation
//   serves d % 4 ≠ 0 and rows that are not 16-byte aligned.
// No global atomics: the output does not depend on any order of execution.
// The wrapper handles k ≤ 0 and k ≥ d, as core/projections.py does.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INF_KEY = 0x7f800000u;  // |inf|; every NaN's key is above
constexpr int BINS0 = 2048;                // pass 0: key bits 30..20
constexpr int BINS = 1024;                 // passes 1, 2: bits 19..10, 9..0

__device__ __forceinline__ unsigned mag_key(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Inclusive sum over lanes >= lane (a suffix sum from the top lane).
__device__ __forceinline__ unsigned suffix_sum(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_down_sync(FULL, v, o);
    if (lane + o < 32) v += y;
  }
  return v;
}

// Inclusive sum over lanes <= lane.
__device__ __forceinline__ unsigned prefix_sum(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

struct Bin {
  unsigned digit;  // the bin that holds the rank-th largest key
  unsigned above;  // keys in higher bins
  unsigned count;  // keys in that bin
};

// The bin of the rank-th largest key (rank >= 1, counted from the top) of
// an NB-bin histogram, by one warp: each lane sums its run of NB/32 bins,
// a suffix sum over lanes and a ballot pick the lane whose run holds the
// rank; the lanes then split that run (1 or 2 bins each) and do the same.
template <int NB>
__device__ __forceinline__ Bin select_bin(const unsigned* hist,
                                          unsigned rank, int lane) {
  constexpr int RUN = NB / 32;  // bins a lane sums: 64 or 32
  constexpr int Q = RUN / 4;    // 16-byte reads a lane
  constexpr int C = RUN / 32;   // bins a lane takes of the chosen run
  const uint4* h4 = reinterpret_cast<const uint4*>(hist) + lane * Q;
  unsigned s = 0u;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    // rotated by lane: the eight lanes of a quarter warp read eight
    // distinct 16-byte bank groups
    const uint4 v = h4[(q + lane) % Q];
    s += v.x + v.y + v.z + v.w;
  }
  unsigned incl = suffix_sum(s, lane);
  const int owner =
      __ffs(__ballot_sync(FULL, incl - s < rank && rank <= incl)) - 1;
  const unsigned above_run = __shfl_sync(FULL, incl - s, owner);
  const unsigned r = rank - above_run;
  unsigned b[C];
  s = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    b[c] = hist[owner * RUN + lane * C + c];
    s += b[c];
  }
  incl = suffix_sum(s, lane);
  const int l2 = __ffs(__ballot_sync(FULL, incl - s < r && r <= incl)) - 1;
  unsigned acc = incl - s;  // keys in this lane's bins' higher neighbours
  int pick = 0;
#pragma unroll
  for (int c = C - 1; c >= 0; --c) {
    if (acc + b[c] >= r) {
      pick = c;
      break;
    }
    acc += b[c];
  }
  Bin out;
  out.digit = __shfl_sync(FULL, (unsigned)(owner * RUN + lane * C + pick), l2);
  out.above = above_run + __shfl_sync(FULL, acc, l2);
  out.count = __shfl_sync(FULL, b[pick], l2);
  return out;
}

// One block a row. THREADS threads, each V 16-byte slots of a chunk of
// 4·V·THREADS elements; HELD keeps the one chunk (d <= 4·V·THREADS) in
// registers, else every pass streams the row chunk by chunk. CAP keys of
// the threshold's bin fit in the shared-memory copy. The loops over
// elements have no branches: an element outside the row, or one that does
// not match, counts in a spare bin (and is copied to a spare slot) that
// nothing reads.
template <int THREADS, int MINB, int V, bool VEC, bool HELD>
__global__ void __launch_bounds__(THREADS, MINB)
topk_row_kernel(const float* __restrict__ z, float* __restrict__ out, int d,
                int k) {
  constexpr int WARPS = THREADS / 32;
  constexpr int CHUNK = 4 * V * THREADS;
  constexpr int CAP = HELD ? 1024 : 8192;
  constexpr int GROUPS = VEC ? V : 4 * V;  // tie-ranking groups a chunk
  constexpr unsigned SPARE = BINS0;        // the bin nothing reads
  __shared__ __align__(16) unsigned hist[BINS0 + 4];
  __shared__ unsigned cand[CAP + 1];
  __shared__ unsigned s_nan, s_ncand, s_min, s_max, s_one;
  __shared__ Bin s_bin;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* zr = z + (size_t)blockIdx.x * d;
  float* outr = out + (size_t)blockIdx.x * d;

  // element e of slot j in the chunk that starts at base
  auto index = [&](int base, int j, int e) {
    return VEC ? base + 4 * (j * THREADS + tid) + e
               : base + (4 * j + e) * THREADS + tid;
  };
  float x[V][4];
  auto load = [&](int base) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (VEC) {
        const int i = index(base, j, 0);
        const float4 q = i < d ? *reinterpret_cast<const float4*>(zr + i)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        x[j][0] = q.x;
        x[j][1] = q.y;
        x[j][2] = q.z;
        x[j][3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = index(base, j, e);
          x[j][e] = i < d ? zr[i] : 0.f;
        }
      }
    }
  };
  auto store = [&](int base, int j, const float (&y)[4]) {
    if (VEC) {
      const int i = index(base, j, 0);
      if (i < d)
        *reinterpret_cast<float4*>(outr + i) =
            make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (index(base, j, e) < d) outr[index(base, j, e)] = y[e];
    }
  };
  // f(key, valid) for every element of the row, called by every thread
  // the same number of times (warp collectives may run inside f)
  auto visit = [&](auto&& f) {
    auto chunk = [&](int base) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(mag_key(x[j][e]), index(base, j, e) < d);
      }
    };
    if (HELD) {
      chunk(0);
    } else {
      for (int base = 0; base < d; base += CHUNK) {
        load(base);
        chunk(base);
      }
    }
  };

  if (tid == 0) {
    s_nan = 0u;
    s_ncand = 0u;
    s_min = FULL;
    s_max = 0u;
    s_one = 0u;
  }
  for (int i = tid; i < BINS0 / 4; i += THREADS)
    reinterpret_cast<uint4*>(hist)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (HELD) load(0);
  __syncthreads();

  // pass 0: bits 30..20 of every key, and the row's NaN count
  unsigned nan = 0u;
  visit([&](unsigned key, bool valid) {
    atomicAdd(&hist[valid ? key >> 20 : SPARE], 1u);
    nan += valid && key > INF_KEY;
  });
  nan = __reduce_add_sync(FULL, nan);
  if (lane == 0) atomicAdd(&s_nan, nan);
  __syncthreads();
  nan = s_nan;
  if (warp == 0) {
    const Bin b = select_bin<BINS0>(hist, (unsigned)k, lane);
    if (lane == 0) s_bin = b;
  }
  __syncthreads();
  Bin bin = s_bin;
  unsigned rank = (unsigned)k - bin.above;  // rank among the bin's keys
  unsigned prefix = bin.digit << 20;        // threshold bits fixed so far
  unsigned pmask = 0x7ff00000u;

  // copy the bin's keys to shared memory (any order): count them, take
  // each thread's place by a warp scan and one atomic a warp, then write
  const bool copied = bin.count <= (unsigned)CAP;
  if (copied) {
    unsigned c = 0u;
    visit([&](unsigned key, bool valid) {
      c += valid && (key & pmask) == prefix;
    });
    const unsigned incl = prefix_sum(c, lane);
    unsigned base = 0u;
    if (lane == 31) base = atomicAdd(&s_ncand, incl);
    unsigned at = __shfl_sync(FULL, base, 31) + incl - c;
    visit([&](unsigned key, bool valid) {
      const bool m = valid && (key & pmask) == prefix;
      cand[m ? at : CAP] = key;
      at += m;
    });
    __syncthreads();
  }
  const unsigned ncand = bin.count;
  // f(key, match) for every key of the bin (copied) or of the row; match:
  // the key has the threshold's bits fixed so far
  auto each_cand = [&](auto&& f) {
    if (copied) {
      for (unsigned i = tid; i < ncand; i += THREADS) {
        const unsigned key = cand[i];
        f(key, (key & pmask) == prefix);
      }
    } else {
      visit([&](unsigned key, bool valid) {
        f(key, valid && (key & pmask) == prefix);
      });
    }
  };

  // a bin of equal keys fixes the threshold
  unsigned lo = FULL, hi = 0u;
  each_cand([&](unsigned key, bool m) {
    lo = min(lo, m ? key : FULL);
    hi = max(hi, m ? key : 0u);
  });
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (lane == 0) {
    atomicMin(&s_min, lo);
    atomicMax(&s_max, hi);
  }
  __syncthreads();
  lo = s_min;
  hi = s_max;
  if (lo != hi) {
#pragma unroll 1
    for (int shift = 10; shift >= 0; shift -= 10) {
      for (int i = tid; i < BINS / 4; i += THREADS)
        reinterpret_cast<uint4*>(hist)[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
      each_cand([&](unsigned key, bool m) {
        atomicAdd(&hist[m ? (key >> shift) & (BINS - 1) : SPARE], 1u);
      });
      __syncthreads();
      if (warp == 0) {
        const Bin b = select_bin<BINS>(hist, rank, lane);
        if (lane == 0) s_bin = b;
      }
      __syncthreads();
      bin = s_bin;
      rank -= bin.above;
      prefix |= bin.digit << shift;
      pmask |= (unsigned)(BINS - 1) << shift;
      if (shift && bin.count == 1u) {
        // one key left: it is the threshold, found by a max over the keys
        // (skips pass 2)
        unsigned one = 0u;
        each_cand([&](unsigned key, bool m) { one = max(one, m ? key : 0u); });
        one = __reduce_max_sync(FULL, one);
        if (lane == 0) atomicMax(&s_one, one);
        __syncthreads();
        prefix = s_one;
        break;
      }
    }
  }
  const unsigned thr = lo == hi ? lo : prefix;
  // bin.count keys equal thr and (k − rank) are above it, NaNs included;
  // the leftmost (rank + NaN count) equal ones are kept (none for a NaN
  // threshold: then no key is at or below inf and above thr)
  const unsigned need = rank + nan;
  const bool rank_ties = thr <= INF_KEY && need < bin.count;

  // every key >= thr that is not NaN
  auto keep_all_ties = [&](int base) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned key = mag_key(x[j][e]);
        y[e] = key >= thr && key <= INF_KEY ? x[j][e] : 0.f;
      }
      store(base, j, y);
    }
  };
  if (!rank_ties) {
    if (HELD) {
      keep_all_ties(0);
    } else {
      for (int base = 0; base < d; base += CHUNK) {
        load(base);
        keep_all_ties(base);
      }
    }
    return;
  }
  // some ties dropped: rank them in index order. Each thread counts its
  // ties in each group (a slot, or with scalar copies a slot's element),
  // four groups to a word of 8-bit fields (a warp's field sums to at most
  // 128); one warp scan a word and the warps' totals give every group's
  // ties at lower indices
  constexpr int NW = (GROUPS + 3) / 4;
  __shared__ unsigned s_tie[WARPS * NW];
  auto field = [](unsigned w, int g) { return (w >> (8 * (g % 4))) & 0xffu; };
  unsigned carry = 0u;  // ties at lower indices, in earlier chunks
  auto rank_chunk = [&](int base) {
    unsigned excl[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) excl[w] = 0u;
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = VEC ? j : 4 * j + e;
        excl[g / 4] += (unsigned)(index(base, j, e) < d &&
                                  mag_key(x[j][e]) == thr)
                       << (8 * (g % 4));
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned incl = prefix_sum(excl[w], lane);
      excl[w] = incl - excl[w];
      if (lane == 31) s_tie[warp * NW + w] = incl;
    }
    __syncthreads();
    unsigned run = carry;  // ties in lower groups, every warp
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y[4];
#pragma unroll
      for (int eg = 0; eg < (VEC ? 1 : 4); ++eg) {
        const int g = VEC ? j : 4 * j + eg;
        unsigned before = run + field(excl[g / 4], g);
        for (int w = 0; w < WARPS; ++w) {
          const unsigned n = field(s_tie[w * NW + g / 4], g);
          before += w < warp ? n : 0u;
          run += n;
        }
#pragma unroll
        for (int e = VEC ? 0 : eg; e < (VEC ? 4 : eg + 1); ++e) {
          const unsigned key = mag_key(x[j][e]);
          const bool tie = key == thr;
          y[e] = (tie ? before < need : key > thr && key <= INF_KEY)
                     ? x[j][e] : 0.f;
          before += tie;
        }
      }
      store(base, j, y);
    }
    carry = run;
    __syncthreads();  // s_tie is rewritten for the next chunk
  };
  if (HELD) {
    rank_chunk(0);
  } else {
    for (int base = 0; base < d; base += CHUNK) {
      load(base);
      rank_chunk(base);
    }
  }
}

template <int THREADS, int MINB, int V, bool HELD>
int launch(const float* z, float* out, int rows, int d, int k, bool vec,
           cudaStream_t stream) {
  if (vec)
    topk_row_kernel<THREADS, MINB, V, true, HELD>
        <<<rows, THREADS, 0, stream>>>(z, out, d, k);
  else
    topk_row_kernel<THREADS, MINB, V, false, HELD>
        <<<rows, THREADS, 0, stream>>>(z, out, d, k);
  return (int)cudaGetLastError();
}

}  // namespace

// z, out: (rows, d) f32, contiguous, on the device; 0 < k < d. variant:
// the index into kernels/ops.py's TOPK_FORMS (threads, slots, held) —
// 0: 64 x 8 held (d <= 2048), 1: 256 x 8 held (d <= 8192), 2: 1024 x 2
// streaming (any d). vec: 16-byte copies (d % 4 == 0, z and out 16-byte
// aligned). Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unknown variant or a row longer than a held variant holds.
extern "C" int topk_row_f32(const float* z, float* out, int rows, int d,
                            int k, int variant, int vec, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      if (d > 2048) break;
      return launch<64, 8, 8, true>(z, out, rows, d, k, vec, s);
    case 1:
      if (d > 8192) break;
      return launch<256, 2, 8, true>(z, out, rows, d, k, vec, s);
    case 2:
      return launch<512, 1, 4, false>(z, out, rows, d, k, vec, s);
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}
