// Exact streaming top-k selection for one block (256 threads), shared by
// the kernels that reduce a stream of (value, position) candidates to k
// (csrc/topk_update.cu), and the merge pass that folds the ranges' top-k
// into the (Q, k) state, shared by K2 and K1 (csrc/topk.cu).
//
// Order: an entry is ahead of another when its value is larger, or the
// values are equal (IEEE ==, so -0.0 ties +0.0) and its position is
// smaller.  Real entries have unique positions, so the order is total
// and any schedule of the block gives the same result.  No value in the
// buffer is NaN: a NaN candidate fails every `v > thr` filter, and
// callers read NaN state values as -inf.
//
// The buffer holds at most kCap entries: entries put there by the
// caller (a state) and the survivors of the tiles seen so far.  When the
// next tile might not fit, the buffer is cut to its entries not below
// its k-th largest value, found by a radix selection (no sort); it is
// sorted once, at the end.  A candidate survives its tile when it is
// strictly above `thr`, the larger of the caller's `least` and the value
// of the last cut.  That drop is exact as long as every candidate of a
// later tile comes after every entry already seen, among equal values:
// the k entries at or above the threshold are then ahead of it.  Callers
// stream their candidates in that order (columns ascending, or ranges
// ascending with each range sorted).

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace topk_select {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                       // candidates per tile
constexpr int kTile = kThreads * kPerThread;        // 1024
constexpr int kCap = 2 * kTile;                     // buffer entries
constexpr int kMaxK = 256;                          // kCap - kTile >= kMaxK
constexpr unsigned kFullMask = 0xffffffffu;

struct __align__(16) Buffer {
  float v[kCap];
  int p[kCap];
  int hist[256];       // one radix digit's counts (kth_largest)
  int cnt;
  int digit, above;    // kth_largest: the chosen digit, entries above it
  float red[kThreads / 32];
};

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ bool ahead(float va, int pa, float vb, int pb) {
  return va > vb || (va == vb && pa < pb);
}

// Block-wide minimum of one value per thread (every thread gets it).
inline __device__ float block_min(Buffer& s, float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFullMask, x, o));
  if ((threadIdx.x & 31) == 0) s.red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = s.red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fminf(m, s.red[w]);
  __syncthreads();
  return m;
}

// The sort is a bitonic network over the whole buffer held in registers:
// thread t owns entries 8t..8t+7.  Pairs closer than 8 entries meet in one
// thread, pairs closer than 256 in one warp (shuffles), and only the
// strides of 256 and more go through shared memory with barriers (6 of
// the 66 steps at 2048 entries).
constexpr int kOwn = kCap / kThreads;               // entries per thread
static_assert(kOwn == 8, "the register sort assumes 8 entries a thread");

// Keep, of the entry (v, p) and its partner (ov, op), the one ahead when
// keep_ahead, else the other.
__device__ __forceinline__ void keep_one(float& v, int& p, float ov, int op,
                                         bool keep_ahead) {
  if (ahead(v, p, ov, op) != keep_ahead) {
    v = ov;
    p = op;
  }
}

// One network step between entries j and j | S of this thread (S < 8).
template <int S>
__device__ __forceinline__ void step_in_thread(float (&v)[kOwn],
                                               int (&p)[kOwn], int size) {
  const int e0 = threadIdx.x * kOwn;
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    if (j & S) continue;
    const int h = j | S;
    const bool up = ((e0 + j) & size) == 0;
    const float vl = v[j], vh = v[h];
    const int pl = p[j], ph = p[h];
    const bool swap = up ? ahead(vh, ph, vl, pl) : ahead(vl, pl, vh, ph);
    v[j] = swap ? vh : vl; v[h] = swap ? vl : vh;
    p[j] = swap ? ph : pl; p[h] = swap ? pl : ph;
  }
}

// Sort the buffer and keep its first k entries (s.cnt = min(cnt, k)),
// ahead-first in s.v/s.p[0, s.cnt).  Whole block; the buffer must be
// complete (synced).
inline __device__ void sort_keep(Buffer& s, int k) {
  const int cnt = s.cnt;
  const int t = threadIdx.x;
  const int e0 = t * kOwn;
  int n = kOwn;
  while (n < cnt) n <<= 1;
  float v[kOwn];
  int p[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; j += 4) {
    const float4 fv = *reinterpret_cast<const float4*>(s.v + e0 + j);
    const int4 ip = *reinterpret_cast<const int4*>(s.p + e0 + j);
    v[j] = fv.x; v[j + 1] = fv.y; v[j + 2] = fv.z; v[j + 3] = fv.w;
    p[j] = ip.x; p[j + 1] = ip.y; p[j + 2] = ip.z; p[j + 3] = ip.w;
  }
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    if (e0 + j >= cnt) {
      v[j] = neg_inf();
      p[j] = INT_MAX;
    }
  }
  // entries at n and past are padding and pair only among themselves:
  // their warps skip the steps that need no barrier
  const bool live = (t & ~31) * kOwn < n;
  const int lane = t & 31;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool up = (e0 & size) == 0;  // for partners in other threads
      if (stride >= 32 * kOwn) {         // another warp: shared memory
        const int other = t ^ (stride / kOwn);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kOwn; j += 4) {
          *reinterpret_cast<float4*>(s.v + e0 + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
          *reinterpret_cast<int4*>(s.p + e0 + j) =
              make_int4(p[j], p[j + 1], p[j + 2], p[j + 3]);
        }
        __syncthreads();
        const bool keep_ahead = ((t & (stride / kOwn)) == 0) == up;
#pragma unroll
        for (int j = 0; j < kOwn; ++j)
          keep_one(v[j], p[j], s.v[other * kOwn + j], s.p[other * kOwn + j],
                   keep_ahead);
      } else if (!live) {
      } else if (stride >= kOwn) {       // another lane of this warp
        const int lanes = stride / kOwn;
        const bool keep_ahead = ((lane & lanes) == 0) == up;
#pragma unroll
        for (int j = 0; j < kOwn; ++j) {
          const float ov = __shfl_xor_sync(kFullMask, v[j], lanes);
          const int op = __shfl_xor_sync(kFullMask, p[j], lanes);
          keep_one(v[j], p[j], ov, op, keep_ahead);
        }
      } else if (stride == 4) {
        step_in_thread<4>(v, p, size);
      } else if (stride == 2) {
        step_in_thread<2>(v, p, size);
      } else {
        step_in_thread<1>(v, p, size);
      }
    }
  }
  __syncthreads();  // every read of the buffer is done
  if (e0 < k) {
#pragma unroll
    for (int j = 0; j < kOwn; j += 4) {
      *reinterpret_cast<float4*>(s.v + e0 + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      *reinterpret_cast<int4*>(s.p + e0 + j) =
          make_int4(p[j], p[j + 1], p[j + 2], p[j + 3]);
    }
  }
  if (t == 0) s.cnt = min(cnt, k);
  __syncthreads();
}

// Append the values whose keep bit is set, wherever the block's count
// puts them (one shared atomic per warp); pos(j) gives the j-th position.
template <int N, class Pos>
__device__ __forceinline__ void append(Buffer& s, const float (&v)[N],
                                       const bool (&keep)[N], Pos pos) {
  const int lane = threadIdx.x & 31;
  unsigned m[N];
  int total = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    m[j] = __ballot_sync(kFullMask, keep[j]);
    total += __popc(m[j]);
  }
  if (total == 0) return;  // uniform across the warp
  int base = 0;
  if (lane == 0) base = atomicAdd(&s.cnt, total);
  base = __shfl_sync(kFullMask, base, 0);
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (m[j] >> lane & 1u) {
      const int slot = base + __popc(m[j] & lower);
      s.v[slot] = v[j];
      s.p[slot] = pos(j);
    }
    base += __popc(m[j]);
  }
}

// Order-preserving key of a value: a larger key for a larger value (-0.0
// below +0.0), and back.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The value of the k-th largest key among s.v[0, cnt), k <= cnt: radix
// selection over four 8-bit digits, most significant first.  Whole block.
inline __device__ float kth_largest(Buffer& s, int cnt, int k) {
  static_assert(kThreads == 256, "one histogram bin per thread");
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0, fixed = 0;  // digits chosen so far, and their bits
  int need = k;                    // rank sought among the keys that match
  for (int shift = 24; shift >= 0; shift -= 8) {
    s.hist[threadIdx.x] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int e = j * kThreads + threadIdx.x;
      const unsigned key = order_key(s.v[e]);
      const int b = e < cnt && (key & fixed) == prefix
                        ? int(key >> shift & 255u) : -1;
      const unsigned peers = __match_any_sync(kFullMask, b);
      if (b >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&s.hist[b], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // lane l scans bins 8l..8l+7
      int c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = s.hist[lane * 8 + i];
        sum += c[i];
      }
      int above = sum;  // becomes the count in bins of lanes >= l
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_down_sync(kFullMask, above, o);
        if (lane + o < 32) above += x;
      }
      above -= sum;
#pragma unroll
      for (int i = 7; i >= 0; --i) {
        if (above < need && above + c[i] >= need) {
          s.digit = lane * 8 + i;
          s.above = above;
        }
        above += c[i];
      }
    }
    __syncthreads();
    need -= s.above;
    prefix |= unsigned(s.digit) << shift;
    fixed |= 255u << shift;
  }
  return key_value(prefix);
}

// Cut a full buffer down without sorting it: keep the entries not below
// its k-th largest value V (at least k of them, so a dropped entry has k
// entries ahead of it) and return V, which a later candidate must exceed
// (the kept entries all come before it).  Where ties at V keep more than
// kCap - kTile entries, sort and keep the first k instead.  Whole block.
inline __device__ float cut(Buffer& s, int k) {
  const int cnt = s.cnt;
  const float kth = kth_largest(s, cnt, k);
  float v[kOwn];
  int p[kOwn];
  bool keep[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int e = j * kThreads + threadIdx.x;
    v[j] = s.v[e];
    p[j] = s.p[e];
    keep[j] = e < cnt && v[j] >= kth;
  }
  __syncthreads();  // every entry is read before any is rewritten
  if (threadIdx.x == 0) s.cnt = 0;
  __syncthreads();
  append(s, v, keep, [&](int j) { return p[j]; });
  __syncthreads();
  const int kept = s.cnt;
  __syncthreads();  // read by all before the caller appends again
  if (kept <= kCap - kTile) return kth;
  sort_keep(s, k);
  return s.v[k - 1];
}

// Fold n_tiles tiles of candidates into the buffer, then sort it: on
// return s.v/s.p[0, s.cnt) are the first s.cnt = min(entries, k) entries.
// load(tile, v) fills this thread's kPerThread values of the tile (NaN
// for none); pos(tile, j) gives the position of its j-th value, asked
// only for survivors.  The caller has filled s.cnt entries and synced.
template <class Load, class Pos>
__device__ void select_stream(Buffer& s, int k, float least, int n_tiles,
                              Load load, Pos pos) {
  float thr = least;
  float next[kPerThread];  // the next tile's values, loaded a tile ahead
  if (n_tiles > 0) load(0, next);
  for (int tile = 0; tile < n_tiles; ++tile) {
    float v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) v[j] = next[j];
    if (tile + 1 < n_tiles) load(tile + 1, next);
    // every thread reads the count before any warp of this tile adds to it
    const int cnt = s.cnt;
    __syncthreads();
    if (cnt + kTile > kCap)  // uniform; cnt > kTile >= k
      thr = fmaxf(least, cut(s, k));
    bool keep[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) keep[j] = v[j] > thr;
    append(s, v, keep, [&](int j) { return pos(tile, j); });
    __syncthreads();
  }
  sort_keep(s, k);
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// -- the (Q, k) state, and the merge pass -----------------------------------
//
// State slot p of query q sits at position p (the incoming state need not
// be sorted); a candidate at position k + j, where j is its column (K2)
// or its superchunk row (K1).  `id(j)` gives a winning candidate's id.

// Read query q's state: a candidate must exceed its smallest value (NaN
// as -inf), which this returns.  With `into_buffer` the k entries also
// enter the buffer at positions 0..k-1 and their ids go to `si`.
inline __device__ float load_state(Buffer& s, int* si, const float* vals,
                                   const int* ids, int q, int k,
                                   bool into_buffer) {
  const size_t row = size_t(q) * k;
  float lo = -neg_inf();
  for (int p = threadIdx.x; p < k; p += kThreads) {
    float v = vals[row + p];
    if (isnan(v)) v = neg_inf();
    lo = fminf(lo, v);
    if (into_buffer) {
      s.v[p] = v;
      s.p[p] = p;
      si[p] = ids[row + p];
    }
  }
  if (threadIdx.x == 0) s.cnt = into_buffer ? k : 0;
  return block_min(s, lo);  // syncs: the buffer and count are visible
}

// Write the buffer's first k entries (all real: the state was in it) as
// query q's new state.
template <class Id>
__device__ void store_state(const Buffer& s, const int* si, float* vals,
                            int* ids, int q, int k, Id id) {
  const size_t row = size_t(q) * k;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int p = s.p[i];
    vals[row + i] = s.v[i];
    ids[row + i] = p < k ? si[p] : id(p - k);
  }
}

// The merge pass, one block per query q: the first k of the state and
// the n partials ws_v / ws_p[q * n, (q + 1) * n), read in that order,
// which must stream them as select_stream requires (the ranges
// ascending, each range sorted or in position order).  Padding partials
// are -inf and never pass the filter.
template <class Id>
__device__ void merge_partials(Buffer& s, int* si, float* vals, int* ids,
                               int q, int k, int n, const float* ws_v,
                               const int* ws_p, Id id) {
  const float least = load_state(s, si, vals, ids, q, k, true);
  const size_t base = size_t(q) * n;
  auto load = [&](int tile, float* v) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = tile * kTile + j * kThreads + threadIdx.x;
      v[j] = e < n ? ws_v[base + e] : nan_f();
    }
  };
  auto pos = [&](int tile, int j) {
    return ws_p[base + tile * kTile + j * kThreads + threadIdx.x];
  };
  select_stream(s, k, least, (n + kTile - 1) / kTile, load, pos);
  store_state(s, si, vals, ids, q, k, id);
}

}  // namespace topk_select
