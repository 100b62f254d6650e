// K1  repro_fused_score_topk: fused score + streaming top-k for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).  Built
// by repro_torch/kernels/_build.py.
//
// Replaces the TPU kernel src/repro/kernels/topk.py::fused_score_topk_pallas
// (:130) and the superchunk scan that hosts it (src/repro/kernels/ops.py:116):
// folds a whole (S*C, d) superchunk of corpus rows into the running (Q, k)
// top-k state (vals, ids), in place, and the (Q, S*C) score matrix never
// reaches device memory.  The new state is the first k of a stable
// descending sort over [state | candidates] (kernels/ref.py::
// fused_score_topk_ref): row r of step s scores queries . docs[s*C + r]
// with id offsets[s] + r and stream position k + s*C + r; rows at or past
// n_valids[s] and NaN scores are -inf and never surface an id; state slot
// p sits at position p (the incoming state need not be sorted).
//
// What bounds it on an H100: 2*Q*N*d float32 operations on N*d*4 bytes of
// rows, so at the main-path shapes (Q = 256, N = 2048, d = 768) the float32
// rate outside the tensor cores (67 TFLOP/s), not memory.  The port keeps
// full float32 scores (TF32 off), so the products run on the FMA pipes:
//   * Stage 1, grid (query tiles, splits): a block owns a tile of queries
//     and one range of `span` superchunk rows (ranges may cross steps; the
//     wrapper picks them from Q, N and the card's SM count so that every
//     SM gets a block where the rows allow it).  Per tile of rows it
//     computes the tile's scores, each thread a register tile of fmaf,
//     from kBK-wide slices of the queries and rows that cp.async stages
//     in shared memory, kStages - 1 slices ahead.  The wide tile (32
//     queries x 128 rows, 4 x 4 a thread) lets every loaded row serve 32
//     queries; the narrow one (16 x 32, 2 x 1) spreads a small superchunk
//     (a serving request's) over the card.  A warp whose rows all lie
//     past its range skips the products.  Each dot product is one fmaf
//     chain over d in order (the ragged tail of d is zero on both sides
//     and adds nothing), so a score's bits depend on d alone: not on the
//     tile, the range, the split count or S.
//   * Then each warp filters its queries' scores of the tile: a score
//     survives when strictly above the query's threshold (the state's
//     smallest value, then the range's own k-th value after a cut), and is
//     appended, in row order, to a per-query buffer of k + (tile rows)
//     entries.  A buffer that might overflow is cut to its exact top k
//     (radix selection of the k-th value, ties to the lower position) by
//     the warp alone.  At the range's end the buffer (a superset of the
//     range's top k) is written, still in row order, to a (Q, splits,
//     min(span, k + tile rows)) workspace.
//   * Stage 2, one block per query: K2's merge pass (topk_select.cuh::
//     merge_partials) folds the state and the partials, read ranges
//     ascending, each in row order, into the new state; the ids of the k
//     winners are computed from their rows.  A wrapper call counts as one
//     launch.

#include <climits>
#include <cstdint>

#include "topk_select.cuh"

namespace {

using topk_select::Buffer;
using topk_select::kFullMask;
using topk_select::kMaxK;
using topk_select::key_value;
using topk_select::neg_inf;
using topk_select::order_key;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;               // slices in flight

// A block tile: each thread scores TM queries x TN rows, so a block of
// 8 warps (2 over the queries, 4 over the rows) covers 8 TM queries and
// 32 TN rows, from slices of BK columns of d.  Warp w filters queries
// w + 8 i, i < TM, of the block.
template <int TM, int TN, int BK>
struct Tile {
  static constexpr int kTM = TM, kTN = TN;
  static constexpr int kBQ = 8 * TM;     // queries per block
  static constexpr int kBN = 32 * TN;    // rows per tile
  static constexpr int kSlab = kBN / 4;  // rows of one warp
  static constexpr int kBK = BK;         // columns of d per staged slice
  static constexpr int kLd = BK + 4;     // staged row stride (floats)
  static constexpr int kLdS = kBN + 8;   // score tile row stride (floats)
};
using Wide = Tile<4, 4, 32>;    // 32 queries x 128 rows
// 16 queries x 32 rows, for grids that the wide tile would leave mostly
// idle: its few products per slice cannot hide a slice's load, so it
// takes d in wider slices
using Narrow = Tile<2, 1, 128>;

// Shared memory, carved from one dynamic allocation (all 4-byte types).
struct Smem {
  float* qs;   // [kStages][kBQ][kLd]   query slices
  float* ds;   // [kStages][kBN][kLd]   row slices
  float* sc;   // [kBQ][kLdS]           the tile's scores
  float* bv;   // [kBQ][cap]            per-query buffers: values
  int* bp;     //                       and positions
  int* hist;   // [kWarps][256]         one radix histogram per warp
};

template <class T>
__host__ __device__ int buffer_cap(int k) { return k + T::kBN; }

template <class T>
size_t smem_bytes(int k) {
  return 4 * (size_t(kStages) * (T::kBQ + T::kBN) * T::kLd +
              size_t(T::kBQ) * T::kLdS +
              size_t(2) * T::kBQ * buffer_cap<T>(k) + size_t(kWarps) * 256);
}

template <class T>
__device__ Smem carve(unsigned char* raw, int cap) {
  Smem s;
  float* f = reinterpret_cast<float*>(raw);
  s.qs = f; f += kStages * T::kBQ * T::kLd;
  s.ds = f; f += kStages * T::kBN * T::kLd;
  s.sc = f; f += T::kBQ * T::kLdS;
  s.bv = f; f += T::kBQ * cap;
  int* n = reinterpret_cast<int*>(f);
  s.bp = n; n += T::kBQ * cap;
  s.hist = n;
  return s;
}

// -- the score tile ---------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage columns [kb, kb + kBK) of queries q0.. and of rows t0.. into one
// buffer; entries past n_q, past row1 or past d are zero.  kVec: 16-byte
// copies (d % 4 == 0 and 16-byte aligned bases), else 4-byte ones.
template <class T, bool kVec>
__device__ __forceinline__ void load_slice(
    float* qs, float* ds, const float* __restrict__ queries,
    const float* __restrict__ docs, int q0, int n_q, int t0, int row1,
    int d, int kb) {
  constexpr int kBQ = T::kBQ, kBK = T::kBK, kLd = T::kLd;
  constexpr int kRows = T::kBQ + T::kBN;
  if (kVec) {
    constexpr int kGroups = kBK / 4;
    for (int g = threadIdx.x; g < kRows * kGroups; g += kThreads) {
      const int r = g / kGroups;
      const int col = kb + 4 * (g - r * kGroups);
      const bool is_q = r < kBQ;
      const int src_row = is_q ? q0 + r : t0 + (r - kBQ);
      const bool full = col < d && (is_q ? src_row < n_q : src_row < row1);
      const float* base = is_q ? queries : docs;
      float* dst = (is_q ? qs + r * kLd : ds + (r - kBQ) * kLd) + (col - kb);
      cp_async16(dst, full ? base + size_t(src_row) * d + col : base, full);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kBK; e += kThreads) {
      const int r = e / kBK;
      const int col = kb + (e - r * kBK);
      const bool is_q = r < kBQ;
      const int src_row = is_q ? q0 + r : t0 + (r - kBQ);
      const bool full = col < d && (is_q ? src_row < n_q : src_row < row1);
      const float* base = is_q ? queries : docs;
      float* dst = (is_q ? qs + r * kLd : ds + (r - kBQ) * kLd) + (col - kb);
      cp_async4(dst, full ? base + size_t(src_row) * d + col : base, full);
    }
  }
  cp_async_commit();
}

// The kBQ x kBN scores of rows [t0, t0 + kBN) into s.sc.  Thread (warp w,
// lane l) owns queries qrow(i) = 4 kTM (w & 1) + (l >> 3) + 4 i and rows
// nrow(j) = kSlab (w >> 1) + (l & 7) + 8 j: a warp's float4 reads of one
// slice touch 4 consecutive query rows and 8 consecutive doc rows, rows
// kLd = 4 (mod 32) floats apart, so no two hit one bank.
template <class T, bool kVec>
__device__ void score_tile(const Smem& s, const float* __restrict__ queries,
                           const float* __restrict__ docs, int q0, int n_q,
                           int t0, int row1, int d) {
  constexpr int kTM = T::kTM, kTN = T::kTN, kBQ = T::kBQ, kBN = T::kBN;
  constexpr int kSlab = T::kSlab, kBK = T::kBK, kLd = T::kLd;
  constexpr int kLdS = T::kLdS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qr = 4 * kTM * (warp & 1) + (lane >> 3);
  const int nr = kSlab * (warp >> 1) + (lane & 7);
  // a warp whose rows all lie past the range's end has nothing to do
  const bool live = t0 + kSlab * (warp >> 1) < row1;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // slice sl sits in buffer sl % kStages; kStages - 1 slices are in
  // flight while one is multiplied (an empty group where none is left)
  const int n_slices = (d + kBK - 1) / kBK;
  auto prefetch = [&](int sl) {
    if (sl < n_slices) {
      const int b = sl % kStages;
      load_slice<T, kVec>(s.qs + b * kBQ * kLd, s.ds + b * kBN * kLd,
                          queries, docs, q0, n_q, t0, row1, d, sl * kBK);
    } else {
      cp_async_commit();
    }
  };
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) prefetch(sl);
  for (int sl = 0; sl < n_slices; ++sl) {
    cp_async_wait<kStages - 2>();  // slice sl has landed
    // ... for every thread, and every thread is done with slice sl - 1,
    // whose buffer the next prefetch refills
    __syncthreads();
    prefetch(sl + kStages - 1);
    if (!live) continue;
    const float* qs = s.qs + (sl % kStages) * kBQ * kLd;
    const float* ds = s.ds + (sl % kStages) * kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (qr + 4 * i) * kLd + kk);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        b[j] = *reinterpret_cast<const float4*>(ds + (nr + 8 * j) * kLd + kk);
      // d in order within each dot product: x, y, z, w of this group
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          float t = acc[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          t = fmaf(a[i].w, b[j].w, t);
          acc[i][j] = t;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      s.sc[(qr + 4 * i) * kLdS + nr + 8 * j] = acc[i][j];
  __syncthreads();
}

// -- one warp's selection over one query's buffer ----------------------------

// The value of the k-th largest key among v[0, cnt), 1 <= k <= cnt: radix
// selection over four 8-bit digits, most significant first.  One warp,
// with a histogram of its own.
__device__ float warp_kth_largest(const float* v, int cnt, int k,
                                  int* hist) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0, fixed = 0;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < 256; b += 32) hist[b] = 0;
    __syncwarp();
    for (int base = 0; base < cnt; base += 32) {
      const int e = base + lane;
      int b = -1;
      if (e < cnt) {
        const unsigned key = order_key(v[e]);
        if ((key & fixed) == prefix) b = int(key >> shift & 255u);
      }
      const unsigned peers = __match_any_sync(kFullMask, b);
      if (b >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[b], __popc(peers));
    }
    __syncwarp();
    // lane l scans bins 8l..8l+7, from the top
    int c[8], sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[i] = hist[lane * 8 + i];
      sum += c[i];
    }
    int above = sum;  // becomes the count in bins of lanes >= l
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_down_sync(kFullMask, above, o);
      if (lane + o < 32) above += x;
    }
    above -= sum;
    int digit = -1, before = 0;
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      if (above < need && above + c[i] >= need) {
        digit = lane * 8 + i;
        before = above;
      }
      above += c[i];
    }
    const int src = __ffs(__ballot_sync(kFullMask, digit >= 0)) - 1;
    digit = __shfl_sync(kFullMask, digit, src);
    need -= __shfl_sync(kFullMask, before, src);
    prefix |= unsigned(digit) << shift;
    fixed |= 255u << shift;
    __syncwarp();  // every lane has read the bins before they are cleared
  }
  return key_value(prefix);
}

// Cut one query's buffer (cnt > k entries, in position order) to its
// first k under (value desc, position asc), keeping their order: the
// entries above the k-th value V and the first of those equal to it.
// Returns V: a later candidate (a larger position) must exceed it.
__device__ float warp_cut(float* bv, int* bp, int cnt, int k, int* hist) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const float kth = warp_kth_largest(bv, cnt, k, hist);
  int above = 0;
  for (int e = lane; e < cnt; e += 32) above += bv[e] > kth;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    above += __shfl_xor_sync(kFullMask, above, o);
  int ties = k - above;  // equal to V and kept: the first ones
  int out = 0;
  for (int base = 0; base < cnt; base += 32) {
    const int e = base + lane;
    const float v = e < cnt ? bv[e] : neg_inf();
    const int p = e < cnt ? bp[e] : 0;
    const bool tie = e < cnt && v == kth;
    const unsigned mt = __ballot_sync(kFullMask, tie);
    const bool keep = v > kth || (tie && __popc(mt & lower) < ties);
    ties -= __popc(mt);
    const unsigned mk = __ballot_sync(kFullMask, keep);
    __syncwarp();  // every lane has read its entry; slots <= entries
    if (keep) {
      const int slot = out + __popc(mk & lower);
      bv[slot] = v;
      bp[slot] = p;
    }
    out += __popc(mk);
    __syncwarp();
  }
  return kth;
}

// -- stage 1 ----------------------------------------------------------------

// Block (x, r): queries [kBQ x, kBQ (x + 1)) and rows [r * span, min((r +
// 1) * span, n_rows)) of the superchunk; writes each query's survivors (at
// most min(span, k + kBN), the rest padded with (-inf, INT_MAX)) to the
// workspace.
template <class T, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
score_range_kernel(const float* __restrict__ queries,
                   const float* __restrict__ docs,
                   const int* __restrict__ n_valids,
                   const float* __restrict__ vals, int n_q, int d, int n_rows,
                   int c, int k, int span, float* __restrict__ ws_v,
                   int* __restrict__ ws_p) {
  constexpr int kTN = T::kTN, kBQ = T::kBQ, kBN = T::kBN, kLdS = T::kLdS;
  constexpr int kQueriesPerWarp = T::kTM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cap = buffer_cap<T>(k);
  const Smem s = carve<T>(smem_raw, cap);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int q0 = blockIdx.x * kBQ;
  const int row0 = blockIdx.y * span;
  const int row1 = min(row0 + span, n_rows);
  int* hist = s.hist + warp * 256;

  // Warp w filters queries q0 + w + 8 i; each starts at its state's
  // smallest value (NaN as -inf).  All the state's loads are issued
  // before any is used.
  float thr[kQueriesPerWarp];
  int cnt[kQueriesPerWarp];
  float st[kQueriesPerWarp][kMaxK / 32];
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int q = q0 + warp + kWarps * i;
#pragma unroll
    for (int u = 0; u < kMaxK / 32; ++u) {
      const int p = lane + 32 * u;
      st[i][u] = q < n_q && p < k ? vals[size_t(q) * k + p] : -neg_inf();
    }
  }
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    float lo = -neg_inf();
#pragma unroll
    for (int u = 0; u < kMaxK / 32; ++u)
      lo = fminf(lo, isnan(st[i][u]) ? neg_inf() : st[i][u]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lo = fminf(lo, __shfl_xor_sync(kFullMask, lo, o));
    thr[i] = lo;
    cnt[i] = 0;
  }

  for (int t0 = row0; t0 < row1; t0 += kBN) {
    score_tile<T, kVec>(s, queries, docs, q0, n_q, t0, row1, d);
    // lane l takes rows t0 + l + 32 j of the tile
    bool valid[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int row = t0 + lane + 32 * j;
      const int step = row / c;
      valid[j] = row < row1 && row - step * c < n_valids[step];
    }
#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      const int qb = warp + kWarps * i;
      if (q0 + qb >= n_q) break;  // uniform across the warp
      float* bv = s.bv + qb * cap;
      int* bp = s.bp + qb * cap;
      float v[kTN];
      unsigned m[kTN];
      int total = 0;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float x = s.sc[qb * kLdS + lane + 32 * j];
        v[j] = valid[j] && !isnan(x) ? x : neg_inf();
        m[j] = __ballot_sync(kFullMask, v[j] > thr[i]);
        total += __popc(m[j]);
      }
      if (total == 0) continue;
      if (cnt[i] + total > cap) {  // uniform; cnt > cap - kBN >= k
        thr[i] = warp_cut(bv, bp, cnt[i], k, hist);
        cnt[i] = k;
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          m[j] = __ballot_sync(kFullMask, v[j] > thr[i]);
      }
      // append in row order
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (m[j] >> lane & 1u) {
          const int slot = cnt[i] + __popc(m[j] & lower);
          bv[slot] = v[j];
          bp[slot] = k + t0 + lane + 32 * j;
        }
        cnt[i] += __popc(m[j]);
      }
      __syncwarp();
    }
  }

  // The survivors, in position order, to the workspace: a superset of
  // the range's top k, as the merge pass needs (cutting them to k here
  // would cost a warp a selection per query; the merge pass cuts once).
  const int width = min(span, cap);
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int qb = warp + kWarps * i;
    if (q0 + qb >= n_q) break;
    const float* bv = s.bv + qb * cap;
    const int* bp = s.bp + qb * cap;
    const size_t w = (size_t(q0 + qb) * gridDim.y + blockIdx.y) * width;
    for (int e = lane; e < width; e += 32) {
      const bool real = e < cnt[i];
      ws_v[w + e] = real ? bv[e] : neg_inf();
      ws_p[w + e] = real ? bp[e] : INT_MAX;
    }
  }
}

// -- stage 2 ----------------------------------------------------------------

// Block q merges its state with the splits * per partials; a winning row
// r of the superchunk gets id offsets[r / c] + r % c.
__global__ void __launch_bounds__(topk_select::kThreads)
fused_merge_kernel(float* __restrict__ vals, int* __restrict__ ids,
                   const int* __restrict__ offsets, int c, int k, int n,
                   const float* __restrict__ ws_v,
                   const int* __restrict__ ws_p) {
  __shared__ Buffer s;
  __shared__ int si[kMaxK];
  topk_select::merge_partials(s, si, vals, ids, blockIdx.x, k, n, ws_v, ws_p,
                              [=](int row) {
                                const int step = row / c;
                                return offsets[step] + (row - step * c);
                              });
}

template <class T, bool kVec>
cudaError_t launch_ranges(const float* queries, const float* docs,
                          const int* n_valids, const float* vals, int n_q,
                          int d, int n_rows, int c, int k, int splits,
                          int span, float* ws_v, int* ws_p,
                          cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(k);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        score_range_kernel<T, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n_q + T::kBQ - 1) / T::kBQ, splits);
  score_range_kernel<T, kVec><<<grid, kThreads, bytes, stream>>>(
      queries, docs, n_valids, vals, n_q, d, n_rows, c, k, span, ws_v, ws_p);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_ranges(const float* queries, const float* docs,
                          const int* n_valids, const float* vals, int n_q,
                          int d, int n_rows, int c, int k, int splits,
                          int span, float* ws_v, int* ws_p,
                          cudaStream_t stream) {
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(docs) % 16 == 0;
  return vec ? launch_ranges<T, true>(queries, docs, n_valids, vals, n_q, d,
                                      n_rows, c, k, splits, span, ws_v, ws_p,
                                      stream)
             : launch_ranges<T, false>(queries, docs, n_valids, vals, n_q, d,
                                       n_rows, c, k, splits, span, ws_v,
                                       ws_p, stream);
}

}  // namespace

extern "C" {

// K1: queries (n_q, d), docs (s*c, d) f32; offsets, n_valids (s,) i32;
// vals (n_q, k) f32 and ids (n_q, k) i32 updated in place.  The s*c rows
// split into `splits` ranges of `span`, scored in tiles of `rows` (128:
// 32 queries a block; 32: 16 queries a block); ws_vals / ws_pos are (n_q,
// splits, min(span, k + rows)) scratch.
int repro_fused_score_topk(const float* queries, const float* docs,
                           const int* offsets, const int* n_valids, int n_q,
                           int d, int s, int c, int k, int rows, int splits,
                           int span, float* vals, int* ids, float* ws_vals,
                           int* ws_pos, void* stream) {
  const long long n_rows = (long long)s * c;
  if (k < 1 || k > kMaxK || n_q < 1 || d < 1 || c < 1 || n_rows < 1 ||
      (rows != Wide::kBN && rows != Narrow::kBN) || splits < 1 ||
      splits > 65535 || span < 1 || (long long)(splits - 1) * span >= n_rows ||
      (long long)splits * span + k > INT_MAX ||
      (long long)splits * min(span, k + rows) > INT_MAX / 2 ||
      ws_vals == nullptr || ws_pos == nullptr)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      rows == Wide::kBN
          ? launch_ranges<Wide>(queries, docs, n_valids, vals, n_q, d,
                                int(n_rows), c, k, splits, span, ws_vals,
                                ws_pos, st)
          : launch_ranges<Narrow>(queries, docs, n_valids, vals, n_q, d,
                                  int(n_rows), c, k, splits, span, ws_vals,
                                  ws_pos, st);
  if (e != cudaSuccess) return int(e);
  fused_merge_kernel<<<n_q, topk_select::kThreads, 0, st>>>(
      vals, ids, offsets, c, k, splits * min(span, k + rows), ws_vals,
      ws_pos);
  return int(cudaGetLastError());
}

// Dynamic shared memory one K1 stage-1 block needs at depth k (the larger
// tile's), for the wrapper's limit check.
long long repro_topk_smem_bytes(int k) {
  return static_cast<long long>(max(smem_bytes<Wide>(k),
                                    smem_bytes<Narrow>(k)));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
