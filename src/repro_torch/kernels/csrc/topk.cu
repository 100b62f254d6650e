// Streaming top-k kernel K1 for Hopper (sm_90a), bound to PyTorch through
// a plain C interface (ctypes).  Built by repro_torch/kernels/_build.py.
//
// K1  repro_fused_score_topk  replaces the TPU kernel
//     src/repro/kernels/topk.py::fused_score_topk_pallas (:130) and the
//     superchunk scan that hosts it (src/repro/kernels/ops.py:116).
//     It folds a whole (S*C, d) superchunk of corpus rows into a running
//     (Q, k) top-k state, in place: one launch per superchunk, and the
//     (Q, S*C) score matrix never exists in device memory.
// K2 (the merge of a given score chunk) has kernels of its own in
// topk_update.cu; the template's kFused = false branches below are what
// K2 ran before, and are no longer instantiated.
//
// What bounds K1 on an H100: it does 2*Q*N*d float32 operations on
// N*d*4 bytes of corpus rows, so at the main-path shapes (Q=256, d=768)
// it is bound by the float32 rate (67 TFLOP/s outside the tensor cores),
// not by memory (3.35 TB/s).
//
// Design (right by construction first; speed is for a later change):
//   * One block of 256 threads owns kQB = 4 queries and loops over every
//     column (corpus row) in passes of kTile = 256.  The TPU's sequential
//     grid axis over the corpus becomes this loop; the running state lives
//     in shared memory for the whole launch.  A block per query tile
//     leaves SMs idle when Q/4 < 132, and every block reads all rows: the
//     next step is a register-tiled product shared by more queries.
//   * K1 scores with float32 FMAs (no tensor cores, no TF32): each warp
//     takes one row, lanes stride over d, and a fixed xor-shuffle tree
//     sums the lanes, so the result is deterministic.  NaN and rows at or
//     past n_valids[step] score -inf.
//   * Selection is the plain version's rule (kernels/ref.py): the first k
//     of a stable descending sort over [state | candidates].  A pass keeps
//     only the columns strictly above the current k-th value (a tie with
//     the state loses, because the state comes first); those are gathered
//     with shared-memory atomics in any order, then every element's new
//     position is computed as the number of elements ahead of it in the
//     total order (value descending, then stream position ascending).
//     That order is total, so the atomics' order cannot change the result.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 4;        // queries per block
constexpr int kTile = 256;    // columns examined per pass
constexpr int kMaxK = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Shared memory, carved from one dynamic allocation (all 4-byte types).
struct Smem {
  float* q;    // [kQB][d]        query rows (K1 only)
  float* sv;   // [2][kQB][k]     state values, double buffered
  float* tv;   // [kQB][kTile]    this pass's scores
  float* cv;   // [kQB][kTile]    candidates kept by the filter
  int* si;     // [2][kQB][k]     state ids
  int* ct;     // [kQB][kTile]    candidate column within the pass
  int* ci;     // [kQB][kTile]    candidate id
  int* cn;     // [kQB]           candidate counts
};

size_t smem_bytes(bool fused, int d, int k) {
  const size_t floats = (fused ? size_t(kQB) * d : 0) + 2 * size_t(kQB) * k +
                        2 * size_t(kQB) * kTile;
  const size_t ints = 2 * size_t(kQB) * k + 2 * size_t(kQB) * kTile + kQB;
  return (floats + ints) * 4;
}

__device__ Smem carve(unsigned char* raw, bool fused, int d, int k) {
  Smem s;
  float* f = reinterpret_cast<float*>(raw);
  s.q = f;  f += fused ? kQB * d : 0;
  s.sv = f; f += 2 * kQB * k;
  s.tv = f; f += kQB * kTile;
  s.cv = f; f += kQB * kTile;
  int* n = reinterpret_cast<int*>(f);
  s.si = n; n += 2 * kQB * k;
  s.ct = n; n += kQB * kTile;
  s.ci = n; n += kQB * kTile;
  s.cn = n;
  return s;
}

// New state of one query: the first k of [state | m candidates] under
// (value desc, position asc).  The state holds positions 0..k-1; candidate
// j sits after the whole state, ordered among the candidates by ct[j].
// Whole block; reads (sv, si) and writes (nv, ni).
__device__ void merge_one(const float* sv, const int* si, float* nv, int* ni,
                          const float* cv, const int* ct, const int* ci,
                          int m, int k) {
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const float v = cv[i];
    const int t = ct[i];
    int pos = 0;
    for (int j = 0; j < m; ++j) {
      const float w = cv[j];
      pos += (w > v) || (w == v && ct[j] < t);
    }
    for (int p = 0; p < k; ++p) pos += sv[p] >= v;
    if (pos < k) { nv[pos] = v; ni[pos] = ci[i]; }
  }
  for (int p = threadIdx.x; p < k; p += kThreads) {
    const float v = sv[p];
    int pos = 0;
    for (int r = 0; r < k; ++r) {
      const float w = sv[r];
      pos += (w > v) || (w == v && r < p);
    }
    for (int j = 0; j < m; ++j) pos += cv[j] > v;
    if (pos < k) { nv[pos] = v; ni[pos] = si[p]; }
  }
}

// kFused: columns are corpus rows (K1), scored here against the queries;
// step = col / c, row = col % c, id = offsets[step] + row.
// !kFused: columns are given scores (K2) with ids chunk_ids[col].
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ queries, const float* __restrict__ docs,
            const int* __restrict__ offsets, const int* __restrict__ n_valids,
            const float* __restrict__ scores, const int* __restrict__ chunk_ids,
            int n_q, int d, int n_cols, int c, int k,
            float* __restrict__ vals, int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, kFused, d, k);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kQB;
  const int nq = min(kQB, n_q - q0);
  const int buf = kQB * k;  // one state buffer

  // 1. Load the incoming state (NaN read as -inf) and the query rows.
  for (int e = tid; e < nq * k; e += kThreads) {
    const float v = vals[size_t(q0) * k + e];
    s.sv[buf + e] = isnan(v) ? neg_inf() : v;
    s.si[buf + e] = ids[size_t(q0) * k + e];
  }
  if (kFused) {
    for (int e = tid; e < kQB * d; e += kThreads)
      s.q[e] = e < nq * d ? queries[size_t(q0) * d + e] : 0.f;
  }
  if (tid < kQB) s.cn[tid] = 0;
  __syncthreads();
  // Order the incoming state (every producer leaves it sorted already;
  // this makes the result independent of that).
  for (int qb = 0; qb < nq; ++qb)
    merge_one(s.sv + buf + qb * k, s.si + buf + qb * k, s.sv + qb * k,
              s.si + qb * k, s.cv, s.ct, s.ci, 0, k);
  int cur = 0;
  __syncthreads();

  for (int base = 0; base < n_cols; base += kTile) {
    // 2. This pass's scores, -inf where masked or NaN.
    if (kFused) {
      for (int t = warp; t < kTile; t += kWarps) {
        const int col = base + t;
        bool valid = false;
        if (col < n_cols) {
          const int step = col / c;
          valid = col - step * c < n_valids[step];
        }
        float acc[kQB];
#pragma unroll
        for (int qb = 0; qb < kQB; ++qb) acc[qb] = 0.f;
        if (valid) {  // uniform across the warp
          const float* row = docs + size_t(col) * d;
          for (int e = lane; e < d; e += 32) {
            const float x = __ldg(row + e);
#pragma unroll
            for (int qb = 0; qb < kQB; ++qb)
              acc[qb] = fmaf(s.q[qb * d + e], x, acc[qb]);
          }
        }
#pragma unroll
        for (int qb = 0; qb < kQB; ++qb) {
          float a = acc[qb];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFullMask, a, o);
          acc[qb] = a;
        }
        if (lane == 0) {
#pragma unroll
          for (int qb = 0; qb < kQB; ++qb)
            s.tv[qb * kTile + t] =
                valid && !isnan(acc[qb]) ? acc[qb] : neg_inf();
        }
      }
    } else {
      for (int e = tid; e < kQB * kTile; e += kThreads) {
        const int qb = e / kTile;
        const int col = base + e - qb * kTile;
        float v = neg_inf();
        if (qb < nq && col < n_cols) {
          v = scores[size_t(q0 + qb) * n_cols + col];
          if (isnan(v)) v = neg_inf();
        }
        s.tv[e] = v;
      }
    }
    __syncthreads();

    // 3. Keep the columns strictly above the current k-th value.
    for (int e = tid; e < nq * kTile; e += kThreads) {
      const int qb = e / kTile;
      const int t = e - qb * kTile;
      const float v = s.tv[e];
      if (v > s.sv[cur * buf + qb * k + k - 1]) {
        const int slot = atomicAdd(&s.cn[qb], 1);
        const int col = base + t;
        s.cv[qb * kTile + slot] = v;
        s.ct[qb * kTile + slot] = t;
        s.ci[qb * kTile + slot] =
            kFused ? offsets[col / c] + col % c : chunk_ids[col];
      }
    }
    __syncthreads();

    // 4. Merge the kept candidates into the other state buffer.
    int total = 0;
#pragma unroll
    for (int qb = 0; qb < kQB; ++qb) total += s.cn[qb];
    if (total > 0) {  // uniform across the block
      const int nxt = cur ^ 1;
      for (int qb = 0; qb < nq; ++qb)
        merge_one(s.sv + cur * buf + qb * k, s.si + cur * buf + qb * k,
                  s.sv + nxt * buf + qb * k, s.si + nxt * buf + qb * k,
                  s.cv + qb * kTile, s.ct + qb * kTile, s.ci + qb * kTile,
                  s.cn[qb], k);
    }
    __syncthreads();
    if (total > 0) cur ^= 1;
    if (tid < kQB) s.cn[tid] = 0;
  }

  // 5. Write the state back in place.
  for (int e = tid; e < nq * k; e += kThreads) {
    vals[size_t(q0) * k + e] = s.sv[cur * buf + e];
    ids[size_t(q0) * k + e] = s.si[cur * buf + e];
  }
}

template <bool kFused>
int launch(const float* queries, const float* docs, const int* offsets,
           const int* n_valids, const float* scores, const int* chunk_ids,
           int n_q, int d, int n_cols, int c, int k, float* vals, int* ids,
           cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return int(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(kFused, d, k);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(bytes));
    if (e != cudaSuccess) return int(e);
  }
  const int blocks = (n_q + kQB - 1) / kQB;
  topk_kernel<kFused><<<blocks, kThreads, bytes, stream>>>(
      queries, docs, offsets, n_valids, scores, chunk_ids, n_q, d, n_cols, c,
      k, vals, ids);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: queries (n_q, d), docs (s*c, d) f32; offsets, n_valids (s,) i32;
// vals (n_q, k) f32 and ids (n_q, k) i32 updated in place.
int repro_fused_score_topk(const float* queries, const float* docs,
                           const int* offsets, const int* n_valids, int n_q,
                           int d, int s, int c, int k, float* vals, int* ids,
                           void* stream) {
  return launch<true>(queries, docs, offsets, n_valids, nullptr, nullptr, n_q,
                      d, s * c, c, k, vals, ids,
                      static_cast<cudaStream_t>(stream));
}

// Shared memory a launch needs, for the wrapper's limit check.
long long repro_topk_smem_bytes(int fused, int d, int k) {
  return static_cast<long long>(smem_bytes(fused != 0, d, k));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
