// K2  repro_topk_update: the streaming top-k merge for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes).  Built by
// repro_torch/kernels/_build.py.
//
// Replaces the TPU kernel src/repro/kernels/topk.py::topk_update_pallas
// (:67): merges a (Q, C) score chunk with ids (C,) into the (Q, k) state
// (vals, ids) in place.  The new state is the first k of a stable
// descending sort over [state | candidates] (kernels/ref.py::
// topk_update_ref): NaN reads as -inf, state slot p sits at position p
// (the incoming state need not be sorted), candidate column c at k + c.
//
// What bounds it on an H100: it reads Q*C*4 bytes of scores once, plus
// the state, and does a comparison or two per score, so it is bound by
// bytes (3.35 TB/s).  That needs many blocks streaming at once, where a
// block per query tile walking every column in serial tiles leaves SMs
// idle (Q = 1 ran one block) and pays a merge per tile.  So:
//   * The column axis is split into `splits` ranges of `span` columns
//     (the wrapper picks them from Q, C and the card's SM count): the
//     grid is (Q, splits), one block per query and range, each thread
//     reading 16 aligned bytes per tile.
//   * Stage 1: a block keeps only the scores strictly above its threshold
//     (the state's smallest value, below which a score has k state
//     entries ahead of it, and the range's own running k-th value), so
//     after the first tiles almost nothing reaches shared memory; a full
//     buffer is cut by a radix selection of its k-th value and sorted
//     only at the end (topk_select.cuh).  A score outside its range's
//     top-k has k entries of the range ahead of it, so each range hands
//     on just its k best.
//   * With splits = 1 the state itself starts in the buffer and stage 1
//     writes the new state: one launch.  With splits > 1 stage 1 writes
//     each range's top k to a (Q, splits, k) workspace and stage 2 (one
//     block per query) merges the state with the splits * k partials in
//     one pass of the same routine; chunk_ids are read for the k winners
//     only.  A wrapper call counts as one launch either way.

#include <cstdint>

#include "topk_select.cuh"

namespace {

using namespace topk_select;

// Stage 1: block (q, r) takes columns [r * span, min((r + 1) * span,
// n_cols)) of query q.
__global__ void __launch_bounds__(kThreads)
range_topk_kernel(float* __restrict__ vals, int* __restrict__ ids,
                  const float* __restrict__ scores,
                  const int* __restrict__ chunk_ids, int n_cols, int k,
                  int span, float* __restrict__ ws_v,
                  int* __restrict__ ws_p) {
  __shared__ Buffer s;
  __shared__ int si[kMaxK];
  const int q = blockIdx.x;
  const int r = blockIdx.y;
  const bool direct = gridDim.y == 1;
  const float least = load_state(s, si, vals, ids, q, k, direct);

  // Tiles start at the 16-byte boundary at or below the range's first
  // column; columns outside the range read as NaN.  An aligned 16-byte
  // load that holds one column of the tensor stays inside its allocation.
  const float* row = scores + size_t(q) * n_cols;
  const int c0 = r * span;
  const int c1 = min(c0 + span, n_cols);
  const int a0 = c0 - int((reinterpret_cast<uintptr_t>(row + c0) >> 2) & 3);
  const float4* groups = reinterpret_cast<const float4*>(row + a0);
  const int n_groups = (c1 - a0 + 3) / 4;
  const int n_tiles = (n_groups + kThreads - 1) / kThreads;
  auto load = [&](int tile, float* v) {
    const int g = tile * kThreads + threadIdx.x;
    float4 x = make_float4(nan_f(), nan_f(), nan_f(), nan_f());
    if (g < n_groups) x = __ldg(groups + g);
    const int col = a0 + 4 * g;
    v[0] = col >= c0 && col < c1 ? x.x : nan_f();
    v[1] = col + 1 >= c0 && col + 1 < c1 ? x.y : nan_f();
    v[2] = col + 2 >= c0 && col + 2 < c1 ? x.z : nan_f();
    v[3] = col + 3 >= c0 && col + 3 < c1 ? x.w : nan_f();
  };
  auto pos = [&](int tile, int j) {
    return k + a0 + 4 * (tile * kThreads + int(threadIdx.x)) + j;
  };
  select_stream(s, k, least, n_tiles, load, pos);

  if (direct) {
    store_state(s, si, vals, ids, q, k,
                [=](int col) { return chunk_ids[col]; });
    return;
  }
  const size_t w = (size_t(q) * gridDim.y + r) * k;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const bool real = i < s.cnt;
    ws_v[w + i] = real ? s.v[i] : neg_inf();
    ws_p[w + i] = real ? s.p[i] : INT_MAX;
  }
}

// Stage 2: block q merges its state with the splits * k partials, read in
// workspace order (ranges ascending, each sorted); chunk_ids are read for
// the k winners only.
__global__ void __launch_bounds__(kThreads)
merge_partials_kernel(float* __restrict__ vals, int* __restrict__ ids,
                      const int* __restrict__ chunk_ids, int k, int splits,
                      const float* __restrict__ ws_v,
                      const int* __restrict__ ws_p) {
  __shared__ Buffer s;
  __shared__ int si[kMaxK];
  merge_partials(s, si, vals, ids, blockIdx.x, k, splits * k, ws_v, ws_p,
                 [=](int col) { return chunk_ids[col]; });
}

}  // namespace

extern "C" {

// K2: scores (n_q, n_cols) f32, chunk_ids (n_cols,) i32; vals / ids
// (n_q, k) updated in place.  Columns split into `splits` ranges of
// `span`; with splits > 1, ws_vals / ws_pos are (n_q, splits, k) scratch.
int repro_topk_update(float* vals, int* ids, const float* scores,
                      const int* chunk_ids, int n_q, int n_cols, int k,
                      int splits, int span, float* ws_vals, int* ws_pos,
                      void* stream) {
  if (k < 1 || k > kMaxK || n_q < 1 || n_cols < 1 || splits < 1 ||
      splits > 65535 || span < 1 || (long long)(splits - 1) * span >= n_cols ||
      (long long)splits * span + k > INT_MAX ||
      (splits > 1 && (ws_vals == nullptr || ws_pos == nullptr)))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  range_topk_kernel<<<dim3(n_q, splits), kThreads, 0, st>>>(
      vals, ids, scores, chunk_ids, n_cols, k, span, ws_vals, ws_pos);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return int(e);
  merge_partials_kernel<<<n_q, kThreads, 0, st>>>(vals, ids, chunk_ids, k,
                                                  splits, ws_vals, ws_pos);
  return int(cudaGetLastError());
}

}  // extern "C"
