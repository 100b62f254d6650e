// EmbeddingBag backward (the table's gradient) for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes).  Built by
// repro_torch/kernels/_build.py.
//
// K4T  repro_embedding_bag_backward  is the backward of K4
//     (csrc/embedding_bag.cu).  It replaces no TPU kernel: the reference
//     differentiates its bag sums (jnp.take + sum, src/repro/models/
//     recsys.py:240, :246) through XLA's scatter-add.  It computes
//       d_table[r, :] = sum over (b, l) with idx[b, l] = r of
//                       (g[b, :] * mask[b, l]) * w[b, l]
//     for (B, D) bag gradients g, (B, L) int32 ids with -1 as padding (a
//     padded slot reads row 0 with mask 0) and optional (B, L) float32
//     weights, accumulated in float32 and written in g's dtype (the
//     table's).  Ids >= V read no row in the forward and add nothing.
//
// What bounds it on an H100: bytes.  The gradient is a dense (V, D) table:
// at DeepFM's train_batch (B = 65,536, L = 39, V = 34.3 M, D = 10) writing
// it is 1.37 GB of the 1.39 GB the function must move (ids 10 MB, g 2.6
// MB), 0.41 ms at 3.35 TB/s.  So the table is written once, here, with
// no zero fill before the launch: every row, touched or not, leaves the
// kernel in one pass of wide stores.  The wrapper (kernels/
// embedding_bag.py) only sorts the B*L ids (torch.sort, stable), once per
// set of ids (ops.BagKeys shares it between DeepFM's two bag sums).
//
// Design (deterministic: the only atomics set flags):
//   * The wrapper hands over the ids' rows sorted stably (keys: padding as
//     INT_MAX, past every row when V <= INT_MAX) with each one's flat
//     position b * L + l (order).  A stable sort keeps a row's
//     contributions in ascending flat position.  Entries whose key is not
//     a row (padding, ids >= V) are past the last row's: the blocks find
//     where they start with one search and never see them.  Were padding
//     sorted onto row 0, as the plain version reads it, a psum lookup's
//     row shard (97 % of its ids another shard's, -1) would make row 0 one
//     serial run of over a million adds.
//   * A padded slot still adds (g * 0) * w to row 0 in the plain version:
//     +-0.0, which leaves a float32 sum that starts at +0.0 as it is, or
//     NaN where g or w is not finite.  A first pass over the ids (pad_pass)
//     sets a flag for each column where a padded slot gives NaN, and the
//     block that owns row 0 starts that column's sum at NaN.
//   * Persistent blocks, each a contiguous run of rows.  The runs are cut
//     by work, not by rows: a row weighs its bytes, an entry `entry_w`
//     bytes (the plan's; 160 + 10 D measured best), and one search over
//     the sorted keys finds where each block starts and its first entry.
//     CTR fields are lopsided -- DeepFM's small-vocabulary fields put
//     most of the 2.56 M ids on the last 1 % of the rows -- so runs of
//     equal rows would leave a few blocks with most of the entries and
//     the rest waiting on them; a row's entries are never split (its sum
//     is one chain).  The wrapper's plan launches two waves of blocks
//     where the table is wide, and the card's scheduler hands the second
//     wave to the SMs that finish first.
//   * A block walks its run in tiles of `tile_rows` rows, staged in shared
//     memory as float32 sums, all +0.0 at the start.  Its entries come in
//     batches of up to one per thread, read one batch ahead (keys and
//     positions) so that staging a batch waits only on its gathers, and a
//     batch spans as many tiles as its entries fall in (in the sparse
//     fields, many: most tiles get a few entries).  Staging issues
//     every gather of the batch (a thread per entry: its bag's gradient
//     row, the padding test, the weight) before any add.
//   * A tile's entries among the staged ones are a prefix (the keys are
//     sorted).  The block marks where each run of equal keys starts, and
//     one thread per (run, column) adds the run's products into the staged
//     sum in entry order: a hot id's run of thousands of entries is a
//     chain of shared-memory adds, batch after batch, not a chain of
//     dependent global loads.
//   * So each (row, column) sum starts from +0.0, adds (g * mask) * w
//     through __fmul_rn / __fadd_rn (no FMA contraction) in ascending
//     flat position, batch after batch, and is rounded once when the tile
//     is written: exactly the plain version (kernels/ref.py
//     embedding_bag_backward_ref), bitwise, under every plan (tile rows,
//     threads, grid, entry weight).
//   * The write-out reads each staged value once, converts it to the
//     output dtype and puts +0.0 back (the next tile starts clean).  Bytes
//     before the first 16-byte boundary of the tile and after the last one
//     go out as single elements (bf16 rows of 20 bytes, D = 7, an `out`
//     that is a view at an odd offset); the rest as 16-byte streaming
//     stores (st.global.cs: the table, written once, should not fill
//     L2).  The staging offset inside shared memory follows the tile's
//     address modulo 16, so the wide loads line up with the wide stores.
//     A TMA bulk copy (cp.async.bulk, shared -> global) from a second,
//     converted buffer, two in turn, was built beside these stores, held
//     bitwise on the card and measured slower at every row (its
//     conversion pass and second buffer cost shared memory and blocks per
//     SM; PERF.md §6), so it was taken out.
//   * Row and byte offsets are 64-bit: V * D passes 2^31 at full width,
//     and V may pass 2^31 (every int32 id is a row).  Then padding's key
//     INT_MAX is a row, and the gather reads idx[p] on that row's run to
//     add +0.0 for a padded slot (which changes no sum: a sum from +0.0 is
//     never -0.0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// A batch's staged products, in floats: batch = min(threads, this / D).
constexpr int kValsFloats = 2560;
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Two bf16 values, each rounded to nearest even, `lo` in the low half.
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 16 bytes of output from the staged sums at `src` (16-byte aligned),
// which it sets back to +0.0.
template <typename T>
__device__ __forceinline__ uint4 take16(float* src);
template <>
__device__ __forceinline__ uint4 take16<float>(float* src) {
  uint4* s = reinterpret_cast<uint4*>(src);
  const uint4 a = *s;
  *s = make_uint4(0u, 0u, 0u, 0u);
  return a;
}
template <>
__device__ __forceinline__ uint4 take16<__nv_bfloat16>(float* src) {
  float4* s = reinterpret_cast<float4*>(src);
  const float4 a = s[0], b = s[1];
  s[0] = s[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                    pack2(b.z, b.w));
}

// A 16-byte store that streams past the caches (st.global.cs): the table
// is written once and not read again by this kernel, so it should not
// push the ids and the gradient out of L2.
__device__ __forceinline__ void store16(void* dst, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// A block's shared memory, in bytes from its 16-byte-aligned start; the
// wrapper's backward_smem (kernels/embedding_bag.py) mirrors it.
struct Layout {
  int batch;       // entries a batch holds
  int acc;         // float[tile_rows * dim + 4]: the staged sums
  int vals;        // float[batch * dim]: the batch's products
  int keys;        // int[batch]
  int seg;         // int[batch + 1]: where each run of equal keys starts
  int warp;        // int[32]: runs a warp
  int total;
};

__host__ __device__ inline Layout layout(int tile_rows, int threads,
                                         int dim) {
  Layout l;
  const int fit = kValsFloats / dim;
  l.batch = threads < fit ? threads : (fit > 1 ? fit : 1);
  int at = 0;
  l.acc = at;
  at += round16(4 * (tile_rows * dim + 4));
  l.vals = at;
  at += round16(4 * l.batch * dim);
  l.keys = at;
  at += round16(4 * l.batch);
  l.seg = at;
  at += round16(4 * (l.batch + 1));
  l.warp = at;
  at += round16(4 * 32);
  l.total = at;
  return l;
}

// The first index in [lo, hi) where `below` is false (hi if none), for
// a `below` that is true up to some index and false from there: every
// thread probes one index a round, so the range shrinks by the block's
// size (~4 rounds over 2.56 M entries).  Called by the whole block.
template <typename Below>
__device__ long long first_not_below(long long lo, long long hi,
                                     Below below) {
  while (lo < hi) {
    const long long step = (hi - lo + blockDim.x - 1) / blockDim.x;
    const long long p = lo + static_cast<long long>(threadIdx.x) * step;
    const int c = __syncthreads_count(p < hi && below(p));
    if (c == 0) {
      hi = lo;
    } else {
      const long long next = lo + (c - 1) * step + 1;
      hi = lo + c * step < hi ? lo + c * step : hi;
      lo = next;
    }
  }
  return lo;
}

// Where the entries that are not rows start: the first with key >= n_rows.
__device__ long long rows_end(const int* __restrict__ keys, long long n,
                              long long n_rows) {
  return first_not_below(0, n, [&](long long p) {
    return static_cast<long long>(keys[p]) < n_rows;
  });
}

// Where block `blk` of `grid` starts: the first row r whose work before
// it, W(r) = r * row_w + S(r) * entry_w (S(r): entries with key < r;
// row_w: a row's bytes; entry_w: an entry's work in bytes written in the
// same time), reaches blk / grid of the whole, and S(r), the block's
// first entry.  W is flat in S between the rows of two neighbouring keys,
// so one search over the entries finds the key interval and the row
// inside it.  Monotone in blk; row 0 for the first block and n_rows past
// the last.  `n`: the entries with a row's key (rows_end).  A row's
// entries are never split between blocks (its sum is one chain); a dense
// stretch of rows is.
struct Split {
  long long row, entry;
};

__device__ Split split_row(const int* __restrict__ keys, long long n,
                           long long n_rows, long long row_w,
                           long long entry_w, long long blk, long long grid) {
  if (blk <= 0) return {0, 0};
  if (blk >= grid) return {n_rows, n};
  const long long total = n_rows * row_w + n * entry_w;
  // the target, blk * total / grid, without overflow
  const long long target = blk * (total / grid) + blk * (total % grid) / grid;
  // tau(i): the first row past key i - 1 (0 for i = 0); S(r) = i for r in
  // [tau(i), tau(i + 1))
  auto tau = [&](long long i) -> long long {
    if (i <= 0) return 0;
    const long long r = static_cast<long long>(keys[i - 1]) + 1;
    return r < n_rows ? r : n_rows;
  };
  // the first entry i whose interval's end weight W(tau(i + 1)) reaches
  // the target
  const long long i = first_not_below(0, n, [&](long long k) {
    return tau(k + 1) * row_w + (k + 1) * entry_w < target;
  });
  const long long lo = tau(i), hi = i < n ? tau(i + 1) : n_rows;
  // inside the interval W(r) = r * row_w + i * entry_w
  const long long need = target - i * entry_w;
  long long r = need <= 0 ? 0 : (need + row_w - 1) / row_w;
  r = r < lo ? lo : (r > hi ? hi : r);
  if (r < hi) return {r, i};
  // at the interval's end more entries may share key i's row
  return {r, first_not_below(i, n, [&](long long p) { return keys[p] < r; })};
}

// The first pass: nan_cols[c] = 1 where a padded slot's (g * 0) * w is
// NaN in column c (nan_cols zeroed before).  A thread a slot, a grid-stride
// loop over the flat ids.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(256)
    pad_pass(const T* __restrict__ grad, const int* __restrict__ idx,
             const float* __restrict__ weights, int n, int n_slots, int dim,
             int* __restrict__ nan_cols) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < n; p += stride) {
    if (idx[p] >= 0) continue;
    const T* g = grad + static_cast<size_t>(p / n_slots) * dim;
    float w = 1.0f;
    if (kWeighted) w = weights[p];
    for (int c = 0; c < dim; ++c) {
      float x = __fmul_rn(to_float(g[c]), 0.0f);
      if (kWeighted) x = __fmul_rn(x, w);
      if (x != x && nan_cols[c] == 0) atomicOr(nan_cols + c, 1);
    }
  }
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(1024)
    bag_backward_kernel(const T* __restrict__ grad,
                        const int* __restrict__ idx,
                        const float* __restrict__ weights,
                        const int* __restrict__ keys,
                        const int* __restrict__ order, int n_all, int n_slots,
                        long long n_rows, int dim, int tile_rows,
                        int entry_w, const int* __restrict__ nan_cols,
                        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const Layout lay = layout(tile_rows, nthreads, dim);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* vals = reinterpret_cast<float*>(smem + lay.vals);
  int* bkeys = reinterpret_cast<int*>(smem + lay.keys);
  int* seg = reinterpret_cast<int*>(smem + lay.seg);
  int* wruns = reinterpret_cast<int*>(smem + lay.warp);
  const int batch = lay.batch;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  // a thread's column and first run when the block adds runs: dim
  // threads a run, nthreads / dim runs at a time (dim <= nthreads; the
  // C entry point sees to it)
  const int col = tid % dim, run_step = nthreads / dim;
  const int run0 = tid < run_step * dim ? tid / dim : INT_MAX;

  // this block's rows, a contiguous run balanced by work, in tiles of
  // tile_rows from its first row; the entries past `n` are not rows
  const long long n = rows_end(keys, n_all, n_rows);
  const long long row_w = static_cast<long long>(dim) * sizeof(T);
  const Split first =
      split_row(keys, n, n_rows, row_w, entry_w, blockIdx.x, gridDim.x);
  const long long row_begin = first.row;
  const long long row_end =
      split_row(keys, n, n_rows, row_w, entry_w, blockIdx.x + 1, gridDim.x)
          .row;
  if (row_begin >= row_end) return;  // the whole block: no row here

  for (int i = tid; i < tile_rows * dim + 4; i += nthreads) acc[i] = 0.0f;
  __syncthreads();

  long long j = first.entry;  // the block's first entry: key >= row_begin

  // the next batch's key and position, one entry a thread, loaded a batch
  // ahead so that staging a batch waits on its gathers alone
  bool pin = false;
  int pkey = INT_MAX, ppos = 0;
  auto prefetch = [&]() {
    if (tid < batch) {
      const long long e = j + tid;
      pin = e < n;
      pkey = pin ? keys[e] : INT_MAX;
      ppos = pin ? order[e] : 0;
    }
  };
  prefetch();

  // the staged batch: entries [j - bcnt, j) of the block, their keys and
  // products in shared memory; entries before q0 are summed
  int bcnt = 0, q0 = 0;
  auto load_batch = [&]() {
    bool take = false;
    if (tid < batch) {
      take = pin && pkey < row_end;
      bkeys[tid] = take ? pkey : INT_MAX;
    }
    // the keys are sorted: the block's entries of this batch are a prefix
    bcnt = __syncthreads_count(take);
    // every gather of the batch before any add: a thread per entry, its
    // bag's gradient row (D values), mask and weight
    if (take) {
      const int p = ppos;
      const T* g = grad + static_cast<size_t>(p / n_slots) * dim;
      // padding on a row only when V > INT_MAX (its key is INT_MAX)
      const bool pad = pkey == INT_MAX && idx[p] < 0;
      float w = 1.0f;
      if (kWeighted) w = weights[p];
      float* dst = vals + tid * dim;
      for (int c = 0; c < dim; ++c) {
        float x = to_float(g[c]);
        if (kWeighted) x = __fmul_rn(x, w);
        dst[c] = pad ? 0.0f : x;
      }
    }
    j += bcnt;
    prefetch();
    q0 = 0;
    __syncthreads();
  };
  load_batch();

  for (long long r0 = row_begin; r0 < row_end; r0 += tile_rows) {
    const int nrow = static_cast<int>(
        row_end - r0 < tile_rows ? row_end - r0 : tile_rows);
    const long long r1 = r0 + nrow;
    T* gt = out + static_cast<size_t>(r0) * dim;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(gt) & 15);
    // the staged tile starts `off` floats in, so that a 16-byte piece of
    // the output is a 16-byte-aligned run of staged sums
    const int off = (mis / static_cast<int>(sizeof(T))) & 3;
    float* tacc = acc + off;
    if (r0 == 0) {
      // row 0's columns where a padded slot gives NaN (pad_pass)
      if (tid < dim && nan_cols[tid] != 0)
        tacc[tid] = __int_as_float(0x7fffffff);
      __syncthreads();
    }

    // the tile's staged entries [q0, q1), a batch at a time; once a batch
    // came back short, the block has no entries left to load
    while (q0 < bcnt || bcnt == batch) {
      if (q0 == bcnt) {
        load_batch();
        if (bcnt == 0) break;
      }
      const int q1 = __syncthreads_count(tid < bcnt && bkeys[tid] < r1);
      if (q1 > q0) {
        // where each run of equal keys starts among [q0, q1)
        const bool head = tid >= q0 && tid < q1 &&
                          (tid == q0 || bkeys[tid - 1] != bkeys[tid]);
        const unsigned ball = __ballot_sync(0xffffffffu, head);
        if (lane == 0) wruns[warp] = __popc(ball);
        __syncthreads();
        int before = 0, runs = 0;
        for (int w = 0; w < nwarps; ++w) {
          const int r = wruns[w];
          before += w < warp ? r : 0;
          runs += r;
        }
        if (head) seg[before + __popc(ball & ((1u << lane) - 1u))] = tid;
        if (tid == 0) seg[runs] = q1;
        __syncthreads();
        // one thread per (run, column): the run's products in entry order
        for (int s = run0; s < runs; s += run_step) {
          const int a = seg[s], z = seg[s + 1];
          float* dst = tacc + static_cast<int>(bkeys[a] - r0) * dim + col;
          float x = *dst;
#pragma unroll 8
          for (int q = a; q < z; ++q) x = __fadd_rn(x, vals[q * dim + col]);
          *dst = x;
        }
        __syncthreads();
      }
      q0 = q1;
      if (q0 < bcnt) break;  // the next staged entry is past this tile
    }

    // the write-out: every element of the tile once, +0.0 put back
    constexpr int kVec = 16 / sizeof(T);
    const int nel = nrow * dim;
    int head_el = ((16 - mis) & 15) / static_cast<int>(sizeof(T));
    if (head_el > nel) head_el = nel;
    const int body = (nel - head_el) / kVec;
    const int tail_at = head_el + body * kVec;
    for (int e = tid; e < head_el; e += nthreads) {
      gt[e] = from_float<T>(tacc[e]);
      tacc[e] = 0.0f;
    }
    for (int e = tail_at + tid; e < nel; e += nthreads) {
      gt[e] = from_float<T>(tacc[e]);
      tacc[e] = 0.0f;
    }
    for (int k = tid; k < body; k += nthreads) {
      const int e0 = head_el + k * kVec;
      store16(gt + e0, take16<T>(tacc + e0));
    }
    __syncthreads();
  }
}

template <typename T, bool kWeighted>
int launch(const void* grad, const int* idx, const float* weights,
           const int* keys, const int* order, int n, int n_slots,
           long long n_rows, int dim, int tile_rows, int threads, int grid,
           int entry_w, int* nan_cols, void* out, cudaStream_t stream) {
  const Layout lay = layout(tile_rows, threads, dim);
  if (lay.total > kMaxSmem) return int(cudaErrorInvalidValue);
  auto kernel = bag_backward_kernel<T, kWeighted>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return int(err);
  }
  cudaError_t err = cudaMemsetAsync(nan_cols, 0, sizeof(int) * dim, stream);
  if (err != cudaSuccess) return int(err);
  if (n > 0) {
    const int blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
    pad_pass<T, kWeighted><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(grad), idx, weights, n, n_slots, dim,
        nan_cols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<grid, threads, lay.total, stream>>>(
      static_cast<const T*>(grad), idx, weights, keys, order, n, n_slots,
      n_rows, dim, tile_rows, entry_w, nan_cols, static_cast<T*>(out));
  return int(cudaGetLastError());
}

template <typename T>
int by_weights(const void* grad, const int* idx, const float* weights,
               const int* keys, const int* order, int n, int n_slots,
               long long n_rows, int dim, int tile_rows, int threads,
               int grid, int entry_w, int* nan_cols, void* out,
               cudaStream_t stream) {
  return weights == nullptr
             ? launch<T, false>(grad, idx, weights, keys, order, n, n_slots,
                                n_rows, dim, tile_rows, threads, grid,
                                entry_w, nan_cols, out, stream)
             : launch<T, true>(grad, idx, weights, keys, order, n, n_slots,
                               n_rows, dim, tile_rows, threads, grid,
                               entry_w, nan_cols, out, stream);
}

}  // namespace

extern "C" {

// K4T: grad (n / n_slots, dim) float32 (grad_bf16 = 0) or bfloat16 (1),
// dim at most `threads`; idx (n / n_slots, n_slots) int32; weights the
// same shape in float32, or null; keys (n,) int32, the ids with padding
// as INT_MAX, sorted stably, and order (n,) int32, each sorted entry's
// flat position; nan_cols (dim,) int32 scratch; out (n_rows, dim) in
// grad's dtype, written whole (rows no id touches are 0; nothing needs
// filling first, n = 0 included).  Two launches: pad_pass, then K4T.
// The plan:
// `tile_rows` rows a tile, `threads` a block (a multiple of 32,
// 32..1024), `grid` persistent blocks sharing the rows out by work (a
// row's bytes, `entry_w` an entry); every plan gives the same bits.
int repro_embedding_bag_backward(const void* grad, int grad_bf16,
                                 const int* idx, const float* weights,
                                 const int* keys, const int* order, int n,
                                 int n_slots, long long n_rows, int dim,
                                 int tile_rows, int threads, int grid,
                                 int entry_w, int* nan_cols, void* out,
                                 void* stream) {
  if (n < 0 || n_slots < 0 || n_rows < 1 || dim < 1 || dim > threads ||
      tile_rows < 1 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      grid < 1 || entry_w < 1 || (n > 0 && n_slots < 1) ||
      static_cast<long long>(tile_rows) * dim > kMaxSmem / 4)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return grad_bf16
             ? by_weights<__nv_bfloat16>(grad, idx, weights, keys, order, n,
                                         n_slots, n_rows, dim, tile_rows,
                                         threads, grid, entry_w, nan_cols,
                                         out, s)
             : by_weights<float>(grad, idx, weights, keys, order, n, n_slots,
                                 n_rows, dim, tile_rows, threads, grid,
                                 entry_w, nan_cols, out, s);
}

}  // extern "C"
