// EmbeddingBag (bag sum) kernel for Hopper (sm_90a), bound to PyTorch through
// a plain C interface (ctypes).  Built by repro_torch/kernels/_build.py.
//
// K4  repro_embedding_bag  replaces the TPU kernel
//     src/repro/kernels/embedding_bag.py::embedding_bag_pallas (:47) and its
//     body _bag_kernel (:24):
//       out[b, :] = sum_l table[idx[b, l], :] * w[b, l] * (idx[b, l] >= 0)
//     for a (V, D) table in device memory, (B, L) int32 ids with -1 as
//     padding and optional (B, L) float32 weights, accumulated in float32
//     and written in the table's dtype.  Like the TPU kernel it never builds
//     the (B, L, D) gathered rows in device memory.
//
// What bounds it on an H100: bytes, and at serving sizes the latency of the
// gathers.  It does 2*B*L*D flops on bytes that are at least the ids (and
// weights), the distinct table rows the ids touch and the output:
// B*L*4 (+ B*L*4) + rows*D*elt + B*D*elt, over 3.35 TB/s.  The rows are
// random gathers, so the real traffic is the 32-byte sectors they fall in
// (a 40-byte row at an 8-byte offset always spans two), and every one of
// the B*L gathers crosses from L2 to an SM unless L1 holds its row: at
// DeepFM's serve_bulk (B = 262,144, L = 39, D = 10) that is 20.4 M sectors
// from L2 against 1.77 M distinct rows from memory, and the kernel stays at
// ~4x the bytes bound whatever its tile or pass (PERF.md).  Where 38 of the
// 39 slots hit the same rows (retrieval_cand) the rows stay in L1 and the
// instructions per gathered piece set the time.  A request of 512 bags is
// a few hundred kilobytes: there the time is the two round trips (ids,
// then rows) that a bag waits for, not its bytes.
//
// Design (a block per tile of consecutive bags; the host's bag_plan in
// kernels/embedding_bag.py picks the tile and the slot pass):
//   * The tile's ids (and weights) are one contiguous span of its bags'
//     L slots: the block loads it once with 16-byte streaming loads
//     (__ldcs), from the 16-byte boundary at or below its start (b * L * 4
//     bytes is not 16-byte aligned when L is odd), masking what lies
//     outside, into shared memory with an odd row stride (L | 1), so the
//     lanes of a warp reading one slot of different bags hit distinct
//     banks.  No thread reads an id from device memory.  Tiles are small
//     (24 bags at most): shared memory comes out of the SM's L1, where the
//     small fields' rows hit.
//   * One thread per (bag, piece): a piece is the widest vector, up to 16
//     bytes, that the row length and the table's and output's addresses
//     allow (a D = 10 float32 row is five 8-byte pieces, a D = 10 bfloat16
//     row five 4-byte pieces, D = 1 one 4-byte piece, D = 32 float32 eight
//     16-byte ones).  The slot axis is walked in passes of `pass` slots:
//     a pass first issues every gather of its slots into registers, all
//     independent and in flight together, and then adds them in slot
//     order.  Registers hold 8 slots (bulk: many threads) or 40 (a small
//     batch, a whole bag in one round trip).  The sums stay in registers
//     across passes, so the slot order and the register use do not depend
//     on L.  A pass keeps one bit per slot for padding and nothing else of
//     the ids: a second read of shared memory per slot cost more.
//   * The sum is the plain version's (kernels/ref.py embedding_bag_ref):
//     acc + (row * w) * mask in float32, slot by slot, through __fmul_rn /
//     __fadd_rn so the compiler cannot contract it into an FMA (without
//     weights, row * 1 is row and is skipped).  Each column's order is
//     l = 0..L-1 whatever the tile, the piece or the pass, so the result
//     is bitwise equal to the plain version, and to itself under every
//     plan.  It is rounded once, to nearest even, at the store, one
//     coalesced streaming store (__stcs) per piece.
//   * Caching: ids and outputs stream through (__ldcs / __stcs); table rows
//     are read through L1 (__ldg: bypassing L1 measured slower even at
//     D = 10).
//   * Edges: a padded slot gathers row 0 and multiplies it by 0 (a
//     non-finite row 0 or weight there gives NaN, as the reference does);
//     an id >= V issues no read and adds a NaN piece (jnp.take's fill
//     mode).  Row offsets are size_t: V * D passes 2^31 at full width.
//   * weights == nullptr means all ones; no (B, L) tensor of ones is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr size_t kStaticSmem = 48 * 1024;

// A piece of a row: kBytes bytes held as 32-bit words (a 2-byte piece in
// the low half of one word).
template <int kBytes>
struct Piece {
  unsigned w[(kBytes + 3) / 4];
};

template <int kBytes>
__device__ __forceinline__ Piece<kBytes> load_piece(const void* p) {
  Piece<kBytes> r;
  if constexpr (kBytes == 2) {
    r.w[0] = __ldg(static_cast<const unsigned short*>(p));
  } else if constexpr (kBytes == 4) {
    r.w[0] = __ldg(static_cast<const unsigned*>(p));
  } else if constexpr (kBytes == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
    r.w[2] = v.z;
    r.w[3] = v.w;
  }
  return r;
}

template <int kBytes>
__device__ __forceinline__ void store_piece(void* p, const Piece<kBytes>& r) {
  if constexpr (kBytes == 2) {
    __stcs(static_cast<unsigned short*>(p),
           static_cast<unsigned short>(r.w[0]));
  } else if constexpr (kBytes == 4) {
    __stcs(static_cast<unsigned*>(p), r.w[0]);
  } else if constexpr (kBytes == 8) {
    __stcs(static_cast<uint2*>(p), make_uint2(r.w[0], r.w[1]));
  } else {
    __stcs(static_cast<uint4*>(p),
           make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]));
  }
}

// Column c of a piece as float32, and a float32 rounded into column c
// (columns are written in ascending order).
template <typename T>
struct Col;
template <>
struct Col<float> {
  __device__ static float get(const unsigned* w, int c) {
    return __uint_as_float(w[c]);
  }
  __device__ static void put(unsigned* w, int c, float x) {
    w[c] = __float_as_uint(x);
  }
};
template <>
struct Col<__nv_bfloat16> {
  __device__ static float get(const unsigned* w, int c) {
    const unsigned x = w[c >> 1];
    return __uint_as_float(c & 1 ? x & 0xffff0000u : x << 16);
  }
  __device__ static void put(unsigned* w, int c, float x) {
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    w[c >> 1] = c & 1 ? w[c >> 1] | (h << 16) : h;
  }
};

// Copies the n 4-byte values at src (the tile's bags, n_slots each) into
// dst, bag t's at dst + t * stride: one 16-byte streaming load per group,
// from the 16-byte boundary at or below src, masking what lies outside.
__device__ __forceinline__ void load_tile(const int* src, int n, int n_slots,
                                          int stride, int* dst) {
  if (n == 0) return;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int lead = static_cast<int>(a & 15) >> 2;
  const int4* p = reinterpret_cast<const int4*>(a - (a & 15));
  const int groups = (lead + n + 3) >> 2;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int4 v = __ldcs(p + g);
    const int x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 4 * g + k - lead;
      if (e >= 0 && e < n)
        dst[stride == n_slots ? e : e + e / n_slots] = x[k];
    }
  }
}

template <typename T, int kVec, int kPass, bool kWeighted>
__global__ void __launch_bounds__(kMaxThreads)
    bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
               const float* __restrict__ weights, int n_bags, int n_slots,
               unsigned rows_lim, int dim, int tile_bags, int pass,
               T* __restrict__ out) {
  constexpr int kCols = kVec / static_cast<int>(sizeof(T));
  using Bits = std::conditional_t<(kPass > 32), uint64_t, uint32_t>;
  extern __shared__ int smem[];
  const int stride = n_slots | 1;
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_bags;
  const int bags = static_cast<int>(
      min(static_cast<long long>(tile_bags), n_bags - b0));
  int* ids = smem;
  float* ws = reinterpret_cast<float*>(smem + tile_bags * stride);
  load_tile(idx + b0 * n_slots, bags * n_slots, n_slots, stride, ids);
  if (kWeighted)
    load_tile(reinterpret_cast<const int*>(weights) + b0 * n_slots,
              bags * n_slots, n_slots, stride, reinterpret_cast<int*>(ws));
  __syncthreads();

  const int pieces = dim / kCols;
  const unsigned row_bytes = static_cast<unsigned>(dim * sizeof(T));
  Piece<kVec> nan_piece;   // NaN in every column, float32 or bfloat16
#pragma unroll
  for (int k = 0; k < (kVec + 3) / 4; ++k) nan_piece.w[k] = 0x7fc07fc0u;
  for (int i = threadIdx.x; i < bags * pieces; i += blockDim.x) {
    const int t = i / pieces;
    const int col = (i - t * pieces) * kCols;
    const int* id = ids + t * stride;
    const float* w = ws + t * stride;
    const char* base = reinterpret_cast<const char*>(table + col);
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
    for (int l0 = 0; l0 < n_slots; l0 += pass) {
      const int n = min(pass, n_slots - l0);
      Piece<kVec> row[kPass];
      Bits padded = 0;                   // bit j: slot l0 + j is padding
      // every gather of the pass in flight before the first sum; an id
      // past the table reads nothing and keeps the NaN piece
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        row[j] = nan_piece;
        if (j < n) {
          const int rid = id[l0 + j];
          if (rid < 0) padded |= Bits{1} << j;
          const unsigned r = max(rid, 0);
          if (r < rows_lim)
            row[j] = load_piece<kVec>(base +
                                      static_cast<size_t>(r) * row_bytes);
        }
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        if (j < n) {
          const float mask = padded >> j & 1 ? 0.0f : 1.0f;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            // x * 1 is x: unweighted slots skip the product by w
            float x = Col<T>::get(row[j].w, c);
            if (kWeighted) x = __fmul_rn(x, w[l0 + j]);
            acc[c] = __fadd_rn(acc[c], __fmul_rn(x, mask));
          }
        }
      }
    }
    Piece<kVec> o{};
#pragma unroll
    for (int c = 0; c < kCols; ++c) Col<T>::put(o.w, c, acc[c]);
    store_piece<kVec>(out + static_cast<size_t>(b0 + t) * dim + col, o);
  }
}

struct Args {
  const void* table;
  const int* idx;
  const float* weights;
  int n_bags, n_slots;
  long long n_rows;
  int dim, tile_bags, pass;
  void* out;
  cudaStream_t stream;
};

template <typename T, int kVec, int kPass, bool kWeighted>
int launch(const Args& a) {
  const auto kernel = bag_kernel<T, kVec, kPass, kWeighted>;
  const long long work =
      static_cast<long long>(a.tile_bags) * (a.dim * sizeof(T) / kVec);
  if (work >= 0x7fffffffLL || a.dim * sizeof(T) > 0xffffffffu)
    return int(cudaErrorInvalidValue);
  // every int32 id is a row where the table has 2^31 rows or more
  const unsigned rows_lim =
      static_cast<unsigned>(std::min<long long>(a.n_rows, 1LL << 31));
  const int threads = static_cast<int>(
      std::min<long long>(kMaxThreads, (work + 31) / 32 * 32));
  const size_t smem = static_cast<size_t>(a.tile_bags) * (a.n_slots | 1) *
                      sizeof(int) * (a.weights == nullptr ? 1 : 2);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return int(e);
  }
  const long long tiles =
      (static_cast<long long>(a.n_bags) + a.tile_bags - 1) / a.tile_bags;
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  bag_kernel<T, kVec, kPass, kWeighted>
      <<<static_cast<unsigned>(tiles), threads, smem, a.stream>>>(
      static_cast<const T*>(a.table), a.idx, a.weights, a.n_bags, a.n_slots,
      rows_lim, a.dim, a.tile_bags, a.pass, static_cast<T*>(a.out));
  return int(cudaGetLastError());
}

// The kernel built for the shortest register stage that holds a pass.
template <typename T, int kVec, bool kWeighted>
int by_pass(const Args& a) {
  if (a.pass <= 8) return launch<T, kVec, 8, kWeighted>(a);
  if (a.pass <= 40) return launch<T, kVec, 40, kWeighted>(a);
  return int(cudaErrorInvalidValue);
}

template <typename T, int kVec>
int by_weights(const Args& a) {
  return a.weights == nullptr ? by_pass<T, kVec, false>(a)
                              : by_pass<T, kVec, true>(a);
}

// The widest piece, up to 16 bytes, that divides the row length and the
// table's and output's addresses.
template <typename T>
int by_vec(const Args& a) {
  const uint64_t span = static_cast<uint64_t>(a.dim) * sizeof(T) |
                        reinterpret_cast<uintptr_t>(a.table) |
                        reinterpret_cast<uintptr_t>(a.out) | 16u;
  switch (span & (~span + 1)) {
    case 16: return by_weights<T, 16>(a);
    case 8: return by_weights<T, 8>(a);
    case 4: return by_weights<T, 4>(a);
    case 2:
      if constexpr (sizeof(T) == 2) return by_weights<T, 2>(a);
      [[fallthrough]];
    default: return int(cudaErrorMisalignedAddress);
  }
}

}  // namespace

extern "C" {

// K4: table (n_rows, dim) float32 (table_bf16 = 0) or bfloat16 (1); idx
// (n_bags, n_slots) int32; weights (n_bags, n_slots) float32 or null; out
// (n_bags, dim) in the table's dtype.  The plan: tiles of tile_bags
// consecutive bags, one block each, and slot passes of `pass` slots
// (1..40); every plan gives the same bits.
int repro_embedding_bag(const void* table, int table_bf16, const int* idx,
                        const float* weights, int n_bags, int n_slots,
                        long long n_rows, int dim, int tile_bags, int pass,
                        void* out, void* stream) {
  if (n_bags < 0 || n_slots < 0 || n_rows < 1 || dim < 1 || tile_bags < 1 ||
      pass < 1)
    return int(cudaErrorInvalidValue);
  if (n_bags == 0) return int(cudaSuccess);
  const Args a{table, idx, weights, n_bags, n_slots, n_rows, dim, tile_bags,
               pass, out, static_cast<cudaStream_t>(stream)};
  return table_bf16 ? by_vec<__nv_bfloat16>(a) : by_vec<float>(a);
}

}  // extern "C"
