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
// What bounds it on an H100: bytes.  It does 2*B*L*D flops on bytes that
// are at least the ids (and weights), the distinct table rows the ids
// touch and the output:  B*L*4 (+ B*L*4) + rows*D*elt + B*D*elt, over
// 3.35 TB/s.  The rows are random gathers, so the real traffic is the
// 32-byte sectors they fall in, not the D*elt bytes alone.
//
// Design (right by construction first; speed is for a later change):
//   * One thread per output element (b, d): neighbouring threads read
//     neighbouring floats of a row, and the D threads of a bag read the
//     same id (one broadcast).  Each thread loops over l = 0..L-1 itself,
//     so nothing carries between blocks, which run in no order (the TPU
//     kernel walked its bags sequentially per tile).
//   * The sum is the plain version's (kernels/ref.py embedding_bag_ref):
//     acc + (row * w) * mask in float32, slot by slot, through __fmul_rn /
//     __fadd_rn so the compiler cannot contract it into an FMA; the result
//     is bitwise equal to the plain version.  It is rounded once, to
//     nearest even, at the store.
//   * Edges: a padded slot reads row 0 and multiplies by 0 (a non-finite
//     row 0 or weight there gives NaN, as the reference does); an id >= V
//     reads a NaN row (jnp.take's fill mode) and never touches memory past
//     the table.  Row offsets are size_t: V * D passes 2^31 at full width.
//   * weights == nullptr means all ones; no (B, L) tensor of ones is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
               const float* __restrict__ weights, long long n_out, int n_slots,
               long long n_rows, int dim, T* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= n_out) return;
  const long long b = e / dim;
  const int d = static_cast<int>(e - b * dim);
  const int* ib = idx + b * n_slots;
  const float* wb = weights == nullptr ? nullptr : weights + b * n_slots;
  const float qnan = __int_as_float(0x7fc00000);
  float acc = 0.0f;
  for (int l = 0; l < n_slots; ++l) {
    const int rid = __ldg(ib + l);
    const long long safe = rid < 0 ? 0 : rid;
    const float row = safe < n_rows
                          ? to_f32(table[static_cast<size_t>(safe) * dim + d])
                          : qnan;
    const float w = wb == nullptr ? 1.0f : __ldg(wb + l);
    const float mask = rid >= 0 ? 1.0f : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(row, w), mask));
  }
  store(out + e, acc);
}

template <typename T>
int launch(const void* table, const int* idx, const float* weights, int n_bags,
           int n_slots, long long n_rows, int dim, void* out,
           cudaStream_t stream) {
  const long long n_out = static_cast<long long>(n_bags) * dim;
  if (n_out == 0) return int(cudaSuccess);
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  bag_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(table), idx, weights, n_out, n_slots, n_rows, dim,
      static_cast<T*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4: table (n_rows, dim) float32 (table_bf16 = 0) or bfloat16 (1); idx
// (n_bags, n_slots) int32; weights (n_bags, n_slots) float32 or null; out
// (n_bags, dim) in the table's dtype.
int repro_embedding_bag(const void* table, int table_bf16, const int* idx,
                        const float* weights, int n_bags, int n_slots,
                        long long n_rows, int dim, void* out, void* stream) {
  if (n_bags < 0 || n_slots < 0 || n_rows < 1 || dim < 1)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table_bf16
             ? launch<__nv_bfloat16>(table, idx, weights, n_bags, n_slots,
                                     n_rows, dim, out, s)
             : launch<float>(table, idx, weights, n_bags, n_slots, n_rows,
                             dim, out, s);
}

}  // extern "C"
