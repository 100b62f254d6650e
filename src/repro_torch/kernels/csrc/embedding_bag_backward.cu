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
//     padded slot read row 0 with mask 0) and optional (B, L) float32
//     weights, accumulated in float32 and written in g's dtype (the
//     table's).  Ids >= V read no row in the forward and add nothing.
//
// What bounds it on an H100: bytes.  The gradient is a dense (V, D) table:
// at DeepFM's train_batch (B = 65,536, L = 39, V = 34.3 M, D = 10) writing
// it is 1.37 GB of the 1.39 GB the function must move (ids 10 MB, g 2.6
// MB), 0.41 ms at 3.35 TB/s.  The wrapper (kernels/embedding_bag.py)
// fills the table with zeros (a memset at the memory rate) and sorts the
// B*L ids (torch.sort, stable); this kernel then reads each contribution
// once, gathering g's rows (the only random reads: one or two 32-byte
// sectors a contribution, ~2.6 M of them) and writes each touched row
// once.  Its own traffic is ~0.1 GB at train_batch, so the fill sets the
// time of the whole, and the kernel is kept simple.
//
// Design (deterministic, no atomics):
//   * The wrapper hands over the ids' rows sorted stably (keys: padding as
//     row 0) with each one's flat position b * L + l (order).  A stable
//     sort keeps a row's contributions in ascending flat position.
//   * One thread per (sorted entry, column).  A thread whose entry heads
//     its row's run (the first entry, or a key unlike the one before)
//     walks the run and sums the contributions of its column; every other
//     thread exits.  So one thread owns each (row, column) sum, adds in
//     ascending flat position through __fmul_rn / __fadd_rn (no FMA
//     contraction) from +0.0, exactly as the plain version
//     (kernels/ref.py embedding_bag_backward_ref) does, and rounds once at
//     its store: bitwise equal to the plain version and to itself under
//     every block size (the "plan" the C entry point takes).
//   * The D threads of one entry read D consecutive values of g's row and
//     write D consecutive values of the output row: coalesced within a
//     row.  Runs differ in length (1 for a 16 M-value field, ~16 for a
//     4096-value one at train_batch), so warps diverge; the kernel's time
//     is small beside the fill's all the same.
//   * Only row 0's run can hold padded slots: there the thread reads
//     idx[p] to learn the mask.  Offsets are size_t: V * D passes 2^31 at
//     full width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

template <typename T, bool kWeighted>
__global__ void bag_backward_kernel(const T* __restrict__ grad,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ weights,
                                    const int* __restrict__ keys,
                                    const int* __restrict__ order, int n,
                                    int n_slots, unsigned rows_lim, int dim,
                                    T* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t / dim;
  if (i >= n) return;
  const int c = static_cast<int>(t - i * dim);
  const int row = keys[i];
  if (i > 0 && keys[i - 1] == row) return;  // not the head of its run
  if (static_cast<unsigned>(row) >= rows_lim) return;  // an id >= V
  float acc = 0.0f;
  for (long long j = i; j < n && keys[j] == row; ++j) {
    const int p = order[j];
    const int b = p / n_slots;
    float x = to_float(grad[static_cast<size_t>(b) * dim + c]);
    const float mask = row == 0 && idx[p] < 0 ? 0.0f : 1.0f;
    x = __fmul_rn(x, mask);
    if (kWeighted) x = __fmul_rn(x, weights[p]);
    acc = __fadd_rn(acc, x);
  }
  out[static_cast<size_t>(row) * dim + c] = from_float<T>(acc);
}

template <typename T, bool kWeighted>
int launch(const void* grad, const int* idx, const float* weights,
           const int* keys, const int* order, int n, int n_slots,
           unsigned rows_lim, int dim, int threads, void* out,
           cudaStream_t stream) {
  const long long work = static_cast<long long>(n) * dim;
  const long long blocks = (work + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  bag_backward_kernel<T, kWeighted>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(grad), idx, weights, keys, order, n, n_slots,
      rows_lim, dim, static_cast<T*>(out));
  return int(cudaGetLastError());
}

template <typename T>
int by_weights(const void* grad, const int* idx, const float* weights,
               const int* keys, const int* order, int n, int n_slots,
               unsigned rows_lim, int dim, int threads, void* out,
               cudaStream_t stream) {
  return weights == nullptr
             ? launch<T, false>(grad, idx, weights, keys, order, n, n_slots,
                                rows_lim, dim, threads, out, stream)
             : launch<T, true>(grad, idx, weights, keys, order, n, n_slots,
                               rows_lim, dim, threads, out, stream);
}

}  // namespace

extern "C" {

// K4T: grad (n / n_slots, dim) float32 (grad_bf16 = 0) or bfloat16 (1);
// idx (n / n_slots, n_slots) int32; weights the same shape in float32, or
// null; keys (n,) int32, the ids with padding as 0, sorted stably, and
// order (n,) int32, each sorted entry's flat position; out (n_rows, dim)
// in grad's dtype, zero where no id points (the caller fills it).  The
// plan is the block size, `threads` (a multiple of 32, 32..1024); every
// plan gives the same bits.
int repro_embedding_bag_backward(const void* grad, int grad_bf16,
                                 const int* idx, const float* weights,
                                 const int* keys, const int* order, int n,
                                 int n_slots, long long n_rows, int dim,
                                 int threads, void* out, void* stream) {
  if (n < 0 || n_slots < 0 || n_rows < 1 || dim < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || (n > 0 && n_slots < 1))
    return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  // every int32 id is a row where the table has 2^31 rows or more
  const unsigned rows_lim =
      static_cast<unsigned>(n_rows < (1LL << 31) ? n_rows : (1LL << 31));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return grad_bf16
             ? by_weights<__nv_bfloat16>(grad, idx, weights, keys, order, n,
                                         n_slots, rows_lim, dim, threads,
                                         out, s)
             : by_weights<float>(grad, idx, weights, keys, order, n,
                                 n_slots, rows_lim, dim, threads, out, s);
}

}  // extern "C"
