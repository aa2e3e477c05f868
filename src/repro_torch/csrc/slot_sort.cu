// The slot plan of the embedding bag's backward — Hopper (sm_90a) CUDA with
// a plain C interface loaded through ctypes.  It arranges the slots; the
// sums and the dense write are the hand-written kernels of
// csrc/embedding_bag.cu.  The reference has no counterpart: jax.grad of its
// gathers is XLA's scatter-add, which sorts inside the op.
//
// Given the B·K flat slots b·K + k of a (B, K) index array into n_rows
// rows, it writes
//   rows      (n,) the indices stably sorted (int32)
//   order     (n,) the flat slot at each sorted position (int32)
//   run_rows  the distinct rows in order, one per run of equal rows
//   starts    each run's first sorted position; starts[n_runs] = n
//   n_runs    (1,) the number of runs, on the device (no host sync)
// Entries of run_rows and starts past n_runs are unspecified.
//
// It is CUB's radix sort (stable, so a row's slots stay in slot order),
// run-length encoding and exclusive scan from the CUDA toolkit's headers,
// and one iota kernel.  The sort reads only the key bits that n_rows needs
// (`end_bit`: 26 at DeepFM's 33,889,984 rows), and the slot values are
// 32-bit, not the 64-bit indices of torch.sort.  Everything is
// deterministic: a radix sort and integer sums give the same output on
// every call.  The library is its own source so that the sort's long CUB
// build runs beside the other kernels' builds, and copies of
// embedding_bag.cu (tools/bag_ablation.py) build without it.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_run_length_encode.cuh>
#include <cub/device/device_scan.cuh>

#include <algorithm>

namespace {

__global__ void iota(uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (uint32_t)i;
}

// Runs the three CUB calls on `bytes` of `temp`; with temp == nullptr it
// runs nothing and sets `bytes` to what the largest of them needs.
cudaError_t plan(void* temp, size_t& bytes, const uint32_t* keys, uint32_t* rows,
                 uint32_t* scratch, uint32_t* order, uint32_t* run_rows, uint32_t* starts,
                 uint32_t* n_runs, int n, int end_bit, cudaStream_t s) {
  size_t need[3] = {bytes, bytes, bytes};
  cudaError_t err = cub::DeviceRadixSort::SortPairs(temp, need[0], keys, rows, scratch, order, n,
                                                    0, end_bit, s);
  if (err != cudaSuccess) return err;
  // the run lengths go into `scratch` (the sort's slot values are spent)
  err = cub::DeviceRunLengthEncode::Encode(temp, need[1], rows, run_rows, scratch, n_runs, n, s);
  if (err != cudaSuccess) return err;
  // starts[j] = Σ_{i < j} length[i]; starts[n_runs] = n whatever follows
  err = cub::DeviceScan::ExclusiveSum(temp, need[2], scratch, starts, n + 1, s);
  if (temp == nullptr) bytes = std::max(need[0], std::max(need[1], need[2]));
  return err;
}

}  // namespace

// The temporary storage, in bytes, that slot_sort_launch needs for n slots
// sorted on end_bit key bits.
extern "C" int slot_sort_temp_bytes(int64_t n, int end_bit, int64_t* bytes) {
  if (n < 0 || n >= INT32_MAX || end_bit < 1 || end_bit > 32) return cudaErrorInvalidValue;
  size_t b = 0;
  const cudaError_t err = plan(nullptr, b, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, (int)n, end_bit, nullptr);
  *bytes = (int64_t)b;
  return err;
}

// indices (n,) int32 in [0, 2^end_bit) -> rows, order, run_rows (n,) and
// starts (n + 1,), n_runs (1,), all int32; scratch (n + 1,) int32 and temp
// (temp_bytes, from slot_sort_temp_bytes) are work space.  Launches on
// `stream`; allocates nothing.
extern "C" int slot_sort_launch(const void* indices, void* rows, void* order, void* run_rows,
                                void* starts, void* n_runs, void* scratch, void* temp,
                                int64_t temp_bytes, int64_t n, int end_bit, void* stream) {
  if (n < 0 || n >= INT32_MAX || end_bit < 1 || end_bit > 32 || temp_bytes < 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    cudaError_t err = cudaMemsetAsync(n_runs, 0, sizeof(uint32_t), s);
    return err != cudaSuccess ? err : cudaMemsetAsync(starts, 0, sizeof(uint32_t), s);
  }
  auto sc = static_cast<uint32_t*>(scratch);
  iota<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(sc, (int)n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  size_t bytes = (size_t)temp_bytes;
  return plan(temp, bytes, static_cast<const uint32_t*>(indices), static_cast<uint32_t*>(rows),
              sc, static_cast<uint32_t*>(order), static_cast<uint32_t*>(run_rows),
              static_cast<uint32_t*>(starts), static_cast<uint32_t*>(n_runs), (int)n, end_bit, s);
}
