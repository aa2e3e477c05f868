// Embedding bag for the DeepFM lookup — Hopper (sm_90a) CUDA, with a plain
// C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernel `_bag_kernel`
// (src/repro/kernels/embedding_bag.py:24):
//
//   out[b, :] = Σ_k w[b, k] · float(table[idx[b, k], :])     (B, D) f32
//
// over a table (V, D) of f32 or bf16, indices (B, K) int32 and weights
// (B, K) f32 (or none: every weight 1).  The Pallas kernel walks a (B, K)
// grid in order, DMAs one (1, D) row per step through a scalar-prefetched
// index map, and accumulates in a VMEM-resident output block that starts at
// zero; the sum runs k = 0 .. K-1.
//
// Design.  One thread per output element (b, d): it walks its bag's K slots
// in the same order, so the D threads of one bag read one table row side by
// side (coalesced as far as a D-float row allows) and the bag's K indices
// and weights are the same few addresses for those D threads (from L1).
// Every output has one writer: no atomics, no shared memory, no barrier.
// Each step is `acc = acc + w · v` rounded twice (__fmul_rn, __fadd_rn: no
// FMA contraction), exactly what the plain version's `out += w[:, k] * row`
// does, so kernel and plain agree bit for bit.  Unweighted bags add `v`
// itself, which equals `1 · v` exactly.
//
// Traps.  Row offsets are 64-bit (idx · D passes 2^31 at 33.9 M rows and
// D = 64).  Rows of D = 10 floats start 40 bytes apart, so loads are scalar:
// any D >= 1 works, D = 1 (the first-order table) included.  Indices are
// not range-checked here; the caller keeps them in [0, V).
//
// Bound.  Bytes: one bag sum does one add (and one multiply) per gathered
// element against 4-byte loads, far below the card's operations-per-byte
// line.  The least traffic is each distinct table row read once plus the
// indices, weights and output; a thread's K loads are independent, so the
// unrolled loop keeps several in flight.  Not yet done: a warp per bag with
// vector loads where D allows, and staging indices in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, bool WEIGHTED>
__global__ void bag_rows(const T* __restrict__ table, const int32_t* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out,
                         int64_t n_out, int K, int D) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_out) return;
  const int64_t b = g / D;
  const int d = (int)(g - b * D);
  const int32_t* ib = idx + b * K;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float v = as_f32(table[(int64_t)ib[k] * D + d]);
    if constexpr (WEIGHTED) {
      acc = __fadd_rn(acc, __fmul_rn(w[b * K + k], v));
    } else {
      acc = __fadd_rn(acc, v);
    }
  }
  out[g] = acc;
}

template <typename T>
cudaError_t launch_bag(const void* table, const int32_t* idx, const float* w, float* out,
                       int64_t n_bags, int K, int D, cudaStream_t s) {
  const int64_t n_out = n_bags * D;
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  auto t = static_cast<const T*>(table);
  if (w != nullptr) {
    bag_rows<T, true><<<(unsigned)blocks, kThreads, 0, s>>>(t, idx, w, out, n_out, K, D);
  } else {
    bag_rows<T, false><<<(unsigned)blocks, kThreads, 0, s>>>(t, idx, w, out, n_out, K, D);
  }
  return cudaGetLastError();
}

}  // namespace

// table (V, dim) f32 (bf16 != 0: bf16), indices (n_bags, bag_size) int32,
// weights (n_bags, bag_size) f32 or null -> out (n_bags, dim) f32.
extern "C" int embedding_bag_launch(const void* table, int bf16, const void* indices,
                                    const void* weights, void* out, int64_t n_bags,
                                    int bag_size, int dim, void* stream) {
  if (n_bags <= 0 || dim <= 0) return cudaSuccess;
  if (bag_size < 0) return cudaErrorInvalidValue;
  auto ix = static_cast<const int32_t*>(indices);
  auto w = static_cast<const float*>(weights);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16 != 0) return launch_bag<__nv_bfloat16>(table, ix, w, o, n_bags, bag_size, dim, s);
  return launch_bag<float>(table, ix, w, o, n_bags, bag_size, dim, s);
}
