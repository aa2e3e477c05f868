// Threefry-2x32 random bits — Hopper (sm_90a) CUDA with a plain C interface
// loaded through ctypes.  It replaces no Pallas kernel: it is the
// counterpart of XLA's lowering of jax.random's `threefry2x32_p`, the hash
// behind every draw the reference's MIS code makes (priorities, Luby's
// per-round integers, permutations' sort keys).
//
// Element i of a draw under the key (k0, k1) hashes the 64-bit counter i,
// split into the words (hi, lo) = (i >> 32, i & 0xFFFFFFFF), with 20 rounds
// of Threefry-2x32 (rotations 13 15 26 6 / 17 29 16 24, a key injection
// every four rounds) into (b1, b2), and writes
//   mode 0 (bits)     b1 ^ b2 as int32, jax.random.bits' uint32 word
//   mode 1 (uniform)  ((b1 ^ b2) >> 9 | 0x3F800000) as f32, minus 1.0:
//                     jax.random.uniform's [0, 1) float
// This is JAX's partitionable mode (jax_threefry_partitionable=True, its
// default), where element i depends on i alone, which is what lets a
// thread own an element.
//
// Bound: 73 32-bit integer operations an element (two adds for the
// counter and key, 20 rounds of add / funnel-shift rotate / xor, five
// injections of two adds, the final xor; 76 for the uniform, whose shift,
// or and subtract follow) against 4 bytes written.  The design is the
// plainest that fits: a thread per element on a grid-stride loop, the key
// schedule in registers, the rounds unrolled, rotations as
// `__funnelshift_l`.  Nothing is read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ void four(uint32_t& x0, uint32_t& x1, int a, int b, int c, int d) {
  mix(x0, x1, a);
  mix(x0, x1, b);
  mix(x0, x1, c);
  mix(x0, x1, d);
}

__global__ void threefry_draw(uint32_t k0, uint32_t k1, long long n, int mode,
                              uint32_t* __restrict__ out) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t x0 = (uint32_t)((unsigned long long)i >> 32) + k0;
    uint32_t x1 = (uint32_t)i + k1;
    four(x0, x1, 13, 15, 26, 6);
    x0 += k1;
    x1 += k2 + 1u;
    four(x0, x1, 17, 29, 16, 24);
    x0 += k2;
    x1 += k0 + 2u;
    four(x0, x1, 13, 15, 26, 6);
    x0 += k0;
    x1 += k1 + 3u;
    four(x0, x1, 17, 29, 16, 24);
    x0 += k1;
    x1 += k2 + 4u;
    four(x0, x1, 13, 15, 26, 6);
    x0 += k2;
    x1 += k0 + 5u;
    const uint32_t bits = x0 ^ x1;
    if (mode == 0) {
      out[i] = bits;
    } else {
      out[i] = __float_as_uint(__uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f);
    }
  }
}

}  // namespace

// 256 threads a block, at most 32 blocks an SM on the H100's 132: past
// that, each thread takes more elements on the grid-stride loop.
extern "C" int threefry_launch(uint32_t k0, uint32_t k1, long long n, int mode, void* out,
                               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  threefry_draw<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      k0, k1, n, mode, (uint32_t*)out);
  return (int)cudaGetLastError();
}
