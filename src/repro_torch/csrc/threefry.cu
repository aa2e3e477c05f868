// Threefry-2x32 random bits — Hopper (sm_90a) CUDA with a plain C interface
// loaded through ctypes.  It replaces no Pallas kernel: it is the
// counterpart of XLA's lowering of jax.random's `threefry2x32_p`, the hash
// behind every draw the reference makes (priorities, Luby's per-round
// integers, permutations' sort keys, the samplers' integers, the models'
// normal inits), and of the elementwise ops JAX puts after it.
//
// Element i of a draw under the key (k0, k1) from the counter `start`
// hashes the 64-bit counter c = start + i, split into the words
// (hi, lo) = (c >> 32, c & 0xFFFFFFFF) as JAX's iota_2x32_shape splits a
// shape's row-major flat index, with 20 rounds of Threefry-2x32
// (rotations 13 15 26 6 / 17 29 16 24, a key injection every four rounds)
// into (b1, b2), and writes
//   mode 0 (bits)     b1 ^ b2 as int32, jax.random.bits' uint32 word
//   mode 1 (uniform)  f = ((b1 ^ b2) >> 9 | 0x3F800000) as f32, minus 1.0,
//                     in [0, 1); then max(lo, fma(f, scale, lo)):
//                     jax.random.uniform's `floats * (maxval - minval) +
//                     minval`, scale being maxval - minval in f32, which
//                     XLA fuses into one FMA (one rounding)
//   mode 2 (normal)   the uniform on [nextafter(-1, 0), 1) (the wrapper
//                     passes its lo and scale), then f32(sqrt 2) times
//                     XLA's single-precision erf_inv (Giles): w =
//                     -log1p(-u * u); on w < 5 Horner over w - 2.5, else
//                     over sqrt(w) - 3; times u
// The uniform's FMA is written __fmaf_rn and every other product and sum
// __fmul_rn / __fadd_rn, so that nvcc contracts nothing on its own: the
// uniform is bit-equal to the reference's, and the normal keeps the plain
// version's form (XLA's own log1p differs from CUDA's by an ulp or so now
// and then, and it fuses some of Horner's steps, so the normal is held to
// the reference within a few ulp).
// This is JAX's partitionable mode (jax_threefry_partitionable=True, its
// default), where element i depends on i alone, which is what lets a
// thread own an element and a block of a draw start at an offset.
//
// Bound: 75 32-bit integer operations an element for the bits (the 64-bit
// counter's add as two, two adds for the counter and key, 20 rounds of
// add / funnel-shift rotate / xor, five injections of two adds, the final
// xor), 80 for the uniform (its shift, or, subtract, FMA and max), 104
// for the normal (square, two negations, log1p, compare,
// subtract, 8 Horner steps of a multiply and an add, the two products),
// against 4 bytes written.  The design is the plainest that fits: a
// thread per element on a grid-stride loop, the key schedule in
// registers, the rounds unrolled, rotations as `__funnelshift_l`.
// Nothing is read.
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

__device__ __forceinline__ float horner(float p, float c, float w) {
  return __fadd_rn(c, __fmul_rn(p, w));
}

// XLA's ErfInv32 for |x| < 1, every rounding on its own.
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  float p;
  if (w < 5.0f) {
    w = __fadd_rn(w, -2.5f);
    p = 2.81022636e-08f;
    p = horner(p, 3.43273939e-07f, w);
    p = horner(p, -3.5233877e-06f, w);
    p = horner(p, -4.39150654e-06f, w);
    p = horner(p, 0.00021858087f, w);
    p = horner(p, -0.00125372503f, w);
    p = horner(p, -0.00417768164f, w);
    p = horner(p, 0.246640727f, w);
    p = horner(p, 1.50140941f, w);
  } else {
    w = __fadd_rn(__fsqrt_rn(w), -3.0f);
    p = -0.000200214257f;
    p = horner(p, 0.000100950558f, w);
    p = horner(p, 0.00134934322f, w);
    p = horner(p, -0.00367342844f, w);
    p = horner(p, 0.00573950773f, w);
    p = horner(p, -0.0076224613f, w);
    p = horner(p, 0.00943887047f, w);
    p = horner(p, 1.00167406f, w);
    p = horner(p, 2.83297682f, w);
  }
  return __fmul_rn(p, x);
}

__global__ void threefry_draw(uint32_t k0, uint32_t k1, unsigned long long start, long long n,
                              int mode, float lo, float scale, uint32_t* __restrict__ out) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned long long c = start + (unsigned long long)i;
    uint32_t x0 = (uint32_t)(c >> 32) + k0;
    uint32_t x1 = (uint32_t)c + k1;
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
      continue;
    }
    const float f = __fadd_rn(__uint_as_float((bits >> 9) | 0x3F800000u), -1.0f);
    const float u = fmaxf(lo, __fmaf_rn(f, scale, lo));
    if (mode == 1) {
      out[i] = __float_as_uint(u);
    } else {
      out[i] = __float_as_uint(__fmul_rn(1.41421354f, erf_inv(u)));
    }
  }
}

}  // namespace

// 256 threads a block, at most 32 blocks an SM on the H100's 132: past
// that, each thread takes more elements on the grid-stride loop.
extern "C" int threefry_launch(uint32_t k0, uint32_t k1, unsigned long long start, long long n,
                               int mode, float lo, float scale, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  threefry_draw<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      k0, k1, start, n, mode, lo, scale, (uint32_t*)out);
  return (int)cudaGetLastError();
}
