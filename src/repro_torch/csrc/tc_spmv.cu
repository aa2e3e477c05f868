// Block-tiled SpMV for TC-MIS phase ② and the fused phase ②+③ — Hopper
// (sm_90a) CUDA, with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/tc_spmv.py:
//   fused (FUSED=true)  `_spmv_fused_kernel` (tc_spmv.py:137): N_c = A × rhs,
//                       then new_alive = alive & ~cand & ~(N_c[:,0] > 0) and
//                       mis_add = cand for the block-row's own vertices;
//   split (FUSED=false) `_spmv_kernel` (tc_spmv.py:54): N_c = A × rhs only.
// Both honour `col_flags`: a tile whose block-column flag is 0 adds nothing.
//
// Design.  One CTA per block-row r walks its tiles
// row_starts[r] .. row_starts[r+1] in order, so nothing accumulates across
// CTAs: no atomics, no second pass, deterministic sums, and padding tiles
// past the real ones are never visited.  A block-row with no tiles writes
// N_c = 0, so the trivial rule (alive' = alive & ~cand, mis_add = cand)
// holds with no patch.  Per active tile the CTA stages the tile (int8
// cells, or packed words: bit j of word w of row v is column 32w + j, only
// the low T bits live when T < 32) and the (T, L) RHS slab in shared
// memory; thread i owns accumulator entries i, i + blockDim, ... of the
// (T, L) block (row v = i / L, lane l = i % L) and adds one tile's
// contribution per visit.  Plain f32 FMA: with 0/1 tiles and a 0/1 RHS
// every sum is an exact integer.  A gated tile is skipped before its tile
// or slab is loaded, which is what the Pallas `skip_dma` option bought.
//
// Bound.  Bytes, not operations: at the main path's shapes (T = 16,
// bitpack, L = 8) a tile is 64 bytes of words against a 512-byte f32 RHS
// slab and ~10 nonzeros, so the RHS slabs (read once per tile that needs
// them, mostly from L2) and the (nbr·T, L) f32 N_c write dominate; the
// tensor-core rate is irrelevant.  The packed path walks set bits only
// (__ffs), so its arithmetic scales with nnz, not T².  Not yet done:
// overlapping the next tile's loads with this tile's work (cp.async/TMA),
// and an MMA form for dense tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename RT>
__device__ __forceinline__ float to_f32(RT x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int T, bool PACKED>
struct TileShape {
  static constexpr int W = T >= 32 ? T / 32 : 1;
  static constexpr int BYTES = PACKED ? T * W * 4 : T * T;
};

template <int T, bool PACKED, bool FUSED, typename RT>
__global__ void tc_spmv_rows(const void* __restrict__ tiles_v,
                             const int32_t* __restrict__ row_starts,
                             const int32_t* __restrict__ tile_cols,
                             const int32_t* __restrict__ col_flags,
                             const RT* __restrict__ rhs,
                             float* __restrict__ n_c,
                             const uint8_t* __restrict__ cand,
                             const uint8_t* __restrict__ alive,
                             uint8_t* __restrict__ new_alive,
                             uint8_t* __restrict__ mis_add, int L) {
  constexpr int W = TileShape<T, PACKED>::W;
  extern __shared__ __align__(16) unsigned char smem[];
  const int TL = T * L;
  float* acc = reinterpret_cast<float*>(smem);  // (T, L) accumulator
  float* slab = acc + TL;                        // (T, L) RHS slab
  unsigned char* tile = reinterpret_cast<unsigned char*>(slab + TL);

  const int r = blockIdx.x;
  for (int i = threadIdx.x; i < TL; i += blockDim.x) acc[i] = 0.f;

  const int t_end = row_starts[r + 1];
  for (int t = row_starts[r]; t < t_end; ++t) {
    const int col = tile_cols[t];
    // the flag is the same for every thread of the CTA: the whole CTA
    // skips together, so the barriers below stay uniform
    if (col_flags != nullptr && col_flags[col] == 0) continue;
    __syncthreads();  // the previous tile's shared data is consumed
    if constexpr (PACKED) {
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(tiles_v) + (size_t)t * T * W;
      uint32_t* dst = reinterpret_cast<uint32_t*>(tile);
      for (int i = threadIdx.x; i < T * W; i += blockDim.x) dst[i] = src[i];
    } else {
      // T*T is a multiple of 64 bytes: copy 16 bytes per thread
      const int4* src = reinterpret_cast<const int4*>(
          reinterpret_cast<const int8_t*>(tiles_v) + (size_t)t * T * T);
      int4* dst = reinterpret_cast<int4*>(tile);
      for (int i = threadIdx.x; i < T * T / 16; i += blockDim.x) dst[i] = src[i];
    }
    const RT* s = rhs + (size_t)col * TL;
    for (int i = threadIdx.x; i < TL; i += blockDim.x) slab[i] = to_f32(s[i]);
    __syncthreads();
    for (int i = threadIdx.x; i < TL; i += blockDim.x) {
      const int v = i / L;
      const int l = i - v * L;
      float sum = 0.f;
      if constexpr (PACKED) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(tile) + v * W;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t bits = row[w];
          if constexpr (T < 32) bits &= (1u << T) - 1u;  // low T bits live
          while (bits) {
            const int j = __ffs(bits) - 1;
            sum += slab[(w * 32 + j) * L + l];
            bits &= bits - 1u;
          }
        }
      } else {
        const int8_t* row = reinterpret_cast<const int8_t*>(tile) + v * T;
#pragma unroll 8
        for (int k = 0; k < T; ++k) sum = fmaf((float)row[k], slab[k * L + l], sum);
      }
      acc[i] += sum;
    }
  }

  // every acc entry was written by the thread that stores it here
  float* out = n_c + (size_t)r * TL;
  for (int i = threadIdx.x; i < TL; i += blockDim.x) out[i] = acc[i];
  if constexpr (FUSED) {
    __syncthreads();  // lane-0 entries belong to other threads
    for (int v = threadIdx.x; v < T; v += blockDim.x) {
      const size_t g = (size_t)r * T + v;
      const bool c = cand[g] != 0;
      const bool a = alive[g] != 0;
      const bool hit = acc[v * L] > 0.f;
      new_alive[g] = (a && !c && !hit) ? 1 : 0;
      mis_add[g] = c ? 1 : 0;
    }
  }
}

struct Args {
  const void* tiles;
  const int32_t* row_starts;
  const int32_t* tile_cols;
  const int32_t* col_flags;
  const void* rhs;
  float* n_c;
  const uint8_t* cand;
  const uint8_t* alive;
  uint8_t* new_alive;
  uint8_t* mis_add;
  int n_block_rows;
  int lanes;
  cudaStream_t stream;
};

template <int T, bool PACKED, bool FUSED, typename RT>
cudaError_t launch(const Args& a) {
  auto kern = tc_spmv_rows<T, PACKED, FUSED, RT>;
  const int tl = T * a.lanes;
  const size_t smem = 2 * (size_t)tl * sizeof(float) + TileShape<T, PACKED>::BYTES;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int threads = ((tl + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  tc_spmv_rows<T, PACKED, FUSED, RT><<<a.n_block_rows, threads, smem, a.stream>>>(
      a.tiles, a.row_starts, a.tile_cols, a.col_flags,
      static_cast<const RT*>(a.rhs), a.n_c, a.cand, a.alive, a.new_alive,
      a.mis_add, a.lanes);
  return cudaGetLastError();
}

template <int T>
cudaError_t dispatch(const Args& a, bool packed, bool fused, bool bf16) {
  if (bf16) {
    if (packed)
      return fused ? launch<T, true, true, __nv_bfloat16>(a)
                   : launch<T, true, false, __nv_bfloat16>(a);
    return fused ? launch<T, false, true, __nv_bfloat16>(a)
                 : launch<T, false, false, __nv_bfloat16>(a);
  }
  if (packed)
    return fused ? launch<T, true, true, float>(a) : launch<T, true, false, float>(a);
  return fused ? launch<T, false, true, float>(a) : launch<T, false, false, float>(a);
}

}  // namespace

// The whole tiled SpMV in one call.  Fused iff `cand` is non-null (then
// `alive`, `new_alive` and `mis_add` must be too).  `col_flags` may be null
// (every column active).  Returns a cudaError_t: 0 on a clean launch.
extern "C" int tc_spmv_launch(const void* tiles, int packed,
                              const void* row_starts, const void* tile_cols,
                              const void* col_flags, const void* rhs,
                              int rhs_bf16, void* n_c, const void* cand,
                              const void* alive, void* new_alive, void* mis_add,
                              int n_block_rows, int tile_size, int lanes,
                              void* stream) {
  if (n_block_rows <= 0) return cudaSuccess;
  if (lanes < 1) return cudaErrorInvalidValue;
  Args a{tiles,
         static_cast<const int32_t*>(row_starts),
         static_cast<const int32_t*>(tile_cols),
         static_cast<const int32_t*>(col_flags),
         rhs,
         static_cast<float*>(n_c),
         static_cast<const uint8_t*>(cand),
         static_cast<const uint8_t*>(alive),
         static_cast<uint8_t*>(new_alive),
         static_cast<uint8_t*>(mis_add),
         n_block_rows,
         lanes,
         static_cast<cudaStream_t>(stream)};
  const bool fused = cand != nullptr;
  const bool pk = packed != 0;
  const bool bf = rhs_bf16 != 0;
  switch (tile_size) {
    case 8: return dispatch<8>(a, pk, fused, bf);
    case 16: return dispatch<16>(a, pk, fused, bf);
    case 32: return dispatch<32>(a, pk, fused, bf);
    case 64: return dispatch<64>(a, pk, fused, bf);
    case 128: return dispatch<128>(a, pk, fused, bf);
    default: return cudaErrorInvalidValue;
  }
}
