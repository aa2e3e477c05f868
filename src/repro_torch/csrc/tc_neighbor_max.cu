// Tiled neighbour max for TC-MIS phase ① — Hopper (sm_90a) CUDA, with a
// plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/tc_neighbor_max.py:
//   nbr_max_rows       `_nbr_max_kernel` (tc_neighbor_max.py:43): on the
//                      dense frontier, out[v] = max of (mask[u] ? p[u] : _NEG)
//                      over the edges (v, u) of v's block-row; tiles int8 or
//                      packed words, as stored.
//   nbr_max_bits_rows  `_nbr_max_bits_kernel` (tc_neighbor_max.py:96): on the
//                      packed frontier, the priority-plane scan.  Per tile
//                      row, cur = tile_word & mask_word; for each plane b from
//                      high to low, a nonempty cur & plane_b sets bit b of the
//                      max and narrows cur.  Sign-biased planes (^ 0x80000000)
//                      are un-biased on the way out.
// In both, a row of a block-row that owns a tile starts at _NEG (the Pallas
// kernels' per-row initialisation), and a block-row that owns no tile
// writes int32 min (what `tile_neighbor_max` and the reference's packed
// wrapper give), so no wrapper patch is needed.
//
// Design.  One thread per vertex row: thread g = r·T + v owns row v of
// block-row r and walks the block-row's tiles row_starts[r] ..
// row_starts[r+1] in order.  Every output has exactly one writer, so there
// are no atomics, no shared memory and no barrier; padding tiles past the
// real ones are never visited.  The T threads of a block-row read the T rows
// of a tile, which lie next to each other in memory, so tile loads coalesce;
// the priorities, mask words and plane words of the tile's column are the
// same few addresses for all T threads and come from L1.  The packed dense
// max walks set bits only (__ffs), so its work scales with nnz, not T².
//
// Bound.  Bytes, not operations: at the slice's shapes (G2, T = 16, W = 1)
// a tile is 64 bytes of words against ~10 nonzeros; the plane scan does 31
// or 32 word ANDs per nonempty tile row, all from L1/L2-resident plane words.
// The tile stream (30 MB packed, 122 MB int8) plus the (nbr·T,) int32 output
// dominate.  Not yet done: staging a column's planes in shared memory once
// per tile, and overlapping the next tile's loads (cp.async/TMA).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNeg = -(1 << 30);   // the reference's _NEG
constexpr int32_t kInt32Min = INT32_MIN;
constexpr int kThreads = 256;

template <int T>
struct Words {
  static constexpr int W = T >= 32 ? T / 32 : 1;
  // the bits of a packed word that carry vertices
  static constexpr uint32_t LIVE = T >= 32 ? 0xffffffffu : (1u << T) - 1u;
};

template <int T, bool PACKED>
__global__ void nbr_max_rows(const void* __restrict__ tiles_v,
                             const int32_t* __restrict__ row_starts,
                             const int32_t* __restrict__ tile_cols,
                             const int32_t* __restrict__ p,
                             const uint8_t* __restrict__ mask,
                             int32_t* __restrict__ out, int n_rows) {
  constexpr int W = Words<T>::W;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_rows) return;
  const int r = g / T;
  const int v = g - r * T;
  const int t0 = row_starts[r];
  const int t1 = row_starts[r + 1];
  int32_t acc = t0 < t1 ? kNeg : kInt32Min;
  for (int t = t0; t < t1; ++t) {
    const size_t base = (size_t)tile_cols[t] * T;
    const int32_t* pc = p + base;
    const uint8_t* mc = mask + base;
    if constexpr (PACKED) {
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(tiles_v) + ((size_t)t * T + v) * W;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t bits = row[w] & Words<T>::LIVE;
        while (bits) {
          const int u = w * 32 + __ffs(bits) - 1;
          if (mc[u]) acc = max(acc, pc[u]);
          bits &= bits - 1u;
        }
      }
    } else {
      // a row of T int8 cells, read 8 bytes at a time (T is a multiple of 8
      // and the tiles are 16-byte aligned)
      const uint2* row = reinterpret_cast<const uint2*>(
          reinterpret_cast<const int8_t*>(tiles_v) + ((size_t)t * T + v) * T);
#pragma unroll
      for (int k = 0; k < T / 8; ++k) {
        const uint2 cells = row[k];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t word = j < 4 ? cells.x : cells.y;
          const int u = k * 8 + j;
          if (((word >> (8 * (j & 3))) & 0xffu) != 0 && mc[u]) acc = max(acc, pc[u]);
        }
      }
    }
  }
  out[g] = acc;
}

// SIGNED: 32 sign-biased resolve planes; else 31 unsigned select planes
// (the only two stacks the engines build).
template <int T, bool SIGNED>
__global__ void nbr_max_bits_rows(const uint32_t* __restrict__ tiles,
                                  const int32_t* __restrict__ row_starts,
                                  const int32_t* __restrict__ tile_cols,
                                  const uint32_t* __restrict__ planes,
                                  const uint32_t* __restrict__ mask_words,
                                  int32_t* __restrict__ out, int n_rows,
                                  int n_block_cols) {
  constexpr int W = Words<T>::W;
  constexpr int NB = SIGNED ? 32 : 31;
  constexpr uint32_t kBias = SIGNED ? 0x80000000u : 0u;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_rows) return;
  const int r = g / T;
  const int v = g - r * T;
  const int t0 = row_starts[r];
  const int t1 = row_starts[r + 1];
  const size_t plane_stride = (size_t)n_block_cols * W;
  int32_t acc = t0 < t1 ? kNeg : kInt32Min;
  for (int t = t0; t < t1; ++t) {
    const size_t col = (size_t)tile_cols[t];
    const uint32_t* row = tiles + ((size_t)t * T + v) * W;
    uint32_t cur[W];
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      cur[w] = row[w] & mask_words[col * W + w];
      any |= cur[w];
    }
    if (any == 0) continue;   // no live neighbour: _NEG, which acc already is
    const uint32_t* pc = planes + col * W;
    uint32_t maxv = 0;
    // the plane words do not depend on cur, so the unrolled scan issues all
    // its loads up front
#pragma unroll
    for (int b = NB - 1; b >= 0; --b) {
      const uint32_t* pw = pc + (size_t)b * plane_stride;
      uint32_t inter[W];
      uint32_t has = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        inter[w] = cur[w] & pw[w];
        has |= inter[w];
      }
      if (has) {
        maxv |= 1u << b;
#pragma unroll
        for (int w = 0; w < W; ++w) cur[w] = inter[w];
      }
    }
    acc = max(acc, (int32_t)(maxv ^ kBias));
  }
  out[g] = acc;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <int T>
cudaError_t launch_nbr_max(const void* tiles, bool packed, const int32_t* row_starts,
                           const int32_t* tile_cols, const int32_t* p,
                           const uint8_t* mask, int32_t* out, int n_rows,
                           cudaStream_t s) {
  if (packed)
    nbr_max_rows<T, true><<<blocks_for(n_rows), kThreads, 0, s>>>(
        tiles, row_starts, tile_cols, p, mask, out, n_rows);
  else
    nbr_max_rows<T, false><<<blocks_for(n_rows), kThreads, 0, s>>>(
        tiles, row_starts, tile_cols, p, mask, out, n_rows);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_nbr_max_bits(const uint32_t* tiles, const int32_t* row_starts,
                                const int32_t* tile_cols, const uint32_t* planes,
                                const uint32_t* mask_words, int32_t* out,
                                int n_rows, int nbc, bool sign, cudaStream_t s) {
  const int grid = blocks_for(n_rows);
  if (sign)
    nbr_max_bits_rows<T, true><<<grid, kThreads, 0, s>>>(
        tiles, row_starts, tile_cols, planes, mask_words, out, n_rows, nbc);
  else
    nbr_max_bits_rows<T, false><<<grid, kThreads, 0, s>>>(
        tiles, row_starts, tile_cols, planes, mask_words, out, n_rows, nbc);
  return cudaGetLastError();
}

}  // namespace

// Dense-frontier neighbour max: out (n_block_rows·T,) int32.  `packed`
// selects (nt, T, W) uint32 words over (nt, T, T) int8 tiles; `p` is the
// (nbc·T,) int32 priority vector and `mask` its (nbc·T,) uint8 liveness.
// Returns a cudaError_t: 0 on a clean launch.
extern "C" int tc_nbr_max_launch(const void* tiles, int packed, const void* row_starts,
                                 const void* tile_cols, const void* p,
                                 const void* mask, void* out, int n_block_rows,
                                 int tile_size, void* stream) {
  if (n_block_rows <= 0) return cudaSuccess;
  const int n_rows = n_block_rows * tile_size;
  auto rs = static_cast<const int32_t*>(row_starts);
  auto tc = static_cast<const int32_t*>(tile_cols);
  auto pp = static_cast<const int32_t*>(p);
  auto mk = static_cast<const uint8_t*>(mask);
  auto o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool pk = packed != 0;
  switch (tile_size) {
    case 8: return launch_nbr_max<8>(tiles, pk, rs, tc, pp, mk, o, n_rows, s);
    case 16: return launch_nbr_max<16>(tiles, pk, rs, tc, pp, mk, o, n_rows, s);
    case 32: return launch_nbr_max<32>(tiles, pk, rs, tc, pp, mk, o, n_rows, s);
    case 64: return launch_nbr_max<64>(tiles, pk, rs, tc, pp, mk, o, n_rows, s);
    case 128: return launch_nbr_max<128>(tiles, pk, rs, tc, pp, mk, o, n_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// Packed-frontier plane scan: tiles (nt, T, W) uint32, mask_words (nbc, W)
// uint32, planes (32, nbc, W) sign-biased uint32 if `sign` != 0, else
// (31, nbc, W) -> out (n_block_rows·T,) int32.
extern "C" int tc_nbr_max_bits_launch(const void* tiles, const void* row_starts,
                                      const void* tile_cols, const void* planes,
                                      const void* mask_words, void* out,
                                      int n_block_rows, int n_block_cols,
                                      int tile_size, int sign, void* stream) {
  if (n_block_rows <= 0) return cudaSuccess;
  const int n_rows = n_block_rows * tile_size;
  auto tw = static_cast<const uint32_t*>(tiles);
  auto rs = static_cast<const int32_t*>(row_starts);
  auto tc = static_cast<const int32_t*>(tile_cols);
  auto pl = static_cast<const uint32_t*>(planes);
  auto mw = static_cast<const uint32_t*>(mask_words);
  auto o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool sg = sign != 0;
  const int nbc = n_block_cols;
  switch (tile_size) {
    case 8: return launch_nbr_max_bits<8>(tw, rs, tc, pl, mw, o, n_rows, nbc, sg, s);
    case 16: return launch_nbr_max_bits<16>(tw, rs, tc, pl, mw, o, n_rows, nbc, sg, s);
    case 32: return launch_nbr_max_bits<32>(tw, rs, tc, pl, mw, o, n_rows, nbc, sg, s);
    case 64: return launch_nbr_max_bits<64>(tw, rs, tc, pl, mw, o, n_rows, nbc, sg, s);
    case 128: return launch_nbr_max_bits<128>(tw, rs, tc, pl, mw, o, n_rows, nbc, sg, s);
    default: return cudaErrorInvalidValue;
  }
}
