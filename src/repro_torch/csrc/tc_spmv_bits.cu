// Packed-word SpMV for TC-MIS phase ② and the fused phase ②+③ on the
// bitwise frontier — Hopper (sm_90a) CUDA, with a plain C interface loaded
// through ctypes.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/tc_spmv.py:
//   fused (FUSED=true)  `_spmv_fused_bits_kernel` (tc_spmv.py:321): hit words,
//                       then new_alive = alive & ~cand & ~hit and
//                       mis_add = cand for the block-row's own words;
//   split (FUSED=false) `_spmv_bits_kernel` (tc_spmv.py:246): hit words only.
// Row v of block-row r is hit iff (tile_word[v][w] & cand_word[col][w]) != 0
// for some tile of the row whose column is not gated (col_flags[col] != 0)
// and some word w.  A nonzero test is all the MIS round needs, so there is
// no popcount.  `cand` is read by block-column as the right-hand side and,
// in the fused epilogue, by block-row as the row's own state.  Words hold
// bit j of word w for vertex 32w + j; for T < 32 only the low T bits are
// live and no output sets a higher one.
//
// Design.  One thread per vertex row: thread g = r·T + v walks block-row r's
// tiles row_starts[r] .. row_starts[r+1] and stops at its first hit.  A
// gated column is skipped before its tile is loaded.  The output words are
// built with __ballot_sync over the row threads: for T >= 32 a warp's 32
// threads are exactly one output word (word g / 32), for T < 32 a warp holds
// 32 / T block-rows and the first thread of each writes its T-bit slice.
// Every word has one writer, so there are no atomics and no shared memory;
// a block-row with no tile writes hit = 0, so the trivial rule
// (new_alive = alive & ~cand, mis_add = cand) holds with no patch.
//
// Bound.  Bytes: at the slice's shapes (G2, T = 16, W = 1) the 64-byte tiles
// of the active columns are the stream (30 MB when every column is
// active); the candidate words of a column are the same address for the
// T threads of a block-row and come from L1/L2.  One AND and one test per
// tile word, so operations are negligible.  Not yet done: overlapping the
// next tile's loads (cp.async/TMA).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a multiple of 32: warps never straddle blocks

template <int T, bool FUSED>
__global__ void spmv_bits_rows(const uint32_t* __restrict__ tiles,
                               const int32_t* __restrict__ row_starts,
                               const int32_t* __restrict__ tile_cols,
                               const int32_t* __restrict__ col_flags,
                               const uint32_t* __restrict__ cand,
                               const uint32_t* __restrict__ alive,
                               uint32_t* __restrict__ hit_out,
                               uint32_t* __restrict__ new_alive,
                               uint32_t* __restrict__ mis_add, int n_rows) {
  constexpr int W = T >= 32 ? T / 32 : 1;
  constexpr uint32_t LIVE = T >= 32 ? 0xffffffffu : (1u << T) - 1u;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = g < n_rows;
  const int r = g / T;
  const int v = g - r * T;
  bool hit = false;
  if (in_range) {
    const int t1 = row_starts[r + 1];
    for (int t = row_starts[r]; t < t1 && !hit; ++t) {
      const int col = tile_cols[t];
      if (col_flags != nullptr && col_flags[col] == 0) continue;
      const uint32_t* row = tiles + ((size_t)t * T + v) * W;
      const uint32_t* c = cand + (size_t)col * W;
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) any |= row[w] & c[w];
      hit = (any & LIVE) != 0;
    }
  }
  // every lane of the warp reaches the ballot, in range or not
  const uint32_t ballot = __ballot_sync(0xffffffffu, hit);
  if (!in_range) return;
  size_t word;
  uint32_t h;
  if constexpr (T >= 32) {
    if ((threadIdx.x & 31) != 0) return;
    word = (size_t)g / 32;               // = r·W + v / 32
    h = ballot;
  } else {
    if (v != 0) return;
    word = (size_t)r;
    h = (ballot >> (threadIdx.x & 31)) & LIVE;
  }
  hit_out[word] = h;
  if constexpr (FUSED) {
    const uint32_t c = cand[word];
    new_alive[word] = alive[word] & ~c & ~h & LIVE;
    mis_add[word] = c & LIVE;
  }
}

template <int T>
cudaError_t launch(const uint32_t* tiles, const int32_t* row_starts,
                   const int32_t* tile_cols, const int32_t* col_flags,
                   const uint32_t* cand, const uint32_t* alive, uint32_t* hit,
                   uint32_t* new_alive, uint32_t* mis_add, int n_rows,
                   cudaStream_t s) {
  const int grid = (n_rows + kThreads - 1) / kThreads;
  if (alive != nullptr)
    spmv_bits_rows<T, true><<<grid, kThreads, 0, s>>>(
        tiles, row_starts, tile_cols, col_flags, cand, alive, hit, new_alive,
        mis_add, n_rows);
  else
    spmv_bits_rows<T, false><<<grid, kThreads, 0, s>>>(
        tiles, row_starts, tile_cols, col_flags, cand, alive, hit, new_alive,
        mis_add, n_rows);
  return cudaGetLastError();
}

}  // namespace

// The whole packed SpMV in one call: tiles (nt, T, W) uint32, cand
// (nbc, W) uint32 -> hit (n_block_rows, W) uint32.  Fused iff `alive` is
// non-null (then `new_alive` and `mis_add` must be too; the block grid must
// be square, since `cand` is also read by block-row).  `col_flags` may be
// null (every column active).  Returns a cudaError_t: 0 on a clean launch.
extern "C" int tc_spmv_bits_launch(const void* tiles, const void* row_starts,
                                   const void* tile_cols, const void* col_flags,
                                   const void* cand, const void* alive, void* hit,
                                   void* new_alive, void* mis_add,
                                   int n_block_rows, int tile_size, void* stream) {
  if (n_block_rows <= 0) return cudaSuccess;
  const int n_rows = n_block_rows * tile_size;
  auto tw = static_cast<const uint32_t*>(tiles);
  auto rs = static_cast<const int32_t*>(row_starts);
  auto tc = static_cast<const int32_t*>(tile_cols);
  auto cf = static_cast<const int32_t*>(col_flags);
  auto cd = static_cast<const uint32_t*>(cand);
  auto al = static_cast<const uint32_t*>(alive);
  auto ht = static_cast<uint32_t*>(hit);
  auto na = static_cast<uint32_t*>(new_alive);
  auto ma = static_cast<uint32_t*>(mis_add);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile_size) {
    case 8: return launch<8>(tw, rs, tc, cf, cd, al, ht, na, ma, n_rows, s);
    case 16: return launch<16>(tw, rs, tc, cf, cd, al, ht, na, ma, n_rows, s);
    case 32: return launch<32>(tw, rs, tc, cf, cd, al, ht, na, ma, n_rows, s);
    case 64: return launch<64>(tw, rs, tc, cf, cd, al, ht, na, ma, n_rows, s);
    case 128: return launch<128>(tw, rs, tc, cf, cd, al, ht, na, ma, n_rows, s);
    default: return cudaErrorInvalidValue;
  }
}
