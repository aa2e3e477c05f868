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
// live and no output sets a higher one.  A block-row with no tile gets
// hit = 0, so the trivial rule (new_alive = alive & ~cand, mis_add = cand)
// holds with no patch.
//
// Bound.  Bytes: at the main path's shapes (G2, T = 16, W = 1) the 64-byte
// tiles of the active columns are the stream (30 MB when every column is
// active); one AND and one test per tile word, so operations are
// negligible.
//
// Design.
// * Both kernels at T <= 16 (the main packed path), a lane per tile
//   (`spmv_bits_tile_lanes<T, FUSED>`).  The form before it, a thread per
//   vertex row walking its block-row's tiles until its first hit, made
//   every step a chain of dependent loads (tile column, flag, candidate
//   word, tile word) and split the lanes of a warp over block-rows of
//   unequal length.  Here a warp owns groups of 64 output rows (64 / T
//   block-rows) and walks a group's tiles 32 at a time, one tile per lane:
//   the column, flag and candidate loads of 32 tiles are in flight
//   together, and a lane whose column is not gated (and has a candidate)
//   loads its whole tile, T words, as 16-byte loads.  It forms the tile's
//   T-bit hit mask, OR_v [(row_v & cand) != 0] << v, and the masks are ORed
//   into each block-row's word by one warp reduction per block-row of the
//   group (__reduce_or_sync, reached by every lane: no warp collective sits
//   under a lane-dependent branch).  Lane j then writes block-row r0 + j's
//   hit word and, fused, its new_alive and mis_add words.  The split
//   kernel's epilogue reads no `alive` and no candidate word by block-row,
//   so its block grid may be non-square.  The grid holds at most the CTAs
//   the card runs at once; each warp strides over the groups, loading the
//   next group's bounds and first 32 tile columns while it works on the
//   current one.
// * Both kernels at T >= 32: a thread per vertex row (`spmv_bits_rows`).
//   Thread g = r·T + v walks block-row r's tiles row_starts[r] ..
//   row_starts[r+1] and stops at its first hit; a gated column is skipped
//   before its tile is loaded.  The output words are built with
//   __ballot_sync over the row threads: a warp's 32 threads are exactly
//   one output word (word g / 32).  Every word has one writer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a multiple of 32: warps never straddle blocks
constexpr int WARPS = 8;        // warps per CTA of the lane-per-tile kernel
constexpr int ROWS_PER_WARP = 64;
constexpr unsigned FULL = 0xffffffffu;

// What both kernels read and write; alive, new_alive and mis_add are null
// in the split kernel, col_flags when every column is active.
struct Args {
  const uint32_t* tiles;
  const int32_t* row_starts;
  const int32_t* tile_cols;
  const int32_t* col_flags;
  const uint32_t* cand;
  const uint32_t* alive;
  uint32_t* hit;
  uint32_t* new_alive;
  uint32_t* mis_add;
  int nbr;
};

template <int T>
struct Words {
  static constexpr int W = T >= 32 ? T / 32 : 1;
  // the bits of a packed word that carry vertices
  static constexpr uint32_t LIVE = T >= 32 ? 0xffffffffu : (1u << T) - 1u;
};

// ---------------------------------------------------------------------------
// both kernels at T <= 16: a lane per tile
// ---------------------------------------------------------------------------

// The T row words of tile t (T·4 bytes: 16-byte loads).
template <int T>
__device__ __forceinline__ void tile_rows(const uint32_t* tiles, int t, uint32_t (&row)[T]) {
  const uint4* q = reinterpret_cast<const uint4*>(tiles) + (size_t)t * (T / 4);
#pragma unroll
  for (int i = 0; i < T / 4; ++i) {
    const uint4 w = __ldg(q + i);
    row[4 * i] = w.x; row[4 * i + 1] = w.y; row[4 * i + 2] = w.z; row[4 * i + 3] = w.w;
  }
}

template <int T, bool FUSED>
__global__ void __launch_bounds__(WARPS * 32)
spmv_bits_tile_lanes(const Args a) {
  constexpr int RB = ROWS_PER_WARP / T;   // block-rows per group
  constexpr uint32_t LIVE = Words<T>::LIVE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (a.nbr + RB - 1) / RB, stride = gridDim.x * WARPS;
  // Lane j <= RB holds the first tile of block-row r0 + j (the end of the
  // last; past nbr, the end of all tiles).  A group's bounds, and the
  // columns of its first 32 tiles, are loaded while the warp works on the
  // group before it.
  int g = blockIdx.x * WARPS + warp;
  int bound = g < groups ? __ldg(a.row_starts + min(g * RB + min(lane, RB), a.nbr)) : 0;
  const int first = __shfl_sync(FULL, bound, 0) + lane;
  int col_first = 0;
  if (first < __shfl_sync(FULL, bound, RB)) col_first = __ldg(a.tile_cols + first);

  for (; g < groups; g += stride) {
    const int r0 = g * RB;
    int edge[RB + 1];
#pragma unroll
    for (int j = 0; j <= RB; ++j) edge[j] = __shfl_sync(FULL, bound, j);
    const int gn = g + stride;
    const int bound_next = gn < groups ? __ldg(a.row_starts + min(gn * RB + min(lane, RB), a.nbr)) : 0;
    uint32_t hit = 0u;   // lane j < RB: block-row r0 + j's hit word

    for (int base = edge[0]; base < edge[RB]; base += 32) {
      const int t = base + lane;
      int rr = -1;       // t's block-row, relative to r0
      uint32_t mask = 0u;
      if (t < edge[RB]) {
        rr = 0;
#pragma unroll
        for (int j = 1; j < RB; ++j) rr += t >= edge[j];
        const int col = base == edge[0] ? col_first : __ldg(a.tile_cols + t);
        const bool open = a.col_flags == nullptr || __ldg(a.col_flags + col) != 0;
        const uint32_t c = __ldg(a.cand + col) & LIVE;
        if (open && c != 0u) {
          uint32_t row[T];
          tile_rows<T>(a.tiles, t, row);
#pragma unroll
          for (int v = 0; v < T; ++v) mask |= (uint32_t)((row[v] & c) != 0u) << v;
        }
      }
      // every lane reaches each reduction, with 0 for another block-row's tile
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const uint32_t x = __reduce_or_sync(FULL, rr == j ? mask : 0u);
        if (lane == j) hit |= x;
      }
    }
    // the next group's first columns, then this group's words out
    const int next = __shfl_sync(FULL, bound_next, 0) + lane;
    if (next < __shfl_sync(FULL, bound_next, RB)) col_first = __ldg(a.tile_cols + next);
    const int r = r0 + lane;
    if (lane < RB && r < a.nbr) {
      a.hit[r] = hit;
      if constexpr (FUSED) {
        const uint32_t c = __ldg(a.cand + r);
        a.new_alive[r] = __ldg(a.alive + r) & ~c & ~hit & LIVE;
        a.mis_add[r] = c & LIVE;
      }
    }
    bound = bound_next;
  }
}

// ---------------------------------------------------------------------------
// both kernels at T >= 32: a thread per vertex row
// ---------------------------------------------------------------------------

template <int T, bool FUSED>
__global__ void spmv_bits_rows(const Args a) {
  static_assert(T >= 32, "a warp's row threads must make whole words");
  constexpr int W = Words<T>::W;
  constexpr uint32_t LIVE = Words<T>::LIVE;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = g < a.nbr * T;
  const int r = g / T;
  const int v = g - r * T;
  const uint32_t* cand = a.cand;
  bool hit = false;
  if (in_range) {
    const int t1 = a.row_starts[r + 1];
    for (int t = a.row_starts[r]; t < t1 && !hit; ++t) {
      const int col = a.tile_cols[t];
      if (a.col_flags != nullptr && a.col_flags[col] == 0) continue;
      const uint32_t* row = a.tiles + ((size_t)t * T + v) * W;
      const uint32_t* c = cand + (size_t)col * W;
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) any |= row[w] & c[w];
      hit = (any & LIVE) != 0;
    }
  }
  // every lane of the warp reaches the ballot, in range or not
  const uint32_t h = __ballot_sync(FULL, hit);
  if (!in_range || (threadIdx.x & 31) != 0) return;
  const size_t word = (size_t)g / 32;    // = r·W + v / 32
  a.hit[word] = h;
  if constexpr (FUSED) {
    const uint32_t c = cand[word];
    a.new_alive[word] = a.alive[word] & ~c & ~h & LIVE;
    a.mis_add[word] = c & LIVE;
  }
}

template <typename Kernel>
int resident_ctas(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, 0);
  return max(sms * per_sm, 1);
}

template <int T, bool FUSED>
cudaError_t launch_tile_lanes(const Args& a, cudaStream_t s) {
  static int resident = 0;   // asked once per kernel
  if (!resident) resident = resident_ctas(spmv_bits_tile_lanes<T, FUSED>);
  constexpr int per_cta = WARPS * (ROWS_PER_WARP / T);
  const int grid = min((a.nbr + per_cta - 1) / per_cta, resident);
  spmv_bits_tile_lanes<T, FUSED><<<grid, WARPS * 32, 0, s>>>(a);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const bool fused = a.alive != nullptr;
  if constexpr (T <= 16) {
    return fused ? launch_tile_lanes<T, true>(a, s) : launch_tile_lanes<T, false>(a, s);
  } else {
    const int grid = (int)(((int64_t)a.nbr * T + kThreads - 1) / kThreads);
    if (fused)
      spmv_bits_rows<T, true><<<grid, kThreads, 0, s>>>(a);
    else
      spmv_bits_rows<T, false><<<grid, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
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
  const Args a{static_cast<const uint32_t*>(tiles), static_cast<const int32_t*>(row_starts),
               static_cast<const int32_t*>(tile_cols), static_cast<const int32_t*>(col_flags),
               static_cast<const uint32_t*>(cand), static_cast<const uint32_t*>(alive),
               static_cast<uint32_t*>(hit), static_cast<uint32_t*>(new_alive),
               static_cast<uint32_t*>(mis_add), n_block_rows};
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile_size) {
    case 8: return launch<8>(a, s);
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
