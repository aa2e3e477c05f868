// Tiled neighbour max for TC-MIS phase ① — Hopper (sm_90a) CUDA, with a
// plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/tc_neighbor_max.py:
//   dense max (DENSE)   `_nbr_max_kernel` (tc_neighbor_max.py:43): on the
//                       dense frontier, row v of a block-row takes, over its
//                       tiles, the max over the T cells u of the tile row of
//                       (cell(v, u) && mask[u] ? p[u] : _NEG); tiles int8 or
//                       packed words, as stored.  Every row of a
//                       block-row that owns a tile starts at _NEG, as the
//                       Pallas kernel's does, so even a row whose T cells
//                       are all live edges is floored there.
//   plane scan          `_nbr_max_bits_kernel` (tc_neighbor_max.py:96): on
//   (SELECT, RESOLVE)   the packed frontier, the max over v's live
//                       neighbours of the key the priority planes spell (31
//                       unsigned select planes, or 32 sign-biased resolve
//                       planes, un-biased on the way out), floored at _NEG.
//                       The bit-serial scan of the Pallas kernel computes
//                       exactly that max, so the kernel reads the keys out
//                       of the planes and takes it directly.
// A block-row that owns no tile writes int32 min (what `tile_neighbor_max`
// and the reference's packed wrapper give), so no wrapper patch is needed.
//
// Bound.  Bytes: at the main path's shapes (G2, T = 16, bitpack: 476,063
// tiles, 68,121 block-rows) the tile stream, the (nbr·T,) int32 output and
// each column's keys or planes once.  Neither sets the time.  The plane
// layout (n_bits, nbc, W) puts a column's 31 or 32 plane words in as many
// cache lines.  In the thread-per-row form that came before (one thread
// per vertex row, 31 plane loads and a 31-step scan per tile row), reading
// the planes from one line in place of 31 took 30 % off the select scan,
// and the per-row heads and scan steps most of the rest.  In this form
// (tools/nbr_max_ablation.py) the time goes to each warp's chain from its
// tiles' loads through the plane loads and the keys to the row maxes:
// reading no keys back after the transpose halves it.
//
// Design.
// * T <= 16 (the main path): a lane per tile.  A warp owns groups of 64
//   output rows (64 / T block-rows) and walks a group's tiles 32 at a
//   time, one tile per lane, so the tile_cols, row-word, mask and plane
//   loads of 32 tiles are in flight together, and one plane load
//   instruction fetches plane b of 32 tiles' columns: tiles of nearby
//   block-rows share block-columns whose plane words lie in the same lines
//   (at G2 a few lines per instruction in place of 32).  A lane with no
//   live neighbour in its tile loads no plane.  The lane turns its
//   column's planes into the T keys in registers (a T×T bit transpose on
//   32/T blocks of planes at once), or loads T priorities as 16-byte
//   vectors (dense max), and parks the keys in its own row of shared
//   memory.  Each tile row then takes the max over the set bits of
//   `row & live`, reading the keys by slot: work that scales with the live
//   neighbours, not with 31 planes.  Rows are max-ed into the warp's 64
//   accumulators in shared memory (tiles of one block-row sit in different
//   lanes), which the warp writes out once, coalesced.
// * T >= 32: a lane per key slot.  A warp owns one block-row at a time,
//   reads its tile_cols (and, for the scan, the column's mask words) 32 at
//   a time, and skips a tile whose mask words are 0 before loading
//   anything else.  Per tile it issues the row words of all its rows and
//   the keys first; lane u holds the key of slot 32·w + u of each word w:
//   the dense max loads it (coalesced), the plane scan has lane b load
//   plane b's W words and transposes the 32×32 bit matrix across the warp
//   (five shuffle stages per word).  Lane v owns rows v, v + 32, ..., and
//   takes the max over its set bits u by __shfl_sync from lane u, looping
//   while any lane has bits left.
// * Both grids hold at most the CTAs the card runs at once; each warp
//   strides over the groups (block-rows), loading the next one's bounds
//   (and, at T <= 16, its first 32 tile columns) while it works on the
//   current one, so no partial last wave idles the card.
// * Max over biased keys is max over the signed keys (the bias flips the
//   sign bit), so each key is un-biased as it is read and compared as
//   int32: the result equals the bit-serial scan's for every key.  Every
//   output has one writer (the warp that owns it), the max is exact in any
//   order, and every t·T·W, t·T·T and b·nbc offset is 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNeg = -(1 << 30);   // the reference's _NEG
constexpr int32_t kInt32Min = INT32_MIN;
constexpr int WARPS = 8;               // warps per CTA
constexpr int ROWS_PER_WARP = 64;      // output rows a warp owns at T <= 16
constexpr unsigned FULL = 0xffffffffu;

enum Kind { DENSE, SELECT, RESOLVE };  // RESOLVE: 32 sign-biased planes

template <int T>
struct Words {
  static constexpr int W = T >= 32 ? T / 32 : 1;
  // the bits of a packed word that carry vertices
  static constexpr uint32_t LIVE = T >= 32 ? 0xffffffffu : (1u << T) - 1u;
};

template <Kind K>
struct Stack {
  static constexpr int NB = K == RESOLVE ? 32 : 31;
  static constexpr uint32_t BIAS = K == RESOLVE ? 0x80000000u : 0u;
};

// What both kernels read; the dense max reads p and mask, the plane scan
// planes ((NB, nbc, W) words) and mask_words ((nbc, W)).
struct Args {
  const void* tiles;
  const int32_t* row_starts;
  const int32_t* tile_cols;
  const int32_t* p;
  const uint8_t* mask;
  const uint32_t* planes;
  const uint32_t* mask_words;
  int32_t* out;
  int nbr;
  int nbc;
};

// the bits of a column index with bit j clear, repeated over the word
__host__ __device__ constexpr uint32_t low_columns(int j) {
  return j == 16 ? 0x0000ffffu : j == 8 ? 0x00ff00ffu : j == 4 ? 0x0f0f0f0fu
       : j == 2 ? 0x33333333u : 0x55555555u;
}

// four int8 cells -> 4 bits, bit i set where byte i is nonzero
__device__ __forceinline__ uint32_t cells4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}
__device__ __forceinline__ uint32_t cells16(uint4 q) {
  return cells4(q.x) | cells4(q.y) << 4 | cells4(q.z) << 8 | cells4(q.w) << 12;
}

// W consecutive words (16-byte aligned for W = 4, 8-byte for W = 2)
template <int W>
__device__ __forceinline__ void load_words(const uint32_t* src, uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else if constexpr (W == 2) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(src));
    w[0] = q.x; w[1] = q.y;
  } else {
    w[0] = __ldg(src);
  }
}

// ---------------------------------------------------------------------------
// T <= 16: a lane per tile
// ---------------------------------------------------------------------------

// The T row words of tile t: packed words as stored, or built from int8
// cells (T = 16: one 16-byte row; T = 8: two rows per 16 bytes).
template <int T, bool PACKED>
__device__ __forceinline__ void tile_rows(const void* tiles, int t, uint32_t (&row)[T]) {
  if constexpr (PACKED) {
    const uint4* q = reinterpret_cast<const uint4*>(tiles) + (size_t)t * (T / 4);
#pragma unroll
    for (int i = 0; i < T / 4; ++i) {
      const uint4 w = __ldg(q + i);
      row[4 * i] = w.x; row[4 * i + 1] = w.y; row[4 * i + 2] = w.z; row[4 * i + 3] = w.w;
    }
  } else if constexpr (T == 16) {
    const uint4* q = reinterpret_cast<const uint4*>(tiles) + (size_t)t * 16;
#pragma unroll
    for (int v = 0; v < 16; ++v) row[v] = cells16(__ldg(q + v));
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(tiles) + (size_t)t * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 w = __ldg(q + i);
      row[2 * i] = cells4(w.x) | cells4(w.y) << 4;
      row[2 * i + 1] = cells4(w.z) | cells4(w.w) << 4;
    }
  }
}

// The dense frontier's live slots of column col: T mask bytes -> T bits.
template <int T>
__device__ __forceinline__ uint32_t mask_bits(const uint8_t* mask, int col) {
  if constexpr (T == 16) {
    return cells16(__ldg(reinterpret_cast<const uint4*>(mask) + col));
  } else {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(mask) + col);
    return cells4(q.x) | cells4(q.y) << 4;
  }
}

// x[b] = plane b's word of a column (bit u = slot u) -> y[u] = the key of
// slot u (bit b = bit u of x[b]).  y[k] first gathers planes k, k + T, ...
// as 32/T blocks of T bits, then each T×T block is transposed in place.
template <int T>
__device__ __forceinline__ void keys_of_planes(const uint32_t (&x)[32], uint32_t (&y)[T]) {
  constexpr uint32_t LIVE = Words<T>::LIVE;
#pragma unroll
  for (int k = 0; k < T; ++k) {
    y[k] = 0u;
#pragma unroll
    for (int q = 0; q < 32 / T; ++q) y[k] |= (x[k + q * T] & LIVE) << (q * T);
  }
#pragma unroll
  for (int j = T / 2; j >= 1; j >>= 1) {
    const uint32_t m = low_columns(j);
#pragma unroll
    for (int k = 0; k < T; ++k) {
      if (k & j) continue;
      const uint32_t lo = y[k], hi = y[k + j];
      y[k] = (lo & m) | ((hi & m) << j);
      y[k + j] = ((lo >> j) & m) | (hi & ~m);
    }
  }
}

template <int T, Kind K, bool PACKED>
__global__ void __launch_bounds__(WARPS * 32)
nbr_max_tile_lanes(const Args a) {
  constexpr int RB = ROWS_PER_WARP / T;   // block-rows per group
  __shared__ int32_t acc_s[WARPS][ROWS_PER_WARP];
  __shared__ int32_t key_s[WARPS][32][T + 1]; // a row of keys per lane
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
    for (int e = lane; e < ROWS_PER_WARP; e += 32) acc_s[warp][e] = kInt32Min;
    __syncwarp();

    for (int base = edge[0]; base < edge[RB]; base += 32) {
      const int t = base + lane;
      if (t >= edge[RB]) continue;
      int rr = 0;   // t's block-row, relative to r0
#pragma unroll
      for (int j = 1; j < RB; ++j) rr += t >= edge[j];
      const int col = base == edge[0] ? col_first : __ldg(a.tile_cols + t);
      uint32_t live;
      if constexpr (K == DENSE) live = mask_bits<T>(a.mask, col);
      else live = __ldg(a.mask_words + col) & Words<T>::LIVE;
      uint32_t cur[T];
      tile_rows<T, PACKED>(a.tiles, t, cur);
      uint32_t any = 0u;
#pragma unroll
      for (int v = 0; v < T; ++v) {
        cur[v] &= live;
        any |= cur[v];
      }
      if (!any) continue;
      int32_t* keys = key_s[warp][lane];
      if constexpr (K == DENSE) {
        const int4* pk = reinterpret_cast<const int4*>(a.p) + (size_t)col * (T / 4);
#pragma unroll
        for (int i = 0; i < T / 4; ++i) {
          const int4 k = __ldg(pk + i);
          keys[4 * i] = k.x; keys[4 * i + 1] = k.y; keys[4 * i + 2] = k.z; keys[4 * i + 3] = k.w;
        }
      } else {
        uint32_t x[32];
#pragma unroll
        for (int b = 0; b < 32; ++b)
          x[b] = b < Stack<K>::NB ? __ldg(a.planes + (size_t)b * a.nbc + col) : 0u;
        uint32_t y[T];
        keys_of_planes<T>(x, y);
#pragma unroll
        for (int u = 0; u < T; ++u) keys[u] = (int32_t)(y[u] ^ Stack<K>::BIAS);
      }
#pragma unroll
      for (int v = 0; v < T; ++v) {
        uint32_t bits = cur[v];
        if (!bits) continue;
        int32_t m = kInt32Min;
        do {
          m = max(m, keys[__ffs(bits) - 1]);
          bits &= bits - 1u;
        } while (bits);
        atomicMax(&acc_s[warp][rr * T + v], m);
      }
    }
    // the next group's first columns, then this group's rows out
    const int next = __shfl_sync(FULL, bound_next, 0) + lane;
    if (next < __shfl_sync(FULL, bound_next, RB)) col_first = __ldg(a.tile_cols + next);
    __syncwarp();
    // The shared load stays outside the `hi > lo` select: inside it, nvcc
    // branches around each pass's load and store and no longer overlaps
    // the two passes, which cost the plane scans 3-8 % at G2.
    for (int e = lane; e < ROWS_PER_WARP; e += 32) {
      const int rr = e / T;
      const int lo = __shfl_sync(FULL, bound, rr), hi = __shfl_sync(FULL, bound, rr + 1);
      if (r0 + rr >= a.nbr) continue;
      const int32_t m = max(acc_s[warp][e], kNeg);
      a.out[(size_t)r0 * T + e] = hi > lo ? m : kInt32Min;
    }
    __syncwarp();
    bound = bound_next;
  }
}

// ---------------------------------------------------------------------------
// T >= 32: a lane per key slot
// ---------------------------------------------------------------------------

// 32×32 bit transpose across the warp: lane r holds row r on entry and
// column `lane` on return (bit r = bit `lane` of row r).
__device__ __forceinline__ uint32_t warp_transpose(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1) {
    const uint32_t m = low_columns(j);
    const uint32_t y = __shfl_xor_sync(FULL, x, j);
    x = (lane & j) ? ((y >> j) & m) | (x & ~m) : (x & m) | ((y & m) << j);
  }
  return x;
}

// Row v of tile t as W words of bits.
template <int T, bool PACKED>
__device__ __forceinline__ void row_words(const void* tiles, int t, int v,
                                          uint32_t (&row)[Words<T>::W]) {
  constexpr int W = Words<T>::W;
  const size_t cell = (size_t)t * T + v;
  if constexpr (PACKED) {
    load_words<W>(reinterpret_cast<const uint32_t*>(tiles) + cell * W, row);
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(tiles) + cell * (T / 16);
#pragma unroll
    for (int w = 0; w < W; ++w) row[w] = cells16(__ldg(q + 2 * w)) | cells16(__ldg(q + 2 * w + 1)) << 16;
  }
}

template <int T, Kind K, bool PACKED>
__global__ void __launch_bounds__(WARPS * 32)
nbr_max_slot_lanes(const Args a) {
  constexpr int W = Words<T>::W;   // key words per lane, and row passes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * WARPS;
  int r = blockIdx.x * WARPS + warp;
  // lanes 0 and 1 hold the block-row's first and end tile, loaded while
  // the warp works on the block-row before it
  int span = r < a.nbr ? __ldg(a.row_starts + r + min(lane, 1)) : 0;
  for (; r < a.nbr; r += stride) {
    const int t0 = __shfl_sync(FULL, span, 0), t1 = __shfl_sync(FULL, span, 1);
    if (r + stride < a.nbr) span = __ldg(a.row_starts + r + stride + min(lane, 1));
    int32_t m[W];       // rows 32·j + lane, floored at _NEG
#pragma unroll
    for (int j = 0; j < W; ++j) m[j] = kNeg;

    for (int base = t0; base < t1; base += 32) {
      int col_l = 0;
      uint32_t mw_l[W] = {};
      bool go = false;
      if (base + lane < t1) {
        col_l = __ldg(a.tile_cols + base + lane);
        if constexpr (K == DENSE) {
          go = true;
        } else {
          load_words<W>(a.mask_words + (size_t)col_l * W, mw_l);
#pragma unroll
          for (int w = 0; w < W; ++w) go |= mw_l[w] != 0u;
        }
      }
      unsigned todo = __ballot_sync(FULL, go);
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1u;
        const int t = base + i;
        const size_t col = (size_t)__shfl_sync(FULL, col_l, i);
        // every load of the tile before the first use: its rows, its keys
        uint32_t cur[W][W];
#pragma unroll
        for (int j = 0; j < W; ++j) row_words<T, PACKED>(a.tiles, t, 32 * j + lane, cur[j]);
        int32_t key[W];
        uint32_t live[W];
        if constexpr (K == DENSE) {
          uint8_t alive[W];
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const size_t slot = col * T + 32 * w + lane;
            key[w] = __ldg(a.p + slot);
            alive[w] = __ldg(a.mask + slot);
          }
#pragma unroll
          for (int w = 0; w < W; ++w) live[w] = __ballot_sync(FULL, alive[w] != 0);
        } else {
          uint32_t x[W] = {};
          if (lane < Stack<K>::NB)
            load_words<W>(a.planes + ((size_t)lane * a.nbc + col) * W, x);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            key[w] = (int32_t)(warp_transpose(x[w], lane) ^ Stack<K>::BIAS);
            live[w] = __shfl_sync(FULL, mw_l[w], i);
          }
        }
#pragma unroll
        for (int j = 0; j < W; ++j) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            uint32_t bits = cur[j][w] & live[w];
            while (__any_sync(FULL, bits)) {
              const int32_t k = __shfl_sync(FULL, key[w], bits ? __ffs(bits) - 1 : 0);
              if (bits) m[j] = max(m[j], k);
              bits &= bits - 1u;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) a.out[(size_t)r * T + 32 * j + lane] = t1 > t0 ? m[j] : kInt32Min;
  }
}

// ---------------------------------------------------------------------------
// launches: a grid of at most the CTAs the card holds at once, each warp
// striding over the groups (T <= 16) or block-rows (T >= 32)
// ---------------------------------------------------------------------------

template <typename Kernel>
int resident_ctas(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, 0);
  return max(sms * per_sm, 1);
}

template <int T, Kind K, bool PACKED>
cudaError_t launch(const Args& a, cudaStream_t s) {
  static int resident = 0;   // asked once per kernel
  if constexpr (T <= 16) {
    constexpr int per_cta = WARPS * (ROWS_PER_WARP / T);
    if (!resident) resident = resident_ctas(nbr_max_tile_lanes<T, K, PACKED>);
    const int grid = min((a.nbr + per_cta - 1) / per_cta, resident);
    nbr_max_tile_lanes<T, K, PACKED><<<grid, WARPS * 32, 0, s>>>(a);
  } else {
    if (!resident) resident = resident_ctas(nbr_max_slot_lanes<T, K, PACKED>);
    const int grid = min((a.nbr + WARPS - 1) / WARPS, resident);
    nbr_max_slot_lanes<T, K, PACKED><<<grid, WARPS * 32, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <Kind K, bool PACKED>
cudaError_t launch_for(int tile_size, const Args& a, cudaStream_t s) {
  switch (tile_size) {
    case 8: return launch<8, K, PACKED>(a, s);
    case 16: return launch<16, K, PACKED>(a, s);
    case 32: return launch<32, K, PACKED>(a, s);
    case 64: return launch<64, K, PACKED>(a, s);
    case 128: return launch<128, K, PACKED>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dense-frontier neighbour max: out (n_block_rows·T,) int32.  `packed`
// selects (nt, T, W) uint32 words over (nt, T, T) int8 tiles; `p` is the
// (nbc·T,) int32 priority vector and `mask` its (nbc·T,) uint8 liveness,
// both 16-byte aligned.  Returns a cudaError_t: 0 on a clean launch.
extern "C" int tc_nbr_max_launch(const void* tiles, int packed, const void* row_starts,
                                 const void* tile_cols, const void* p,
                                 const void* mask, void* out, int n_block_rows,
                                 int tile_size, void* stream) {
  if (n_block_rows <= 0) return cudaSuccess;
  const Args a{tiles, static_cast<const int32_t*>(row_starts),
               static_cast<const int32_t*>(tile_cols), static_cast<const int32_t*>(p),
               static_cast<const uint8_t*>(mask), nullptr, nullptr,
               static_cast<int32_t*>(out), n_block_rows, 0};
  auto s = static_cast<cudaStream_t>(stream);
  return packed ? launch_for<DENSE, true>(tile_size, a, s)
                : launch_for<DENSE, false>(tile_size, a, s);
}

// Packed-frontier plane scan: tiles (nt, T, W) uint32, mask_words (nbc, W)
// uint32, planes (32, nbc, W) sign-biased uint32 if `sign` != 0, else
// (31, nbc, W); planes and mask_words 16-byte aligned -> out (n_block_rows·T,)
// int32.
extern "C" int tc_nbr_max_bits_launch(const void* tiles, const void* row_starts,
                                      const void* tile_cols, const void* planes,
                                      const void* mask_words, void* out,
                                      int n_block_rows, int n_block_cols,
                                      int tile_size, int sign, void* stream) {
  if (n_block_rows <= 0) return cudaSuccess;
  const Args a{tiles, static_cast<const int32_t*>(row_starts),
               static_cast<const int32_t*>(tile_cols), nullptr, nullptr,
               static_cast<const uint32_t*>(planes), static_cast<const uint32_t*>(mask_words),
               static_cast<int32_t*>(out), n_block_rows, n_block_cols};
  auto s = static_cast<cudaStream_t>(stream);
  return sign ? launch_for<RESOLVE, true>(tile_size, a, s)
              : launch_for<SELECT, true>(tile_size, a, s);
}
