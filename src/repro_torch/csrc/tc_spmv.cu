// Block-tiled SpMV for TC-MIS phase ② and the fused phase ②+③ — Hopper
// (sm_90a) CUDA on the tensor cores, with a plain C interface loaded
// through ctypes.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/tc_spmv.py:
//   fused (FUSED=true)  `_spmv_fused_kernel` (tc_spmv.py:137): N_c = A × rhs,
//                       then new_alive = alive & ~cand & ~(N_c[:,0] > 0) and
//                       mis_add = cand for the block-row's own vertices;
//   split (FUSED=false) `_spmv_kernel` (tc_spmv.py:54): N_c = A × rhs only.
// Both honour `col_flags`: a tile whose block-column flag is 0 adds nothing,
// and neither its tile nor its RHS slab is loaded (the Pallas `skip_dma`).
//
// Bound.  Bytes: at the main path's shapes (T = 16, bitpack, L = 8) a tile
// is 64 bytes of words against a 512-byte f32 RHS slab, so the least the
// card can move is the active tiles, each needed slab once and the
// (nbr·T, L) f32 N_c.  The kernel reads a slab once per tile that needs
// it (about seven times at G2, mostly from L2), so that L2 traffic sits
// above the bound.  Neither sets its time: measured at G2 (T = 16),
// taking out the slab loads, the tile loads, the mma or the f32 split each
// saves time in proportion to the instructions it removes, and the
// block-row heads alone (row_starts, tile_cols, col_flags, the ballot and
// the stores) take half of it.  The time follows the instruction count,
// so the design below cuts instructions per tile.
//
// Design.
// * A warp per (block-row, 16-row strip): T = 16 is one warp per
//   block-row, T = 128 eight independent warps (one CTA, so seven of the
//   eight reads of each slab hit L1); T = 8 fills half an m16 fragment and
//   zeroes the rest.  Rows are independent, so nothing is reduced across
//   warps: no atomics, no barrier, deterministic sums.  Eight warps to a
//   CTA, at most 64 registers (__launch_bounds__(256, 4)): 32 resident
//   warps per SM.
// * The warp reads its block-row's tile_cols and their col_flags 32 at a
//   time, lane-parallel, and builds the active-tile mask with
//   __ballot_sync; a gated tile loads neither its tile nor its slab.
//   Tiles past row_starts[r+1] (the padding) are never visited; a
//   block-row with no tiles stores N_c = 0, so the trivial rule (alive' =
//   alive & ~cand, mis_add = cand) needs no patch.
// * A batch of four 16-wide k-steps (four tiles at T = 16, half a tile at
//   T = 128) has its loads issued before the first product uses them;
//   registers are the pipeline, no shared memory.  One pointer per tile
//   and step: with L fixed at compile time (the engines' 8; other L take a
//   run-time instance), the rows g + 8 and the slab rows are immediate
//   offsets from it.
// * The tile × slab product is mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32
//   on one 8-lane block of the RHS per pass (ceil(L / 8) passes, the lanes
//   past L loaded as 0 and never stored).  The K order inside a step is
//   permuted so that thread q of a quad owns four adjacent columns, 4q ..
//   4q + 3 (2q, 2q + 1 at T = 8): one packed word or one int8 word per row
//   and step, and four slab rows for the B fragment.  A 0/1 cell is exact
//   in bf16 and is built in registers (a nonzero int8 byte or a set bit
//   becomes 1.0, as the plain version's `tiles != 0` mask); nothing is
//   unpacked in device memory.
// * At T >= 32 a warp's 16×16 blocks are often empty (G2 at T = 128: most
//   of them), so the batch's A words come first, and only blocks with an
//   edge load their slab rows and multiply.
// * An f32 RHS is split in registers into three bf16 parts, hi = rn(x),
//   mid = rn(x - hi), lo = rn(x - hi - mid), each multiplied into its own
//   f32 accumulator, which the epilogue adds hi + mid + lo.  The parts sum
//   back to x exactly for finite x with 2^-110 <= |x| < 2^128·(1 - 2^-9)
//   (and 0), and A is 0/1, so every product is exact and only the order
//   and rounding of the sums differ from the plain version: 0/1 lanes,
//   whose sums are small integers, and rows with one nonzero term are
//   exact.  When no value of a batch has low 16 bits (0/1 lanes, as the
//   engines' RHS), hi is the value's high half and mid = lo = 0, so only
//   the hi product runs: the same bits.  A bf16 RHS (split kernel only)
//   takes one mma.
// * The epilogue stores each thread's fragment as float2 (rows g and g+8,
//   lanes 2q and 2q+1; scalars when L is odd).  In the fused kernel the
//   quad leaders, which hold lane 0, apply the phase-③ rule to their two
//   rows.  Every t·T·W, t·T·T and r·T·L offset is 64-bit.
//
// Why mma.sync and not wgmma: wgmma multiplies a 64-row A by one B that
// sits in shared memory.  At T = 16 (the main path) the four block-rows a
// 64-row product would cover lie in different block-columns and gather
// four different slabs, so there is no common B.  At T = 128 the eight
// strips of a block-row do share each slab, but it would have to be staged
// in shared memory behind a barrier per tile, for products far below the
// tensor cores' rate anyway.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // warps per CTA
constexpr int MIN_CTAS = 4;          // CTAs per SM the register budget must allow
constexpr int BATCH = 4;             // k-steps whose loads are in flight together
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t BF16_ONE = 0x3F80u;

template <int T, typename RT>
struct Shape {
  static constexpr int STRIPS = T >= 16 ? T / 16 : 1;    // 16-row strips per block-row
  static constexpr int ROWS_PER_CTA = WARPS / STRIPS;
  static constexpr int KS = T >= 16 ? T / 16 : 1;        // k-steps per tile
  static constexpr int KG = KS < BATCH ? KS : BATCH;     // k-steps of one tile per batch
  static constexpr int TILES = BATCH / KG;               // tiles per batch
  static constexpr int ROWS = T >= 16 ? 2 : 1;           // rows g (and g + 8) per thread
  static constexpr int ELEMS = T >= 16 ? 4 : 2;          // K elements a thread owns per step
  static constexpr int PARTS = sizeof(RT) == 2 ? 1 : 3;  // bf16 parts of an RHS value
};

// two cells (bits 0, 1 of x) -> a bf16x2 A register (1.0 where an edge)
__device__ __forceinline__ uint32_t pair_from_bits(uint32_t x) {
  return (x & 1u) * BF16_ONE | (x & 2u) * (BF16_ONE << 15);
}
// int8 cells: m holds 0xFF per nonzero byte; bytes 0, 1 -> sel 0x1100, 2, 3 -> 0x3322
__device__ __forceinline__ uint32_t pair_from_bytes(uint32_t m, uint32_t sel) {
  return __byte_perm(m, 0u, sel) & (BF16_ONE * 0x10001u);
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two RHS values (x0, x1) -> the bf16x2 B register of each part: three
// for f32 (hi, mid, lo, whose sums give back x0 and x1 exactly), one for
// bf16.
__device__ __forceinline__ void rhs_parts(float x0, float x1, uint32_t (&part)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float2 h = __bfloat1622float2(hi);
  const float r0 = x0 - h.x, r1 = x1 - h.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const float2 m = __bfloat1622float2(mid);
  part[0] = bf2_bits(hi);
  part[1] = bf2_bits(mid);
  part[2] = bf2_bits(__floats2bfloat162_rn(r0 - m.x, r1 - m.y));
}
__device__ __forceinline__ void rhs_parts(__nv_bfloat16 x0, __nv_bfloat16 x1,
                                          uint32_t (&part)[1]) {
  part[0] = __bfloat16_as_ushort(x0) | (uint32_t)__bfloat16_as_ushort(x1) << 16;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename RT>
__device__ __forceinline__ RT load_rhs(const RT* p, bool live) {
  return live ? __ldg(p) : RT(0.f);
}

// LANES > 0 fixes L at compile time (the engines' 8), so that every slab
// and output offset folds into the load's immediate; LANES = 0 takes L at
// run time.
template <int T, bool PACKED, bool FUSED, typename RT, int LANES>
__global__ void __launch_bounds__(WARPS * 32, MIN_CTAS)
tc_spmv_rows(const void* __restrict__ tiles_v, const int32_t* __restrict__ row_starts,
             const int32_t* __restrict__ tile_cols, const int32_t* __restrict__ col_flags,
             const RT* __restrict__ rhs, float* __restrict__ n_c,
             const uint8_t* __restrict__ cand, const uint8_t* __restrict__ alive,
             uint8_t* __restrict__ new_alive, uint8_t* __restrict__ mis_add,
             int nbr, int lanes) {
  using S = Shape<T, RT>;
  const int L = LANES > 0 ? LANES : lanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * S::ROWS_PER_CTA + warp / S::STRIPS;
  if (r >= nbr) return;
  const int g = lane >> 2, q = lane & 3;
  const int row = (warp % S::STRIPS) * 16 + g;   // this thread's rows: row, row + 8
  const int t_begin = row_starts[r], t_end = row_starts[r + 1];
  for (int lane0 = 0; lane0 < L; lane0 += 8) {
    const int n = lane0 + g;                    // the RHS lane of this thread's B
    float acc[S::PARTS][4] = {};                // one accumulator per part
    for (int base = t_begin; base < t_end; base += 32) {
      int col = 0;
      bool act = false;
      if (base + lane < t_end) {
        col = tile_cols[base + lane];
        act = col_flags == nullptr || col_flags[col] != 0;
      }
      unsigned live = __ballot_sync(FULL, act);
      while (live) {
        // up to TILES active tiles of this chunk; `live` is warp-uniform
        bool valid[S::TILES];
        int tile[S::TILES], tcol[S::TILES];
#pragma unroll
        for (int i = 0; i < S::TILES; ++i) {
          valid[i] = live != 0;
          const int p = valid[i] ? __ffs(live) - 1 : 0;
          live &= live - 1u;
          tile[i] = base + p;
          tcol[i] = __shfl_sync(FULL, col, p);
        }
        for (int kg = 0; kg < S::KS; kg += S::KG) {
          // issue every load of the batch before the first product
          uint32_t a_raw[S::TILES][S::KG][S::ROWS];
          RT b_raw[S::TILES][S::KG][S::ELEMS];
#pragma unroll
          for (int i = 0; i < S::TILES; ++i) {
            if (!valid[i]) continue;
#pragma unroll
            for (int j = 0; j < S::KG; ++j) {
              const int k0 = 16 * (kg + j) + S::ELEMS * q;   // first K element owned
              // one pointer per tile and step; rows g + 8 and elements e
              // are constant offsets from it when L is
              const size_t cell = (size_t)tile[i] * T + row;
              if constexpr (PACKED) {
                constexpr int W = T >= 32 ? T / 32 : 1;   // words per packed row
                const uint32_t* pa =
                    reinterpret_cast<const uint32_t*>(tiles_v) + cell * W + k0 / 32;
#pragma unroll
                for (int hh = 0; hh < S::ROWS; ++hh) a_raw[i][j][hh] = __ldg(pa + 8 * W * hh);
              } else {
                const unsigned char* pa =
                    reinterpret_cast<const unsigned char*>(tiles_v) + cell * T + k0;
#pragma unroll
                for (int hh = 0; hh < S::ROWS; ++hh)
                  a_raw[i][j][hh] = T == 8 ? __ldg(reinterpret_cast<const uint16_t*>(pa))
                                           : __ldg(reinterpret_cast<const uint32_t*>(
                                                 pa + 8 * T * hh));
              }
            }
          }
          // Large tiles are sparse: at T >= 32 the warp's 16×16 blocks
          // (its strip × one k-step) are often empty (G2 at T = 128: most
          // of them).  There the A words come first, and only the blocks
          // with an edge load their slab rows and multiply.
          unsigned busy = ~0u;
          if constexpr (T >= 32) {
            unsigned mine = 0u;
#pragma unroll
            for (int i = 0; i < S::TILES; ++i)
#pragma unroll
              for (int j = 0; j < S::KG; ++j) {
                const int k0 = 16 * (kg + j) + S::ELEMS * q;
                const uint32_t cells = PACKED ? (a_raw[i][j][0] | a_raw[i][j][1]) >> (k0 & 31) & 15u
                                              : a_raw[i][j][0] | a_raw[i][j][1];
                if (valid[i] && cells != 0u) mine |= 1u << (i * S::KG + j);
              }
            busy = __reduce_or_sync(FULL, mine);
            if (busy == 0u) continue;
          }
#pragma unroll
          for (int i = 0; i < S::TILES; ++i) {
            if (!valid[i]) continue;
#pragma unroll
            for (int j = 0; j < S::KG; ++j) {
              if (!(busy >> (i * S::KG + j) & 1u)) continue;
              const int k0 = 16 * (kg + j) + S::ELEMS * q;
              const RT* pb = rhs + ((size_t)tcol[i] * T + k0) * L + n;
#pragma unroll
              for (int e = 0; e < S::ELEMS; ++e) b_raw[i][j][e] = load_rhs(pb + e * L, n < L);
            }
          }
          // An f32 value whose low 16 bits are 0 is its own bf16 (hi), with
          // mid = lo = 0: when the whole batch is so (0/1 lanes, as the
          // engines' RHS), the mid and lo products add nothing and are
          // skipped; the sums are the same bits either way.
          bool split = false;
          if constexpr (S::PARTS == 3) {
            uint32_t low = 0u;
#pragma unroll
            for (int i = 0; i < S::TILES; ++i)
#pragma unroll
              for (int j = 0; j < S::KG; ++j)
#pragma unroll
                for (int e = 0; e < S::ELEMS; ++e)
                  if (valid[i] && (busy >> (i * S::KG + j) & 1u))
                    low |= __float_as_uint(b_raw[i][j][e]);
            split = __any_sync(FULL, (low & 0xFFFFu) != 0u);
          }
#pragma unroll
          for (int i = 0; i < S::TILES; ++i) {
            if (!valid[i]) continue;
#pragma unroll
            for (int j = 0; j < S::KG; ++j) {
              if (!(busy >> (i * S::KG + j) & 1u)) continue;
              const int k0 = 16 * (kg + j) + S::ELEMS * q;
              uint32_t a[4] = {0u, 0u, 0u, 0u};   // rows g, g+8 × elements (0,1), (2,3)
#pragma unroll
              for (int hh = 0; hh < S::ROWS; ++hh) {
                if constexpr (PACKED) {
                  const uint32_t x = a_raw[i][j][hh] >> (k0 & 31);
                  a[hh] = pair_from_bits(x);
                  if constexpr (T >= 16) a[2 + hh] = pair_from_bits(x >> 2);
                } else {
                  const uint32_t m = __vcmpne4(a_raw[i][j][hh], 0u);
                  a[hh] = pair_from_bytes(m, 0x1100);
                  if constexpr (T >= 16) a[2 + hh] = pair_from_bytes(m, 0x3322);
                }
              }
              const RT(&x)[S::ELEMS] = b_raw[i][j];
              uint32_t b0[S::PARTS], b1[S::PARTS] = {};
              if constexpr (S::PARTS == 3) {
                if (!split) {   // the high halves are the hi parts
                  b0[0] = __byte_perm(__float_as_uint(x[0]), __float_as_uint(x[1]), 0x7632);
                  if constexpr (S::ELEMS == 4)
                    b1[0] = __byte_perm(__float_as_uint(x[2]), __float_as_uint(x[3]), 0x7632);
                  mma_bf16(acc[0], a, b0[0], b1[0]);
                  continue;
                }
              }
              rhs_parts(x[0], x[1], b0);
              if constexpr (S::ELEMS == 4) rhs_parts(x[2], x[3], b1);
#pragma unroll
              for (int part = 0; part < S::PARTS; ++part)
                mma_bf16(acc[part], a, b0[part], b1[part]);
            }
          }
        }
      }
    }

    // acc: rows g (entries 0, 1) and g + 8 (entries 2, 3), lanes c, c + 1;
    // the parts add up largest first
    float sum[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      sum[v] = acc[0][v];
#pragma unroll
      for (int part = 1; part < S::PARTS; ++part) sum[v] += acc[part][v];
    }
    const int c = lane0 + 2 * q;
#pragma unroll
    for (int hh = 0; hh < S::ROWS; ++hh) {
      const size_t v = (size_t)r * T + row + 8 * hh;
      float* out = n_c + v * L + c;
      if ((L & 1) == 0 && c + 1 < L) {
        *reinterpret_cast<float2*>(out) = make_float2(sum[2 * hh], sum[2 * hh + 1]);
      } else {
        if (c < L) out[0] = sum[2 * hh];
        if (c + 1 < L) out[1] = sum[2 * hh + 1];
      }
      if constexpr (FUSED) {
        if (lane0 == 0 && q == 0) {   // sum[2hh] is lane 0 of this row
          const bool cd = cand[v] != 0;
          new_alive[v] = (alive[v] != 0 && !cd && !(sum[2 * hh] > 0.f)) ? 1 : 0;
          mis_add[v] = cd ? 1 : 0;
        }
      }
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
  constexpr int rows_per_cta = Shape<T, RT>::ROWS_PER_CTA;
  const unsigned grid = (unsigned)((a.n_block_rows + rows_per_cta - 1) / rows_per_cta);
  auto kern = a.lanes == 8 ? tc_spmv_rows<T, PACKED, FUSED, RT, 8>
                           : tc_spmv_rows<T, PACKED, FUSED, RT, 0>;
  kern<<<grid, WARPS * 32, 0, a.stream>>>(
      a.tiles, a.row_starts, a.tile_cols, a.col_flags, static_cast<const RT*>(a.rhs),
      a.n_c, a.cand, a.alive, a.new_alive, a.mis_add, a.n_block_rows, a.lanes);
  return cudaGetLastError();
}

template <int T>
cudaError_t dispatch(const Args& a, bool packed, bool fused, bool bf16) {
  if (fused) {   // the fused kernel takes an f32 RHS only
    if (bf16) return cudaErrorInvalidValue;
    return packed ? launch<T, true, true, float>(a) : launch<T, false, true, float>(a);
  }
  if (bf16)
    return packed ? launch<T, true, false, __nv_bfloat16>(a)
                  : launch<T, false, false, __nv_bfloat16>(a);
  return packed ? launch<T, true, false, float>(a) : launch<T, false, false, float>(a);
}

}  // namespace

// The whole tiled SpMV in one call.  Fused iff `cand` is non-null (then
// `alive`, `new_alive` and `mis_add` must be too, and the RHS f32).
// `col_flags` may be null (every column active).  Returns a cudaError_t: 0
// on a clean launch.
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
