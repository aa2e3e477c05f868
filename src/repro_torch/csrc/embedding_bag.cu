// Embedding bag for the DeepFM lookup and its gradient — Hopper (sm_90a)
// CUDA, with a plain C interface loaded through ctypes.  Two entries:
// `embedding_bag_launch` (the forward, below) and
// `embedding_bag_backward_launch` (the gradient with respect to the
// table, at the end of the file).
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
// Bound.  Bytes: one bag sum does one add (and one multiply) per gathered
// element, far below the card's operations-per-byte line.  The least
// traffic is each distinct table row read once plus the indices, weights
// and output.  At DeepFM's serve_bulk bags (262,144 × 39 into 33.9 M rows)
// the indices are 40.9 MB, most of the D = 1 bag's bytes.
//
// Design.  The form before this one ran a thread per output element: at
// D = 1 neighbouring lanes read indices 156 bytes apart (32 sectors per
// warp-wide load), a 40-byte D = 10 row took 10 scalar loads, and a
// thread could not have many row loads in flight.  Here a CTA owns a run
// of NB consecutive bags:
// * It stages their indices (and weights) through shared memory first.
//   When every slot of the run fits and K is odd, the (NB, K) block is one
//   contiguous piece, read with 16-byte loads by the whole CTA and stored
//   at the same offset modulo 16 bytes, so the stores are 16 bytes too.
//   Otherwise (K even, or too many slots) each warp copies whole bags into
//   rows of an odd stride, in chunks of slots.  An odd stride keeps the
//   lanes' reads of the staged slots free of bank conflicts.
// * A group of G lanes owns a bag: a lane per element, or per aligned pair
//   of elements as one float2 where D is even on an f32 table.  G is the
//   row's element count in those units, at most 32, so at D = 1 a lane
//   owns a bag (NB = 128) and at D = 10 five lanes do (NB = 25).
// * Each lane issues a chunk of row loads before it sums them (16 where a
//   lane owns a bag, 8 in a group: at serve_bulk's D = 10 fewer registers
//   and more resident lanes beat longer chunks), then writes its outputs;
//   the lanes of a CTA cover consecutive outputs, so the stores are
//   coalesced.
// Exactness: each output keeps the plain version's order and rounding,
// k = 0 .. K-1, `acc = __fadd_rn(acc, __fmul_rn(w, v))` (unweighted `+ v`,
// which equals `+ 1 · v` exactly), from 0.  Loads are issued early; the
// sum order is not changed.  When the slots come in several chunks a lane
// carries its sum through its own output element (a float written and read
// back unchanged).  Every output has one writer: no atomics.
//
// Traps.  Row offsets are 64-bit (idx · D passes 2^31 at 33.9 M rows and
// D = 64).  A float2 load needs the table 8-byte aligned; the launch checks
// the pointer and otherwise loads scalars.  K = 0 writes zeros.  Indices
// are not range-checked here; the caller keeps them in [0, V).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;    // a CTA
constexpr int kMaxGroup = 32;    // lanes per bag, at most
// row loads a lane issues before it sums them: where a lane owns a bag
// (D = 1) it needs many in flight; where a group shares one, fewer
// registers keep more lanes resident, which serve_bulk's bags favour
constexpr int kChunkBag = 16;
constexpr int kChunkGroup = 8;
constexpr int kStageWords = 5120;  // staged slots per CTA (indices; weights as many)

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int VEC>
struct Vals {
  float x[VEC];
};

// VEC consecutive elements of a row, as floats
template <typename T, int VEC>
__device__ __forceinline__ Vals<VEC> load_vec(const T* p) {
  Vals<VEC> v;
  if constexpr (VEC == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v.x[0] = q.x;
    v.x[1] = q.y;
  } else {
    v.x[0] = as_f32(p[0]);
  }
  return v;
}

// The misalignment of a word pointer, in words modulo 4.
__device__ __forceinline__ int words_past_16(const uint32_t* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// src[0 .. n) -> dst[0 .. n), by participant `id` of `cnt`: a scalar head
// up to src's first 16-byte boundary, 16-byte loads, a scalar tail.  When
// dst has src's alignment modulo 16 bytes, the body is stored 16 bytes at
// a time too.
__device__ __forceinline__ void copy_words(const uint32_t* __restrict__ src, int n,
                                           uint32_t* dst, int id, int cnt) {
  const int head = min((4 - words_past_16(src)) & 3, n);
  for (int i = id; i < head; i += cnt) dst[i] = __ldg(src + i);
  const int body = (n - head) / 4;
  const uint4* q = reinterpret_cast<const uint4*>(src + head);
  const bool aligned = words_past_16(dst + head) == 0;
  for (int i = id; i < body; i += cnt) {
    const uint4 x = __ldg(q + i);
    uint32_t* d = dst + head + 4 * i;
    if (aligned) {
      *reinterpret_cast<uint4*>(d) = x;
    } else {
      d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
    }
  }
  for (int i = head + 4 * body + id; i < n; i += cnt) dst[i] = __ldg(src + i);
}

// Slots k0 .. k0 + kc - 1 of bags b0 .. b0 + nb - 1 of a (n_bags, K) array
// of words -> buf[pad + bag · KS + k - k0]; returns pad.  When the chunk is
// every slot and KS == K the run is one contiguous piece, copied by the
// whole CTA with pad = src's misalignment (so buf + pad shares it);
// otherwise each warp copies whole bags, pad = 0.
__device__ __forceinline__ int stage_slots(const uint32_t* __restrict__ src, int64_t b0,
                                           int nb, int K, int k0, int kc, int KS,
                                           uint32_t* buf) {
  if (kc == K && KS == K) {
    const uint32_t* run = src + b0 * K;
    const int pad = words_past_16(run);
    copy_words(run, nb * K, buf + pad, threadIdx.x, blockDim.x);
    return pad;
  }
  for (int r = threadIdx.x >> 5; r < nb; r += blockDim.x >> 5)
    copy_words(src + (b0 + r) * K + k0, kc, buf + r * KS, threadIdx.x & 31, 32);
  return 0;
}

// Words of shared memory that NB bags' slots at stride KS take: room for
// a pad of up to 3, and a multiple of 4 so the weights start 16-byte aligned.
__host__ __device__ __forceinline__ int stage_words(int NB, int KS) {
  return (NB * KS + 3 + 3) & ~3;
}

template <typename T, int VEC, int CH, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
bag_groups(const T* __restrict__ table, const int32_t* __restrict__ idx,
           const float* __restrict__ w, float* __restrict__ out, int64_t n_bags,
           int K, int D, int G, int KC, int KS) {
  extern __shared__ uint4 stage_s[];   // stage_words(NB, KS) index words, then weights
  const int NB = kThreads / G;
  const int bag = threadIdx.x / G, lane = threadIdx.x - bag * G;
  const int64_t b0 = (int64_t)blockIdx.x * NB;
  const int nb = (int)min((int64_t)NB, n_bags - b0);
  const bool owner = bag < nb;
  const int units = D / VEC + (D % VEC != 0);
  uint32_t* idx_buf = reinterpret_cast<uint32_t*>(stage_s);
  uint32_t* w_buf = idx_buf + stage_words(NB, KS);
  float* out_b = out + (b0 + bag) * D;

  for (int k0 = 0; k0 == 0 || k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();   // every lane has read the previous chunk's slots
    const uint32_t* idx_s = idx_buf + bag * KS +
        stage_slots(reinterpret_cast<const uint32_t*>(idx), b0, nb, K, k0, kc, KS, idx_buf);
    const uint32_t* w_s = w_buf + bag * KS;
    if constexpr (WEIGHTED)
      w_s += stage_slots(reinterpret_cast<const uint32_t*>(w), b0, nb, K, k0, kc, KS, w_buf);
    __syncthreads();
    if (!owner) continue;
    for (int u = lane; u < units; u += G) {
      const int e = u * VEC;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = k0 == 0 ? 0.0f : out_b[e + i];
      for (int k = 0; k < kc; k += CH) {
        Vals<VEC> v[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          if (k + j < kc) {
            const int64_t row = idx_s[k + j];
            v[j] = load_vec<T, VEC>(table + row * D + e);
          }
        }
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          if (k + j >= kc) continue;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            if constexpr (WEIGHTED) {
              acc[i] = __fadd_rn(acc[i], __fmul_rn(__uint_as_float(w_s[k + j]), v[j].x[i]));
            } else {
              acc[i] = __fadd_rn(acc[i], v[j].x[i]);
            }
          }
        }
      }
      if constexpr (VEC == 2) {
        *reinterpret_cast<float2*>(out_b + e) = make_float2(acc[0], acc[1]);
      } else {
        out_b[e] = acc[0];
      }
    }
  }
}

template <typename T, int VEC, bool WEIGHTED>
cudaError_t launch_groups(const T* table, const int32_t* idx, const float* w, float* out,
                          int64_t n_bags, int K, int D, cudaStream_t s) {
  const int units = D / VEC + (D % VEC != 0);
  const int G = min(units, kMaxGroup);
  const int NB = kThreads / G;
  // the whole run of slots in one contiguous piece where K is odd and it
  // fits; else chunks of slots in rows of an odd stride
  int KC = K, KS = K;
  if (K % 2 == 0 || (int64_t)NB * K > kStageWords) {
    KC = max(1, min(K, kStageWords / NB - 1));
    KS = KC | 1;
  }
  const int64_t blocks = (n_bags + NB - 1) / NB;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = (size_t)stage_words(NB, KS) * 4 * (WEIGHTED ? 2 : 1);
  if (G == 1)
    bag_groups<T, VEC, kChunkBag, WEIGHTED><<<(unsigned)blocks, kThreads, smem, s>>>(
        table, idx, w, out, n_bags, K, D, G, KC, KS);
  else
    bag_groups<T, VEC, kChunkGroup, WEIGHTED><<<(unsigned)blocks, kThreads, smem, s>>>(
        table, idx, w, out, n_bags, K, D, G, KC, KS);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bag(const void* table, const int32_t* idx, const float* w, float* out,
                       int64_t n_bags, int K, int D, cudaStream_t s) {
  auto t = static_cast<const T*>(table);
  if constexpr (std::is_same<T, float>::value) {
    if (D % 2 == 0 && reinterpret_cast<uintptr_t>(table) % 8 == 0)
      return w != nullptr ? launch_groups<T, 2, true>(t, idx, w, out, n_bags, K, D, s)
                          : launch_groups<T, 2, false>(t, idx, w, out, n_bags, K, D, s);
  }
  return w != nullptr ? launch_groups<T, 1, true>(t, idx, w, out, n_bags, K, D, s)
                      : launch_groups<T, 1, false>(t, idx, w, out, n_bags, K, D, s);
}

// ---- backward ---------------------------------------------------------
//
// The gradient of the bag sum with respect to the table,
//
//   grad_table[r, :] = Σ_{(b, k): idx[b, k] = r} (w[b, k] · grad_out[b, :]
//                                                 + extra[b, k, :])
//
// as a dense (V, D) f32 array whose untouched rows are 0.  `extra` (B, K,
// D), optional, is the gradient of a plain gather table[idx] over the same
// slots (DeepFM's v = embed[flat]), so one launch takes both.  The
// reference has no Pallas backward: jax.grad of its gathers gives XLA's
// scatter-add of g_v[b, k] + g_s[b] per slot.
//
// Deterministic.  The slot plan (csrc/slot_sort.cu, made once per index
// array and shared by every backward over it) sorts the B·K flat slots by
// row, stably: `rows` holds the sorted rows, `order` each sorted
// position's flat slot b·K + k, `run_rows` / `starts` each run of equal
// rows.  Each slot's term is `__fadd_rn(__fmul_rn(w, g), x)` (unweighted
// `g + x`; without extra `w · g` or `g`), and each row sums its terms in
// one fixed order, which the plain version follows: the sorted positions
// are cut into segments at every multiple of kSegment (a chunk edge) and
// wherever the row changes; each segment sums its terms in slot order from
// 0, and each row sums its segments in order from 0.  The sums are
// `__fadd_rn` and the products `__fmul_rn`, so the compiler cannot
// contract them into an FMA: the plain version gives the same bits, and so
// does every call.  No atomics: every segment and every output element has
// one writer.
//
// Bound.  Bytes: the dense (V, D) write (1.356 GB at DeepFM's 33,889,984
// rows and D = 10, 0.136 GB at D = 1) dominates the 10.2 MB of int32
// indices, the 2.6 MB of grad_out and the 102 MB of extra at train_batch
// (B = 65,536, K = 39): about 0.41 ms at D = 10 on 3.35 TB/s.
//
// Design.  The dense write is the bound, so it is done once: no clear
// (a clear alone is the bound's whole write, 0.41 ms), and no touched row
// written twice.  `bag_backward_dense` writes each output element once: a
// CTA owns R
// consecutive rows (R · D ≈ kTileFloats), builds them in shared memory
// (zeros, then each run's sum at its row) and stores the tile with
// 16-byte stores.  Nothing in it waits on more than two loads: its runs
// are tile_first[t] .. tile_first[t + 1] (`bag_backward_tiles`, a binary
// search of `run_rows` per CTA edge), and their sums are ready in a compact
// `run_sum`.  A dense write that summed the runs itself took 0.92 ms at D
// = 10 against 0.43 for its zeros alone: its CTAs, few per SM for their
// shared memory, waited on chains of dependent loads under the write
// traffic.  The sums come first, in kernels with no shared memory where
// many warps hide the gathers' latency: `bag_backward_segments` takes the
// sorted positions a chunk of kSegment at a time, a lane group per chunk
// with kAhead gathers in flight per lane (0.17 ms at D = 10 with the gather
// term; a warp per chunk that gathered all its terms at once was slower,
// 0.21 ms with the lanes over (position, element) pairs and 0.62 with a
// lane per position), and sums every segment into `part` at its first
// position;
// `bag_backward_runs` adds each run's segment sums (one for most runs;
// ClickStream's 16-row field gives runs of 4,096 slots at B = 65,536, 128
// segments) into run_sum.  Segments bound a group's serial adds at
// kSegment in the first and at run / kSegment + 1 in the second.  (Summing
// the runs that lie inside one chunk straight from their slots, in a group
// per run, was slower: 0.27 ms for the run sums at D = 10 with the gather
// term, one or two gathers in flight per lane.)
constexpr int kSegment = 32;       // positions a segment spans at most
constexpr int kAhead = 8;          // loads a lane issues before its adds
constexpr int kDenseThreads = 256;
constexpr int kTileFloats = 8192;  // a dense-write CTA's rows, in floats (32 KB)
constexpr int kRunCtasPerSm = 16;  // the run sums' grid: 2,048 threads an SM

// Element e of the term of flat slot `slot` (bag slot / K), rounded as the
// plain version rounds it.
template <bool WEIGHTED, bool EXTRA>
__device__ __forceinline__ float slot_term(int64_t slot, const float* __restrict__ w,
                                           const float* __restrict__ grad_out,
                                           const float* __restrict__ extra, int K, int D,
                                           int e) {
  float t = grad_out[slot / K * D + e];
  if constexpr (WEIGHTED) t = __fmul_rn(w[slot], t);
  if constexpr (EXTRA) t = __fadd_rn(t, extra[slot * D + e]);
  return t;
}

// Every segment's sum: a lane group per chunk of kSegment positions sums
// each segment of the chunk (cut where the row changes) in slot order from
// 0 into `part` at the segment's first position.  Walking the sorted
// positions in order keeps kAhead slots' gathers in flight per lane.
template <bool WEIGHTED, bool EXTRA>
__global__ void __launch_bounds__(kThreads)
bag_backward_segments(const int32_t* __restrict__ rows, const int32_t* __restrict__ order,
                      const float* __restrict__ w, const float* __restrict__ grad_out,
                      const float* __restrict__ extra, float* __restrict__ part, int64_t n,
                      int K, int D, int G) {
  const int NB = kThreads / G;
  const int grp = threadIdx.x / G, lane = threadIdx.x - grp * G;
  const int64_t c0 = ((int64_t)blockIdx.x * NB + grp) * kSegment;
  if (grp >= NB || c0 >= n) return;
  const int64_t c1 = min(c0 + kSegment, n);
  for (int e = lane; e < D; e += G) {
    float acc = 0.0f;
    int64_t seg = c0;            // a chunk's first position opens a segment
    int32_t cur = rows[c0];
    for (int64_t j = c0; j < c1; j += kAhead) {
      int32_t r[kAhead];
      float t[kAhead];
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        const bool in = j + c < c1;
        r[c] = in ? rows[j + c] : cur;
        t[c] = in ? slot_term<WEIGHTED, EXTRA>(order[j + c], w, grad_out, extra, K, D, e) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        if (j + c >= c1) break;
        if (r[c] != cur) {       // the row changes: a new segment
          part[seg * D + e] = acc;
          acc = 0.0f;
          seg = j + c;
          cur = r[c];
        }
        acc = __fadd_rn(acc, t[c]);
      }
    }
    part[seg * D + e] = acc;
  }
}

// tile_first[t] = the first run whose row is >= t · R, for t = 0 ..
// n_tiles (n_runs at n_tiles): the runs of each dense-write CTA.
__global__ void __launch_bounds__(kThreads)
bag_backward_tiles(const int32_t* __restrict__ run_rows, const int32_t* __restrict__ n_runs_at,
                   int32_t* __restrict__ tile_first, int64_t n_tiles, int R) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > n_tiles) return;
  const int64_t key = t * R;
  int64_t lo = 0, hi = *n_runs_at;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (run_rows[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  tile_first[t] = (int32_t)lo;
}

// Each run's sum, in the plain version's order, into run_sum[k]: its
// segment sums from `part` (the first at the run's first position, then
// one at each multiple of kSegment inside the run), added in order from 0.
// A lane group per run, striding over the runs: the grid is one wave of
// CTAs, since n_runs lies on the device (875,909 runs for train_batch's
// 2,555,904 slots) and a grid sized for every slot spent most of its time
// scheduling CTAs that had no run.  Consecutive groups read nearby segment
// sums and write consecutive rows.
__global__ void __launch_bounds__(kThreads)
bag_backward_runs(const int32_t* __restrict__ starts, const int32_t* __restrict__ n_runs_at,
                  const float* __restrict__ part, float* __restrict__ run_sum, int D, int G) {
  const int NB = kThreads / G;
  const int grp = threadIdx.x / G, lane = threadIdx.x - grp * G;
  if (grp >= NB) return;
  const int64_t n_runs = *n_runs_at;
  for (int64_t k = (int64_t)blockIdx.x * NB + grp; k < n_runs; k += (int64_t)gridDim.x * NB) {
    const int64_t p0 = starts[k], p1 = starts[k + 1];
    for (int e = lane; e < D; e += G) {
      float acc = __fadd_rn(0.0f, part[p0 * D + e]);
      for (int64_t s = (p0 / kSegment + 1) * kSegment; s < p1; s += kAhead * kSegment) {
        float q[kAhead];
#pragma unroll
        for (int c = 0; c < kAhead; ++c) {
          const int64_t at = s + (int64_t)c * kSegment;
          q[c] = at < p1 ? part[at * D + e] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kAhead; ++c)
          if (s + (int64_t)c * kSegment < p1) acc = __fadd_rn(acc, q[c]);
      }
      run_sum[k * D + e] = acc;
    }
  }
}

// The dense write: a CTA builds rows r0 .. r0 + R - 1 in shared memory,
// zeros and then its runs' sums (tile_first[t] .. tile_first[t + 1]: the
// groups read run rows and sums of consecutive runs, coalesced), and
// stores the tile once with 16-byte stores.
__global__ void __launch_bounds__(kDenseThreads)
bag_backward_dense(const int32_t* __restrict__ run_rows, const int32_t* __restrict__ tile_first,
                   const float* __restrict__ run_sum, float* __restrict__ grad_table,
                   int64_t n_rows, int D, int G, int R) {
  extern __shared__ float4 tile4[];    // R · D floats: this CTA's rows
  float* tile = reinterpret_cast<float*>(tile4);
  const int64_t r0 = (int64_t)blockIdx.x * R;
  const int count = (int)min((int64_t)R, n_rows - r0) * D;   // floats this CTA writes
  const int64_t k0 = tile_first[blockIdx.x], k1 = tile_first[blockIdx.x + 1];
  for (int i = threadIdx.x; i < (count + 3) / 4; i += blockDim.x)
    tile4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const int NG = blockDim.x / G;
  const int grp = threadIdx.x / G, lane = threadIdx.x - grp * G;
  if (grp < NG) {
    for (int64_t k = k0 + grp; k < k1; k += NG) {
      float* dst = tile + (run_rows[k] - r0) * D;
      for (int e = lane; e < D; e += G) dst[e] = run_sum[k * D + e];
    }
  }
  __syncthreads();
  // R is a multiple of 4, so the tile starts 16-byte aligned in grad_table
  float4* out4 = reinterpret_cast<float4*>(grad_table + r0 * D);
  for (int i = threadIdx.x; i < count / 4; i += blockDim.x) out4[i] = tile4[i];
  for (int i = count / 4 * 4 + threadIdx.x; i < count; i += blockDim.x)
    grad_table[r0 * D + i] = tile[i];
}

// The rows one dense-write CTA owns at width D: a multiple of 4, at least 4.
int dense_rows(int D) { return max(4, kTileFloats / D / 4 * 4); }

template <bool WEIGHTED, bool EXTRA>
cudaError_t launch_sums(const int32_t* rows, const int32_t* order, const int32_t* starts,
                        const int32_t* n_runs, const float* w, const float* g, const float* x,
                        float* part, float* run_sum, int64_t n, int K, int D, cudaStream_t s) {
  const int G = min(D, kMaxGroup);
  const int NB = kThreads / G;
  const int64_t chunks = (n + kSegment - 1) / kSegment;
  const int64_t seg_blocks = (chunks + NB - 1) / NB;
  if (seg_blocks > INT32_MAX) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one wave: kRunCtasPerSm resident CTAs of kThreads on each SM, fewer
  // where the slots are few
  const int64_t run_blocks = min((int64_t)sms * kRunCtasPerSm, (n + NB - 1) / NB);
  bag_backward_segments<WEIGHTED, EXTRA><<<(unsigned)seg_blocks, kThreads, 0, s>>>(
      rows, order, w, g, x, part, n, K, D, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bag_backward_runs<<<(unsigned)run_blocks, kThreads, 0, s>>>(starts, n_runs, part, run_sum,
                                                               D, G);
  return cudaGetLastError();
}

cudaError_t launch_dense(const int32_t* run_rows, const int32_t* n_runs,
                         const float* run_sum, int32_t* tile_first, float* grad_table,
                         int64_t n_rows, int D, cudaStream_t s) {
  const int R = dense_rows(D);
  const int64_t n_tiles = (n_rows + R - 1) / R;
  if (n_tiles >= INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = (size_t)R * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bag_backward_dense, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  bag_backward_tiles<<<(unsigned)(n_tiles / kThreads + 1), kThreads, 0, s>>>(
      run_rows, n_runs, tile_first, n_tiles, R);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bag_backward_dense<<<(unsigned)n_tiles, kDenseThreads, smem, s>>>(
      run_rows, tile_first, run_sum, grad_table, n_rows, D, min(D, kMaxGroup), R);
  return cudaGetLastError();
}

template <bool WEIGHTED>
cudaError_t launch_sums_for(const int32_t* rows, const int32_t* order, const int32_t* starts,
                            const int32_t* n_runs, const float* w, const float* g,
                            const float* x, float* part, float* run_sum, int64_t n, int K,
                            int D, cudaStream_t s) {
  return x != nullptr
             ? launch_sums<WEIGHTED, true>(rows, order, starts, n_runs, w, g, x, part, run_sum,
                                           n, K, D, s)
             : launch_sums<WEIGHTED, false>(rows, order, starts, n_runs, w, g, x, part, run_sum,
                                            n, K, D, s);
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

// The slot plan of csrc/slot_sort.cu over n_slots = n_bags · bag_size
// slots (rows, order (n_slots,), run_rows (n_slots,), starts (n_slots + 1,),
// n_runs (1,), all int32), weights (n_bags, bag_size) f32 or null,
// grad_out (n_bags, dim) f32, extra (n_bags, bag_size, dim) f32 or null;
// scratch: part and run_sum (n_slots, dim) f32, tile_first (n_tiles + 1,)
// int32 with n_tiles = ceil(n_table_rows / R) and R = max(4, kTileFloats /
// dim / 4 · 4) -> grad_table (n_table_rows, dim) f32, 16-byte aligned,
// every element written once.  Four kernels on `stream`: the segment sums,
// the run sums, each dense-write CTA's runs, the dense write.
extern "C" int embedding_bag_backward_launch(const void* rows, const void* order,
                                             const void* run_rows, const void* starts,
                                             const void* n_runs, const void* weights,
                                             const void* grad_out, const void* extra, void* part,
                                             void* run_sum, void* tile_first,
                                             int64_t tile_first_len, void* grad_table,
                                             int64_t n_table_rows, int64_t n_slots,
                                             int bag_size, int dim, void* stream) {
  if (n_table_rows < 0 || n_slots < 0 || n_slots >= INT32_MAX || dim < 0 ||
      (n_slots > 0 && bag_size <= 0) || reinterpret_cast<uintptr_t>(grad_table) % 16 != 0)
    return cudaErrorInvalidValue;
  if (n_table_rows == 0 || dim == 0) return cudaSuccess;
  const int R = dense_rows(dim);
  if (tile_first_len < (n_table_rows + R - 1) / R + 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const int32_t*>(rows);
  auto o = static_cast<const int32_t*>(order);
  auto st = static_cast<const int32_t*>(starts);
  auto nr = static_cast<const int32_t*>(n_runs);
  auto w = static_cast<const float*>(weights);
  auto g = static_cast<const float*>(grad_out);
  auto x = static_cast<const float*>(extra);
  auto p = static_cast<float*>(part);
  auto rs = static_cast<float*>(run_sum);
  cudaError_t err = cudaSuccess;
  if (n_slots > 0)
    err = w != nullptr
              ? launch_sums_for<true>(r, o, st, nr, w, g, x, p, rs, n_slots, bag_size, dim, s)
              : launch_sums_for<false>(r, o, st, nr, w, g, x, p, rs, n_slots, bag_size, dim, s);
  if (err != cudaSuccess) return err;
  return launch_dense(static_cast<const int32_t*>(run_rows), nr, rs,
                      static_cast<int32_t*>(tile_first), static_cast<float*>(grad_table),
                      n_table_rows, dim, s);
}
