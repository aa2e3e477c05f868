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
//   grad_table[r, :] = Σ_{(b, k): idx[b, k] = r} w[b, k] · grad_out[b, :]
//
// as a dense (V, D) f32 array whose untouched rows are 0.  The reference
// has no Pallas backward: jax.grad of its gathers gives XLA's scatter-add.
//
// Deterministic.  The wrapper sorts the B·K flat slots by row with a
// stable sort, which keeps slot order within a row: `rows` holds the sorted
// row ids (int32), `order` each sorted position's flat slot b·K + k
// (int64).  Each row's terms w · g (one rounding each) are summed in one
// fixed order, which the plain version follows:
// * the sorted positions are cut into segments at every multiple of
//   kSegment and wherever the row changes; `bag_backward_segments` (a lane
//   group per kSegment positions) sums each segment's terms in slot order
//   from 0 into `part` at the segment's first position;
// * `bag_backward_runs` (a lane group per sorted position; the group whose
//   position opens a run of equal rows works, the others exit) sums the
//   run's segment sums in order from 0 and writes the row once.
// Each lane owns one element of the row.  The sums are `__fadd_rn` and the
// products `__fmul_rn`, so the compiler cannot contract them into an FMA:
// the plain version gives the same bits, and so does every call.  No
// atomics: every segment and every row has one writer.
//
// Bound.  Bytes: the dense (V, D) write (1.356 GB at DeepFM's 33,889,984
// rows and D = 10, 0.136 GB at D = 1) dominates the 10.2 MB of int32
// indices and the 2.6 MB of grad_out at train_batch (B = 65,536, K = 39),
// so the bound is about 0.40 ms at D = 10 on 3.35 TB/s.  The entry clears
// the array with cudaMemsetAsync, which is that bound's write; the touched
// rows are then written again (2.56 M of 33.9 M rows at most), and the
// segment sums go through `part` (B·K·D floats, written and read once at
// most).
//
// Design.  Were one group to sum a whole run, the longest run would set
// the time: ClickStream's 16-row field gives 4,096 slots a row at B =
// 65,536, that many dependent adds (2.24 ms a D = 10 launch on the H100,
// against 0.94 segmented).  Segments bound a group's serial adds at
// kSegment in the first kernel and at run / kSegment + 1 in the second.
// Each lane issues kAhead slot and gradient loads before it adds them, in
// order.
constexpr int kSegment = 32;     // positions a segment spans at most
constexpr int kAhead = 8;        // loads a lane issues before its adds

template <bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
bag_backward_segments(const int32_t* __restrict__ rows, const int64_t* __restrict__ order,
                      const float* __restrict__ w, const float* __restrict__ grad_out,
                      float* __restrict__ part, int64_t n, int K, int D, int G) {
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
        const int64_t slot = in ? order[j + c] : 0;
        const float g = in ? grad_out[slot / K * D + e] : 0.0f;
        if constexpr (WEIGHTED) {
          t[c] = __fmul_rn(in ? w[slot] : 0.0f, g);
        } else {
          t[c] = g;
        }
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

__global__ void __launch_bounds__(kThreads)
bag_backward_runs(const int32_t* __restrict__ rows, const float* __restrict__ part,
                  float* __restrict__ grad_table, int64_t n, int D, int G) {
  const int NB = kThreads / G;
  const int grp = threadIdx.x / G, lane = threadIdx.x - grp * G;
  const int64_t i = (int64_t)blockIdx.x * NB + grp;
  if (grp >= NB || i >= n) return;
  const int32_t r = rows[i];
  if (i > 0 && rows[i - 1] == r) return;     // not the first position of its run
  const int64_t next = (i / kSegment + 1) * kSegment;   // the run's second segment, if any
  for (int e = lane; e < D; e += G) {
    float acc = __fadd_rn(0.0f, part[i * D + e]);
    bool more = true;
    for (int64_t s = next; more; s += kAhead * kSegment) {
      bool in[kAhead];
      float p[kAhead];
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        const int64_t at = s + (int64_t)c * kSegment;
        in[c] = at < n && rows[at] == r;
        p[c] = in[c] ? part[at * D + e] : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        if (!in[c]) {            // rows are sorted: the run has ended
          more = false;
          break;
        }
        acc = __fadd_rn(acc, p[c]);
      }
    }
    grad_table[(int64_t)r * D + e] = acc;
  }
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

// rows (n_slots,) int32 sorted, order (n_slots,) int64 (the flat slot
// b · bag_size + k of each sorted position), weights (n_bags, bag_size) f32
// or null, grad_out (n_bags, dim) f32, part (n_slots, dim) f32 scratch ->
// grad_table (n_table_rows, dim) f32, cleared here first.  n_slots =
// n_bags · bag_size.  Two kernels on `stream`: the segment sums, then the
// runs.
extern "C" int embedding_bag_backward_launch(const void* rows, const void* order,
                                             const void* weights, const void* grad_out,
                                             void* part, void* grad_table,
                                             int64_t n_table_rows, int64_t n_slots,
                                             int bag_size, int dim, void* stream) {
  if (n_table_rows < 0 || n_slots < 0 || dim < 0 || (n_slots > 0 && bag_size <= 0))
    return cudaErrorInvalidValue;
  if (n_table_rows == 0 || dim == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(grad_table, 0, (size_t)n_table_rows * dim * sizeof(float), s);
  if (err != cudaSuccess || n_slots == 0) return err;
  const int G = min(dim, kMaxGroup);
  const int NB = kThreads / G;
  const int64_t chunks = (n_slots + kSegment - 1) / kSegment;
  const int64_t seg_blocks = (chunks + NB - 1) / NB, run_blocks = (n_slots + NB - 1) / NB;
  if (run_blocks > INT32_MAX) return cudaErrorInvalidValue;
  auto r = static_cast<const int32_t*>(rows);
  auto o = static_cast<const int64_t*>(order);
  auto w = static_cast<const float*>(weights);
  auto g = static_cast<const float*>(grad_out);
  auto p = static_cast<float*>(part);
  if (w != nullptr)
    bag_backward_segments<true><<<(unsigned)seg_blocks, kThreads, 0, s>>>(r, o, w, g, p, n_slots,
                                                                          bag_size, dim, G);
  else
    bag_backward_segments<false><<<(unsigned)seg_blocks, kThreads, 0, s>>>(r, o, w, g, p, n_slots,
                                                                           bag_size, dim, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bag_backward_runs<<<(unsigned)run_blocks, kThreads, 0, s>>>(r, p, static_cast<float*>(grad_table),
                                                              n_slots, dim, G);
  return cudaGetLastError();
}
