#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; exits non-zero, printing no
result, without them.  Imports nothing of JAX or of the reference package.
Phases, each fatal on failure:

  1. build   every csrc/*.cu with nvcc (one process per source, in parallel);
             print the build seconds, each source's register range and
             spilling kernels from -Xptxas -v, each tc_spmv,
             tc_neighbor_max, tc_spmv_bits and embedding_bag instance's
             registers and spill bytes, the count of HMMA (tensor-core)
             instructions in the built tc_spmv library by cuobjdump (the
             line says so where cuobjdump is missing; the main path's
             instance must have some), and the card's name and power limit.
  2. kernels hold each of the six MIS kernels against its plain-torch
             version on the card, on the G2 stand-in (grid2d(1044, 1044):
             1,089,936 vertices) planned four ways, {int8, bitpack} × T ∈
             {16, 128}, with seeded random frontiers, with about a third of
             the block-columns gated off and with no gating.  The dense
             fused SpMV (0/1 RHS), both neighbour maxes and both packed
             SpMVs must agree exactly; the split SpMV on a random f32 RHS
             within rtol=atol=1e-5 (the tensor cores sum in another order
             and rounding); both dense SpMVs exactly on a full-mantissa f32
             RHS that puts one nonzero term in each output (the kernel's
             three bf16 parts must give back all 24 bits).  The packed
             kernels run on the bitpack plans, the plane scan on H3's
             unsigned select keys and sign-biased resolve keys.  Then the
             four kernels a hybrid round runs (split SpMV, split packed
             SpMV, both neighbour maxes) on the compacted dense partition
             of G2 at T = 16, both storages: at threshold 30 (67,338 dense
             tiles, 783 block-rows with none) and at 68 (no real tile, only
             the 8 padding tiles), gated and ungated, exact but the split
             SpMV on randn (1e-5).
  3. paths   each path is one `Solver.solve(G2)`, with every launch count
             set to 0 just before it and read just after it:
             - `SolveOptions()`, the defaults (`hybrid="auto"`): must plan
               T = 16, bitpack, threshold 68 from the port's cost model, a
               partition of 0 dense tiles, 476,063 tail tiles and 4,461,800
               tail nnz; split SpMV once per round (on the empty dense
               partition), fused SpMV never;
             - `hybrid_threshold=30` (67,338 dense tiles): split SpMV once
               per round; with `phase1="tiled"` (bitwise frontier): plane
               scan 2×, split packed SpMV 1× per round; with
               `frontier="dense"` too: dense neighbour max 2×, split SpMV
               1×; and with telemetry: the trace of `tiled_ref`, 408,725
               tail tiles in every round;
             - `SolveOptions(hybrid="off")` (fused engine, auto-T = 16,
               bitpack, segment phase ①): fused SpMV once per round; also
               with storage="int8"; and `tiled_pallas` on int8: split SpMV
               once per round;
             - the packed-frontier path `SolveOptions(hybrid="off",
               phase1="tiled")`, which must resolve to the bitwise
               frontier: plane scan 2× per round (H3), fused packed SpMV
               once; with `engine="tiled_pallas"`: split packed SpMV once;
             - `phase1="tiled", frontier="dense"`: dense neighbour max 2×
               per round, dense fused SpMV once;
             - with `telemetry=True`, the main path and the packed
               `tiled_pallas` path: the same launches per round, and a
               round trace that passes `RoundTrace.check_invariants`, opens
               on all vertices, selects the MIS and equals, in every
               column, the trace of `tiled_ref` with the same options.
             Every other count must stay 0.  Each path converges to a valid
             MIS equal, in set and rounds, to the plain-torch `tiled_ref`
             engine's on the card with the same options and priorities, and
             all paths give the same MIS.  The kernels line's launches are
             each kernel's on the first `hybrid="off"` path that runs it
             (the full tiling phase 4 times); the hybrid paths' launches,
             on the dense partitions, print on a line of their own.
             Then the baselines: `ecl_mis(G2)` converges to a valid MIS
             equal, in set and rounds, to `Solver.solve` with
             `heuristic="ecl"` on the same priorities; `luby_mis(G2)`
             converges to a valid MIS; their rounds and sizes print beside
             TC-MIS's.  The G3 stand-in (`delaunay_like(524288)`) plans and
             solves with `SolveOptions()` and with `hybrid="off"`, to the
             same MIS; the generator, plan and partition seconds print.
             The draws (`core.prng`, the reference's jax.random threefry
             stream): the Threefry kernel bit-equal to its plain version for
             n in {1, 2, 3, 1,023, 1,089,936, 2^24 + 1}, bits and uniforms,
             under keys with high bits set, timed cold and warm beside its
             bound; then from seed 0 alone, `Solver(SolveOptions())` on G2,
             `luby_mis`, `ecl_mis` and a quarter-G2 `solve_many` member (its
             solo solve under `request_key` too) each give the reference's
             MIS: |MIS|, rounds and the SHA-256 of `np.packbits(in_mis)`
             equal to `G2_SEED_MIS`, which tests/test_torch_g2_seed.py holds
             to the reference on the CPU.  Every solve above counts its
             Threefry launches too: one `make_priorities` is 1 under H3, 1 +
             the permutation's sort rounds under H2 and ECL (3 on G2), one a
             round under Luby (`draw_launches`).
  4. timing  CUDA-event times per launch (in the order plain, kernel,
             kernel, plain; the stream kept busy while a window's calls are
             enqueued) of each kernel and its plain version, at the round-1
             inputs of the path that runs it, each call with L2 flushed
             just before it (cold: the inputs come from HBM, as the byte
             bound assumes), and the kernel's warm time besides (20 calls
             back to back, inputs that fit staying in L2); the bound from
             this run's bytes and operations (and, for the dense SpMVs, the
             slab bytes the kernel reads once per active tile); a library
             yardstick (never used by the port, timed cold) where one
             PyTorch call computes the same function; the median of 5 warm
             solves of the segment and the packed path, beside the
             profiler twin's split of a round (`Solver.profile`: phase ①,
             ②+③, the state merge; medians of 5, each profile held to the
             solve's MIS and rounds) and its set-up alone (priorities, bit
             planes, state₀), the median of 5 warm solves with telemetry on,
             and a torch.profiler breakdown of one more telemetry solve,
             set-up, solve and profile of each, with every launch of the
             port's kernels in it, the solve and the profile traced with
             `Trace(profiler=True)`: their spans (solver.*, rounds.phase*)
             must appear among the profiler's events, each printed with its
             host time and the device time of the kernels inside it; all of
             this for the default path and the threshold-30 paths (split
             and packed) too.  Then the median of 5 warm runs of
             `ecl_mis` and `luby_mis` on G2 and of the default path on G3;
             and at the threshold-30 round-1 inputs, cold, the split SpMV
             on the dense partition beside its bound and the tail's ②
             segment sum, with the ms per dense tile, per tail nnz and the
             break-even nnz they imply beside the cost model's 68 and 80
             (printed only: the planner reads the model).
  5. batched the serving mix of benchmarks/serve_throughput.py (64 requests at
             scale 1024: grid2d(128, 8), powerlaw(1024, 4), erdos_renyi(1024,
             6), erdos_renyi(512, 3), cycled, seeds 16, 17, ...) through
             `Solver.solve_many` in batches of 16, under `SolveOptions()` and
             `hybrid="off"`; then four grid2d(522, 522) members (seeds 0-3,
             1,089,936 vertices, G2's count) as one batch under
             `SolveOptions()`, `hybrid="off"` and `hybrid="off",
             phase1="tiled"`.  Each run's launches are counted (a partitioned
             batch runs the split SpMV, an unpartitioned one the fused SpMV,
             once a round; the tiled phase ① two dense maxes a round: a batch
             counts rounds per vertex, so its frontier is dense); every member
             equals, in MIS and rounds, its solo solve under its own request
             key and is a valid MIS of its plan graph.  Before the G2
             batch's solve, the six MIS kernels are held exactly against
             their plain versions on its round-1 inputs, with the column flags
             its `col_gate` zeroes.  Printed: ms per batch and per member
             (median of 5 warm), the G2 batch against four solo solves.
  6. dynamic `Solver.update` on G2 with `repair="incremental"` on the
             default, `hybrid="off"` and packed paths: `random_delta` at 0.2,
             1 and 5 % of the 2,230,900 undirected edges (k adds and k
             removes, k = int(n_und · frac) // 2, seed int(frac · 1e4), as
             benchmarks/dyngraph_bench.py draws them).  The patched tiling
             (`patch_plan`, median of 3) equals a rebuild of the mutated
             graph array for array, partition and `tail_bits` included; the
             covered pass's kernel (`tc_spmv`, or `tc_spmv_bits` on the
             packed path) is held exactly against its plain version on the
             full patched tiling; the repair launches it once plus the
             path's kernels once (twice for the plane scan) a round; the
             repaired MIS is valid; at 1 % or less it takes strictly fewer
             rounds than a cold solve of the patched plan; an empty delta
             returns the prior solution.  Printed: patch, repair and cold ms
             (medians of 3), rounds and MIS sizes.
  7. disk    G2 planned (T = 16, bitpack, hybrid auto) into a temporary
             `cache_dir` under build/ and loaded by a fresh `PlanCache`:
             status "disk", every array equal; build and load ms.
  8. deepfm  DeepFM serving at the full published CONFIG (39 fields,
             33,889,984 rows, d = 10, MLP 400-400-400), weights drawn on
             the card from seed 0, fields from `ClickStream(FIELD_VOCABS, B,
             seed=0)`:
             - the embedding-bag kernel against its plain version at
               serve_bulk shapes (B = 262,144, K = 39): D = 10 and D = 1,
               unweighted and with random weights, and a bf16 table; exact;
             - serve_p99 (B = 512) and serve_bulk forwards and one
               retrieval_cand sweep (1,000,448 candidates of field 13), each
               with every launch count set to 0 just before it: 2 bag
               launches each, every other count 0.  serve_p99 within 1e-4
               of the same weights' CPU forward; serve_bulk within 1e-5 of
               the card forward with both bags through the plain version;
               256 sampled candidates within 1e-4 of the full model scored
               one by one.  Float32 products without TF32 throughout;
             - timing: the bag kernel per launch at serve_bulk (D = 10, D =
               1, and D = 10 weighted), cold and warm as in phase 4, beside
               its plain version, its bound
               (distinct rows read once; the 32-byte-sector count beside
               it) and one torch.nn.functional.embedding_bag call; the
               median of 5 warm forwards at serve_p99 and serve_bulk and of
               5 retrieval sweeps; a profile of one serve_bulk forward.
  9. serve   the serving front door (run after phase 7, while G2 is held),
             each worker step with every launch count set to 0 just before
             it and read just after it:
             (a) the serving mix of phase 5 through one `MISService`
                 (`ServeConfig(tile_size=32, engine="fused_pallas",
                 max_batch=16, seed=0)`, benchmarks/serve_throughput.py's)
                 in a cold and a warm wave, with the segment and the tiled
                 phase ①: every response valid and equal, in MIS and
                 rounds, to a fresh `Solver.solve_many` of its window's
                 plans; warm plans all "mem"; each window launches the
                 split SpMV (partitioned group) or the fused SpMV once a
                 round per group loop, plus two dense maxes a round when
                 tiled.  Printed per wave: requests per second,
                 `service.latency_ms.batched` p50 / p99 (bucket bounds),
                 the windows;
             (b) G2 written as a SNAP edge list under build/serve/, parsed
                 alone and planned alone (a fresh cache), then submitted
                 plainly and with stream=True (plans "built", "mem"), one
                 step equal to `Solver.solve` under the request key;
                 a 1 % update (phase 6's draw) valid, incremental, in fewer
                 rounds than a cold solve of the patched plan, launching
                 the covered pass once and the path's kernels per round
                 (`ServeConfig()` and `phase1="tiled"`: plane scan twice and
                 split packed SpMV once a round); an unknown base raises
                 KeyError, a bad delta gives an error response beside a
                 valid one; `is_valid_mis_checks` on G2 equal to the single
                 checks on the solution, the empty and the full set, its ms;
             (c) `python -m repro_torch.serve_mis --once --repeat 2
                 --telemetry --trace-path ... --metrics-path ... --update
                 0:<1 % delta>` on G2's file and the three fixtures: exit 0,
                 every line valid, the update line's base_id 0, the .prom
                 file's service metrics; `python -m repro_torch.obs report`
                 exit 0 (--json: trace and rounds records), 2 on an empty
                 file, 0 on (a)'s two metrics records (their latency
                 histograms printed); the trace's ms by span per window;
             (d) `python -m repro_torch.launch.serve_graphs --engine
                 fused_pallas --requests 32 --scale 1024 --waves 3
                 --repeat-frac 0.5`: exit 0, its per-wave lines.

 10. sharded the Solver's sharded route (run after phase 7, while G2 is held):
             (a) G2 through `Solver(SolveOptions(placement="sharded"))` on a
                 one-rank NCCL group (`core.distributed.process_group`),
                 with packed and byte gathers: placement "sharded",
                 n_shards 1, the MIS and rounds of the `hybrid="off"` main
                 path, `tc_spmv` launched once a round and every other
                 kernel never (phase ① is plain torch on the shards),
                 `is_valid_mis_checks` true; (c) the median of 5 warm
                 sharded solves beside the main path's, and the round's
                 parts on round-1 inputs (warm CUDA events: the plain
                 phase ①, a packed and a byte gather, the split SpMV) with
                 their shares of the solve;
             (b) the split SpMV on each slab of a 4-way `shard_tiled(G2)`
                 (rows_per_shard × padded block-columns, not square) on the
                 round-1 RHS over the global columns: exact against its
                 plain version, the stacked outputs equal to the whole
                 tiling's;
             (d) `spmv_tiled(backend="pallas")` on G2 at L = 64 (GIN's
                 width) within 1e-5 of the plain version, its warm ms
                 beside the plain version's; `neighbor_max_tiled(backend=
                 "pallas")` exact.

 11. train   DeepFM training at the full CONFIG and train_batch (B = 65,536,
             fields and labels from `ClickStream(FIELD_VOCABS, B, seed=0)`;
             run after phase 8, float32 products without TF32):
             (a) the bag's backward kernel (`embedding_bag_backward`) bit-equal
                 to its plain version on the card, and two launches bit-equal
                 (one launch each), with the slot plan (`sort_slots`, CUB)
                 equal to the plain sort's: on train_batch's (65,536, 39)
                 slots at D = 10 and D = 1, unweighted and with random
                 weights, at D = 10 with the gather's gradient as the `extra`
                 term; every slot in the 16-row field (runs of about 160,000
                 slots); the dense write's edges: rows 0 and V - 1 touched,
                 rows 0, 1, V - 2, V - 1 untouched, every slot in one row,
                 3 CTAs' rows and 5 more (D = 10 and D = 1), no slots ((0,
                 39) and (512, 0)), no rows;
             (b) one `configs.deepfm.train_step` (`OptConfig(total_steps=
                 10000)`, the cell's) with every launch count set to 0 just
                 before it: `embedding_bag` 2, `embedding_bag_backward` 2 (D =
                 1, and D = 10 with the gather's gradient), one slot sort,
                 every MIS kernel 0; `embed`'s gradient fed by the bag's
                 Function alone (no IndexBackward0 in the graph); the loss
                 finite; every parameter and moment within 1e-6 of the same
                 step with both bags' forward and backward through their
                 plain versions;
             (c) 20 steps with tests/test_recsys.py's `OptConfig(lr=3e-3,
                 warmup_steps=5, total_steps=100, weight_decay=0.0)`: the
                 losses (finite), the median step ms split by CUDA events
                 into forward, backward and optimizer, the peak device
                 memory, a profile of one step (one slot sort, no
                 `aten::sort`, no `index_put_`); the backward kernel per
                 launch (D = 10, D = 1, D = 10 weighted, D = 10 with the
                 gather term, each sorting on its own; D = 10 with the gather
                 term and D = 1 on the step's shared plan), cold and warm,
                 beside its plain version, its bound and one
                 `torch.zeros(V, D).index_add_` (the kernels line carries D =
                 10 sorting on its own); the slot plan alone, a stable
                 `torch.sort` and a clear of a (V, 10) array;
             (d) the TrainLoop on the card at test_training_reduces_loss's
                 config (10 fields of 32, d = 8, MLP 32, B = 256), checkpoints
                 under build/train/: the mean loss of the last 10 of 60 steps
                 below the first 10's by more than 0.01; 25 straight steps
                 equal, bit for bit, 20 steps then a fresh loop that restores
                 and runs 5; a failure raised at step 13 recovered.

 12. gnn     the GNN family (run after phase 11), every `[gnn]` line beside
             the card's name and power limit:
             (a) full_graph_sm's stand-in, `erdos_renyi(2708, avg_deg=2 ·
                 10,556 / 2,708, seed 0)`, 1,433 random features: the split
                 SpMV (`tc_spmv`) against its plain version at GIN's widths,
                 L = 1,433 (layer 1, odd: the scalar stores), 64 (layers
                 2-5) and 3, at T = 16 and 32 on int8 tiles: exact on a
                 full-mantissa RHS (each lane's nonzeros on a greedy vertex
                 set no vertex has two neighbours in, so each output is one
                 term, as phase 2's), within 1e-5 on the features and randn;
                 cold and warm ms per launch beside its plain version, the
                 bound and `sparse_bsr_tensor @ rhs`.  gin-tu (5 layers,
                 d_hidden 64, n_out 7) forward on `backend="tiled"` with
                 every launch count set to 0 just before it: `tc_spmv` 5
                 (one a layer), every other 0; within 1e-4 (scale-
                 normalised) of the segment forward; its warm ms beside
                 the segment forward's; with grad enabled it raises;
             (b) minibatch_lg's stand-in, `erdos_renyi` at Reddit's 232,965
                 vertices and about its 114.6 M half-edges (host seconds
                 printed), the CSR built on the card (`NeighborSampler`,
                 seconds printed): every masked-in slot of one
                 `NeighborSampler` draw and of one cell tree (1,024 seeds,
                 fanout (15, 10): 169,984 slots, 168,960 edges) a CSR
                 neighbour of its parent;
             (c) the train step of gin-tu, pna, egnn and mace on
                 full_graph_sm (the graph of (a), segment backend),
                 minibatch_lg (a 561 MB feature table, seeds and fanout
                 slots drawn on the card each step, the cell's inline
                 sampler) and molecule (`GraphBatchStream(128, 30, 64,
                 16)`, one block-diagonal graph), `OptConfig(total_steps=
                 1000)`, each through the port's own entry point
                 (`full_graph_step`, `minibatch_step`, `molecule_step`):
                 step 0's loss and every leaf's gradient norm within 1e-4
                 (relative) of the CPU's on the same state dict and inputs
                 (minibatch_lg on the step's first 128 seeds; PNA and EGNN
                 in f64 on both, their f32 gradients being ill-
                 conditioned), the same
                 non-finite leaves; the loss finite and falling over 5
                 steps on one batch; 10 more on fresh inputs, the median ms
                 a step split by CUDA events recorded inside the step (its
                 `loss_and_grads` wrapped, the model's forward hooked) into
                 sampling (minibatch_lg's tree), forward (to the model's
                 output), backward and optimizer, the peak device memory,
                 no port kernel launched.  EGNN on molecule: its gradient
                 is not finite (the reference's sqrt at the masked
                 self-loops), so the loss must be finite, the non-finite
                 leaves those of the CPU run, and no AdamW step runs;
             (d) after minibatch_lg's cells, its tables split over the flat
                 mesh as the reference places them (`dist.lookup`), on a
                 one-rank NCCL group and a (1, 1) mesh: gin-tu's
                 `minibatch_step(mesh=, tables=)` on the blocks bit-equal
                 (loss and every leaf of the parameters, m and v) to the
                 step without a mesh on the whole tables, both under
                 torch's deterministic algorithms (float atomics put two
                 runs of one step apart on the card), the step without a
                 mesh run twice bit-equal as the control; the lookup's ms
                 (the tree and its rows read through `TableSplit.take`)
                 beside whole-table indexing, median of 5.

 13. lm      LM serving (run after phase 12), every `[lm]` line beside the
             card's name and power limit; weights from a seeded generator
             on the card, prompts `TokenStream(vocab, B, S, seed=17)`'s
             first batch, bf16 unless said; TF32 off:
             (a) the main path: qwen3-0.6b's full CONFIG (28 layers, d
                 1,024, vocab 151,936), 8 prompts of 512 tokens through
                 `lm_cells.prefill_step` into a 32,768-slot cache
                 (decode_32k's length, its batch of 128 cut to 8; 30.06 GB
                 of cache), then 32 greedy steps of `lm_cells.serve_step`,
                 with every kernel's launch count set to 0 just before and
                 read just after (all 0: the LM runs none of the port's
                 kernels); prefill ms, each step's ms by CUDA events (median
                 printed) beside its bound (the weights but `embed` and the
                 whole cache read once over HBM), cache bytes, peak memory,
                 finite logits; one more step under torch.profiler (device
                 busy share, the ten largest kernels);
             (b) prefill_32k's length: 1 x 32,768 (its batch of 32 cut to
                 1): ms and peak memory beside the work the recurrence does
                 (every KV chunk for every query, 4·S²·H·d_h·L f32 FLOPs,
                 plus the bf16 GEMMs) and its bound;
             (c) the keystone at full width in f32: teacher-forced
                 `decode_step` logits against `forward`'s, from a prefill
                 of S - 4 tokens, rtol = atol = 2e-3, on qwen3-0.6b (B = 2,
                 S = 512) and on mixtral-8x22b cut to 2 layers (capacity
                 factor 8, window 4,096, B = 1: a prefill of 4,608 tokens
                 whose last 4,096 fill the ring, then decode steps that
                 overwrite its oldest slots);
             (d) the other archs at full width: qwen1.5-0.5b whole,
                 mixtral-8x22b 2 of 56 layers, deepseek-v3-671b 4 of 61 (3
                 dense, 1 MoE, the MTP block), nemotron-4-340b 2 of 96; each
                 prefill 2 x 1,024 then 16 greedy steps: the tree holds
                 `param_count()` parameters (plus the leaves it leaves
                 out), prefill ms, the step's median ms, peak memory,
                 finite logits, each MoE layer's drop fraction, one more
                 step profiled as in (a);
             (e) card against CPU: the five SMOKE configs' weights drawn on
                 the CPU and carried to the card as numpy
                 (`lm_params_from_numpy`), prefill 2 x 12 and 4 decode
                 steps in f32: logits within 1e-5 and every MoE call's
                 expert ids equal;
             (f) `python -m repro_torch.launch.serve` at its defaults exits
                 0.

 14. lm-train LM training (run after phase 13), every `[lm-train]` line
             beside the card's name and power limit; weights from a seeded
             generator on the card, batches `TokenStream(vocab, B, S,
             seed=17)`, bf16, TF32 off, `OptConfig(total_steps=10000)`:
             (a) the main path: qwen3-0.6b's full CONFIG at train_4k's
                 length, S = 4,096, its batch of 256 cut to 16 (the largest
                 power of two that fits), remat "full": one warm-up step
                 (every leaf's gradient checked finite) and 3 timed steps
                 through `lm_cells.make_lm_train_step`, with every kernel's
                 launch count set to 0 just before and read just after (all
                 0: the LM runs none of the port's kernels); each step split
                 by CUDA events into forward (to the loss), backward and
                 optimizer, the median beside its bound (6·N·B·S bf16 FLOPs
                 at 989 T/s plus the recurrence's f32 FLOPs over every chunk,
                 4x the forward's, at 67 T/s), peak memory, finite losses;
                 one more step under torch.profiler;
             (b) remat holds: qwen3-0.6b cut to 2 layers, 1 x 4,096: step
                 0's loss and every leaf's gradient norm under remat
                 "full", "dots" and off within 1e-6 (relative), each one's
                 peak memory above the weights;
             (c) the other archs at full width where their state fits one
                 card: qwen1.5-0.5b whole at (a)'s batch, mixtral-8x22b 1 of
                 56 layers and deepseek-v3-671b cut to its 3 dense layers
                 (MLA, the MTP loss), each 1 x 4,096 with its state donated
                 (in-place AdamW); one warm-up and 2 timed steps split as in
                 (a), peak memory, finite losses and gradients, each MoE
                 layer's drop fraction; one line says what waits (deepseek's
                 MoE layers, nemotron-4-340b);
             (d) card against CPU: the five SMOKE configs' weights drawn on
                 the CPU and carried to the card as numpy, one f32 train step
                 on each side: the loss, every updated leaf and both moments
                 within rtol = atol = 1e-5, every MoE call's expert ids
                 equal;
             (e) `python -m repro_torch.launch.train` at its defaults
                 (cpu-small, 200 steps) exits 0 with its last loss below
                 ln(vocab) - 0.3.

 15. dist    the distribution layer (run after phase 14), every `[dist]` line
             beside the card's name and power limit, on a one-rank NCCL
             group (`core.distributed.process_group`, as phase 10) and a
             (1, 1) ("data", "model") `DeviceMesh`, destroyed after:
             (a) qwen3-0.6b's tree at full width, 4 of 28 layers,
                 placed by `lm_param_specs`
                 (`dist.distribute`) and gathered back (`full_tensor()`),
                 bit-equal; a placed `checkpoint.save` and
                 `reshard_checkpoint` of it, bit-equal, with the seconds;
             (b) `make_lm_train_step(mesh=)` on qwen3-0.6b whole at S =
                 4,096, 4 sequences, remat "full", over `place_lm_state`
                 (ZeRO-1 moments) and `shard_batch`: the warm-up step's
                 loss and every parameter and moment within 1e-6
                 (relative to the leaf's largest entry) of the step
                 without a mesh on the same state and batch; one timed
                 step each way (CUDA events) and their peaks; then
                 mixtral-8x22b at full width, one layer, 1 x 4,096, the
                 state donated, so that the data-parallel MoE layer
                 (`moe_ffn(dp=)`) runs: its step against the step without
                 a mesh from the same seed, the loss, drop fraction and
                 every parameter and moment (the latter's on the host)
                 within 1e-6;
             (c) DeepFM's full CONFIG `train_step(mesh=)` at B = 65,536
                 through `VocabParallelBag` on the table's row block, with
                 the launch counts set to 0 just before it: 2 bags, 2
                 backwards, 1 slot sort; every parameter and moment within
                 1e-6 of phase 11's step; the shard bag's sums, gathered
                 rows and table gradient bit-equal to its plain version;
             (d) `moe_ffn_shardmap` at deepseek-v3's MoE width (E = 256,
                 k = 8, d_expert = 2,048, D = 7,168, one shared expert,
                 bf16), 8,192 tokens at capacity factor 8 (none dropped,
                 checked) against `moe_ffn`: expert ids, kept slots and
                 slots equal, the output within 2^-8 of max |y| (one bf16
                 step at the output's scale), ms of each.
 16. tp      the 'model' axis (run after phase 15), every `[tp]` line beside
             the card's name and power limit, on a new one-rank NCCL group
             and a (1, 1) ("data", "model") `DeviceMesh`, destroyed after.
             Every run goes through the code a 'model' axis larger than 1
             runs (every collective on the one-rank groups) and is held
             bit-equal to the step without a mesh:
             (a) qwen3-0.6b whole, 4 x 4,096, `place_lm_state(fsdp=True)`
                 and `make_lm_train_step(mesh=, fsdp=True)`: a warm-up and
                 a timed step, the loss and every parameter and moment
                 after each;
             (b) deepseek-v3's 3 dense layers with the MTP block at full
                 width, 1 x 4,096, the state donated: one step each way
                 from the same seed, every leaf by an exact fingerprint
                 (the state does not fit twice);
             (c) qwen3-0.6b's `prefill_step(mesh=)` of 8 x 512 into a
                 32,768-slot cache placed by `cache_specs`, then 8 greedy
                 `serve_step(mesh=)` calls: every step's logits, ms per
                 step beside the steps without a mesh;
             (d) DeepFM's full CONFIG over (data, model): `train_step(mesh=)`
                 at B = 65,536 (2 bag launches, 2 backwards, 1 slot sort,
                 counted from 0 just before it), serve_bulk and
                 retrieval_cand (2 bag launches each);
             (e) the query-head path: qwen3-0.6b full width cut to 4
                 layers, its KV heads read as not splitting (`Layouts`), so
                 each rank computes its query heads and the KV heads they
                 read off wk / wv gathered whole (a prefill: all, into a
                 whole cache): a train step at 2 x 4,096, a prefill of 2 x
                 512 and 4 greedy steps.
             Each LM line names the layout its step took (`Layouts`: the
             residual stream sequence-parallel between the layers where
             S % 8 == 0, as the reference's; the attention's and FFN's
             split).  A `[bench]` line then writes the phase's step times
             as a stamped bench document (`obs.bench.write_bench`) under a
             temporary directory and prints the stamp read on the card:
             device_name, power_limit, torch_version, cuda_version.
 17. products ogb_products' full-graph step with the graph split (run after
             phase 16), every `[products]` line beside the card's name and
             power limit, on a new one-rank NCCL group and a (1, 1)
             ("data", "model") `DeviceMesh`, destroyed after.  For each of
             gin-tu, pna, egnn and mace at the shape's widths (d_feat 100,
             47 classes) and average degree, the vertices cut to
             `PRODUCTS_CUTS` (gin-tu a quarter: 612,257 vertices, about
             30.9 M half-edges; pna 1/64, egnn 1/32, mace 1/128; pna and
             egnn checked in f64, GNN_CPU_F64, as phase 12 compares them:
             their f32 gradients are ill-conditioned, two f32 runs summing
             in other orders lie up to 6e-5 apart): the stand-in (`products_inputs`), split by
             `dist.graph.split_graph`; the step without a mesh from one
             state, and from it again on the graph relabelled two ways
             (vertices and edges in other orders), whose largest
             difference from the first is its run-to-run spread
             (`index_add_` sums with float atomics in an order that changes
             from run to run; the split sums over vertices and edges in
             other orders too); then `full_graph_step(split=)` from that state over
             `place_gnn_state`, held to the first within twice the spread
             (no less than twice the dtype's epsilon) in the loss, the
             gradient norm and every leaf of m and sqrt(v) (relative in
             L2); for pna and egnn then the f32 witness on the same graph
             (printed, not held): the f32 step without a mesh in the three
             orders and the f32 placed step, each one's distance from the
             f64 step without a mesh; then 3 more placed steps in f32,
             median ms split by CUDA events into forward, backward and
             optimizer, peak GiB, no port kernel launched (ogb_products
             runs none).
 19. dryrun  the dry run held against the card (run after phase 14),
             every `[dryrun]` line beside the card's name and power limit;
             each prediction is `launch.dryrun.count_pass` of a cell's
             production program on fake CUDA tensors as rank 0 of a fake
             one-rank group (nothing allocated), each measurement a step
             an earlier phase ran, its peak taken as the dry run counts it
             (its arguments' bytes plus the most it allocated above what
             was live when the peak was reset):
             (a) qwen3-0.6b train_4k at phase 14's batch (16 x 4,096) on a
                 (1, 1) mesh against phase 14 (a)'s steps: predicted peak
                 within 10 % + 256 MiB of the measured; the counted FLOPs
                 beside `lm_train_flops`; no kernel record;
             (b) DeepFM train_batch on a (1, 1) mesh against phase 11
                 (b)'s step: the peak within 10 % + 256 MiB; the fake
                 branches' launches (2 bags, 2 backwards, 1 sort) those of
                 the card's step;
             (c) one round of the sharded MIS (`core.distributed.mis_round`)
                 on G2 (T = 16, int8, one slab) on a one-rank NCCL group,
                 the launch counts set to 0 just before it: tc_spmv once,
                 every other kernel 0; its outputs' shapes and dtypes those
                 of the dry run's fake round (`configs.tcmis.round_step`) on
                 the same shapes; `tc_spmv` launched and through its fake
                 branch on the same inputs, the same shape and dtype; both
                 peaks printed.  The group is destroyed after.
 18. lint    the hot-path lint held against the card (run after phase 9,
             while G2 and phase 3's plans are held), every `[lint]` line
             beside the card's name and power limit:
             (a) `repro_torch.lint.main(["src/repro_torch"])` in the
                 process: exit 0; the hot set's size, its seeds and the
                 suppressions by rule;
             (b) a warm `Solver.solve(G2)` (one untimed solve before it) on
                 three paths, `SolveOptions()` (hybrid auto), `hybrid="off"`
                 (fused_pallas) and the packed `hybrid="off",
                 phase1="tiled"`, then the main path with telemetry and
                 through `Solver.profile` (the profiler twin), each under
                 `torch.cuda.set_sync_debug_mode("warn")` in
                 `warnings.catch_warnings(record=True)` (simplefilter
                 "always"; the mode back to 0 in a `finally`), every launch
                 count set to 0 just before: each sync the card reports is
                 sorted by the port's innermost file:line
                 (`repro_torch.lint.audit`) into sanctioned (hot set, a
                 line the lint suppresses), outside (not hot: set-up,
                 epilogue, the front door) or unaccounted (hot set, a line
                 the lint neither flags nor suppresses), which fails the
                 phase.  Printed per path: syncs a solve and a round
                 against its rounds, each site with its count, group and
                 whether the card reported it, the lint names it, or both
                 (an explicit `torch.cuda.synchronize()` does not warn
                 under the mode; RPT005 / RPT010 name it all the same).

The last three lines of standard output are, in order: the kernels JSON
object (one record per kernel), the card's name and power limit as
nvidia-smi gives them, and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

G2_SHAPE = (1044, 1044)          # roadNet-PA stand-in, full size
G3_N = 524_288                   # delaunay_n19 stand-in, full size
# G2 at T = 16: threshold -> (dense tiles, tail tiles, tail nnz, block-rows
# with no dense tile), of 476,063 tiles, 4,461,800 half-edges, 68,121 rows
G2_PARTITIONS = {30: (67_338, 408_725, 2_441_660, 783), 68: (0, 476_063, 4_461_800, 68_121)}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM 32-bit rate outside the tensor cores
CSRC = "src/repro_torch/csrc/"
# G2's MIS from seed 0 alone as the reference computes it (JAX 0.9.0's
# threefry stream; tests/test_torch_g2_seed.py holds these to the
# reference): path -> (|MIS|, rounds, SHA-256 of np.packbits(in_mis)).
# "member" is grid2d(522, 522, seed=0) under its request key.
G2_SEED_MIS = {
    "solve": (392658, 5, "33c3a9540c9dec76aefe6bf1a9af2de2788603b259326f383355c74962bc1ced"),
    "luby": (382739, 5, "f771c6596f38021bac4ab29588760755393d008eaab52d42d3d61c84d32e6b4d"),
    "ecl": (393823, 5, "28b8b25e603eb2fd4964c21463bc09cc1ee526da6d1e0bf19f74dd23c5a3948a"),
    "member": (98347, 6, "452d3eda39a53db5e14208e47fb9207432ba163abdb274beaf706d8f68d588ec"),
}
# the Threefry kernel against its plain version: sizes and key words (the
# high bit of each word set in some)
DRAW_SIZES = (1, 2, 3, 1023, 1_089_936, (1 << 24) + 1)
DRAW_KEYS = ((0, 0), (0x80000000, 0xFFFFFFFF), (0xDEADBEEF, 0x8BADF00D))
# the new modes and the start counter against the plain version (phase 3
# (c)): sizes, starts crossing and past the counter's high word; the
# normals within DRAW_NORMAL_ULPS, every other draw bit for bit
DRAW_MODE_SIZES = (1, 1023, (1 << 24) + 1)
DRAW_STARTS = (0, (1 << 32) - 5, 3 << 32)
DRAW_RANGES = ((0.0, 1.0), (-3.5, 2.25))
DRAW_NORMAL_ULPS = 4
DRAW_TIMED_NORMALS = 1 << 26
# From seed 0 alone, the reference's first elements of every normal leaf
# of qwen3-0.6b's `init_lm(key(0))` (a stacked leaf's layers 0 and 27),
# DeepFM's `deepfm_init(key(0), CONFIG)` and GIN's init at minibatch_lg's
# widths (602 -> 41): leaf -> (bits' kind, the leaf's scale, the first 8
# flat elements' bf16 / f32 bits as ints; MLP weights as the reference's
# (in, out)).  Element j of a leaf depends on its key and j alone, so
# tests/test_torch_init_seed.py computes these with the reference at tiny
# widths of each structure and holds them here; phase 3 (d) holds the
# card's full-width inits to them within one bf16 / INIT_F32_ULPS f32 ulps.
INIT_F32_ULPS = 4
INIT_SEED_LEAVES = {
    'qwen3-0.6b': {
        'dense_layers/attn/wk@0': ('bf16', 0.02, [15521, -17201, -17244, -17944, -17362, -17275, 15549, 15641]),
        'dense_layers/attn/wk@27': ('bf16', 0.02, [15544, 15490, -17129, 15634, 15468, 15264, -17231, -17249]),
        'dense_layers/attn/wo@0': ('bf16', 0.002672612419124244, [-17903, -17534, 15042, 15214, 15222, 15160, 15062, -18031]),
        'dense_layers/attn/wo@27': ('bf16', 0.002672612419124244, [-18138, 15042, -17486, 15308, -17721, 15217, -17524, -17922]),
        'dense_layers/attn/wq@0': ('bf16', 0.02, [-17862, 15064, -17065, 15256, -17669, 15405, 15316, -18159]),
        'dense_layers/attn/wq@27': ('bf16', 0.02, [-17514, 15476, -17208, -17368, 15463, -17266, -17249, -17147]),
        'dense_layers/attn/wv@0': ('bf16', 0.02, [15620, 15141, -17486, -17196, 15561, -17926, 15457, -17472]),
        'dense_layers/attn/wv@27': ('bf16', 0.02, [15361, -17235, -17202, -17111, -17244, -17137, 15072, 15429]),
        'dense_layers/ffn/w1@0': ('bf16', 0.02, [-17824, 15375, -17149, -17265, 15602, -17227, 15528, 14974]),
        'dense_layers/ffn/w1@27': ('bf16', 0.02, [-17204, 15127, 15431, 15321, 15462, 15296, 15258, -17402]),
        'dense_layers/ffn/w2@0': ('bf16', 0.002672612419124244, [14749, 14877, 15244, 15152, -17629, 15080, -17562, -17785]),
        'dense_layers/ffn/w2@27': ('bf16', 0.002672612419124244, [14919, 15122, -17455, 15134, -17734, -17891, -17678, -17934]),
        'dense_layers/ffn/w3@0': ('bf16', 0.02, [15639, -17400, -17306, -17314, -17695, -17237, -17231, 15501]),
        'dense_layers/ffn/w3@27': ('bf16', 0.02, [-17458, -17599, 15527, -17287, 15529, -17415, -17382, 15419]),
        'embed': ('bf16', 0.02, [15524, -17260, -17291, -17216, -17265, 15425, 15469, -17240]),
        'head': ('bf16', 0.02, [-17080, -17113, 15239, -17432, -17286, -17215, -17220, 15299]),
    },
    'deepfm': {
        'embed': ('f32', 0.01, [1009024873, -1139507575, -1141561028, -1136661840, -1139884505, 1002500946, 1005402021, -1138227020]),
        'linear': ('f32', 0.01, [-1127737854, -1129921712, 990295193, -1150831647, -1141264637, -1136584693, -1136910382, 994230309]),
        'mlp/0': ('f32', 0.07161148740394328, [-1109806086, -1115921320, -1119490244, -1148176956, -1140809418, 1033080204, -1116081139, -1115363224]),
        'mlp/1': ('f32', 0.07071067811865475, [1027567774, -1125713625, 1027837152, -1120725658, -1107990635, 1032115221, -1140590981, -1106425792]),
        'mlp/2': ('f32', 0.07071067811865475, [1027390255, -1117194562, -1145184842, -1132987963, -1136322601, 1023563028, -1156748923, 1032948679]),
        'mlp/3': ('f32', 0.07071067811865475, [1009936810, 1036398021, -1114044023, -1131410986, 1023778195, 1046693470, 1037269884, 1029129302]),
    },
    'gin-tu': {
        'layers/0/mlp/0': ('f32', 0.0576390417704235, [-1123568873, 1027396930, -1133172370, 1034471932, -1124641765, -1110573732, -1119026708, 1011238148]),
        'layers/0/mlp/1': ('f32', 0.1767766952966369, [-1100767051, -1114544778, -1102381852, 1042219228, -1105461621, 1031464718, 1042955527, -1129239532]),
        'layers/1/mlp/0': ('f32', 0.1767766952966369, [1024460349, -1106548036, -1100752159, -1114331695, -1103754451, 1028619395, 1043597722, 1035233258]),
        'layers/1/mlp/1': ('f32', 0.1767766952966369, [-1099839966, -1115731860, 1029717994, -1103810358, -1134529285, -1104886282, 1027679578, 1050943733]),
        'layers/2/mlp/0': ('f32', 0.1767766952966369, [-1098491309, -1105476931, -1108062644, -1137574217, -1130445891, 1043734268, -1105575562, -1104934013]),
        'layers/2/mlp/1': ('f32', 0.1767766952966369, [1039092933, -1114612808, 1039429654, -1109402945, -1097244484, 1042680089, -1130040295, -1095722417]),
        'layers/3/mlp/0': ('f32', 0.1767766952966369, [1050163355, 1039209707, -1122781957, 1041798250, 1048972554, 1051287413, 1041113820, -1098721007]),
        'layers/3/mlp/1': ('f32', 0.1767766952966369, [1044044455, 1020864047, -1116793881, 1036744767, 1036719071, 1042117406, 1042207883, 1035649019]),
        'layers/4/mlp/0': ('f32', 0.1767766952966369, [1042067181, -1100555179, -1120818861, -1097224311, -1112509608, 1039221690, -1126383679, -1101696461]),
        'layers/4/mlp/1': ('f32', 0.1767766952966369, [1028215862, 1038093053, -1101180353, 1043969733, -1104176286, -1101772240, -1106574536, 1037649479]),
        'head/0': ('f32', 0.1767766952966369, [1000931521, -1110124363, -1100741397, -1135863437, -1098098044, -1122370245, -1105894732, -1096845038]),
    },
}
# name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "tc_spmv_fused": (CSRC + "tc_spmv.cu", "src/repro/kernels/tc_spmv.py:137"),
    "tc_spmv": (CSRC + "tc_spmv.cu", "src/repro/kernels/tc_spmv.py:54"),
    "tc_neighbor_max": (CSRC + "tc_neighbor_max.cu",
                        "src/repro/kernels/tc_neighbor_max.py:43"),
    "tc_spmv_fused_bits": (CSRC + "tc_spmv_bits.cu", "src/repro/kernels/tc_spmv.py:321"),
    "tc_spmv_bits": (CSRC + "tc_spmv_bits.cu", "src/repro/kernels/tc_spmv.py:246"),
    "tc_neighbor_max_bits": (CSRC + "tc_neighbor_max.cu",
                             "src/repro/kernels/tc_neighbor_max.py:96"),
    "embedding_bag": (CSRC + "embedding_bag.cu", "src/repro/kernels/embedding_bag.py:24"),
    # no Pallas body: the reference's table gradient is jax.grad of the
    # gathers in deepfm_loss, XLA's scatter-add
    "embedding_bag_backward": (CSRC + "embedding_bag.cu", "src/repro/models/deepfm.py:92"),
    # no Pallas body: the reference draws through jax.random, whose bits
    # XLA's lowering of threefry2x32_p computes (first at Eq. 1's uniform)
    "threefry": (CSRC + "threefry.cu", "src/repro/core/heuristics.py:62"),
}
# retrieval_cand scores the items of the first categorical field (10,000,000
# rows); the 13 numeric fields hold 64 values each
ITEM_FIELD = 13
RETRIEVAL_CHECKED = 256     # candidates re-scored one by one with the full model


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def wrappers() -> dict:
    """Kernel name -> its wrapper (which carries the `.launches` count)."""
    from repro_torch.hopper import embedding_bag as E
    from repro_torch.hopper import tc_neighbor_max as N
    from repro_torch.hopper import tc_spmv as S
    from repro_torch.hopper import threefry as F

    return {
        "tc_spmv_fused": S.tc_spmv_fused, "tc_spmv": S.tc_spmv,
        "tc_neighbor_max": N.tc_neighbor_max,
        "tc_spmv_fused_bits": S.tc_spmv_fused_bits, "tc_spmv_bits": S.tc_spmv_bits,
        "tc_neighbor_max_bits": N.tc_neighbor_max_bits,
        "embedding_bag": E.embedding_bag, "embedding_bag_backward": E.embedding_bag_backward,
        "threefry": F.threefry_bits,
    }


def draw_launches(heuristic: str, n: int) -> int:
    """The Threefry launches of one `make_priorities` over n vertices:
    Eq. 1's uniforms (all but H1), the permutation's sort keys (all but
    H3, one launch a sort round); none over no vertex."""
    from repro_torch.core.prng import permutation_rounds

    if n == 0:
        return 0
    return int(heuristic != "h1") + (0 if heuristic == "h3" else permutation_rounds(n))


def mis_digest(in_mis) -> tuple:
    """(|MIS|, SHA-256 of np.packbits(in_mis)) of a host or device vector."""
    import hashlib

    import numpy as np
    import torch

    if isinstance(in_mis, torch.Tensor):
        in_mis = in_mis.cpu().numpy()
    x = np.asarray(in_mis).astype(bool)
    return int(x.sum()), hashlib.sha256(np.packbits(x).tobytes()).hexdigest()


# cycles the stream spins before a timed window: ~50 ms at the H100's
# clock, longer than the host takes to enqueue the window's calls
QUEUE_AHEAD_CYCLES = 100_000_000
# bytes written between cold calls: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20


def time_ms(fn, reps: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Mean ms per call from CUDA events, after warm-up.  The stream is
    kept busy while the calls are enqueued, so a kernel shorter than its
    wrapper's host overhead is timed on the card, not on the host.

    Warm: one window over `reps` calls back to back, so inputs that fit in
    L2 stay there from one call to the next.  Cold: each call in a window
    of its own, with L2_FLUSH_BYTES written just before it, so each call
    reads its inputs from HBM, as the byte bounds assume."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls_per_window = 1 if cold else reps
    windows = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(reps // calls_per_window)]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold else None
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    for start, end in windows:
        if cold:
            flush.zero_()
        start.record()
        for _ in range(calls_per_window):
            fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in windows) / reps


# tc_spmv_rows<T, PACKED, FUSED, RT, LANES> as the Itanium ABI mangles it
SPMV_INSTANCE = re.compile(
    r"tc_spmv_rowsILi(\d+)ELb([01])ELb([01])E(f|13__nv_bfloat16)Li(\d+)E")
MAIN_SPMV = "T=16 bitpack fused f32 L=8"     # the main path's instance
# nbr_max_{tile,slot}_lanes<T, Kind, PACKED> as the Itanium ABI mangles it
NBR_MAX_INSTANCE = re.compile(r"nbr_max_(tile|slot)_lanesILi(\d+)EL.*?KindE(\d)ELb([01])E")
# spmv_bits_tile_lanes<T, FUSED> and spmv_bits_rows<T, FUSED>
SPMV_BITS_INSTANCE = re.compile(r"spmv_bits_(tile_lanes|rows)ILi(\d+)E(?:Lb([01])E)?")
# bag_groups<T, VEC, CH, WEIGHTED>, bag_backward_segments<WEIGHTED, EXTRA>,
# bag_backward_runs, bag_backward_tiles and bag_backward_dense
BAG_INSTANCE = re.compile(r"bag_groupsI(f|13__nv_bfloat16)Li(\d)ELi(\d+)ELb([01])E")
BAG_BACKWARD_INSTANCE = re.compile(
    r"bag_backward_(segments|runs|dense|tiles)(?:ILb([01])ELb([01])E)?")


def ptxas_kernels(log: str) -> dict:
    """-Xptxas -v output -> {mangled kernel: {registers, spill stores and
    loads in bytes}}."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def spmv_label(mangled: str) -> str:
    m = SPMV_INSTANCE.search(mangled)
    if m is None:
        return mangled
    T, packed, fused, rt, lanes = m.groups()
    return (f"T={T} {'bitpack' if packed == '1' else 'int8'} "
            f"{'fused' if fused == '1' else 'split'} {'f32' if rt == 'f' else 'bf16'} "
            f"L={lanes if lanes != '0' else 'any'}")


def nbr_max_label(mangled: str) -> str:
    m = NBR_MAX_INSTANCE.search(mangled)
    if m is None:
        return mangled
    lanes, T, kind, packed = m.groups()
    return (f"T={T} {('dense', 'select', 'resolve')[int(kind)]} "
            f"{'bitpack' if packed == '1' else 'int8'} (a lane per {lanes})")


def spmv_bits_label(mangled: str) -> str:
    m = SPMV_BITS_INSTANCE.search(mangled)
    if m is None:
        return mangled
    form, T, fused = m.groups()
    how = "a lane per tile" if form == "tile_lanes" else "a thread per row"
    return f"T={T} {'fused' if fused == '1' else 'split'} ({how})"


def bag_label(mangled: str) -> str:
    m = BAG_BACKWARD_INSTANCE.search(mangled)
    if m is not None:
        kind, weighted, extra = m.groups()
        return f"backward {kind}" + ("" if weighted is None else
                                     (" weighted" if weighted == "1" else " unweighted")
                                     + (" with the gather term" if extra == "1" else ""))
    m = BAG_INSTANCE.search(mangled)
    if m is None:
        return mangled
    dtype, vec, chunk, weighted = m.groups()
    return (f"{'f32' if dtype == 'f' else 'bf16'} {'pairs' if vec == '2' else 'scalars'} "
            f"chunk {chunk} {'weighted' if weighted == '1' else 'unweighted'}")


# source -> the label of each of its kernel instances in the build phase
INSTANCE_LABELS = {"tc_spmv": spmv_label, "tc_neighbor_max": nbr_max_label,
                   "tc_spmv_bits": spmv_bits_label, "embedding_bag": bag_label}


def hmma_line(build) -> str:
    """HMMA instructions in the built tc_spmv library, by cuobjdump."""
    import shutil

    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return "tc_spmv SASS: cuobjdump not found beside nvcc or on PATH, HMMA not counted"
    sass = subprocess.run([tool, "-sass", str(build.library_path("tc_spmv"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    per_fn, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = spmv_label(m.group(1))
            per_fn[cur] = 0
        elif cur is not None and "HMMA" in ln:
            per_fn[cur] += 1
    check(per_fn.get(MAIN_SPMV, 0) > 0, f"no HMMA in the {MAIN_SPMV} tc_spmv instance")
    return (f"tc_spmv SASS: {sum(per_fn.values())} HMMA in {sum(v > 0 for v in per_fn.values())}"
            f" of {len(per_fn)} kernels ({MAIN_SPMV}: {per_fn[MAIN_SPMV]})")


def phase_build() -> None:
    from repro_torch.hopper import build

    t0 = time.perf_counter()
    took = build.build_all()
    print(f"[build] {json.dumps({k: round(v, 3) for k, v in took.items()})} "
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    for name in took:
        kernels = ptxas_kernels(build.build_log(name))
        spilling = [k for k, v in kernels.items() if v.get("spill_stores") or v.get("spill_loads")]
        regs = sorted(v.get("registers", 0) for v in kernels.values())
        print(f"[build] {name}: {len(kernels)} kernels, registers "
              f"{regs[0] if regs else '?'}..{regs[-1] if regs else '?'}, "
              f"{len(spilling)} spilling", flush=True)
        label = INSTANCE_LABELS.get(name)
        if label is not None:
            check(len(kernels) > 0, f"no -Xptxas -v report for {name}")
            for mangled, v in sorted(kernels.items(), key=lambda kv: label(kv[0])):
                print(f"[build]   {name} {label(mangled)}: {v.get('registers')} "
                      f"registers, {v.get('spill_stores')} B spill stores, "
                      f"{v.get('spill_loads')} B spill loads", flush=True)
    print(f"[build] {hmma_line(build)}", flush=True)
    print(f"[card] {card_line()}", flush=True)


def random_frontier(tiled, gen):
    """Seeded cand/alive on the padded vertex axis, and column flags with
    about a third of the block-columns gated off."""
    import torch
    from repro_torch.core.engine import block_col_flags

    n = tiled.n_padded
    dev = tiled.device
    alive = torch.rand(n, generator=gen, device=dev) < 0.7
    cand = alive & (torch.rand(n, generator=gen, device=dev) < 0.2)
    gate = (torch.rand(tiled.n_block_cols, generator=gen, device=dev) >= 1 / 3)
    flags = block_col_flags(alive, tiled.tile_size) * gate.to(torch.int32)
    return cand, alive, flags.contiguous()


def max_err(a, b) -> float:
    """max |a - b| over integer (or bool, or word) or float outputs."""
    if not a.numel():
        return 0.0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return float((a.long() - b.long()).abs().max())


def exact(errs: dict, name: str, got, want, what: str) -> None:
    """Hold outputs equal, bit for bit, and record the max |err| (0)."""
    import torch

    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
              f"{name} kernel != plain (output {i}, {what}): max |err| {max_err(a, b)}")
        errs[name] = max(errs.get(name, 0.0), max_err(a, b))


def full_mantissa_rhs(tiled, member, gen, what: str):
    """An RHS on which every output of the dense SpMV is a single term:
    lane l holds ±(1 + k·2^-23)·2^e (k over all 23-bit mantissas, e in
    [-20, 20]) on the vertices of `member`'s column l ((n_padded, lanes)
    bool), and 0 elsewhere.  No vertex may have two members of a lane as
    neighbours; checked here with the plain SpMV of the indicator."""
    import torch
    from repro_torch.hopper import tc_spmv as K

    check(int(K.tc_spmv_plain(tiled, member.float()).max()) == 1,
          f"full-mantissa RHS ({what}): some row has two nonzero terms on a lane")
    shape = tuple(member.shape)
    k = torch.randint(0, 1 << 23, shape, generator=gen, device="cuda")
    k[::5] = (1 << 23) - 1          # rounds up to the next power of two in bf16
    e = torch.randint(-20, 21, shape, generator=gen, device="cuda")
    sign = torch.randint(0, 2, shape, generator=gen, device="cuda") * 2 - 1
    x = torch.ldexp(1 + k.double() * 2.0 ** -23, e.double()) * sign
    return torch.where(member, x, 0.0).float()


def g2_lattice_member(tiled, lanes: int):
    """G2's full-mantissa lanes: lane l on the lattice vertices (i, j) with
    (i mod 3, j mod 3) = (l // 3, l % 3).  Two such vertices lie 3 or more
    apart in i or j, and an edge (lattice or diagonal shortcut) moves at
    most 1 in each, so no vertex has two of them as neighbours."""
    import torch

    n_rows, n_cols = G2_SHAPE
    v = torch.arange(tiled.n_padded, device="cuda")
    cls = (v // n_cols % 3) * 3 + v % n_cols % 3
    return (cls[:, None] == torch.arange(lanes, device="cuda")) & (v < n_rows * n_cols)[:, None]


def phase_kernels(g2) -> dict:
    """Kernel vs plain on the four G2 plans; returns max |err| per kernel."""
    import torch
    from repro_torch.api import Plan
    from repro_torch.core import prng
    from repro_torch.core.heuristics import make_priorities
    from repro_torch.core.tiling import pack_frontier_words, pack_priority_planes
    from repro_torch.hopper import tc_neighbor_max as N
    from repro_torch.hopper import tc_spmv as K

    errs = {}
    for T in (16, 128):
        pri = make_priorities("h3", prng.key(T), g2.n_nodes, g2.degrees())
        for storage in ("int8", "bitpack"):
            t0 = time.perf_counter()
            plan = Plan.build(g2, tile_size=T, storage=storage)
            tiled = plan.tiled
            gen = torch.Generator(device="cuda").manual_seed(T + 1)
            cand, alive, flags = random_frontier(tiled, gen)
            what = f"T={T}, {storage}"
            lanes = 8
            rhs01 = (torch.rand((tiled.n_padded, lanes), generator=gen,
                                device="cuda") < 0.5).float()
            rhs01[:, 0] = cand.float()
            rhs01[:, 1] = alive.float()
            rhs = torch.randn((tiled.n_padded, lanes), generator=gen, device="cuda")
            full = full_mantissa_rhs(tiled, g2_lattice_member(tiled, lanes), gen, what)
            err = 0.0
            for fl in (flags, None):
                how = f"{what}, flags {'on' if fl is not None else 'off'}"
                exact(errs, "tc_spmv_fused",
                      K.tc_spmv_fused(tiled, rhs01, cand, alive, col_flags=fl),
                      K.tc_spmv_fused_plain(tiled, rhs01, cand, alive, col_flags=fl), how)
                got = K.tc_spmv(tiled, rhs, col_flags=fl)
                want = K.tc_spmv_plain(tiled, rhs, col_flags=fl)
                torch.cuda.synchronize()
                err = max(err, float((got - want).abs().max()))
                check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                      f"split kernel != plain ({how}): max |err| {err}")
                how += ", full-mantissa RHS"
                exact(errs, "tc_spmv_fused",
                      K.tc_spmv_fused(tiled, full, cand, alive, col_flags=fl),
                      K.tc_spmv_fused_plain(tiled, full, cand, alive, col_flags=fl), how)
                exact(errs, "tc_spmv", K.tc_spmv(tiled, full, col_flags=fl),
                      K.tc_spmv_plain(tiled, full, col_flags=fl), how)
            errs["tc_spmv"] = max(errs.get("tc_spmv", 0.0), err)

            n = g2.n_nodes
            p = torch.nn.functional.pad(pri.select, (0, tiled.n_padded - n), value=-(1 << 30))
            exact(errs, "tc_neighbor_max", N.tc_neighbor_max(tiled, p, alive),
                  N.tc_neighbor_max_plain(tiled, p, alive), what)
            if storage == "bitpack":
                cand_w, alive_w = (pack_frontier_words(x, T) for x in (cand, alive))
                for fl in (flags, None):
                    how = f"{what}, flags {'on' if fl is not None else 'off'}"
                    exact(errs, "tc_spmv_fused_bits",
                          K.tc_spmv_fused_bits(tiled, cand_w, alive_w, col_flags=fl),
                          K.tc_spmv_fused_bits_plain(tiled, cand_w, alive_w, col_flags=fl),
                          how)
                    exact(errs, "tc_spmv_bits", K.tc_spmv_bits(tiled, cand_w, col_flags=fl),
                          K.tc_spmv_bits_plain(tiled, cand_w, col_flags=fl), how)
                res = torch.nn.functional.pad(pri.resolve, (0, tiled.n_padded - n))
                for key, n_bits, signed in ((p, 31, False), (res, 32, True)):
                    planes = pack_priority_planes(key, T, n_bits, signed=signed)
                    exact(errs, "tc_neighbor_max_bits",
                          N.tc_neighbor_max_bits(tiled, planes, alive_w, signed=signed),
                          N.tc_neighbor_max_bits_plain(tiled, planes, alive_w, signed=signed),
                          f"{what}, {'signed' if signed else 'unsigned'} planes")
            torch.cuda.synchronize()
            print(f"[kernels] {what}: tiles={tiled.n_tiles} "
                  f"active_cols={int(flags.sum())}/{tiled.n_block_cols} all exact "
                  f"(both dense SpMVs on the full-mantissa RHS too) but the split "
                  f"SpMV on randn, max|err|={err:.3g} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            del plan, tiled
    check(sorted(errs) == sorted(k for k in KERNELS
                                 if not k.startswith("embedding_bag") and k != "threefry"),
          f"kernels held: {sorted(errs)}")
    return errs


def phase_kernels_partition(g2, errs: dict) -> None:
    """The four kernels of a hybrid round against their plain versions on
    G2's compacted dense partitions (T = 16, both storages)."""
    import torch
    from repro_torch.api import Plan
    from repro_torch.core import prng
    from repro_torch.core.heuristics import make_priorities
    from repro_torch.core.tiling import (
        pack_frontier_words, pack_priority_planes, partition_tiles)
    from repro_torch.hopper import tc_neighbor_max as N
    from repro_torch.hopper import tc_spmv as K

    n = g2.n_nodes
    for storage in ("int8", "bitpack"):
        tiled = Plan.build(g2, tile_size=16, storage=storage).tiled
        T = tiled.tile_size
        gen = torch.Generator(device="cuda").manual_seed(30)
        pri = make_priorities("h3", prng.key(30), n, g2.degrees())
        p = torch.nn.functional.pad(pri.select, (0, tiled.n_padded - n), value=-(1 << 30))
        res = torch.nn.functional.pad(pri.resolve, (0, tiled.n_padded - n))
        for thr, want in G2_PARTITIONS.items():
            t0 = time.perf_counter()
            part = partition_tiles(tiled, thr)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            dense = part.dense
            uncovered = int((dense.row_starts[1:] == dense.row_starts[:-1]).sum())
            got = (part.n_dense_tiles, part.n_sparse_tiles, part.sp_nnz, uncovered)
            check(got == want, f"G2 partition at {thr}, {storage}: {got}, expected {want}")
            what = f"dense partition at threshold {thr}, T=16, {storage}"
            cand, alive, flags = random_frontier(dense, gen)
            rhs01 = (torch.rand((dense.n_padded, 8), generator=gen, device="cuda") < 0.5).float()
            rhs01[:, 0], rhs01[:, 1] = cand.float(), alive.float()
            rhs = torch.randn((dense.n_padded, 8), generator=gen, device="cuda")
            cand_w, alive_w = (pack_frontier_words(x, T) for x in (cand, alive))
            err = 0.0
            for fl in (flags, None):
                how = f"{what}, flags {'on' if fl is not None else 'off'}"
                exact(errs, "tc_spmv", K.tc_spmv(dense, rhs01, col_flags=fl),
                      K.tc_spmv_plain(dense, rhs01, col_flags=fl), how + ", 0/1 RHS")
                got_n, want_n = (K.tc_spmv(dense, rhs, col_flags=fl),
                                 K.tc_spmv_plain(dense, rhs, col_flags=fl))
                err = max(err, max_err(got_n, want_n))
                check(torch.allclose(got_n, want_n, rtol=1e-5, atol=1e-5),
                      f"split kernel != plain ({how}): max |err| {err}")
                exact(errs, "tc_spmv_bits", K.tc_spmv_bits(dense, cand_w, col_flags=fl),
                      K.tc_spmv_bits_plain(dense, cand_w, col_flags=fl), how)
            errs["tc_spmv"] = max(errs.get("tc_spmv", 0.0), err)
            exact(errs, "tc_neighbor_max", N.tc_neighbor_max(dense, p, alive),
                  N.tc_neighbor_max_plain(dense, p, alive), what)
            for key, n_bits, signed in ((p, 31, False), (res, 32, True)):
                planes = pack_priority_planes(key, T, n_bits, signed=signed)
                exact(errs, "tc_neighbor_max_bits",
                      N.tc_neighbor_max_bits(dense, planes, alive_w, signed=signed),
                      N.tc_neighbor_max_bits_plain(dense, planes, alive_w, signed=signed),
                      f"{what}, {'signed' if signed else 'unsigned'} planes")
            torch.cuda.synchronize()
            print(f"[kernels] {what}: {part.n_dense_tiles} dense tiles, {uncovered} of "
                  f"{dense.n_block_rows} block-rows with none, {part.n_sparse_tiles} tail "
                  f"tiles, {part.sp_nnz} tail nnz (partitioned in {secs:.2f} s); "
                  f"tc_spmv, tc_spmv_bits, tc_neighbor_max, tc_neighbor_max_bits all exact "
                  f"but the split SpMV on randn, max|err|={err:.3g}", flush=True)
            del part, dense


def solve_path(g2, options, label: str, plans):
    """One `Solver.solve` with every launch count set to 0 just before it;
    returns (solver, plan, result, {kernel: launches}) read just after."""
    from repro_torch.api import Solver

    solver = Solver(options, device="cuda", plans=plans)
    plan = solver.plan(g2)
    res, counts = counted(lambda: solver.solve(plan))
    print(f"[paths] {label}: T={plan.tile_size} {plan.storage} "
          f"tiles={plan.tiled.n_tiles} rounds={res.rounds} "
          f"converged={res.converged} mis={res.mis_size} "
          f"launches={ {k: v for k, v in counts.items() if v} } "
          f"solve_ms={res.stats['solve_ms']:.3f}", flush=True)
    return solver, plan, res, counts


def phase_paths(g2) -> dict:
    import numpy as np
    import torch
    from repro_torch.api import PlanCache, SolveOptions
    from repro_torch.core.engine import get_engine, resolve_frontier
    from repro_torch.core.validate import is_valid_mis

    plans = PlanCache()
    launches = {}          # the kernels line's: hybrid="off" paths, timed tilings
    hybrid_launches = {}   # path -> launches on the hybrid paths
    out = {}
    mis = {}
    refs = {}   # tiled_ref results by options

    def run(label, opts, expect, *, key=None):
        """Solve, hold validity, launch counts (kernel -> launches per
        round; every other kernel 0) and equality with `tiled_ref`;
        returns (plan, result, `tiled_ref`'s result)."""
        solver, plan, res, counts = solve_path(g2, opts, label, plans)
        check(res.converged, f"{label} did not converge")
        check(is_valid_mis(plan.g, torch.from_numpy(res.in_mis_plan).cuda()),
              f"{label}: MIS is not valid")
        want = {k: expect.get(k, 0) * res.rounds for k in KERNELS}
        want["threefry"] = draw_launches(opts.heuristic, plan.n_nodes)
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        if plan.tiled.partition is None:
            for k in (*expect, "threefry"):
                launches.setdefault(k, counts[k])
        else:
            hybrid_launches[label] = {k: counts[k] for k in expect}
        ref_opts = dataclasses.replace(opts, engine="tiled_ref")
        if ref_opts not in refs:
            refs[ref_opts] = solve_path(g2, ref_opts, f"tiled_ref for {label}", plans)[2]
        ref = refs[ref_opts]
        check(ref.rounds == res.rounds and np.array_equal(ref.in_mis, res.in_mis),
              f"{label} differs from tiled_ref with the same options")
        mis[label] = (res.in_mis, res.rounds)
        if key:
            out[key] = (solver, plan, res)
        return plan, res, ref

    default, _, _ = run("default", SolveOptions(), {"tc_spmv": 1}, key="default")
    part = default.tiled.partition
    check(default.tile_size == 16 and default.storage == "bitpack"
          and (default.hybrid, default.hybrid_threshold) == ("auto", 68)
          and part is not None
          and (part.n_dense_tiles, part.n_sparse_tiles, part.sp_nnz) == G2_PARTITIONS[68][:3],
          f"default path planned T={default.tile_size} {default.storage} "
          f"{default.hybrid}:{default.hybrid_threshold}, partition "
          f"{None if part is None else (part.n_dense_tiles, part.n_sparse_tiles, part.sp_nnz)}")
    h30 = SolveOptions(hybrid_threshold=30)
    hp, _, _ = run("hybrid 30", h30, {"tc_spmv": 1}, key="hybrid30")
    part = hp.tiled.partition
    check(part is not None and (part.n_dense_tiles, part.n_sparse_tiles, part.sp_nnz)
          == G2_PARTITIONS[30][:3], "hybrid 30 path: the partition is not G2's at 30")
    h30_packed = dataclasses.replace(h30, phase1="tiled")
    hk, _, _ = run("hybrid 30 packed", h30_packed,
                   {"tc_neighbor_max_bits": 2, "tc_spmv_bits": 1}, key="hybrid30_packed")
    frontier = resolve_frontier(h30_packed, get_engine(h30_packed.engine), storage=hk.storage)
    check(frontier == "bitwise", f"hybrid 30 packed path: frontier {frontier}")
    run("hybrid 30 dense tiled", dataclasses.replace(h30, phase1="tiled", frontier="dense"),
        {"tc_neighbor_max": 2, "tc_spmv": 1})

    main, _, _ = run("main", SolveOptions(hybrid="off"), {"tc_spmv_fused": 1}, key="main")
    check(main.tile_size == 16 and main.storage == "bitpack",
          f"main path planned T={main.tile_size} {main.storage}")
    run("main storage=int8", SolveOptions(hybrid="off", storage="int8"),
        {"tc_spmv_fused": 1})
    run("tiled_pallas storage=int8",
        SolveOptions(hybrid="off", storage="int8", engine="tiled_pallas"), {"tc_spmv": 1})

    slice_opts = SolveOptions(hybrid="off", phase1="tiled")
    sl, _, _ = run("packed", slice_opts,
                   {"tc_neighbor_max_bits": 2, "tc_spmv_fused_bits": 1}, key="packed")
    frontier = resolve_frontier(slice_opts, get_engine(slice_opts.engine), storage=sl.storage)
    check(sl.tile_size == 16 and sl.storage == "bitpack" and frontier == "bitwise",
          f"packed path planned T={sl.tile_size} {sl.storage}, frontier {frontier}")
    split_opts = SolveOptions(hybrid="off", phase1="tiled", engine="tiled_pallas")
    run("packed tiled_pallas", split_opts, {"tc_neighbor_max_bits": 2, "tc_spmv_bits": 1})
    run("dense tiled phase 1", SolveOptions(hybrid="off", phase1="tiled", frontier="dense"),
        {"tc_neighbor_max": 2, "tc_spmv_fused": 1})

    # round telemetry: the same kernels as often, the same MIS, and the trace
    # `tiled_ref` records with the same options (both engines take their
    # column flags from the one `TorchRoundEngine.col_flags`)
    for label, opts, expect in (
            ("main telemetry", SolveOptions(hybrid="off"), {"tc_spmv_fused": 1}),
            ("packed tiled_pallas telemetry", split_opts,
             {"tc_neighbor_max_bits": 2, "tc_spmv_bits": 1}),
            ("hybrid 30 telemetry", h30, {"tc_spmv": 1})):
        plan, res, ref = run(label, dataclasses.replace(opts, telemetry=True), expect)
        rt = res.telemetry
        tail = 0 if plan.tiled.partition is None else plan.tiled.partition.n_sparse_tiles
        check(rt.tiles_sparse == [tail] * rt.rounds,
              f"{label}: tail tiles per round {rt.tiles_sparse}, expected {tail}")
        rt.check_invariants()
        check(rt.rounds == res.rounds and rt.alive[0] == g2.n_nodes
              and sum(rt.selected) == res.mis_size,
              f"{label}: trace rounds {rt.rounds}, alive0 {rt.alive[0]}, "
              f"selected {sum(rt.selected)} against {res.rounds}, {g2.n_nodes}, "
              f"{res.mis_size}")
        columns = {k: v for k, v in rt.to_dict().items() if k != "meta"}
        check(columns == {k: v for k, v in ref.telemetry.to_dict().items() if k != "meta"},
              f"{label}: trace differs from tiled_ref's")
        print(f"[paths] {label}: {json.dumps(columns)}", flush=True)

    base_mis, base_rounds = mis["default"]
    for label, (m, r) in mis.items():
        check(r == base_rounds and np.array_equal(m, base_mis),
              f"{label} differs from the default path (rounds {r} vs {base_rounds})")
    print(f"[paths] all {len(mis)} paths: the same MIS of {int(base_mis.sum())} "
          f"vertices in {base_rounds} rounds", flush=True)
    print(f"[paths] launches on the hybrid paths (dense partitions, not in the kernels "
          f"line): {json.dumps(hybrid_launches)}", flush=True)
    out["launches"] = launches
    out["plans"] = plans
    return out


def phase_baselines(g2, paths: dict) -> dict:
    """ECL-MIS and Luby on G2 beside TC-MIS; the G3 stand-in planned and
    solved with the default options and with `hybrid="off"`."""
    import numpy as np
    import torch
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.core import ecl_mis, is_valid_mis, luby_mis, prng
    from repro_torch.core.tiling import attach_partition
    from repro_torch.graphs import delaunay_like

    out = {}
    e, counts = counted(lambda: ecl_mis(g2, prng.key(0)))
    check(bool(e.converged) and is_valid_mis(g2, e.in_mis), "ecl_mis: no valid MIS")
    want = {k: draw_launches("ecl", g2.n_nodes) if k == "threefry" else 0 for k in KERNELS}
    check(counts == want, f"ecl_mis: launches {counts}, expected {want}")
    solver = Solver(SolveOptions(heuristic="ecl"), device="cuda", plans=paths["plans"])
    plan = solver.plan(g2)
    tc, counts = counted(lambda: solver.solve(plan))
    check(counts["tc_spmv"] == tc.rounds, f"TC-MIS with ECL priorities: launches {counts}")
    check(tc.rounds == int(e.rounds) and np.array_equal(tc.in_mis, e.in_mis.cpu().numpy()),
          f"ecl_mis ({int(e.rounds)} rounds) differs from TC-MIS with heuristic='ecl' "
          f"({tc.rounds} rounds) on the same priorities")
    lb, counts = counted(lambda: luby_mis(g2, prng.key(0)))
    check(bool(lb.converged) and is_valid_mis(g2, lb.in_mis), "luby_mis: no valid MIS")
    want = {k: int(lb.rounds) if k == "threefry" else 0 for k in KERNELS}
    check(counts == want, f"luby_mis: launches {counts}, expected {want} (one draw a round)")
    h3 = paths["default"][2]
    print(f"[baselines] G2: luby_mis {int(lb.rounds)} rounds, {int(lb.in_mis.sum())} vertices; "
          f"ecl_mis {int(e.rounds)} rounds, {int(e.in_mis.sum())} vertices, equal to TC-MIS "
          f"with heuristic='ecl' (default path); TC-MIS H3 {h3.rounds} rounds, "
          f"{h3.mis_size} vertices", flush=True)

    t0 = time.perf_counter()
    g3 = delaunay_like(G3_N, device="cuda")
    gen_s = time.perf_counter() - t0
    g3_runs = {}
    for label, opts in (("default", SolveOptions()), ("off", SolveOptions(hybrid="off"))):
        solver = Solver(opts, device="cuda")
        t0 = time.perf_counter()
        plan = solver.plan(g3)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        res, counts = counted(lambda: solver.solve(plan))
        check(res.converged and is_valid_mis(plan.g, torch.from_numpy(res.in_mis_plan).cuda()),
              f"G3 {label}: no valid MIS")
        part = plan.tiled.partition
        print(f"[baselines] G3 delaunay_like({G3_N}) {label}: n={g3.n_nodes} "
              f"half-edges={g3.n_edges}; plan {plan_s:.2f} s: T={plan.tile_size} "
              f"{plan.storage} tiles={plan.tiled.n_tiles} hybrid={plan.hybrid}:"
              f"{plan.hybrid_threshold} partition="
              f"{None if part is None else (part.n_dense_tiles, part.n_sparse_tiles, part.sp_nnz)}"
              f"; rounds={res.rounds} mis={res.mis_size} "
              f"launches={ {k: v for k, v in counts.items() if v} }", flush=True)
        g3_runs[label] = (solver, plan, res)
    off_plan = g3_runs["off"][1]
    t0 = time.perf_counter()
    attach_partition(off_plan.tiled, mode="auto", threshold=g3_runs["default"][1].hybrid_threshold)
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t0
    a, b = g3_runs["default"][2], g3_runs["off"][2]
    check(a.rounds == b.rounds and np.array_equal(a.in_mis, b.in_mis),
          "G3: the default path and hybrid='off' give different MIS")
    print(f"[baselines] G3: generator {gen_s:.2f} s, partition alone {part_s:.2f} s; "
          f"default and hybrid='off' give one MIS of {a.mis_size} vertices in {a.rounds} "
          f"rounds", flush=True)
    out["g3"] = g3_runs["default"]
    return out


def ordered_bits(t):
    """A bf16 or f32 tensor's bits as int64 in the floats' order (so that
    their difference counts ulps)."""
    import torch

    if t.dtype == torch.bfloat16:
        b = t.contiguous().view(torch.int16).long()
        return torch.where(b < 0, -(b & 0x7FFF), b)
    b = t.float().contiguous().view(torch.int32).long()
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


def draws_modes(errs: dict) -> None:
    """(c) The kernel's modes from a start counter against the plain
    version on the card (`threefry_bits_plain` as torch ops there): at
    DRAW_MODE_SIZES from DRAW_STARTS (a draw that crosses the counter's
    high word, one past it) under DRAW_KEYS (the largest size under the
    last key alone), bits and uniforms over DRAW_RANGES bit for bit,
    normals within DRAW_NORMAL_ULPS (the share bit-equal printed); then
    one normal launch of DRAW_TIMED_NORMALS, cold and warm, beside its
    bound."""
    import torch
    from repro_torch.hopper import threefry as F

    t0 = time.perf_counter()
    cases = [("bits", 0.0, 1.0)] + [("uniform", lo, hi) for lo, hi in DRAW_RANGES] + [
        ("normal", 0.0, 1.0)]
    worst, same, total = 0, 0, 0
    for n in DRAW_MODE_SIZES:
        for start in DRAW_STARTS:
            for k0, k1 in (DRAW_KEYS if n < 1 << 20 else DRAW_KEYS[-1:]):
                for mode, lo, hi in cases:
                    got = F.threefry_bits(k0, k1, n, "cuda", mode, start=start, minval=lo,
                                          maxval=hi)
                    want = F.threefry_bits_plain(k0, k1, torch.empty_like(got), mode,
                                                 start=start, minval=lo, maxval=hi)
                    what = f"n={n}, start {start}, key ({k0:#x}, {k1:#x}), {mode} [{lo}, {hi})"
                    if mode != "normal":
                        exact(errs, "threefry", got.view(torch.int32), want.view(torch.int32),
                              what)
                        continue
                    ulps = (ordered_bits(got) - ordered_bits(want)).abs()
                    worst = max(worst, int(ulps.max()))
                    same += int((ulps == 0).sum())
                    total += n
                    check(worst <= DRAW_NORMAL_ULPS and bool(torch.isfinite(got).all()),
                          f"threefry normal kernel vs plain, {what}: {worst} ulps")
                    errs["threefry"] = max(errs.get("threefry", 0.0), max_err(got, want))
    torch.cuda.synchronize()
    print(f"[draws] (c) threefry from start counters {list(DRAW_STARTS)} at n "
          f"{list(DRAW_MODE_SIZES)}: bits and uniforms on {[list(r) for r in DRAW_RANGES]} "
          f"bit-equal to the plain version on the card; normals within {worst} ulps "
          f"(limit {DRAW_NORMAL_ULPS}), {same / total:.6f} of {total} bit-equal "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    n = DRAW_TIMED_NORMALS
    cold = time_ms(lambda: F.threefry_bits(7, 9, n, "cuda", "normal"), cold=True)
    warm = time_ms(lambda: F.threefry_bits(7, 9, n, "cuda", "normal"))
    bound = _bound(4 * n, F.OPS_PER_ELEMENT["normal"] * n)
    print(f"[draws] (c) threefry normal n={n}: {cold:.4f} ms cold, {warm:.4f} ms warm, "
          f"bound {bound[0]:.4f} ms by {bound[1]} ({bound[2]} B, {bound[3]} ops)", flush=True)


def init_leaves(name: str, built) -> dict:
    """{leaf: tensor} of a model built from key(0), named and laid out as
    `INIT_SEED_LEAVES` holds them (a stacked LM leaf's layers 0 and n - 1,
    MLP weights transposed to the reference's (in, out))."""
    from repro_torch.models import transformer as tf

    if name == "qwen3-0.6b":
        params, cfg = built
        out = {}
        for path, _, _, init in tf._walk(tf._tree_spec(cfg)):
            if isinstance(init, str):
                continue
            leaf, key = tf._get(params, path), "/".join(path)
            if path[0].endswith("_layers"):
                out.update({f"{key}@{i}": leaf[i] for i in (0, leaf.shape[0] - 1)})
            else:
                out[key] = leaf
        return out
    if name == "deepfm":
        out = {"embed": built.embed.detach(), "linear": built.linear.detach()}
        out.update({f"mlp/{i}": m.weight.detach().T for i, m in enumerate(built.mlp.layers)})
        return out
    out = {f"layers/{l}/mlp/{i}": m.weight.detach().T
           for l, layer in enumerate(built.layers) for i, m in enumerate(layer.mlp.layers)}
    out.update({f"head/{i}": m.weight.detach().T for i, m in enumerate(built.head.layers)})
    return out


def draws_inits() -> None:
    """(d) From key(0) alone, at full width on the card: qwen3-0.6b's
    `init_lm`, DeepFM's CONFIG and GIN at minibatch_lg's widths, each
    leaf's first elements held to the reference's (`INIT_SEED_LEAVES`:
    one bf16 ulp, INIT_F32_ULPS f32 ulps) and its mean and std to 0 and its
    scale (within 1 %, or 5 / sqrt(size) where a leaf is too small for
    1 % to be a test); the wall time of each init and its Threefry
    launches (one a leaf, a layer's slice of a stacked leaf, or a 2^26
    block of either)."""
    import math

    import torch
    from repro_torch.configs import GNN_ARCHS, LM_ARCHS
    from repro_torch.configs import deepfm as DC
    from repro_torch.configs import gnn_cells as GC
    from repro_torch.core import prng
    from repro_torch.hopper import threefry as F
    from repro_torch.models import deepfm as M
    from repro_torch.models import transformer as tf
    from repro_torch.train import tree as T

    def build(name):
        if name == "qwen3-0.6b":
            cfg = LM_ARCHS[name].CONFIG
            return tf.init_lm(prng.key(0), cfg, device="cuda"), cfg
        if name == "deepfm":
            return M.DeepFM(DC.CONFIG, seed=0, device="cuda")
        lg = GC.GNN_SHAPES["minibatch_lg"]
        return GNN_ARCHS[name].init(lg["d_feat"], lg["n_out"], seed=0, device="cuda")

    for name, pins in INIT_SEED_LEAVES.items():
        torch.cuda.synchronize()
        before = F.threefry_bits.launches
        t0 = time.perf_counter()
        built = build(name)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = F.threefry_bits.launches - before
        leaves = init_leaves(name, built)
        check(sorted(leaves) == sorted(pins), f"[draws] (d) {name}: leaves {sorted(leaves)}")
        worst, stats = {"bf16": 0, "f32": 0}, 0.0
        for leaf, (kind, scale, want) in pins.items():
            t = leaves[leaf]
            check({"bf16": torch.bfloat16, "f32": torch.float32}[kind] == t.dtype,
                  f"[draws] (d) {name} {leaf}: dtype {t.dtype}")
            ref = torch.tensor(want, dtype=torch.int16 if kind == "bf16" else torch.int32,
                               device="cuda").view(t.dtype)
            ulps = int((ordered_bits(t.reshape(-1)[:len(want)]) - ordered_bits(ref)).abs().max())
            limit = 1 if kind == "bf16" else INIT_F32_ULPS
            check(ulps <= limit, f"[draws] (d) {name} {leaf}: first elements {ulps} ulps "
                  f"from the reference's (limit {limit})")
            worst[kind] = max(worst[kind], ulps)
            x = t.float()
            tol = max(0.01, 5 / math.sqrt(x.numel()))
            mean, std = float(x.mean()) / scale, float(x.std()) / scale
            check(abs(mean) <= tol and abs(std - 1) <= tol,
                  f"[draws] (d) {name} {leaf}: mean {mean:.4g} and std {std:.4g} of its scale "
                  f"{scale} (tolerance {tol:.3g})")
            stats = max(stats, abs(mean) / tol, abs(std - 1) / tol)
        n_params = (sum(x.numel() for x in T.leaves(built[0])) if name == "qwen3-0.6b" else
                    sum(p.numel() for p in built.parameters()))
        print(f"[draws] (d) {name} from key(0) at full width on the card: {n_params:,} "
              f"parameters in {secs:.3f} s, {launches} threefry launches; the first elements of "
              f"its {len(pins)} normal leaves the reference's within {worst['bf16']} bf16 / "
              f"{worst['f32']} f32 ulps, means and stds at most {stats:.3f} of their "
              f"tolerances", flush=True)
        del built, leaves
        torch.cuda.empty_cache()


def phase_draws(g2, errs: dict, paths: dict) -> dict:
    """(a) The Threefry kernel bit-equal to its plain version at DRAW_SIZES
    under DRAW_KEYS, bits and uniforms, and across two launches; timed at
    the main path's draw (G2's Eq. 1 uniforms) and at 2^24 + 1.  (c) Its
    new modes and start counter (`draws_modes`), (d) the full-width inits
    from the seed alone (`draws_inits`).  (b) From seed 0 alone, on the
    card: the default solve of G2, `luby_mis`, `ecl_mis` and a
    `solve_many` member, each held to the reference's MIS (`G2_SEED_MIS`)
    and its Threefry launches counted.  Returns the kernel's record."""
    import torch
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.core import ecl_mis, luby_mis, prng
    from repro_torch.graphs import grid2d
    from repro_torch.hopper import threefry as F

    t0 = time.perf_counter()
    for n in DRAW_SIZES:
        for k0, k1 in DRAW_KEYS:
            for mode in ("bits", "uniform"):
                got = F.threefry_bits(k0, k1, n, "cuda", mode)
                want = F.threefry_bits_plain(k0, k1, torch.empty_like(got), mode)
                exact(errs, "threefry", got.view(torch.int32), want.view(torch.int32),
                      f"n={n}, key ({k0:#x}, {k1:#x}), {mode}")
    big = DRAW_SIZES[-1]
    exact(errs, "threefry", F.threefry_bits(*DRAW_KEYS[2], big, "cuda"),
          F.threefry_bits(*DRAW_KEYS[2], big, "cuda"), "two launches")
    torch.cuda.synchronize()
    print(f"[draws] (a) threefry bit-equal to its plain version at n {list(DRAW_SIZES)}, "
          f"keys {[(hex(a), hex(b)) for a, b in DRAW_KEYS]}, bits and uniforms, and across "
          f"two launches ({time.perf_counter() - t0:.1f} s)", flush=True)

    n = g2.n_nodes
    kq = prng.split(prng.key(0))[0]          # H3's Eq. 1 key under seed 0

    timing = time_pair(
        lambda: F.threefry_bits(kq.k0, kq.k1, n, "cuda", "uniform"),
        lambda: F.threefry_bits_plain(kq.k0, kq.k1, torch.empty(n, device="cuda"), "uniform"))
    rec = record("threefry", paths["launches"], errs, timing,
                 _bound(4 * n, F.OPS_PER_ELEMENT["uniform"] * n), None)
    cold = time_ms(lambda: F.threefry_bits(kq.k0, kq.k1, big, "cuda", "uniform"), cold=True)
    warm = time_ms(lambda: F.threefry_bits(kq.k0, kq.k1, big, "cuda", "uniform"))
    bound = _bound(4 * big, F.OPS_PER_ELEMENT["uniform"] * big)
    print(f"[draws] (a) threefry uniform n={big}: {cold:.4f} ms cold, {warm:.4f} ms warm, "
          f"bound {bound[0]:.4f} ms by {bound[1]} ({bound[2]} B, {bound[3]} ops)", flush=True)

    draws_modes(errs)
    draws_inits()

    def hold(path, in_mis, rounds, counts, draws):
        size, digest = mis_digest(in_mis)
        want = G2_SEED_MIS[path]
        check((size, rounds, digest) == want,
              f"[draws] {path} from seed 0: {size} vertices in {rounds} rounds, sha256 "
              f"{digest}; the reference's {want}")
        check(counts["threefry"] == draws,
              f"[draws] {path}: {counts['threefry']} threefry launches, expected {draws}")
        print(f"[draws] (b) {path} from seed 0: {size} vertices in {rounds} rounds, sha256 "
              f"{digest[:16]}..., the reference's; threefry launches {draws}", flush=True)

    solver = Solver(SolveOptions(), device="cuda", plans=paths["plans"])
    plan = solver.plan(g2)
    res, counts = counted(lambda: solver.solve(plan))
    hold("solve", res.in_mis, res.rounds, counts, draw_launches("h3", n))
    lb, counts = counted(lambda: luby_mis(g2, prng.key(0)))
    hold("luby", lb.in_mis, int(lb.rounds), counts, int(lb.rounds))
    e, counts = counted(lambda: ecl_mis(g2, prng.key(0)))
    hold("ecl", e.in_mis, int(e.rounds), counts, draw_launches("ecl", n))
    members = [grid2d(*G2_MEMBER, seed=s, device="cuda") for s in (0, 1)]
    batched = Solver(SolveOptions(), device="cuda")
    results, counts = counted(lambda: batched.solve_many(members))
    check([r.placement for r in results] == ["batched"] * 2,
          "[draws] the members were not batched")
    hold("member", results[0].in_mis, results[0].rounds, counts,
         sum(draw_launches("h3", m.n_nodes) for m in members))
    solo = batched.solve(results[0].plan, key=batched.request_key(results[0].plan))
    check(mis_digest(solo.in_mis) == mis_digest(results[0].in_mis)
          and solo.rounds == results[0].rounds,
          "[draws] the member differs from its solo solve under its request key")
    print(f"[draws] phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return rec


def _active_tiles(tiled, flags):
    nt = tiled.n_tiles
    return flags[tiled.tile_cols[:nt].long()] != 0


def _nnz(tiled, active=None) -> int:
    """Nonzeros of the (active) real tiles, counted in chunks."""
    from repro_torch.core.tiling import dense_tile_mask

    nt, nnz = tiled.n_tiles, 0
    for lo in range(0, nt, 1 << 16):
        hi = min(lo + (1 << 16), nt)
        m = dense_tile_mask(tiled.tiles[lo:hi], tiled.tile_size)
        nnz += int((m if active is None else m[active[lo:hi]]).sum())
    return nnz


def _meta_bytes(tiled) -> int:
    return tiled.tile_cols.numel() * 4 + tiled.row_starts.numel() * 4


def _bound(nbytes: int, ops: int):
    """(ms, "bytes"|"operations", bytes, ops): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def bound_spmv(tiled, flags, lanes: int, fused: bool):
    """Dense SpMV: tiles and RHS slabs of active columns read once, n_c
    written once (+ cand, alive in and two masks out when fused); one
    multiply-add per nonzero of an active tile per lane."""
    import torch

    active = _active_tiles(tiled, flags)
    tile_bytes = tiled.tiles[0].numel() * tiled.tiles.element_size()
    n_cols = int(torch.unique(tiled.tile_cols[: tiled.n_tiles][active]).numel())
    n_pad, T = tiled.n_padded, tiled.tile_size
    nbytes = (int(active.sum()) * tile_bytes + _meta_bytes(tiled) + flags.numel() * 4
              + n_cols * T * lanes * 4 + n_pad * lanes * 4 + (4 * n_pad if fused else 0))
    return _bound(nbytes, 2 * _nnz(tiled, active) * lanes)


def bound_spmv_bits(tiled, words, flags, fused: bool):
    """Packed SpMV: word tiles and candidate words of active columns read
    once, hit words written (+ own cand and alive words in, two word
    outputs when fused); one AND and one test per active tile word."""
    import torch

    active = _active_tiles(tiled, flags)
    n_active = int(active.sum())
    T, W, nbr = tiled.tile_size, words.shape[-1], tiled.n_block_rows
    n_cols = int(torch.unique(tiled.tile_cols[: tiled.n_tiles][active]).numel())
    nbytes = (n_active * T * W * 4 + _meta_bytes(tiled) + flags.numel() * 4
              + n_cols * W * 4 + nbr * W * 4 + (4 * nbr * W * 4 if fused else 0))
    return _bound(nbytes, 2 * n_active * T * W)


def bound_nbr_max(tiled):
    """Dense neighbour max: every real tile, the priority and mask vectors
    read once, the (nbr·T,) int32 max written; a test and a max per
    nonzero."""
    nt, n_pad = tiled.n_tiles, tiled.n_padded
    tile_bytes = tiled.tiles[0].numel() * tiled.tiles.element_size()
    nbytes = nt * tile_bytes + _meta_bytes(tiled) + 5 * n_pad + 4 * n_pad
    return _bound(nbytes, 2 * _nnz(tiled))


def bound_plane_scan(tiled, words, planes, mask_w):
    """Plane scan: every real word tile and the mask words read once, the
    plane words of each column that some tile row has a live neighbour in,
    the (nbr·T,) int32 max written; per such tile row an AND, a test and a
    select per plane word."""
    import torch

    nt, T, W = tiled.n_tiles, tiled.tile_size, words.shape[-1]
    cols = tiled.tile_cols[:nt].long()
    live_rows = ((words[:nt] & mask_w[cols][:, None, :]) != 0).any(dim=2)   # (nt, T)
    n_cols = int(torch.unique(cols[live_rows.any(dim=1)]).numel())
    n_bits = planes.shape[0]
    nbytes = (nt * T * W * 4 + _meta_bytes(tiled) + mask_w.numel() * 4
              + n_bits * n_cols * W * 4 + tiled.n_padded * 4)
    return _bound(nbytes, 3 * n_bits * W * int(live_rows.sum()))


def yardstick_segment_max(g, p, mask):
    """The library yardstick of both neighbour maxes: one scatter_reduce
    ("amax") over the real half-edges with the masked priorities
    pre-gathered — the call the segment phase ① reduces to."""
    import torch
    from repro_torch.core.spmv import INT32_MIN, _NEG

    E, n = g.n_edges, g.n_nodes
    recv = g.receivers[:E].long()
    contrib = torch.where(mask[g.senders[:E].long()], p[g.senders[:E].long()], _NEG)
    contrib = contrib.to(torch.int32)

    def call():
        return torch.full((n,), INT32_MIN, dtype=torch.int32, device=p.device).scatter_reduce_(
            0, recv, contrib, "amax")

    return call


def time_pair(kern, plain) -> tuple:
    """plain, kernel, kernel, plain, cold; then the kernel twice warm:
    (kernel ms, plain ms, the four, the kernel's warm ms)."""
    p1 = time_ms(plain, cold=True)
    k1 = time_ms(kern, cold=True)
    k2 = time_ms(kern, cold=True)
    p2 = time_ms(plain, cold=True)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2), (time_ms(kern) + time_ms(kern)) / 2


def record(name, launches, errs, timing, bound, library_ms):
    ms, plain_ms, (p1, k1, k2, p2), warm_ms = timing
    bound_ms, bound_by, nbytes, ops = bound
    lib = "—" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"[timing] {name}: kernel {k1:.4f}/{k2:.4f} ms (warm {warm_ms:.4f} ms), "
          f"plain {p1:.4f}/{p2:.4f} ms, library {lib}, bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes} B, {ops} ops)", flush=True)
    source, replaces = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def timing_dense(main, launches: dict, errs: dict) -> list:
    """The two dense SpMV kernels at the main path's round-1 inputs, with
    one `torch.sparse_bsr_tensor @ rhs` as their yardstick."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.tc_mis import _setup
    from repro_torch.core.tiling import dense_tile_mask
    from repro_torch.hopper import tc_spmv as K

    solver, plan, _ = main
    tiled = plan.tiled
    engine, ctx, pri, state0 = _setup(plan.g, tiled, prng.key(solver.options.seed),
                                      solver.options)
    cand = engine.phase1_candidates(ctx, pri, state0.alive)
    flags = engine.col_flags(ctx, cand).contiguous()
    alive = state0.alive
    rhs = engine._pack_rhs(ctx, cand, alive)
    lanes = rhs.shape[1]
    print(f"[timing] main path round-1 inputs: T={tiled.tile_size} {tiled.storage} "
          f"tiles={tiled.n_tiles} cand={int(cand.sum())} "
          f"active_cols={int(flags.sum())}/{tiled.n_block_cols} lanes={lanes}", flush=True)
    n_active = int(_active_tiles(tiled, flags).sum())
    print(f"[timing] dense SpMV slab reads: {n_active} active tiles x "
          f"{tiled.tile_size * lanes * 4} B = {n_active * tiled.tile_size * lanes * 4} B, "
          f"mostly from L2 (the bound counts each needed slab once)", flush=True)

    nt = tiled.n_tiles
    values = dense_tile_mask(tiled.tiles[:nt], tiled.tile_size).to(torch.float32)
    bsr = torch.sparse_bsr_tensor(
        tiled.row_starts.long(), tiled.tile_cols[:nt].long(), values,
        size=(tiled.n_padded, tiled.n_padded), check_invariants=True,
    )
    check(torch.allclose(bsr @ rhs, K.tc_spmv_plain(tiled, rhs), atol=1e-5),
          "BSR library product disagrees with the plain SpMV")
    library_ms = time_ms(lambda: bsr @ rhs, cold=True)
    del values, bsr
    return [
        record("tc_spmv_fused", launches, errs, time_pair(
            lambda: K.tc_spmv_fused(tiled, rhs, cand, alive, col_flags=flags),
            lambda: K.tc_spmv_fused_plain(tiled, rhs, cand, alive, col_flags=flags)),
            bound_spmv(tiled, flags, lanes, True), library_ms),
        record("tc_spmv", launches, errs, time_pair(
            lambda: K.tc_spmv(tiled, rhs, col_flags=flags),
            lambda: K.tc_spmv_plain(tiled, rhs, col_flags=flags)),
            bound_spmv(tiled, flags, lanes, False), library_ms),
    ]


def timing_packed(packed, launches: dict, errs: dict) -> list:
    """The four phase-① / packed kernels at the packed path's round-1
    inputs (G2, T = 16, bitpack): the select plane scan and the dense max
    on the all-alive mask, the packed SpMVs on round 1's candidates."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.tc_mis import _setup
    from repro_torch.core.tiling import pack_frontier_words, unpack_frontier_words
    from repro_torch.hopper import tc_neighbor_max as N
    from repro_torch.hopper import tc_spmv as K

    solver, plan, _ = packed
    tiled, T = plan.tiled, plan.tile_size
    engine, ctx, pri, state0 = _setup(plan.g, tiled, prng.key(solver.options.seed),
                                      solver.options)
    b = ctx.bits
    words, alive_w = b.tiles_bits, state0.alive
    cand_w = engine.phase1_candidates_bits(ctx, pri, alive_w)
    flags = engine.col_flags_bits(ctx, cand_w).contiguous()
    alive = unpack_frontier_words(alive_w, T)
    max_np = N.tc_neighbor_max_bits(tiled, b.select_planes, alive_w, tiles_words=words)
    pending_w = pack_frontier_words(pri.select >= max_np, T) & alive_w
    print(f"[timing] packed path round-1 inputs: T={T} {tiled.storage} "
          f"tiles={tiled.n_tiles} alive={int(alive.sum())} "
          f"pending={int(unpack_frontier_words(pending_w, T).sum())} "
          f"cand={int(unpack_frontier_words(cand_w, T).sum())} "
          f"active_cols={int(flags.sum())}/{tiled.n_block_cols}", flush=True)

    seg_max = yardstick_segment_max(plan.g, pri.select, alive)
    check(torch.equal(seg_max()[plan.g.degrees() > 0],
                      N.tc_neighbor_max(tiled, pri.select, alive)[: plan.g.n_nodes][
                          plan.g.degrees() > 0]),
          "the scatter_reduce yardstick disagrees with the neighbour max")
    library_ms = time_ms(seg_max, cold=True)
    res_t = time_pair(
        lambda: N.tc_neighbor_max_bits(tiled, b.resolve_planes, pending_w,
                                       tiles_words=words, signed=True),
        lambda: N.tc_neighbor_max_bits_plain(tiled, b.resolve_planes, pending_w,
                                             tiles_words=words, signed=True))
    res_bound = bound_plane_scan(tiled, words, b.resolve_planes, pending_w)[0]
    print(f"[timing] tc_neighbor_max_bits, the round's 2nd launch (32 resolve "
          f"planes, pending mask): kernel {res_t[2][1]:.4f}/{res_t[2][2]:.4f} ms "
          f"(warm {res_t[3]:.4f} ms), "
          f"plain {res_t[2][0]:.4f}/{res_t[2][3]:.4f} ms, bound {res_bound:.4f} ms "
          f"(kernel {res_t[0] / res_bound:.2f}x its bound)", flush=True)
    return [
        record("tc_neighbor_max", launches, errs, time_pair(
            lambda: N.tc_neighbor_max(tiled, pri.select, alive),
            lambda: N.tc_neighbor_max_plain(tiled, pri.select, alive)),
            bound_nbr_max(tiled), library_ms),
        record("tc_spmv_fused_bits", launches, errs, time_pair(
            lambda: K.tc_spmv_fused_bits(tiled, cand_w, alive_w, tiles_words=words,
                                         col_flags=flags),
            lambda: K.tc_spmv_fused_bits_plain(tiled, cand_w, alive_w, tiles_words=words,
                                               col_flags=flags)),
            bound_spmv_bits(tiled, words, flags, True), None),
        record("tc_spmv_bits", launches, errs, time_pair(
            lambda: K.tc_spmv_bits(tiled, cand_w, tiles_words=words, col_flags=flags),
            lambda: K.tc_spmv_bits_plain(tiled, cand_w, tiles_words=words, col_flags=flags)),
            bound_spmv_bits(tiled, words, flags, False), None),
        record("tc_neighbor_max_bits", launches, errs, time_pair(
            lambda: N.tc_neighbor_max_bits(tiled, b.select_planes, alive_w, tiles_words=words),
            lambda: N.tc_neighbor_max_bits_plain(tiled, b.select_planes, alive_w,
                                                 tiles_words=words)),
            bound_plane_scan(tiled, words, b.select_planes, alive_w), library_ms),
    ]


# the spans of repro_torch.obs.trace
SPANS = ("solver.", "rounds.")
# profiled calls of one `profile_call` while the profiler returns no device event
PROFILE_TRIES = 3
# the port's own kernels (csrc/*.cu) among the profiler's device events
PORT_KERNEL = re.compile(
    r"\b(tc_spmv_rows|nbr_max_\w+_lanes|spmv_bits_\w+|bag_groups|bag_backward_\w+)[<(]")


def profile_call(fn, label: str, names: Optional[set] = None) -> set:
    """One more warm call of `fn` under torch.profiler: device time by
    kernel (the device-side events: kernels, copies, fills), the ten
    largest and every one of the port's kernels, and the device's busy
    share of the wall time.  Prints each span of a `Trace(profiler=True)`
    among the profiler's events with its host time and the device time of
    the kernels launched inside it, and returns the spans' names.  Adds
    every event's name (host ops and device kernels) to `names`.

    On the H100 the profiler now and then hands back no device event for
    a short window (3 of 250 profiled G2 set-ups, each ~0.16 ms of device
    work, and once 17 of 21 kernels), so an empty trace is taken again, up
    to `PROFILE_TRIES` calls in all, before the check fails; the calls
    made are left in `profile_call.calls`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # a span's range on the device timeline is not device work
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0 and not e.key.startswith(SPANS)]
        if events:
            break
        print(f"[profile] {label}: the profiler returned no device event "
              f"(call {attempt} of {PROFILE_TRIES})", flush=True)
    profile_call.calls = attempt
    if names is not None:
        names.update(e.key for e in prof.key_averages())
    check(bool(events), f"profiler saw no device time in the {label} call "
          f"({PROFILE_TRIES} calls)")
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %), idle "
          f"{100 * (1 - busy_us / wall_us):.1f} %", flush=True)
    ranked = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    for i, e in enumerate(ranked):
        if i < 10 or PORT_KERNEL.search(e.key):
            print(f"[profile]   {e.self_device_time_total / 1e3:8.4f} ms  x{e.count:<4d} "
                  f"{e.key[:90]}", flush=True)
    spans = {e.key: e for e in prof.key_averages()
             if e.key.startswith(SPANS) and e.device_type == torch.autograd.DeviceType.CPU}
    for name, e in sorted(spans.items()):
        print(f"[profile]   span {name} x{e.count}: host {e.cpu_time_total / 1e3:.4f} ms, "
              f"kernels inside {e.device_time_total / 1e3:.4f} ms", flush=True)
    return set(spans)


def timing_solves(paths: dict) -> None:
    """Median of 5 warm solves (plan cached, kernels loaded) per path, and
    of 5 with telemetry on; the solve's set-up alone (priorities, bit
    planes, state₀) and the profiler twin's phase split (`Solver.profile`,
    median of 5 per phase) beside it, each profile held to the solve's MIS
    and rounds; then one telemetry solve, one set-up, one solve and one
    profile each under torch.profiler, the last two with
    `Trace(profiler=True)`, whose spans must show among the profiler's
    events."""
    import numpy as np
    import torch
    from repro_torch.api import Solver
    from repro_torch.core import prng
    from repro_torch.core.tc_mis import _setup
    from repro_torch.obs import Trace

    for key, label in (("default", "default options, hybrid auto (empty dense half)"),
                       ("hybrid30", "hybrid 30, segment phase ①"),
                       ("hybrid30_packed", "hybrid 30, tiled phase ①, packed frontier"),
                       ("main", "segment phase ①, hybrid off"),
                       ("packed", "tiled phase ①, packed frontier, hybrid off")):
        solver, plan, res = paths[key]
        med, took = median_ms(lambda: solver.solve(plan))
        print(f"[timing] warm solve, {label}: median {med:.3f} ms "
              f"of {[round(x, 3) for x in took]}, rounds={res.rounds}", flush=True)
        on = Solver(dataclasses.replace(solver.options, telemetry=True), device="cuda")
        med_on, took_on = median_ms(lambda: on.solve(plan))
        print(f"[timing] warm solve with telemetry, {label}: median {med_on:.3f} ms "
              f"of {[round(x, 3) for x in took_on]}", flush=True)
        profile_call(lambda: on.solve(plan), f"{label} solve with telemetry")

        def setup():
            return _setup(plan.g, plan.tiled, prng.key(solver.options.seed), solver.options)

        med_setup, took_setup = median_ms(setup)
        print(f"[timing] solve set-up alone, {label}: median {med_setup:.3f} ms "
              f"of {[round(x, 3) for x in took_setup]}", flush=True)
        profile_call(setup, f"{label} set-up")
        phases = {"phase1": [], "phase2": [], "phase3": []}
        for _ in range(5):
            prof, times = solver.profile(plan)
            check(prof.rounds == res.rounds == times["rounds"]
                  and np.array_equal(prof.in_mis, res.in_mis),
                  f"{label}: Solver.profile differs from solve")
            for k in phases:
                phases[k].append(times[k] * 1e3 / res.rounds)
        split = {k: statistics.median(v) for k, v in phases.items()}
        print(f"[timing] profiler twin, {label}: ms per round, median of 5: "
              f"phase ① {split['phase1']:.4f}, ②+③ {split['phase2']:.4f}, "
              f"③ merge {split['phase3']:.4f}, sum {sum(split.values()):.4f}; "
              f"warm solve {med / res.rounds:.4f} ms per round; "
              f"all five {json.dumps({k: [round(x, 4) for x in v] for k, v in phases.items()})}",
              flush=True)
        spans = profile_call(lambda: solver.solve(plan, trace=Trace(label, profiler=True)),
                             f"{label} solve")
        check(spans == {"solver.solve", "solver.plan", "solver.execute"},
              f"{label}: spans among the profiler's events: {sorted(spans)}")
        spans = profile_call(lambda: solver.profile(plan, trace=Trace(label, profiler=True)),
                             f"{label} profile")
        check(spans == {"solver.profile", "solver.plan", "rounds.phase1", "rounds.phase2",
                        "rounds.phase3"},
              f"{label}: spans among the profiler's events: {sorted(spans)}")


def timing_hybrid(g2, paths: dict, baselines: dict) -> None:
    """Median of 5 warm runs of the two baselines on G2 and of the
    default path's solve on G3; then, cold at the
    threshold-30 path's round-1 inputs, the split SpMV on the dense
    partition (and on the default path's empty one) beside its bound, and
    the tail's ② segment sum, with the costs per dense tile and per tail
    nnz and the break-even they imply (printed, never read by the
    planner)."""
    import torch
    from repro_torch.core import ecl_mis, luby_mis, prng
    from repro_torch.core.tc_mis import _setup
    from repro_torch.hopper import tc_spmv as K
    from repro_torch.perf import hybrid_density_threshold

    for label, fn in (("ecl_mis", ecl_mis), ("luby_mis", luby_mis)):
        med, took = median_ms(lambda: fn(g2, prng.key(0)))
        print(f"[timing] warm {label} on G2: median {med:.3f} ms "
              f"of {[round(x, 3) for x in took]}", flush=True)
    solver, plan, res = baselines["g3"]
    med, took = median_ms(lambda: solver.solve(plan))
    print(f"[timing] warm solve, G3 default path: median {med:.3f} ms "
          f"of {[round(x, 3) for x in took]}, rounds={res.rounds}", flush=True)

    solver, plan, _ = paths["hybrid30"]
    part = plan.tiled.partition
    engine, ctx, pri, state0 = _setup(plan.g, plan.tiled, prng.key(solver.options.seed),
                                      solver.options)
    dctx = dataclasses.replace(ctx, tiled=part.dense)
    alive = state0.alive
    cand = engine._hybrid_candidates(ctx, dctx, pri, alive)
    flags = engine.col_flags(dctx, cand).contiguous()
    rhs = engine._pack_rhs(dctx, cand, alive)
    n_active = int(_active_tiles(part.dense, flags).sum())
    spmv_ms = time_ms(lambda: K.tc_spmv(part.dense, rhs, col_flags=flags), cold=True)
    bound = bound_spmv(part.dense, flags, rhs.shape[1], False)
    tail_ms = time_ms(lambda: engine._sparse_counts(ctx, cand), cold=True)
    empty = paths["default"][1].tiled.partition.dense
    empty_flags = torch.ones(empty.n_block_cols, dtype=torch.int32, device="cuda")
    empty_ms = time_ms(lambda: K.tc_spmv(empty, rhs, col_flags=empty_flags), cold=True)
    per_tile, per_nnz = spmv_ms / max(n_active, 1), tail_ms / part.sp_nnz
    print(f"[timing] hybrid 30 round-1 inputs: cand={int(cand.sum())} dense tiles "
          f"{part.n_dense_tiles} ({n_active} active), tail nnz {part.sp_nnz}; "
          f"tc_spmv on the dense partition "
          f"{spmv_ms:.4f} ms cold, bound {bound[0]:.4f} ms by {bound[1]}; on the empty "
          f"partition {empty_ms:.4f} ms; the tail's ② segment sum {tail_ms:.4f} ms cold; "
          f"{per_tile * 1e6:.3f} ns per active dense tile, {per_nnz * 1e6:.4f} ns per tail "
          f"nnz: break-even {per_tile / per_nnz:.1f} nnz per tile, against the cost model's "
          f"{hybrid_density_threshold(16, 'bitpack')} (bitpack) and "
          f"{hybrid_density_threshold(16, 'int8')} (int8)", flush=True)


def counted(fn):
    """fn() with every launch count set to 0 just before it; returns its
    output and {kernel: launches} read just after it."""
    import torch

    for w in wrappers().values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in wrappers().items()}


def retrieval_by_candidate(model, user, cands, item_field: int):
    """Each candidate scored by the full DeepFM (plain gathers and sums, no
    bag kernel) with the item's embedding zeroed in the deep tower only:
    what the factorised retrieval sweep must equal."""
    n = cands.numel()
    fields = user[None, :].repeat(n, 1)
    fields[:, item_field] = cands
    flat = fields + model.offsets[None, :]
    v = model.embed[flat]
    lin = model.linear[flat].sum(1)
    s = v.sum(1)
    fm = 0.5 * ((s * s).sum(-1) - (v * v).sum(dim=(1, 2)))
    v_deep = v.clone()
    v_deep[:, item_field] = 0.0
    deep = model.mlp(v_deep.reshape(n, -1))[:, 0]
    return model.bias + lin + fm + deep


def phase_deepfm(errs: dict) -> dict:
    """DeepFM at full CONFIG on the card: the bag kernel against its plain
    version at serve_bulk shapes (exact), then the three serve shapes, each
    driven once with the launch counts set to 0 just before it."""
    import copy

    import torch
    from repro_torch.configs.deepfm import (
        CONFIG, FIELD_VOCABS, RETRIEVAL_CANDIDATES, SHAPES, retrieval_step, serve_step)
    from repro_torch.data.pipeline import ClickStream
    from repro_torch.hopper import embedding_bag as E
    from repro_torch.models import deepfm as M

    t0 = time.perf_counter()
    model = M.DeepFM(CONFIG, seed=0, device="cuda")
    torch.cuda.synchronize()
    V = CONFIG.total_vocab
    print(f"[deepfm] CONFIG: {CONFIG.n_fields} fields, {V} rows, d={CONFIG.embed_dim}, "
          f"MLP {CONFIG.mlp_dims}, {CONFIG.param_count()} parameters, built on the card "
          f"from seed 0 ({time.perf_counter() - t0:.1f} s)", flush=True)
    fields = {shape: torch.from_numpy(
        ClickStream(FIELD_VOCABS, SHAPES[shape]["batch"], seed=0).batch_at(0)[0]).cuda()
        for shape in ("serve_p99", "serve_bulk")}
    flat = fields["serve_bulk"] + model.offsets[None, :]
    cpu_model = copy.deepcopy(model).cpu()     # the same weights, for serve_p99

    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(13)
        w = torch.rand(flat.shape, generator=gen, device="cuda")
        tables = {"D=10 f32": model.embed, "D=1 f32": model.linear.view(V, 1),
                  "D=10 bf16": model.embed.to(torch.bfloat16)}
        for what, table in tables.items():
            for weights in (None, w):
                how = f"serve_bulk {tuple(flat.shape)}, {what}, " + (
                    "unweighted" if weights is None else "random weights")
                exact(errs, "embedding_bag", E.embedding_bag(table, flat, weights),
                      E.embedding_bag_plain(table, flat, weights), how)
        del tables
        # the other two paths' bag shapes: serve_p99's (512, 39) bags, and
        # retrieval's one (1, 39) bag weighted by the 0/1 user mask
        mask = (torch.arange(CONFIG.n_fields, device="cuda") != ITEM_FIELD).float()[None, :]
        small = {f"serve_p99 {tuple(fields['serve_p99'].shape)}, unweighted":
                 (fields["serve_p99"] + model.offsets[None, :], None),
                 "retrieval_cand (1, 39), user-mask weights":
                 ((fields["serve_p99"][0] + model.offsets)[None, :], mask)}
        for how, (idx, weights) in small.items():
            for what, table in (("D=10", model.embed), ("D=1", model.linear.view(V, 1))):
                exact(errs, "embedding_bag", E.embedding_bag(table, idx, weights),
                      E.embedding_bag_plain(table, idx, weights), f"{how}, {what} f32")
        torch.cuda.synchronize()
        print("[kernels] embedding_bag at serve_bulk (D ∈ {10, 1} f32 and D = 10 bf16, "
              "unweighted and weighted), serve_p99 and retrieval_cand (D ∈ {10, 1}): "
              "all exact", flush=True)

        want_launches = {k: 0 for k in KERNELS}
        want_launches["embedding_bag"] = 2
        logits, launches = {}, {}
        for shape, batch in fields.items():
            out, counts = counted(lambda: serve_step(model, batch))
            check(counts == want_launches, f"{shape}: launches {counts}, expected {want_launches}")
            launches[shape] = counts["embedding_bag"]
            check(out.shape == (batch.shape[0],) and out.dtype == torch.float32
                  and bool(torch.isfinite(out).all()), f"{shape}: logits not finite of shape (B,)")
            logits[shape] = out

        want = cpu_model(fields["serve_p99"].cpu())
        del cpu_model
        err_p99 = max_err(logits["serve_p99"].cpu(), want)
        check(torch.allclose(logits["serve_p99"].cpu(), want, rtol=1e-4, atol=1e-4),
              f"serve_p99 logits != the CPU forward: max |err| {err_p99}")
        want = M.deepfm_logits(model, fields["serve_bulk"], bag=E.embedding_bag_plain)
        err_bulk = max_err(logits["serve_bulk"], want)
        check(torch.allclose(logits["serve_bulk"], want, rtol=1e-5, atol=1e-5),
              f"serve_bulk logits != the forward through plain bags: max |err| {err_bulk}")
        print(f"[deepfm] serve_p99 B={fields['serve_p99'].shape[0]}: 2 bag launches, "
              f"max |err| vs the CPU forward {err_p99:.3g} (tol 1e-4); serve_bulk "
              f"B={fields['serve_bulk'].shape[0]}: 2 bag launches, max |err| vs the card "
              f"forward through plain bags {err_bulk:.3g} (tol 1e-5)", flush=True)

        user = fields["serve_p99"][0]
        cands = torch.randint(0, FIELD_VOCABS[ITEM_FIELD], (RETRIEVAL_CANDIDATES,),
                              generator=gen, device="cuda", dtype=torch.int32)
        scores, counts = counted(lambda: retrieval_step(model, user, cands, ITEM_FIELD))
        check(counts == want_launches, f"retrieval_cand: launches {counts}")
        check(scores.shape == (RETRIEVAL_CANDIDATES,) and bool(torch.isfinite(scores).all()),
              "retrieval_cand: scores not finite of shape (N,)")
        pick = torch.randperm(RETRIEVAL_CANDIDATES, generator=gen, device="cuda")
        pick = pick[:RETRIEVAL_CHECKED]
        want = retrieval_by_candidate(model, user, cands[pick], ITEM_FIELD)
        err_ret = max_err(scores[pick], want)
        check(torch.allclose(scores[pick], want, rtol=1e-4, atol=1e-4),
              f"retrieval_cand != per-candidate DeepFM: max |err| {err_ret}")
        print(f"[deepfm] retrieval_cand: {RETRIEVAL_CANDIDATES} candidates of field "
              f"{ITEM_FIELD}, 2 bag launches; {RETRIEVAL_CHECKED} re-scored one by one, "
              f"max |err| {err_ret:.3g} (tol 1e-4)", flush=True)
    return {"model": model, "fields": fields, "flat": flat, "user": user, "cands": cands,
            "weights": w, "launches": {"embedding_bag": launches["serve_bulk"]}}


def bound_bag(table, idx, weights):
    """Bag sum: each distinct table row the bags touch read once, the
    indices (and weights) read once, the (B, D) f32 output written once; an
    add (and a multiply) per gathered element.  Returns the bound and the
    byte counts: all gathered rows, the distinct rows (useful bytes), and
    the distinct 32-byte sectors those rows cover."""
    import torch

    D, (B, K) = table.shape[1], idx.shape
    row_bytes = D * table.element_size()
    rows = torch.unique(idx).long()
    io = idx.numel() * 4 + (0 if weights is None else weights.numel() * 4) + B * D * 4
    first = rows * row_bytes // 32
    last = (rows * row_bytes + row_bytes - 1) // 32
    span = int((last - first).max()) + 1
    sectors = torch.unique(torch.cat([torch.minimum(first + s, last) for s in range(span)]))
    useful = rows.numel() * row_bytes
    ops = B * K * D * (1 if weights is None else 2)
    return _bound(useful + io, ops), {
        "distinct_rows": rows.numel(), "gathered_row_bytes": B * K * row_bytes,
        "useful_row_bytes": useful, "index_weight_output_bytes": io,
        "sector_bytes": sectors.numel() * 32,
        "sector_bound_ms": (sectors.numel() * 32 + io) / HBM_BYTES_PER_S * 1e3,
    }


def median_ms(fn, n: int = 5):
    """Median and all of n host-clock times (ms) of fn() + synchronize."""
    import torch

    took = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        took.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(took), took


def timing_deepfm(state: dict, errs: dict) -> list:
    """The bag kernel per launch at serve_bulk (the forward's two bags: D =
    10 and D = 1, unweighted; D = 10 weighted besides), beside its plain
    version, its bound and one `torch.nn.functional.embedding_bag` call;
    then the medians of 5 warm forwards and retrieval sweeps, and a profile
    of one serve_bulk forward.  The kernels line carries the D = 10 bag."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.deepfm import retrieval_step, serve_step
    from repro_torch.hopper import embedding_bag as E

    model, flat, w = state["model"], state["flat"], state["weights"]
    V = model.embed.shape[0]
    records = {}
    with torch.inference_mode():
        for what, table, weights in (("D=10", model.embed, None),
                                     ("D=1", model.linear.view(V, 1), None),
                                     ("D=10 weighted", model.embed, w)):
            def library(table=table, weights=weights):
                return F.embedding_bag(flat, table, mode="sum", per_sample_weights=weights)

            check(torch.allclose(library(), E.embedding_bag(table, flat, weights),
                                 rtol=1e-5, atol=1e-5),
                  f"torch.nn.functional.embedding_bag disagrees with the bag ({what})")
            library_ms = time_ms(library, cold=True)
            timing = time_pair(lambda: E.embedding_bag(table, flat, weights),
                               lambda: E.embedding_bag_plain(table, flat, weights))
            bound, extra = bound_bag(table, flat, weights)
            print(f"[timing] embedding_bag {what} at serve_bulk {tuple(flat.shape)}: "
                  f"{json.dumps(extra)}", flush=True)
            records[what] = record("embedding_bag", state["launches"], errs, timing, bound,
                                   library_ms)

        for shape, batch in state["fields"].items():
            med, took = median_ms(lambda: serve_step(model, batch))
            print(f"[timing] warm forward, {shape} (B={batch.shape[0]}): median {med:.3f} ms "
                  f"of {[round(x, 3) for x in took]}", flush=True)
        med, took = median_ms(lambda: retrieval_step(model, state["user"], state["cands"],
                                                     ITEM_FIELD))
        print(f"[timing] warm retrieval sweep, retrieval_cand ({state['cands'].numel()} "
              f"candidates): median {med:.3f} ms of {[round(x, 3) for x in took]}", flush=True)
        profile_call(lambda: serve_step(model, state["fields"]["serve_bulk"]),
                     "serve_bulk forward")
    return [records["D=10"]]


# --------------------------------------------------------------------------
# DeepFM training
# --------------------------------------------------------------------------

# tests/test_recsys.py:74, test_training_reduces_loss's optimizer
RECSYS_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=100, weight_decay=0.0)
TRAIN_STEPS = 20
# test_training_reduces_loss's model and batch (tests/test_recsys.py:70-73)
LOOP_VOCABS, LOOP_DIM, LOOP_MLP, LOOP_BATCH = tuple([32] * 10), 8, (32,), 256
TRAIN_DIR = ROOT / "build" / "train"
HOT_FIELD = 38      # FIELD_VOCABS' 16-row field: 4,096 slots a row at B = 65,536
TRAIN_TOL = 1e-6    # the card's step against the step through plain bags


def bound_bag_backward(n_rows: int, grad_out, idx, weights, extra=None):
    """Bag backward: the dense (n_rows, D) f32 gradient written once, the
    indices, weights, grad_out and the gather's gradient `extra` read once;
    an add (and a multiply, and the gather term's add) per slot and
    element."""
    (B, K), D = idx.shape, grad_out.shape[1]
    nbytes = n_rows * D * 4 + idx.numel() * 4 + grad_out.numel() * 4 + (
        0 if weights is None else weights.numel() * 4) + (0 if extra is None else extra.numel() * 4)
    ops = B * K * D * (1 + (weights is not None) + (extra is not None))
    return _bound(nbytes, ops)


def hold_slot_plan(idx, n_rows: int, what: str) -> None:
    """`sort_slots` (CUB on the card) equal to `sort_slots_plain` in every
    array up to its run count."""
    import torch
    from repro_torch.hopper import embedding_bag as E

    got, want = E.sort_slots(idx, n_rows), E.sort_slots_plain(idx, n_rows)
    n_runs = int(want.n_runs)
    same = (torch.equal(got.n_runs, want.n_runs) and torch.equal(got.rows, want.rows)
            and torch.equal(got.order, want.order)
            and torch.equal(got.run_rows[:n_runs], want.run_rows[:n_runs])
            and torch.equal(got.starts[:n_runs + 1], want.starts[:n_runs + 1]))
    check(same, f"sort_slots != sort_slots_plain ({what})")


def backward_cases(model, flat, B: int, D: int, gen) -> tuple:
    """Phase 11 (a)'s cases, (what, grad_out, indices, weights, extra,
    n_rows), and the train_batch inputs they draw on (weights, the gather's
    gradient, grad_out per D).  train_batch's slots at D = 10 and 1,
    unweighted and weighted, with the gather's gradient; every slot in the
    16-row field; the dense write's edges: the first and last rows touched
    and untouched, row counts that are no multiple of a CTA's rows, every
    slot in one row, no slots, no rows."""
    import torch
    from repro_torch.configs import deepfm as C
    from repro_torch.hopper import embedding_bag as E

    V = model.embed.shape[0]
    w = torch.rand(flat.shape, generator=gen, device="cuda")
    x = torch.randn(flat.shape + (D,), generator=gen, device="cuda")
    grads_out = {d: torch.randn((B, d), generator=gen, device="cuda") for d in (D, 1)}
    hot = model.offsets[HOT_FIELD] + torch.randint(
        0, C.FIELD_VOCABS[HOT_FIELD], flat.shape, generator=gen, device="cuda", dtype=torch.int32)
    ends = flat.clone()
    ends[0, 0], ends[-1, -1] = 0, V - 1
    inner = flat.clamp(1, V - 2)
    R10, R1 = E.dense_rows(D), E.dense_rows(1)     # a dense-write CTA's rows
    small = torch.randint(0, 3 * R10 + 5, (512, 39), generator=gen, device="cuda",
                          dtype=torch.int32)
    g10 = grads_out[D]
    cases = [(f"D={d}, {'random weights' if wt is not None else 'unweighted'}"
              f"{', gather term' if xt is not None else ''}", grads_out[d], flat, wt, xt, V)
             for d in (D, 1) for wt in (None, w) for xt in ((None, x) if d == D else (None,))]
    cases += [
        (f"every slot in the {C.FIELD_VOCABS[HOT_FIELD]}-row field, D={D}, random weights, "
         "gather term", g10, hot, w, x, V),
        (f"rows 0 and {V - 1} touched, D={D}, gather term", g10, ends, None, x, V),
        (f"rows 0, 1, {V - 2} and {V - 1} untouched, D={D}", g10, inner, w, None, V),
        (f"every slot in row {V // 2}, D={D}, gather term", g10,
         torch.full_like(flat, V // 2), None, x, V),
        (f"{3 * R10 + 5} rows (3 CTAs of {R10} and 5), D={D}",
         g10[:512], small, w[:512], x[:512], 3 * R10 + 5),
        (f"{3 * R1 + 5} rows (3 CTAs of {R1} and 5), D=1",
         grads_out[1][:512], small, None, None, 3 * R1 + 5),
        (f"no slots, D={D}", g10[:0], flat[:0], None, x[:0], V),
        (f"no slots, D={D}", g10[:512], flat[:512, :0], None, None, 1000),
        ("no rows, no slots", g10[:0], flat[:0], None, None, 0),
    ]
    return cases, {"weights": w, "extra": x, "grads_out": grads_out}


def phase_train(errs: dict) -> dict:
    """DeepFM training at the full CONFIG and train_batch (B = 65,536):
    (a) the bag's backward kernel against its plain version, bit for bit,
    and twice on one input, and the slot plan against its plain version;
    (b) one `train_step` with the launch counts set to 0 just before it,
    against the same step through both plain bags; (c) 20 steps timed by
    CUDA events, a profile, the backward kernel's per-launch times; (d)
    the TrainLoop on the card."""
    import torch
    from repro_torch.configs import deepfm as C
    from repro_torch.data.pipeline import ClickStream
    from repro_torch.hopper import embedding_bag as E
    from repro_torch.models import deepfm as M
    from repro_torch.train import adamw_init

    t0 = time.perf_counter()
    B = C.SHAPES["train_batch"]["batch"]
    model = M.DeepFM(C.CONFIG, seed=0, device="cuda")
    V, D = model.embed.shape
    stream = ClickStream(C.FIELD_VOCABS, B, seed=0)
    fields, labels = (torch.from_numpy(a).cuda() for a in stream.batch_at(0))
    flat = fields + model.offsets[None, :]
    print(f"[train] CONFIG {V} rows, d={D}, {C.CONFIG.param_count()} parameters, "
          f"train_batch B={B} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # (a) the backward kernel at train_batch's bag shapes and the dense write's edges
    gen = torch.Generator(device="cuda").manual_seed(23)
    cases, inputs = backward_cases(model, flat, B, D, gen)
    for what, g, idx, wt, xt, n_rows in cases:
        t1 = time.perf_counter()
        hold_slot_plan(idx, n_rows, what)
        launches = E.embedding_bag_backward.launches
        got = E.embedding_bag_backward(g, idx, wt, n_rows, extra=xt)
        again = E.embedding_bag_backward(g, idx, wt, n_rows, extra=xt)
        check(E.embedding_bag_backward.launches - launches == (2 if got.numel() else 0),
              f"embedding_bag_backward launches ({what})")
        exact(errs, "embedding_bag_backward", got, again, f"{what}, two launches")
        del again
        exact(errs, "embedding_bag_backward", got,
              E.embedding_bag_backward_plain(g, idx, wt, n_rows, extra=xt), what)
        print(f"[train] (a) embedding_bag_backward {what}, {tuple(idx.shape)} slots into "
              f"{n_rows} rows: bit-equal to the plain version on the card and across two "
              f"launches, slot plan equal to the plain sort's ({time.perf_counter() - t1:.1f} s)",
              flush=True)
        del got
    del cases

    # (b) one full-width train step through the kernels, and through plain bags
    params = C.train_params(model)
    opt = adamw_init(params)
    sorts = E.sort_slots.calls
    before = step_memory_start()
    (p1, s1, loss), counts = counted(lambda: C.train_step(model, params, opt, fields, labels))
    STEP_PEAKS["deepfm train_batch"] = step_peak(before, (params, opt, fields, labels))
    sorts = E.sort_slots.calls - sorts
    want = {k: 0 for k in KERNELS}
    want.update(embedding_bag=2, embedding_bag_backward=2)
    check(counts == want, f"train_step: launches {counts}, expected {want}")
    check(sorts == 1, f"train_step: {sorts} slot sorts, expected 1")
    check(bool(torch.isfinite(loss)), f"train_step: loss {float(loss)}")
    pp, ps, ploss = C.train_step(model, params, opt, fields, labels, bag=E.embedding_bag_plain)
    err = max(max_err(a, b) for part, plain in ((p1, pp), (s1.m, ps.m), (s1.v, ps.v))
              for a, b in ((part[k], plain[k]) for k in part))
    check(err <= TRAIN_TOL and abs(float(loss) - float(ploss)) <= TRAIN_TOL,
          f"train_step through the kernels != through plain bags: max |err| {err}")
    parents = table_parents(model, params, fields, labels)
    check(parents == {"embed": ["_BagBackward"], "linear": ["ViewBackward0"]},
          f"train_step: the tables' gradient nodes {parents}")
    print(f"[train] (b) train_step: launches {counts}, {sorts} slot sort; loss {float(loss):.6f}; "
          f"every parameter and moment within {err:.3g} of the step through plain bags (tol "
          f"{TRAIN_TOL}), loss {abs(float(loss) - float(ploss)):.3g}; the tables' gradient "
          f"nodes {parents}", flush=True)
    del p1, s1, pp, ps
    torch.cuda.synchronize()
    return {"model": model, "params": params, "stream": stream, "fields": fields,
            "labels": labels, "flat": flat, "launches": counts, **inputs}


def table_parents(model, params, fields, labels) -> dict:
    """The autograd nodes that feed each table's gradient in the step's
    graph: the bag's Function alone for `embed` (the gather's gradient goes
    through it), a view of it for `linear`; no IndexBackward0."""
    import torch
    from repro_torch.models import deepfm as M

    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    logits = torch.func.functional_call(model, leaves, (fields,))
    seen, todo = {}, [M.bce_with_logits(logits, labels).grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and id(node) not in seen:
            seen[id(node)] = node
            todo.extend(nxt for nxt, _ in node.next_functions)
    check(not any(type(n).__name__ == "IndexBackward0" for n in seen.values()),
          "train_step: an IndexBackward0 in the step's graph")
    return {k: sorted(type(n).__name__ for n in seen.values() if any(
        getattr(nxt, "variable", None) is leaves[k] for nxt, _ in n.next_functions))
        for k in ("embed", "linear")}


def timing_train(state: dict, errs: dict) -> list:
    """(c) TRAIN_STEPS full-width steps with RECSYS_OPT, each split by CUDA
    events into forward (to the logits: a forward hook), backward (the rest
    of `loss_and_grads`) and optimizer (`adamw_update`), the two calls
    `train_step` makes; a profile of one step (one slot sort, no
    `index_put_`); the backward kernel per launch, sorting on its own and
    on the step's slot plan, beside its plain version, its bound and one
    `index_add_`; the slot plan alone."""
    import numpy as np
    import torch
    from repro_torch.configs import deepfm as C
    from repro_torch.hopper import embedding_bag as E
    from repro_torch.train import OptConfig, adamw_init, adamw_update

    model, stream = state["model"], state["stream"]
    opt_cfg = OptConfig(**RECSYS_OPT)
    params = state["params"]
    opt = adamw_init(params)
    batches = [tuple(torch.from_numpy(a).cuda() for a in stream.batch_at(i))
               for i in range(TRAIN_STEPS)]
    marks = []
    hook = model.register_forward_hook(lambda *_: marks[-1][1].record())
    losses = []
    extra_host = state.pop("extra").cpu()   # (B, K, 10) f32, off the card while steps run
    torch.cuda.reset_peak_memory_stats()
    for fields, labels in batches:
        marks.append([torch.cuda.Event(enable_timing=True) for _ in range(4)])
        marks[-1][0].record()
        loss, grads = C.loss_and_grads(model, params, fields, labels)
        marks[-1][2].record()
        params, opt, _ = adamw_update(opt_cfg, grads, opt, params)
        marks[-1][3].record()
        losses.append(loss)
        del grads
    torch.cuda.synchronize()
    hook.remove()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"train: losses not finite: {losses}")
    parts = {name: statistics.median(m[i].elapsed_time(m[j]) for m in marks)
             for name, i, j in (("step", 0, 3), ("forward", 0, 1), ("backward", 1, 2),
                                ("optimizer", 2, 3))}
    print(f"[train] (c) {TRAIN_STEPS} steps at train_batch, OptConfig({RECSYS_OPT}): "
          f"losses {[round(x, 6) for x in losses]}", flush=True)
    print(f"[train] (c) median ms per step {parts['step']:.3f}: forward {parts['forward']:.3f}, "
          f"backward {parts['backward']:.3f}, optimizer {parts['optimizer']:.3f} (CUDA events); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    fields, labels = batches[0]
    names, sorts = set(), E.sort_slots.calls
    profile_call(lambda: C.train_step(model, params, opt, fields, labels, opt_cfg=opt_cfg),
                 "train_batch step", names)
    sorts = E.sort_slots.calls - sorts
    put = sorted(k for k in names if "index_put" in k or "indexing_backward" in k)
    check(sorts == profile_call.calls and not put and "aten::sort" not in names,
          f"the profiled step ({profile_call.calls} calls): {sorts} slot sorts, "
          f"index_put ops {put}, aten::sort "
          f"{'aten::sort' in names}")
    print(f"[profile]   the step: {sorts} slot sort in {profile_call.calls} call(s), "
          f"no aten::sort, no index_put_ "
          f"(radix-sort kernels: {sorted(k for k in names if 'RadixSort' in k)})", flush=True)
    del batches, params, opt

    flat, w, x = state["flat"], state["weights"], extra_host.cuda()
    V = model.embed.shape[0]
    slots = E.sort_slots(flat, V)
    sort_ms = time_ms(lambda: E.sort_slots(flat, V), cold=True)
    torch_sort_ms = time_ms(lambda: torch.sort(flat.reshape(-1), stable=True), cold=True)
    clear_ms = time_ms(lambda: torch.empty((V, 10), device="cuda").zero_(), cold=True)
    print(f"[timing] embedding_bag_backward's parts at train_batch: the slot plan (sort_slots: "
          f"CUB radix sort of {flat.numel()} slots on {(V - 1).bit_length()} key bits, 32-bit "
          f"slots, run-length encoding, scan) {sort_ms:.4f} ms, once a step; a stable "
          f"torch.sort (64-bit slots, the form before) {torch_sort_ms:.4f} ms; a ({V}, 10) f32 "
          f"clear {clear_ms:.4f} ms (cold)", flush=True)
    records = {}
    for what, g, weights, extra, plan in (
            ("D=10", state["grads_out"][10], None, None, None),
            ("D=1", state["grads_out"][1], None, None, None),
            ("D=10 weighted", state["grads_out"][10], w, None, None),
            ("D=10 gather term", state["grads_out"][10], None, x, None),
            ("D=10 gather term, the step's plan", state["grads_out"][10], None, x, slots),
            ("D=1, the step's plan", state["grads_out"][1], None, None, slots)):
        (B, K), Dg = flat.shape, g.shape[1]
        idx = flat.reshape(-1)

        def library(g=g, weights=weights, extra=extra):
            terms = (g[:, None, :].expand(B, K, Dg) if weights is None
                     else weights[..., None] * g[:, None, :])
            if extra is not None:
                terms = terms + extra
            return torch.zeros((V, Dg), device="cuda").index_add_(0, idx, terms.reshape(-1, Dg))

        def kernel(g=g, weights=weights, extra=extra, plan=plan):
            return E.embedding_bag_backward(g, flat, weights, V, extra=extra, slots=plan)

        lib_err = max_err(library(), kernel())
        check(lib_err <= 1e-3, f"index_add_ disagrees with the bag backward ({what}): {lib_err}")
        library_ms = time_ms(library, cold=True)
        timing = time_pair(kernel, lambda: E.embedding_bag_backward_plain(
            g, flat, weights, V, extra=extra))
        print(f"[timing] embedding_bag_backward {what} at train_batch {tuple(flat.shape)}: "
              f"index_add_ max |err| {lib_err:.3g} (atomics, another order)", flush=True)
        records[what] = record("embedding_bag_backward", state["launches"], errs, timing,
                               bound_bag_backward(V, g, flat, weights, extra), library_ms)
    return [records["D=10"]]


def phase_train_loop() -> None:
    """(d) TrainLoop on the card at test_training_reduces_loss's config,
    checkpoints under build/train/: the loss falls over 60 steps; 25
    straight steps equal 20, a fresh loop's restore and 5 more, bit for
    bit; a failure at step 13 is retried and the run completes."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import deepfm as C
    from repro_torch.data.pipeline import ClickStream
    from repro_torch.models import deepfm as M
    from repro_torch.train import LoopConfig, OptConfig, TrainLoop, adamw_init
    from repro_torch.train import tree as T

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    cfg = M.DeepFMConfig(field_vocabs=LOOP_VOCABS, embed_dim=LOOP_DIM, mlp_dims=LOOP_MLP)
    opt_cfg = OptConfig(**RECSYS_OPT)

    def make_loop(name: str) -> TrainLoop:
        model = M.DeepFM(cfg, seed=0, device="cuda")
        params = C.train_params(model)

        def step_fn(state, batch):
            params, opt, loss = C.train_step(model, *state, *batch, opt_cfg=opt_cfg)
            return (params, opt), {"loss": loss}

        return TrainLoop(step_fn, (params, adamw_init(params)),
                         ClickStream(cfg.field_vocabs, LOOP_BATCH, seed=0),
                         LoopConfig(ckpt_dir=str(TRAIN_DIR / name), checkpoint_every=10,
                                    log_path=str(TRAIN_DIR / f"{name}.jsonl")), device="cuda")

    t0 = time.perf_counter()
    make_loop("fall").run(60)
    losses = [json.loads(ln)["loss"] for ln in (TRAIN_DIR / "fall.jsonl").read_text().splitlines()
              if "loss" in ln]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(len(losses) == 60 and last < first - 0.01,
          f"TrainLoop: loss {first:.4f} -> {last:.4f} over 60 steps")
    straight = make_loop("straight")
    straight.run(25)
    make_loop("resumed").run(20)
    resumed = make_loop("resumed")
    check(resumed.start_step == 20, f"TrainLoop resumed at {resumed.start_step}, not 20")
    resumed.run(5)
    pairs = list(zip(T.leaves(straight.state), T.leaves(resumed.state)))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    check(differ == 0, f"TrainLoop: 25 straight steps != 20 + restore + 5 in {differ} of "
                       f"{len(pairs)} leaves")
    armed = {"on": True}

    def fail_hook(step):
        if step == 13 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated node loss")

    res = make_loop("failure").run(30, fail_hook=fail_hook)
    check(res["recoveries"] >= 1 and res["final_step"] == 29
          and np.isfinite(res["metrics"]["loss"]), f"TrainLoop failure run: {res}")
    print(f"[train] (d) TrainLoop ({len(LOOP_VOCABS)} fields of {LOOP_VOCABS[0]}, d={LOOP_DIM}, "
          f"MLP {LOOP_MLP}, B={LOOP_BATCH}): loss {first:.4f} -> {last:.4f} over 60 steps; "
          f"25 straight steps == 20 + restore + 5, bitwise in all {len(pairs)} leaves; a "
          f"failure at step 13 recovered ({res['recoveries']} retry), final step "
          f"{res['final_step']} ({time.perf_counter() - t0:.1f} s)", flush=True)


# --------------------------------------------------------------------------
# the batched and dynamic routes, and the plan cache's disk layer
# --------------------------------------------------------------------------

SERVE_SCALE, SERVE_REQUESTS, SERVE_BATCH = 1024, 64, 16   # serve_throughput, not quick
G2_MEMBER = (522, 522)          # four of these hold G2's 1,089,936 vertices
DELTA_FRACS = (0.002, 0.01, 0.05)   # of G2's undirected edges, as dyngraph_bench
SMALL_FRAC = 0.01               # repair takes strictly fewer rounds than cold here


def serving_mix():
    """The reference's non-quick serving mix (benchmarks/serve_throughput.py
    `_request_mix(64, 1024, seed=16)`): grid2d(128, 8), powerlaw(1024, 4),
    erdos_renyi(1024, 6), erdos_renyi(512, 3), cycled, seeds 16, 17, ..."""
    from repro_torch.graphs import erdos_renyi, grid2d, powerlaw

    s = SERVE_SCALE
    makers = [lambda k: grid2d(s // 8, 8, seed=k, device="cuda"),
              lambda k: powerlaw(s, avg_deg=4.0, seed=k, device="cuda"),
              lambda k: erdos_renyi(s, avg_deg=6.0, seed=k, device="cuda"),
              lambda k: erdos_renyi(s // 2, avg_deg=3.0, seed=k, device="cuda")]
    return [makers[i % 4](SERVE_BATCH + i // 4) for i in range(SERVE_REQUESTS)]


def batch_launches(results, counts: dict, label: str) -> None:
    """A `solve_many` run's launches: a batch with a partition runs the
    split SpMV on its dense half once a round, one without it the fused
    SpMV; every kernel the run's batches take was launched, no other."""
    want = set()
    for r in results:
        if r.placement == "batched":
            want.add("tc_spmv" if ".h" in r.stats["bucket"] else "tc_spmv_fused")
    got = {k for k, v in counts.items() if v and k != "threefry"}
    check(got == want, f"{label}: kernels launched {got}, expected {want}")


def hold_batch_kernels(batch, options, errs: dict, what: str) -> None:
    """Every MIS kernel on a batch's round-1 inputs, with the column flags
    its `col_gate` zeroes, against its plain version: candidates from the
    plain `tiled_ref` round, alive = `alive0`."""
    import torch
    from repro_torch.core.tc_mis import _setup
    from repro_torch.core.tiling import pack_frontier_words, pack_priority_planes
    from repro_torch.hopper import tc_neighbor_max as N
    from repro_torch.hopper import tc_spmv as K

    opts = dataclasses.replace(options, engine="tiled_ref", hybrid="off")
    t = dataclasses.replace(batch.tiled, partition=None)
    engine, ctx, pri, state = _setup(batch.g, t, None, opts, batch.priorities,
                                     batch.alive0, batch.col_gate, True)
    alive = state.alive
    cand = engine.phase1_candidates(ctx, pri, alive)
    flags = engine.col_flags(ctx, cand).contiguous()
    check(int(flags.sum()) <= int(batch.col_gate.sum()) < t.n_block_cols,
          f"{what}: col_gate gates no column")
    T = t.tile_size
    rhs = engine._pack_rhs(ctx, cand, alive)
    exact(errs, "tc_spmv_fused", K.tc_spmv_fused(t, rhs, cand, alive, col_flags=flags),
          K.tc_spmv_fused_plain(t, rhs, cand, alive, col_flags=flags), what)
    exact(errs, "tc_spmv", K.tc_spmv(t, rhs, col_flags=flags),
          K.tc_spmv_plain(t, rhs, col_flags=flags), what)
    exact(errs, "tc_neighbor_max", N.tc_neighbor_max(t, pri.select, alive),
          N.tc_neighbor_max_plain(t, pri.select, alive), what)
    cand_w, alive_w = pack_frontier_words(cand, T), pack_frontier_words(alive, T)
    exact(errs, "tc_spmv_bits", K.tc_spmv_bits(t, cand_w, col_flags=flags),
          K.tc_spmv_bits_plain(t, cand_w, col_flags=flags), what)
    exact(errs, "tc_spmv_fused_bits",
          K.tc_spmv_fused_bits(t, cand_w, alive_w, col_flags=flags),
          K.tc_spmv_fused_bits_plain(t, cand_w, alive_w, col_flags=flags), what)
    for key, n_bits, signed in ((pri.select, 31, False), (pri.resolve, 32, True)):
        planes = pack_priority_planes(key, T, n_bits, signed=signed)
        exact(errs, "tc_neighbor_max_bits",
              N.tc_neighbor_max_bits(t, planes, alive_w, signed=signed),
              N.tc_neighbor_max_bits_plain(t, planes, alive_w, signed=signed), what)
    torch.cuda.synchronize()
    print(f"[batched] {what}: six kernels exact against their plain versions on the "
          f"round-1 inputs, {int(flags.sum())} of {t.n_block_cols} block-columns active "
          f"({int(batch.col_gate.sum())} real)", flush=True)


def check_members(solver, results, label: str) -> None:
    """Each member's MIS and rounds equal its solo solve under its own
    request key, and it is a valid MIS of its plan graph."""
    import numpy as np
    import torch
    from repro_torch.core.validate import is_valid_mis

    for i, r in enumerate(results):
        solo = solver.solve(r.plan, key=solver.request_key(r.plan))
        check(solo.rounds == r.rounds and np.array_equal(solo.in_mis, r.in_mis),
              f"{label}: member {i} differs from its solo solve "
              f"({r.rounds} rounds against {solo.rounds})")
        check(r.converged and is_valid_mis(r.plan.g, torch.from_numpy(r.in_mis_plan).cuda()),
              f"{label}: member {i} is not a valid MIS")


def phase_batched(g2, errs: dict) -> None:
    """The serving mix through `solve_many` in batches of 16, and four
    quarter-G2 members as one batch, each under the default options and
    `hybrid="off"` (the G2 batch with `phase1="tiled"` too)."""
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.graphs import grid2d
    from repro_torch.serve_mis.batcher import member_priorities, pack_batch

    mix = serving_mix()
    for label, opts in (("default", SolveOptions()), ("off", SolveOptions(hybrid="off"))):
        solver = Solver(opts, device="cuda")
        for b in range(0, SERVE_REQUESTS, SERVE_BATCH):
            graphs = mix[b: b + SERVE_BATCH]
            results, counts = counted(lambda: solver.solve_many(graphs))
            batch_launches(results, counts, f"serving mix {label}, batch {b // SERVE_BATCH}")
            check_members(solver, results, f"serving mix {label}, batch {b // SERVE_BATCH}")
            med, took = median_ms(lambda: solver.solve_many(graphs))
            groups = {}
            for r in results:
                groups.setdefault(r.stats.get("bucket", "solo"), []).append(r.rounds)
            print(f"[batched] serving mix {label}, batch {b // SERVE_BATCH} ({len(graphs)} "
                  f"requests, scale {SERVE_SCALE}): median {med:.3f} ms per batch, "
                  f"{med / len(graphs):.4f} ms per member, of "
                  f"{[round(x, 3) for x in took]}; groups {json.dumps(groups)}; "
                  f"launches { {k: v for k, v in counts.items() if v} }", flush=True)

    members = [grid2d(*G2_MEMBER, seed=s, device="cuda") for s in range(4)]
    check(sum(m.n_nodes for m in members) == g2.n_nodes, "G2 batch: vertex count")
    for label, opts, expect in (
            ("default", SolveOptions(), {"tc_spmv": 1}),
            ("off", SolveOptions(hybrid="off"), {"tc_spmv_fused": 1}),
            ("off tiled", SolveOptions(hybrid="off", phase1="tiled"),
             {"tc_neighbor_max": 2, "tc_spmv_fused": 1})):
        solver = Solver(opts, device="cuda")
        plans = [solver.plan(m) for m in members]
        if label != "off tiled":
            pris = [member_priorities(p, solver.request_key(p), opts.heuristic)
                    for p in plans]
            hold_batch_kernels(pack_batch(plans, pris), opts, errs, f"G2 batch, {label}")
        results, counts = counted(lambda: solver.solve_many(plans))
        rounds = max(r.rounds for r in results)
        want = {k: expect.get(k, 0) * rounds for k in KERNELS}
        # a fresh solver's priority cache misses: one draw a member
        want["threefry"] = sum(draw_launches(opts.heuristic, p.n_nodes) for p in plans)
        check(counts == want, f"G2 batch {label}: launches {counts}, expected {want}")
        check(all(r.placement == "batched" for r in results), f"G2 batch {label}: not batched")
        check_members(solver, results, f"G2 batch {label}")
        med, took = median_ms(lambda: solver.solve_many(plans))
        keys = [solver.request_key(p) for p in plans]
        solo_med, solo_took = median_ms(
            lambda: [solver.solve(p, key=k) for p, k in zip(plans, keys)])
        r0 = results[0]
        print(f"[batched] G2 batch {label} (4 x grid2d{G2_MEMBER}, T={r0.plan.tile_size} "
              f"{r0.plan.storage}, bucket {r0.stats['bucket']}): rounds "
              f"{[r.rounds for r in results]}, mis {[r.mis_size for r in results]}; "
              f"median {med:.3f} ms per batch of {[round(x, 3) for x in took]} against "
              f"{solo_med:.3f} ms for the four solo solves of "
              f"{[round(x, 3) for x in solo_took]}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)


def same_tiling(a, b) -> bool:
    import torch

    if any(getattr(a, k) != getattr(b, k) for k in ("n_tiles", "n_block_rows", "storage")):
        return False
    if not all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("tiles", "tile_rows", "tile_cols", "row_starts")):
        return False
    pa, pb = a.partition, b.partition
    if (pa is None) != (pb is None):
        return False
    if pa is None:
        return True
    return ((pa.threshold, pa.n_dense_tiles, pa.n_sparse_tiles, pa.sp_nnz)
            == (pb.threshold, pb.n_dense_tiles, pb.n_sparse_tiles, pb.sp_nnz)
            and same_tiling(pa.dense, pb.dense)
            and all(torch.equal(x, y) for x, y in zip(
                (pa.tail_rows, pa.tail_cols, *pa.tail_bits),
                (pb.tail_rows, pb.tail_cols, *pb.tail_bits))))


def hold_cover_kernels(plan, options, prior, touched, errs: dict, what: str) -> None:
    """The covered pass's kernel on the full patched tiling, against its
    plain version: `tc_spmv` on the seed set as lane 0 (dense frontier) or
    `tc_spmv_bits` on its words (packed)."""
    import torch
    from repro_torch.core.engine import get_engine, resolve_frontier
    from repro_torch.core.tiling import pack_frontier_words, pack_vertex_vector
    from repro_torch.dyngraph.repair import dirty_mask
    from repro_torch.hopper import tc_spmv as K

    t = plan.tiled
    dirty = torch.from_numpy(dirty_mask(plan.n_nodes, touched)).cuda()
    seed = torch.from_numpy(plan.to_plan_ids(prior.in_mis).astype(bool)).cuda() & ~dirty
    padded = pack_vertex_vector(seed, t)
    frontier = resolve_frontier(options, get_engine(options.engine), storage=t.storage)
    if frontier == "bitwise":
        words = pack_frontier_words(padded, t.tile_size)
        exact(errs, "tc_spmv_bits", K.tc_spmv_bits(t, words), K.tc_spmv_bits_plain(t, words),
              what)
    else:
        rhs = torch.zeros((t.n_padded, options.lanes), dtype=torch.float32, device="cuda")
        rhs[:, 0] = padded.float()
        exact(errs, "tc_spmv", K.tc_spmv(t, rhs), K.tc_spmv_plain(t, rhs), what)
    torch.cuda.synchronize()


def phase_dynamic(g2, errs: dict) -> None:
    """`Solver.update` on G2: `random_delta` at 0.2, 1 and 5 % of the
    undirected edges on the default, `hybrid="off"` and packed paths with
    `repair="incremental"`, then a cold solve of the patched plan."""
    import numpy as np
    import torch
    from repro_torch.api import PlanCache, Solver, SolveOptions, patch_plan
    from repro_torch.core.tiling import attach_partition, build_block_tiles
    from repro_torch.core.validate import is_valid_mis
    from repro_torch.dyngraph import EdgeDelta, apply_graph_delta, random_delta

    n_und = g2.n_edges // 2
    deltas = {}
    for frac in DELTA_FRACS:
        k = int(n_und * frac) // 2
        t0 = time.perf_counter()
        deltas[frac] = random_delta(g2, n_add=k, n_remove=k, seed=int(frac * 1e4))
        print(f"[dynamic] delta {frac:.1%}: {k} adds + {k} removes, "
              f"{deltas[frac].touched().size} touched vertices "
              f"(drawn in {time.perf_counter() - t0:.1f} s)", flush=True)
    rebuilt = {}
    plans = PlanCache(tile_size=16, storage="bitpack", device="cuda")
    for label, opts, cover, expect in (
            ("default", SolveOptions(repair="incremental"), "tc_spmv", {"tc_spmv": 1}),
            ("off", SolveOptions(repair="incremental", hybrid="off"), "tc_spmv",
             {"tc_spmv_fused": 1}),
            ("packed", SolveOptions(repair="incremental", hybrid="off", phase1="tiled"),
             "tc_spmv_bits", {"tc_spmv_fused_bits": 1, "tc_neighbor_max_bits": 2})):
        solver = Solver(opts, device="cuda", plans=plans)
        plan = solver.plan(g2)
        prior = solver.solve(plan)
        # the repair draws the patched graph's priorities once
        draws = draw_launches(opts.heuristic, g2.n_nodes)
        same, counts = counted(lambda: solver.update(prior, EdgeDelta.make()))
        check(same.rounds == 0 and np.array_equal(same.in_mis, prior.in_mis)
              and counts == {k: int(k == cover) + draws * (k == "threefry") for k in KERNELS},
              f"dynamic {label}: an empty delta did not return the prior solution "
              f"after the covered pass alone (launches {counts})")
        for frac, delta in deltas.items():
            took = []
            for _ in range(3):
                t0 = time.perf_counter()
                patched = patch_plan(plan, delta)
                torch.cuda.synchronize()
                took.append((time.perf_counter() - t0) * 1e3)
            patch_ms = statistics.median(took)
            key = (plan.key, frac)
            if key not in rebuilt:
                t = build_block_tiles(apply_graph_delta(g2, delta), tile_size=16,
                                      storage="bitpack")
                if plan.hybrid != "off":
                    t = attach_partition(t, mode=plan.hybrid, threshold=plan.hybrid_threshold)
                rebuilt[key] = t
            check(same_tiling(patched.tiled, rebuilt[key]),
                  f"dynamic {label} {frac:.1%}: the patched tiling differs from a rebuild")
            cached, status = plans.apply_delta(plan, delta)
            check(same_tiling(cached.tiled, patched.tiled), f"dynamic {label}: cache patch")
            hold_cover_kernels(cached, opts, prior, delta.touched(), errs,
                               f"G2 {label} {frac:.1%} covered pass")
            rep, counts = counted(lambda: solver.update(prior, delta))
            want = {k: expect.get(k, 0) * rep.rounds + (k == cover) + draws * (k == "threefry")
                    for k in KERNELS}
            check(counts == want, f"dynamic {label} {frac:.1%}: launches {counts}, "
                                  f"expected {want}")
            check(rep.stats["repair"] == "incremental" and rep.stats["patch"] == "mem"
                  and rep.converged
                  and is_valid_mis(rep.plan.g, torch.from_numpy(rep.in_mis_plan).cuda()),
                  f"dynamic {label} {frac:.1%}: the repaired MIS is not valid")
            rep_ms, rep_took = median_ms(lambda: solver.update(prior, delta), 3)
            cold = solver.solve(rep.plan)
            check(cold.converged, f"dynamic {label}: cold solve did not converge")
            cold_ms, cold_took = median_ms(lambda: solver.solve(rep.plan), 3)
            if frac <= SMALL_FRAC:
                check(rep.rounds < cold.rounds,
                      f"dynamic {label} {frac:.1%}: repair took {rep.rounds} rounds, "
                      f"cold {cold.rounds}")
            print(f"[dynamic] G2 {label} {frac:.1%} (+{delta.n_add} -{delta.n_remove}, "
                  f"{status}): patch {patch_ms:.3f} ms (median of "
                  f"{[round(x, 3) for x in took]}, tiles {plan.tiled.n_tiles} -> "
                  f"{patched.tiled.n_tiles}); repair {rep_ms:.3f} ms of "
                  f"{[round(x, 3) for x in rep_took]}, {rep.rounds} rounds, mis "
                  f"{rep.mis_size}; cold {cold_ms:.3f} ms of "
                  f"{[round(x, 3) for x in cold_took]}, {cold.rounds} rounds, mis "
                  f"{cold.mis_size}; launches { {k: v for k, v in counts.items() if v} }",
                  flush=True)
            del patched, cached, rep, cold
        del solver, plan, prior


def phase_disk_cache(g2) -> None:
    """G2 planned into a temporary cache directory and loaded in a fresh
    cache: status "disk", every array equal."""
    import tempfile

    import torch
    from repro_torch.api import PlanCache

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        kw = dict(tile_size=16, storage="bitpack", cache_dir=d, device="cuda")
        t0 = time.perf_counter()
        a, st = PlanCache(**kw).plan(g2, hybrid="auto")
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        b, st2 = PlanCache(**kw).plan(g2, hybrid="auto")
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        check((st, st2) == ("built", "disk"), f"disk cache: statuses {st}, {st2}")
        check(same_tiling(a.tiled, b.tiled) and a.key == b.key
              and torch.equal(a.g.senders, b.g.senders)
              and torch.equal(a.g.receivers, b.g.receivers),
              "disk cache: the loaded plan differs from the built one")
        size = sum(f.stat().st_size for f in pathlib.Path(d).iterdir())
    print(f"[disk] G2 plan (T=16 bitpack, hybrid auto:{a.hybrid_threshold}): built and "
          f"written in {build_ms:.1f} ms, loaded by a fresh cache in {load_ms:.1f} ms "
          f"({size / 1e6:.1f} MB on disk); every array equal", flush=True)


# --------------------------------------------------------------------------
# the sharded route on a one-rank NCCL group
# --------------------------------------------------------------------------

SHARD_SPLIT = 4       # the slab check cuts G2 into this many rps x nbr_pad slabs
GIN_WIDTH = 64        # spmv_tiled's RHS width in GIN (d_hidden)


def round1_frontier(tiled, pri, n_padded: int):
    """G2's round-1 (cand, alive) over `n_padded` vertices (zero beyond the
    tiling's), H3 two-pass, with the plain phase ① a shard runs."""
    import torch
    from repro_torch.core.spmv import neighbor_max_tiled

    n = tiled.n_nodes
    pad = lambda x: torch.nn.functional.pad(x, (0, tiled.n_padded - n), value=-(1 << 30))
    select, resolve = pad(pri.select), pad(pri.resolve)
    alive = torch.arange(tiled.n_padded, device="cuda") < n
    pend = alive & (select >= neighbor_max_tiled(tiled, select, alive))
    cand = pend & (resolve > neighbor_max_tiled(tiled, resolve, pend))
    grow = lambda x: torch.nn.functional.pad(x, (0, n_padded - tiled.n_padded))
    return grow(cand), grow(alive)


def phase_sharded(g2, errs: dict) -> None:
    """`placement="sharded"` on G2 through a one-rank NCCL group, the
    split SpMV on each slab of a 4-way split, and the tiled wrappers."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import PlanCache, Solver, SolveOptions
    from repro_torch.core import distributed as D
    from repro_torch.core import prng
    from repro_torch.core.engine import block_col_flags
    from repro_torch.core.heuristics import make_priorities
    from repro_torch.core.spmv import neighbor_max_tiled, spmv_tiled
    from repro_torch.core.validate import is_valid_mis_checks
    from repro_torch.hopper import tc_neighbor_max as N
    from repro_torch.hopper import tc_spmv as K

    t_phase = time.perf_counter()
    plans = PlanCache(device="cuda")
    main_solver = Solver(SolveOptions(hybrid="off"), device="cuda", plans=plans)
    main_plan = main_solver.plan(g2)
    main = main_solver.solve(main_plan)
    main_ms, _ = median_ms(lambda: main_solver.solve(main_plan))

    # (a) the route, with and without packed gathers
    try:
        for bitpack in (True, False):
            solver = Solver(SolveOptions(placement="sharded", bitpack=bitpack), device="cuda",
                            plans=plans)
            plan = solver.plan(g2)
            res, counts = counted(lambda: solver.solve(plan))
            label = f"bitpack={bitpack}"
            check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                  f"[sharded] {label}: group {dist.get_backend()} of {dist.get_world_size()}")
            check(res.placement == "sharded" and res.stats["n_shards"] == 1
                  and res.stats["compile"] == "compiled" and res.converged,
                  f"[sharded] {label}: {res.placement} {res.stats}")
            check(plan.tile_size == 16 and plan.storage == "bitpack"
                  and plan.tiled.partition is not None,
                  f"[sharded] {label}: planned T={plan.tile_size} {plan.storage}")
            want = {k: res.rounds if k == "tc_spmv" else 0 for k in KERNELS}
            want["threefry"] = draw_launches(solver.options.heuristic, g2.n_nodes)
            check(counts == want, f"[sharded] {label}: launches {counts}, expected {want}")
            check(res.rounds == main.rounds and np.array_equal(res.in_mis, main.in_mis),
                  f"[sharded] {label}: MIS of {res.mis_size} in {res.rounds} rounds, the "
                  f"main path's {main.mis_size} in {main.rounds}")
            valid = is_valid_mis_checks(plan.g, torch.from_numpy(res.in_mis_plan).cuda())
            check(valid == (True, True), f"[sharded] {label}: (independent, maximal) {valid}")
            # (c) time: warm solves beside the main path's
            ms, took = median_ms(lambda: solver.solve(plan))
            print(f"[sharded] {label}: G2 MIS {res.mis_size} in {res.rounds} rounds, equal to "
                  f"the hybrid=\"off\" main path's; launches {counts['tc_spmv']} tc_spmv "
                  f"(once a round), {counts['threefry']} threefry (the draw), every other "
                  f"kernel 0; valid; warm solve median "
                  f"{ms:.3f} ms (of {[round(t, 3) for t in took]}) against the main path's "
                  f"{main_ms:.3f} ms", flush=True)

            # the round's parts on round-1 inputs of the one-rank slab (warm,
            # CUDA events): the plain phase ①, a gather, the split SpMV
            if bitpack:
                pri = make_priorities("h3", prng.key(0), g2.n_nodes, g2.degrees())
                sh1 = D.shard_tiled(plan.tiled, 1)
                slab = sh1.slab(0)
                check(slab.n_block_rows == slab.n_block_cols == plan.tiled.n_block_rows,
                      "[sharded] the one-rank slab is not square")
                cand, alive = round1_frontier(plan.tiled, pri, sh1.n_padded)
                sel = torch.nn.functional.pad(pri.select, (0, sh1.n_padded - g2.n_nodes),
                                              value=-(1 << 30))
                rhs = torch.zeros((sh1.n_padded, 8), device="cuda")
                rhs[:, 0], rhs[:, 1] = cand, alive
                flags = block_col_flags(cand, 16)
                parts = {
                    "phase1": time_ms(lambda: neighbor_max_tiled(slab, sel, alive), reps=10),
                    "gather_packed": time_ms(lambda: D.gather_bool(alive, 16, bitpack=True)),
                    "gather_bytes": time_ms(lambda: D.gather_bool(alive, 16, bitpack=False)),
                    "spmv": time_ms(lambda: K.tc_spmv(slab, rhs, col_flags=flags)),
                }
                n_gathers = 3 * res.rounds + 2
                shares = {
                    "phase1": 2 * res.rounds * parts["phase1"] / ms,
                    "gather": n_gathers * parts["gather_packed"] / ms,
                    "spmv": res.rounds * parts["spmv"] / ms,
                }
                print(f"[sharded] round parts, warm ms per call on round-1 inputs: "
                      f"{json.dumps({k: round(v, 4) for k, v in parts.items()})}; per solve "
                      f"(2 phase-1 maxes and 3 gathers a round, 2 gathers outside): shares of "
                      f"the {ms:.3f} ms solve {json.dumps({k: round(v, 3) for k, v in shares.items()})}",
                      flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    # (b) the split SpMV on each non-square slab of a 4-way split, on the
    # round-1 RHS over the global columns
    tiled = main_plan.tiled
    pri = make_priorities("h3", prng.key(0), g2.n_nodes, g2.degrees())
    sh = D.shard_tiled(tiled, SHARD_SPLIT)
    cand, alive = round1_frontier(tiled, pri, sh.n_padded)
    rhs = torch.zeros((sh.n_padded, 8), device="cuda")
    rhs[:, 0], rhs[:, 1] = cand, alive
    flags = block_col_flags(cand, 16)
    outs = []
    for s in range(SHARD_SPLIT):
        slab = sh.slab(s)
        check(slab.n_block_rows < slab.n_block_cols == sh.n_block_cols,
              f"[sharded] slab {s} is {slab.n_block_rows} x {slab.n_block_cols}")
        got = K.tc_spmv(slab, rhs, col_flags=flags)
        exact(errs, "tc_spmv", got, K.tc_spmv_plain(slab, rhs, col_flags=flags),
              f"slab {s} of {SHARD_SPLIT}, round-1 RHS")
        outs.append(got)
    whole = K.tc_spmv_plain(tiled, rhs[: tiled.n_padded].contiguous(),
                            col_flags=flags[: tiled.n_block_cols].contiguous())
    check(torch.equal(torch.cat(outs)[: tiled.n_padded], whole),
          "[sharded] the stacked slabs' SpMV differs from the whole tiling's")
    print(f"[sharded] split SpMV on the {SHARD_SPLIT} slabs of G2 ({sh.rows_per_shard} x "
          f"{sh.n_block_cols} blocks, real tiles {list(sh.shard_tiles)}, padded to "
          f"{sh.tiles.shape[1]}): exact against the plain version on lanes 0 (round-1 "
          f"candidates, {int(cand.sum())}) and 1 (alive), stacked equal to the whole tiling's",
          flush=True)
    del sh, outs, whole

    # (d) the tiled wrappers: spmv_tiled at GIN's width, neighbor_max_tiled
    gen = torch.Generator(device="cuda").manual_seed(GIN_WIDTH)
    h = torch.randn((tiled.n_padded, GIN_WIDTH), generator=gen, device="cuda")
    got = spmv_tiled(tiled, h, backend="pallas")
    want = spmv_tiled(tiled, h, backend="ref")
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"spmv_tiled(backend='pallas') at L={GIN_WIDTH}: max |err| {err}")
    errs["tc_spmv"] = max(errs.get("tc_spmv", 0.0), err)
    del want
    kern_ms = time_ms(lambda: spmv_tiled(tiled, h, backend="pallas"), reps=10)
    plain_ms = time_ms(lambda: spmv_tiled(tiled, h, backend="ref"), reps=3, warmup=1)
    del got, h
    alive = alive[: tiled.n_padded].contiguous()
    sel = torch.nn.functional.pad(pri.select, (0, tiled.n_padded - g2.n_nodes),
                                  value=-(1 << 30))
    exact(errs, "tc_neighbor_max", neighbor_max_tiled(tiled, sel, alive, backend="pallas"),
          N.tc_neighbor_max_plain(tiled, sel, alive), "neighbor_max_tiled on G2")
    print(f"[sharded] spmv_tiled(backend='pallas') on G2 at L={GIN_WIDTH}: max |err| {err:.3g} "
          f"(tol 1e-5), {kern_ms:.4f} ms warm against the plain version's {plain_ms:.4f}; "
          f"neighbor_max_tiled(backend='pallas') exact; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# --------------------------------------------------------------------------
# the serving front door: MISService, its CLI, the report CLI, the launcher
# --------------------------------------------------------------------------

# benchmarks/serve_throughput.py:56-63, not quick: its service config
SERVE_CFG = dict(tile_size=32, engine="fused_pallas", max_batch=SERVE_BATCH, seed=0)
SERVE_DIR = ROOT / "build" / "serve"
FIXTURES = [ROOT / "tests" / "fixtures" / f for f in ("tiny.mtx", "tiny.edges", "tiny.dimacs")]


def window_launches(responses, phase1: str, draws: int) -> dict:
    """The launches one service window must make: each batched group's
    loop runs the split SpMV (partitioned) or the fused SpMV once a round,
    with phase1="tiled" two dense maxes a round too (a batch's frontier is
    dense); a group's rounds are its slowest member's.  `draws` Threefry
    launches: one a member whose priorities missed the cache (H3)."""
    rounds = {}
    for r in responses:
        check(r.stats["bucket"] != "local", f"service request {r.id} was not batched")
        rounds[r.stats["bucket"]] = max(rounds.get(r.stats["bucket"], 0), r.rounds)
    want = {k: 0 for k in KERNELS}
    for bucket, n in rounds.items():
        want["tc_spmv" if ".h" in bucket else "tc_spmv_fused"] += n
        if phase1 == "tiled":
            want["tc_neighbor_max"] += 2 * n
    want["threefry"] = draws
    return want


def update_launches(plan, options, rounds: int) -> dict:
    """An incremental update's launches: the covered pass once, then per
    repair round the path's ② (split SpMV, or the split packed SpMV on the
    bitwise frontier) and its phase ① maxes (two under H3); the patched
    graph's priorities drawn once."""
    from repro_torch.core.engine import get_engine, resolve_frontier

    want = {k: 0 for k in KERNELS}
    bitwise = resolve_frontier(options, get_engine(options.engine),
                               storage=plan.storage) == "bitwise"
    want["tc_spmv_bits" if bitwise else "tc_spmv"] = rounds + 1
    if options.phase1 == "tiled":
        want["tc_neighbor_max_bits" if bitwise else "tc_neighbor_max"] = 2 * rounds
    want["threefry"] = draw_launches(options.heuristic, plan.n_nodes)
    return want


def wave_latency(hist, before) -> tuple:
    """p50 and p99 (bucket upper bounds) of the observations a histogram
    took since `before` = (bucket counts, count)."""
    from repro_torch.obs.metrics import Histogram

    w = Histogram("wave", hist.buckets)
    w.bucket_counts = [a - b for a, b in zip(hist.bucket_counts, before[0])]
    w.count, w.max = hist.count - before[1], hist.max
    return w.quantile(0.5), w.quantile(0.99)


def phase_serve_traffic() -> None:
    """(a) The reference's serving traffic through `MISService`: one cold
    and one warm wave of the 64-request mix on one service, with the
    segment and the tiled phase ①."""
    import numpy as np
    from repro_torch.api import Solver
    from repro_torch.obs import JsonlWriter
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve_mis import MISService, ServeConfig

    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    (SERVE_DIR / "traffic.jsonl").unlink(missing_ok=True)
    sink = JsonlWriter(str(SERVE_DIR / "traffic.jsonl"))
    mix = serving_mix()
    for phase1 in ("segment", "tiled"):
        cfg = ServeConfig(**SERVE_CFG, phase1=phase1)
        svc = MISService(cfg, device="cuda")
        fresh = Solver(cfg.solve_options(), device="cuda")
        hist = svc.metrics.histogram("service.latency_ms.batched")
        for wave in ("cold", "warm"):
            before = (list(hist.bucket_counts), hist.count)
            windows, launches = [], {k: 0 for k in KERNELS}
            t0 = time.perf_counter()
            for g in mix:
                svc.submit(g)
            while svc.pending:
                misses = obs_metrics.counter("batcher.priority_cache.misses").value
                out, counts = counted(svc.step)
                misses = obs_metrics.counter("batcher.priority_cache.misses").value - misses
                want = window_launches(out, phase1, misses)
                check(counts == want, f"serve {phase1} {wave} window {len(windows)}: launches "
                                      f"{counts}, expected {want}")
                windows.append(out)
                launches = {k: launches[k] + counts[k] for k in KERNELS}
            took = time.perf_counter() - t0
            responses = [r for w in windows for r in w]
            check(len(responses) == SERVE_REQUESTS and all(r.valid for r in responses),
                  f"serve {phase1} {wave}: a response is missing or invalid")
            if wave == "warm":
                check(all(r.stats["plan_cache"] == "mem" for r in responses),
                      f"serve {phase1}: a warm plan was not a memory hit")
            for w in windows:
                plans = [svc.planner.plan(mix[r.id % SERVE_REQUESTS])[0] for r in w]
                for r, s in zip(w, fresh.solve_many(plans)):
                    check(r.rounds == s.rounds and np.array_equal(r.in_mis, s.in_mis),
                          f"serve {phase1} {wave}: request {r.id} differs from solve_many")
            p50, p99 = wave_latency(hist, before)
            groups = sorted({r.stats["bucket"] for r in responses})
            print(f"[serve] traffic {phase1} {wave} wave: {len(responses)} requests in "
                  f"{took * 1e3:.3f} ms, {len(responses) / took:.1f} requests/s; "
                  f"service.latency_ms.batched p50 <= {p50} ms, p99 <= {p99} ms (bucket "
                  f"bounds); windows {[len(w) for w in windows]}, rounds per window "
                  f"{[max(r.rounds for r in w) for w in windows]}; buckets {groups}; launches "
                  f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        sink.write_metrics(svc.metrics_snapshot())   # read back by the report CLI in (c)
        del svc, fresh
    sink.close()


def write_edge_list(g, path) -> None:
    """`g` as a SNAP edge list, each undirected edge once."""
    import numpy as np

    s = g.senders[: g.n_edges].cpu().numpy()
    r = g.receivers[: g.n_edges].cpu().numpy()
    keep = s < r
    np.savetxt(path, np.stack([s[keep], r[keep]], 1), fmt="%d\t%d",
               header=f"grid2d{G2_SHAPE}: {g.n_nodes} vertices\nFromNodeId\tToNodeId")


def write_delta(delta, path) -> None:
    """A delta file: `+ u v` per added edge, `- u v` per removed one."""
    import numpy as np

    with open(path, "w") as f:
        np.savetxt(f, delta.add, fmt="+ %d %d")
        np.savetxt(f, delta.remove, fmt="- %d %d")


def phase_serve_g2(g2) -> tuple:
    """(b) G2 as a file through the service, plainly and streamed, one
    window, a 1 % update, a bad update and an unknown base, on the segment
    and the tiled phase ①; the fused validity check on G2."""
    import numpy as np
    import torch
    from repro_torch.api import Solver
    from repro_torch.core.validate import is_independent, is_maximal, is_valid_mis_checks
    from repro_torch.dyngraph import EdgeDelta, random_delta
    from repro_torch.graphs import grid2d
    from repro_torch.serve_mis import MISService, ServeConfig, load_graph

    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    edges, delta_path = SERVE_DIR / "g2.edges", SERVE_DIR / "g2_1pct.delta"
    t0 = time.perf_counter()
    write_edge_list(g2, edges)
    write_s = time.perf_counter() - t0
    k = int(g2.n_edges // 2 * SMALL_FRAC) // 2
    delta = random_delta(g2, n_add=k, n_remove=k, seed=int(SMALL_FRAC * 1e4))
    write_delta(delta, delta_path)
    t0 = time.perf_counter()
    parsed = load_graph(str(edges), device="cuda")
    torch.cuda.synchronize()
    parse_ms = (time.perf_counter() - t0) * 1e3
    check(parsed.n_nodes == g2.n_nodes and parsed.n_edges == g2.n_edges
          and torch.equal(parsed.senders, g2.senders)
          and torch.equal(parsed.receivers, g2.receivers), "G2's edge file parses to another graph")
    print(f"[serve] G2 edge file: {edges.stat().st_size / 1e6:.1f} MB written in {write_s:.1f} s, "
          f"parsed alone in {parse_ms:.1f} ms; 1 % delta {delta.n_add} adds + "
          f"{delta.n_remove} removes", flush=True)

    for phase1 in ("segment", "tiled"):
        cfg = ServeConfig(phase1=phase1)
        opts = cfg.solve_options()
        t0 = time.perf_counter()
        Solver(opts, device="cuda").plans.plan(parsed)     # a fresh cache: built
        torch.cuda.synchronize()
        plan_ms = (time.perf_counter() - t0) * 1e3
        svc = MISService(cfg, device="cuda")
        t0 = time.perf_counter()
        rid = svc.submit(str(edges))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        svc.submit(str(edges), stream=True)
        torch.cuda.synchronize()
        stream_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out, counts = counted(svc.step)
        step_ms = (time.perf_counter() - t0) * 1e3
        draws = draw_launches(opts.heuristic, g2.n_nodes)   # the twin request hits the cache
        check(len(out) == 2 and all(r.valid for r in out), f"serve G2 {phase1}: invalid response")
        check([r.stats["plan_cache"] for r in out] == ["built", "mem"],
              f"serve G2 {phase1}: plan layers {[r.stats['plan_cache'] for r in out]}")
        want = window_launches(out, phase1, draws)
        check(counts == want, f"serve G2 {phase1}: launches {counts}, expected {want}")
        plan = svc.planner.plan(parsed)[0]
        solo = svc.solver.solve(plan, key=svc.solver.request_key(plan))
        for r in out:
            check(r.rounds == solo.rounds and np.array_equal(r.in_mis, solo.in_mis),
                  f"serve G2 {phase1}: request {r.id} differs from its solo solve")

        uid = svc.submit_update(rid, delta)
        t0 = time.perf_counter()
        (upd,), counts = counted(svc.step)
        upd_ms = (time.perf_counter() - t0) * 1e3
        patched = svc.planner.apply_delta(plan, delta)[0]
        cold = svc.solver.solve(patched, key=svc.solver.request_key(patched))
        check(upd.valid and upd.stats["repair"] == "incremental" and upd.stats["base_id"] == rid,
              f"serve G2 {phase1}: update response {upd.stats}")
        check(upd.rounds < cold.rounds, f"serve G2 {phase1}: update took {upd.rounds} rounds, "
                                        f"cold {cold.rounds}")
        want = update_launches(patched, opts, upd.rounds)
        check(counts == want, f"serve G2 {phase1} update: launches {counts}, expected {want}")
        print(f"[serve] G2 {phase1} (T={plan.tile_size} {plan.storage}, hybrid "
              f"{plan.hybrid}:{plan.hybrid_threshold}): plan alone {plan_ms:.1f} ms (built in "
              f"a fresh cache); submit {plain_ms:.1f} ms (parse + plan "
              f"built), stream submit {stream_ms:.1f} ms (chunked parse + plan mem); one step "
              f"of both {step_ms:.1f} ms, {out[0].rounds} rounds, mis {out[0].mis_size}, "
              f"bucket {out[0].stats['bucket']}; 1 % update step {upd_ms:.1f} ms (solve "
              f"{upd.stats['solve_ms']:.3f} ms), {upd.rounds} rounds against cold "
              f"{cold.rounds}, mis {upd.mis_size}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)

        if phase1 == "segment":
            try:
                svc.submit_update(10 ** 9, delta)
                fail("serve G2: an update of an unknown id was accepted")
            except KeyError:
                pass
            non_edge = random_delta(g2, n_add=1, seed=7).add
            svc.submit_update(uid, EdgeDelta(add=np.zeros((0, 2), np.int64), remove=non_edge))
            svc.submit(grid2d(40, 40, device="cuda"))
            err, ok = svc.step()
            check(not err.valid and "not in the graph" in err.stats.get("error", "") and ok.valid,
                  "serve G2: a bad update did not give an error response beside a valid one")
            sol = solo.in_mis_plan
            none, full = np.zeros_like(sol), np.ones_like(sol)
            for mask, want in ((sol, (True, True)), (none, (True, False)), (full, (False, True))):
                t = torch.from_numpy(mask).cuda()
                check(is_valid_mis_checks(plan.g, mask) == want
                      == (is_independent(plan.g, t), is_maximal(plan.g, t)),
                      f"is_valid_mis_checks on G2 disagrees with the single checks ({want})")
            med, took = median_ms(lambda: is_valid_mis_checks(plan.g, sol))
            print(f"[serve] G2 validity check: {med:.3f} ms per response (median of "
                  f"{[round(x, 3) for x in took]}, numpy mask in, two bools out); an unknown "
                  f"base raised KeyError; a bad delta gave an error response beside a valid one",
                  flush=True)
        del svc, plan, solo, patched, cold, out, upd
    return edges, delta_path


def run_module(*args, timeout: int = 600):
    """`python -m <args>` from the repository root; returns the process."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=timeout)


def phase_serve_cli(edges, delta_path) -> None:
    """(c) The serving CLI as users run it, then the report CLI on its
    trace; (d) the synthetic-traffic launcher."""
    trace, prom = SERVE_DIR / "trace.jsonl", SERVE_DIR / "metrics.prom"
    empty = SERVE_DIR / "empty.jsonl"
    for f in (trace, prom):
        f.unlink(missing_ok=True)
    empty.write_text("")
    t0 = time.perf_counter()
    proc = run_module("repro_torch.serve_mis", "--once", "--repeat", "2", "--telemetry",
                      "--trace-path", str(trace), "--metrics-path", str(prom),
                      "--update", f"0:{delta_path}", str(edges), *map(str, FIXTURES))
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"serve_mis CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    check(len(lines) == 2 * (1 + len(FIXTURES)) + 1 and all(r["valid"] for r in lines),
          f"serve_mis CLI: {len(lines)} response lines, valid {[r['valid'] for r in lines]}")
    check(lines[-1].get("base_id") == 0, f"serve_mis CLI: the update line {lines[-1]}")
    text = prom.read_text()
    check("repro_service_requests_total" in text
          and "# TYPE repro_service_latency_ms_update histogram" in text,
          "serve_mis CLI: the promtext file lacks the service metrics")
    rep = run_module("repro_torch.obs", "report", str(trace))
    rep_json = run_module("repro_torch.obs", "report", "--json", str(trace))
    rep_empty = run_module("repro_torch.obs", "report", str(empty))
    check(rep.returncode == 0 and rep_json.returncode == 0 and rep_empty.returncode == 2,
          f"report CLI exit codes {rep.returncode}, {rep_json.returncode}, "
          f"{rep_empty.returncode} (expected 0, 0, 2)")
    counts = json.loads(rep_json.stdout)["counts"]
    check(counts.get("trace", 0) >= 1 and counts.get("rounds", 0) >= 1,
          f"report --json counts {counts}")
    rep_traffic = run_module("repro_torch.obs", "report", str(SERVE_DIR / "traffic.jsonl"))
    health = [l.strip() for l in rep_traffic.stdout.splitlines()
              if l.strip().startswith("service.latency_ms.batched")]
    check(rep_traffic.returncode == 0 and len(health) == 2,
          f"report CLI on phase (a)'s metrics records: exit {rep_traffic.returncode}")
    served = [l for l in proc.stderr.splitlines() if l.startswith("# served=")]
    g2_line = next(r for r in lines if r["source"] == str(edges))
    print(f"[serve] CLI --once --repeat 2 (G2 file + 3 fixtures, --update 0:1 %): exit "
          f"{proc.returncode} in {cli_s:.1f} s; {len(lines)} valid lines; G2 line rounds "
          f"{g2_line['rounds']} mis {g2_line['mis_size']} bucket {g2_line['bucket']} "
          f"execute_ms {g2_line.get('execute_ms')}; update line rounds {lines[-1]['rounds']} "
          f"repair {lines[-1]['repair']}; {served[-1] if served else 'no summary'}; "
          f"{len(text.splitlines())} promtext lines; report exit {rep.returncode}, --json "
          f"exit {rep_json.returncode} counts {counts}, empty file exit {rep_empty.returncode}",
          flush=True)
    for line in health:
        print(f"[serve] report of (a)'s metrics records (segment, then tiled): {line}",
              flush=True)
    for rec in json.loads(rep_json.stdout)["records"]:
        if rec["kind"] == "trace":
            spans = {}
            for sp in rec["spans"]:
                n, ms = spans.get(sp["name"], (0, 0.0))
                spans[sp["name"]] = (n + 1, ms + sp["dur_ms"])
            print(f"[serve] CLI trace {rec['request_id']}, ms by span (count): "
                  + ", ".join(f"{k} {ms:.3f} ({n})" for k, (n, ms) in spans.items()),
                  flush=True)

    t0 = time.perf_counter()
    proc = run_module("repro_torch.launch.serve_graphs", "--engine", "fused_pallas",
                      "--requests", "32", "--scale", "1024", "--waves", "3",
                      "--repeat-frac", "0.5")
    check(proc.returncode == 0, f"serve_graphs exited {proc.returncode}: {proc.stderr[-2000:]}")
    for line in proc.stdout.splitlines():
        print(f"[serve] serve_graphs: {line}", flush=True)
    print(f"[serve] serve_graphs: exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)


def phase_serve(g2) -> None:
    t0 = time.perf_counter()
    phase_serve_traffic()
    edges, delta_path = phase_serve_g2(g2)
    phase_serve_cli(edges, delta_path)
    print(f"[serve] phase 9: {time.perf_counter() - t0:.1f} s", flush=True)


# --------------------------------------------------------------------------
# phase 18: the hot-path lint, held on the card by a host-sync audit
# --------------------------------------------------------------------------

# the G2 runs of the audit: (label, SolveOptions keyword arguments, the
# Solver method): the three paths, then the main path's telemetry loop and
# its profiler twin, which reach the lint's other sanctioned sync sites
LINT_PATHS = (("default", {}, "solve"), ("main", {"hybrid": "off"}, "solve"),
              ("packed", {"hybrid": "off", "phase1": "tiled"}, "solve"),
              ("main telemetry", {"hybrid": "off", "telemetry": True}, "solve"),
              ("main profile", {"hybrid": "off"}, "profile"))


def lint_run() -> tuple:
    """(a): the lint of src/repro_torch in the process.  Returns the
    context and its findings."""
    import collections
    import contextlib
    import io

    from repro_torch.lint import load_universe, main as lint_main, run_rules

    port = ROOT / "src" / "repro_torch"
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lint_main([str(port)])
    summary = out.getvalue().strip().splitlines()[-1]
    check(rc == 0, f"repro_torch.lint exited {rc}: {summary}")
    ctx = load_universe([port])
    findings = run_rules(ctx)
    by_rule = collections.Counter(f.rule for f in findings if f.suppressed)
    print(f"[lint] (a) repro_torch.lint src/repro_torch: exit {rc}, {summary!r}; "
          f"hot set {len(ctx.graph.hot)} functions from {len(ctx.graph.seeds)} seeds, "
          f"round loops {sorted(ctx.graph.round_loops)}; suppressions by rule "
          f"{dict(sorted(by_rule.items()))} ({time.perf_counter() - t0:.2f} s)", flush=True)
    return ctx, findings


def audit_solve(solver, plan, method: str = "solve"):
    """One warm `solver.<method>(plan)` under the sync debug mode:
    (result, launches, recorded sync sites)."""
    import warnings

    import torch
    from repro_torch.lint.audit import SyncRecorder

    port = ROOT / "src" / "repro_torch"
    run = getattr(solver, method)
    run(plan)                                   # warm: kernels loaded, plan cached
    torch.cuda.synchronize()
    rec = SyncRecorder(port, skip=(port / "lint",))
    for w in wrappers().values():
        w.launches = 0
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = rec
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = run(plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if method == "profile":
        res = res[0]
    return res, {name: w.launches for name, w in wrappers().items()}, rec


def phase_lint(g2, plans) -> None:
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.lint.audit import GROUPS, UNACCOUNTED, classify_sites

    t0 = time.perf_counter()
    card = card_line()
    ctx, findings = lint_run()
    # the lint's own account of host syncs: RPT005 / RPT010 lines
    named = {(ctx.modules[f.module].path.resolve(), f.line)
             for f in findings if f.rule in ("RPT005", "RPT010")}
    reported = set()
    for label, kw, method in LINT_PATHS:
        solver = Solver(SolveOptions(**kw), device="cuda", plans=plans)
        plan = solver.plan(g2)
        res, counts, rec = audit_solve(solver, plan, method)
        check(res.converged, f"[lint] {label}: the audited solve did not converge")
        groups = classify_sites(ctx, rec.sites)
        n = len(rec.sites)
        sites = []
        for group in GROUPS:
            for (path, line), k in sorted(groups[group].items()):
                where = pathlib.Path(path)
                rel = where.relative_to(ROOT) if ROOT in where.parents else where
                key = (where.resolve(), line)
                reported.add(key)
                held = "card+lint" if key in named else "card"
                sites.append(f"{rel}:{line} x{k} {group} ({held})")
        print(f"[lint] (b) {label}: {n} syncs a solve over {res.rounds} rounds = "
              f"{n / max(res.rounds, 1):.2f} a round; by group "
              f"{ {g: sum(groups[g].values()) for g in GROUPS} }; launches "
              f"{ {k: v for k, v in counts.items() if v} }; sites: {'; '.join(sites)}; "
              f"other warnings {sorted(set(m[:120] for m in rec.others))}; {card}", flush=True)
        check(not groups[UNACCOUNTED],
              f"[lint] {label}: syncs in the hot set at lines the lint neither flags nor "
              f"suppresses: {sorted(groups[UNACCOUNTED])}")
    lint_only = sorted(f"{p.relative_to(ROOT) if ROOT in p.parents else p}:{ln}"
                       for p, ln in named - reported)
    print(f"[lint] (b) sites the lint names that the card did not report on these paths "
          f"(lint only: not run, or an explicit synchronize the mode does not see): "
          f"{lint_only}", flush=True)
    print(f"[lint] phase 18: {time.perf_counter() - t0:.1f} s; {card}", flush=True)


# --------------------------------------------------------------------------
# phase 12: the GNN family (GIN's tiled A x H, the train steps, the sampler)
# --------------------------------------------------------------------------

GNN_SEED = 0
GIN_TILES = (16, 32)
GIN_LANES = (1433, 64, 3)       # layer 1 (d_feat), layers 2-5 (d_hidden), an odd few
GIN_TOL = 1e-4                  # tiled against segment forward, scale-normalised
GNN_DESCENT_STEPS = 5           # the loss must fall over these, on one batch
GNN_TIMED_STEPS = 10
D2_SETS = 3                     # distance-2 vertex sets behind the full-mantissa RHS
GNN_CPU_TOL = 1e-4              # step 0's loss and leaf gradient norms, card against CPU
GNN_CPU_SEEDS = 128             # minibatch_lg's seeds in that comparison (of 1,024)
GNN_CPU_F64 = ("pna", "egnn")   # compared in f64: f32 gradients ill-conditioned (hold_to_cpu)


def gnn_graph(shape: dict, avg_deg: float):
    """The shape's stand-in: erdos_renyi(n, avg_deg, GNN_SEED) on the card."""
    from repro_torch.graphs.generators import erdos_renyi

    return erdos_renyi(shape["n_nodes"], avg_deg=avg_deg, seed=GNN_SEED, device="cuda")


def distance2_sets(g, count: int):
    """`count` greedy vertex sets (random orders from GNN_SEED) in which no
    vertex has two members as neighbours: a lane whose nonzeros lie on one
    such set puts at most one term in each output of A × rhs."""
    import numpy as np
    import torch
    from repro_torch.graphs.graph import build_csr

    indptr, indices = build_csr(g)
    rng = np.random.default_rng(GNN_SEED)
    sets = []
    for _ in range(count):
        member = np.zeros(g.n_nodes, bool)
        covered = np.zeros(g.n_nodes, bool)
        for u in rng.permutation(g.n_nodes):
            nb = indices[indptr[u]:indptr[u + 1]]
            if not covered[nb].any():
                member[u] = True
                covered[nb] = True
        sets.append(torch.from_numpy(member).cuda())
    return sets


def distance2_member(tiled, lanes: int, sets):
    """GIN's full-mantissa lanes: lane l on distance-2 set l mod len(sets)."""
    import torch

    n = sets[0].numel()
    member = torch.zeros((tiled.n_padded, lanes), dtype=torch.bool, device="cuda")
    for i, s in enumerate(sets):
        member[:n, i::len(sets)] = s[:, None]
    return member


def scale_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def phase_gin_kernel(g, feats, errs: dict) -> dict:
    """(a) the split SpMV at GIN's shapes against its plain version: on a
    full-mantissa RHS exactly, on the features (L = 1433) and randn lanes
    within phase 2's 1e-5; cold and warm ms beside the bound and one
    `sparse_bsr_tensor @ rhs`.  Returns the tilings by T."""
    import torch
    from repro_torch.core.tiling import build_block_tiles, dense_tile_mask
    from repro_torch.hopper import tc_spmv as K

    sets = distance2_sets(g, D2_SETS)
    print(f"[gnn] (a) full_graph_sm stand-in: n={g.n_nodes} half-edges={g.n_edges}; "
          f"distance-2 sets of {[int(s.sum()) for s in sets]} vertices", flush=True)
    tilings = {}
    for T in GIN_TILES:
        tiled = build_block_tiles(g, tile_size=T)
        tilings[T] = tiled
        nt = tiled.n_tiles
        bsr = torch.sparse_bsr_tensor(
            tiled.row_starts.long(), tiled.tile_cols[:nt].long(),
            dense_tile_mask(tiled.tiles[:nt], T).to(torch.float32),
            size=(tiled.n_padded, tiled.n_padded), check_invariants=True)
        flags = torch.ones(tiled.n_block_cols, dtype=torch.int32, device="cuda")
        for L in GIN_LANES:
            gen = torch.Generator(device="cuda").manual_seed(GNN_SEED + T + L)
            what = f"T={T}, L={L}"
            member = distance2_member(tiled, L, sets)
            full = full_mantissa_rhs(tiled, member, gen, f"GIN {what}")
            exact(errs, "tc_spmv", K.tc_spmv(tiled, full), K.tc_spmv_plain(tiled, full),
                  f"GIN {what}, full-mantissa RHS")
            if L == feats.shape[1]:
                rhs = torch.nn.functional.pad(feats, (0, 0, 0, tiled.n_padded - g.n_nodes))
            else:
                rhs = torch.randn((tiled.n_padded, L), generator=gen, device="cuda")
            got, want = K.tc_spmv(tiled, rhs), K.tc_spmv_plain(tiled, rhs)
            err = max_err(got, want)
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"split SpMV != plain at GIN {what}: max |err| {err}")
            errs["tc_spmv"] = max(errs["tc_spmv"], err)
            lib_err = max_err(bsr @ rhs, want)
            check(lib_err <= 1e-4, f"BSR library product disagrees at GIN {what}: {lib_err}")
            library_ms = time_ms(lambda: bsr @ rhs, cold=True)
            ms, plain_ms, (p1, k1, k2, p2), warm = time_pair(
                lambda: K.tc_spmv(tiled, rhs), lambda: K.tc_spmv_plain(tiled, rhs))
            bound_ms, by, nbytes, ops = bound_spmv(tiled, flags, L, False)
            print(f"[gnn] (a) tc_spmv GIN {what} ({tiled.n_tiles} tiles, {tiled.n_block_rows} "
                  f"block-rows, {-(-L // 8)} lane passes): exact on the full-mantissa RHS, "
                  f"max |err| {err:.3g} on {'the features' if L == feats.shape[1] else 'randn'}; "
                  f"kernel {k1:.4f}/{k2:.4f} ms cold (warm {warm:.4f}), plain {p1:.4f}/{p2:.4f} "
                  f"ms, sparse_bsr_tensor @ rhs {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                  f"{by} ({nbytes} B, {ops} ops)", flush=True)
        del bsr
    return tilings


def phase_gin_forward(g, feats, tilings: dict) -> None:
    """(a) GIN at gin-tu width (5 layers, d_hidden 64, n_out 7): the tiled
    forward, one split-SpMV launch a layer, against the segment forward;
    the tiled backend refuses to differentiate."""
    import torch
    from repro_torch.configs import gin_tu

    model = gin_tu._init(feats.shape[1], 7, seed=GNN_SEED, device="cuda")
    mask = g.edge_mask
    s, r = g.senders, g.receivers
    with torch.no_grad():
        h_seg, out_seg = model(feats, s, r, mask)
        seg_ms = time_ms(lambda: model(feats, s, r, mask), reps=10)
        for T, tiled in tilings.items():
            (h, out), launches = counted(
                lambda: model(feats, s, r, mask, tiled=tiled, backend="tiled"))
            others = {k: v for k, v in launches.items() if k != "tc_spmv" and v}
            check(launches["tc_spmv"] == gin_tu.N_LAYERS and not others,
                  f"GIN tiled forward T={T}: launches {launches}")
            err_h, err_out = scale_err(h, h_seg), scale_err(out, out_seg)
            check(err_h <= GIN_TOL and err_out <= GIN_TOL,
                  f"GIN tiled vs segment T={T}: scale-normalised {err_h:.3g}, {err_out:.3g}")
            tiled_ms = time_ms(lambda: model(feats, s, r, mask, tiled=tiled, backend="tiled"),
                               reps=10)
            print(f"[gnn] (a) GIN forward T={T} tiled: tc_spmv launches {launches['tc_spmv']} "
                  f"(one a layer), every other kernel 0; against the segment forward h "
                  f"{err_h:.3g}, logits {err_out:.3g} scale-normalised (tol {GIN_TOL}); "
                  f"{tiled_ms:.4f} ms warm against segment {seg_ms:.4f} ms", flush=True)
    try:
        model(feats, s, r, mask, tiled=tilings[GIN_TILES[0]], backend="tiled")
    except RuntimeError as e:
        check("no gradient" in str(e), f"GIN tiled under grad raised {e!r}")
    else:
        fail("GIN tiled backend returned a result with grad enabled")
    print("[gnn] (a) GIN tiled under grad: raises (no gradient through the launch)", flush=True)


@contextlib.contextmanager
def plain_draws():
    """Every `core.prng` draw through `threefry_bits_plain` on the card
    (torch ops there) in place of the kernel: the plain version's side of
    a comparison on a whole path."""
    import torch
    from repro_torch.core import prng
    from repro_torch.hopper import threefry as F

    def plain(k0, k1, n, device, mode="bits", **kw):
        out = torch.empty(n, dtype=torch.int32 if mode == "bits" else torch.float32,
                          device=device)
        return F.threefry_bits_plain(k0, k1, out, mode, **kw)

    kernel, prng.threefry_bits = prng.threefry_bits, plain
    try:
        yield
    finally:
        prng.threefry_bits = kernel


def phase_gnn_sampler(shape: dict):
    """(b) The minibatch_lg stand-in: erdos_renyi at Reddit's 232,965
    vertices and about its 114.6 M half-edges, the CSR by a stable sort on
    the card, one NeighborSampler sample and one cell tree of 1,024 seeds
    at fanout (15, 10) under one key: every masked-in child a CSR
    neighbour of its parent, and (e) both samples, whose draws the Threefry
    kernel makes, bit-equal to the same samples through the plain version
    on the card (`plain_draws`).  Returns (indptr, indices)."""
    import torch
    from repro_torch.configs import gnn_cells as C
    from repro_torch.core import prng
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.hopper import threefry as F

    t0 = time.perf_counter()
    g = gnn_graph(shape, shape["n_edges"] / shape["n_nodes"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(g, shape["fanout"])
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    n, indptr, indices = g.n_nodes, sampler.indptr, sampler.indices
    del g
    check(int(indptr[-1]) == indices.numel() and bool((indptr[1:] >= indptr[:-1]).all()),
          "device CSR: indptr not a running count of the indices")
    rows = torch.repeat_interleave(torch.arange(n, device="cuda"), indptr[1:] - indptr[:-1])
    keys = rows * n + indices
    del rows
    check(bool((keys[1:] > keys[:-1]).all()), "device CSR: rows not sorted and distinct")

    def neighbours(parent, child, mask) -> int:
        parent, child = parent[mask].long(), child[mask].long()
        want = parent * n + child
        at = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
        check(bool((keys[at] == want).all()), "a sampled vertex is not a neighbour of its parent")
        return int(mask.sum())

    gen = torch.Generator(device="cuda").manual_seed(GNN_SEED)
    B = shape["batch_nodes"]
    seeds = torch.randperm(n, generator=gen, device="cuda")[:B].to(torch.int32)
    key = prng.key(GNN_SEED)

    def sample():
        sub = sampler.sample(key, seeds)
        tree = C.minibatch_tree(indptr, indices, seeds,
                                C.minibatch_draws(key, B, shape["fanout"], "cuda"))
        return sub.layers + sub.masks, tree

    before = F.threefry_bits.launches
    sub, tree = sample()
    torch.cuda.synchronize()
    launches = F.threefry_bits.launches - before
    with plain_draws():
        plain = sample()
    check(launches == 2 * len(shape["fanout"]),
          f"[gnn] (e) {launches} threefry launches for the two samples, expected "
          f"{2 * len(shape['fanout'])}")
    check(all(torch.equal(x, y) for x, y in zip(sub + tree, plain[0] + plain[1])),
          "[gnn] (e) the samples from the key differ from the plain version's")
    del plain
    checked = 0
    half = len(sub) // 2
    for k in range(1, half):
        parent = sub[k - 1][..., None].expand(sub[k].shape)
        checked += neighbours(parent, sub[k], sub[half + k])
    ids, snd, rcv, emask = tree
    checked += neighbours(ids[rcv.long()], ids[snd.long()], emask)
    del keys
    print(f"[gnn] (b) minibatch_lg stand-in: n={n} half-edges={indices.numel()} "
          f"(erdos_renyi avg_deg {shape['n_edges'] / n:.4f}): generated in {gen_s:.3f} s "
          f"(host symmetrise, copy to the card), CSR on the card in {csr_s:.3f} s; "
          f"NeighborSampler fanout {shape['fanout']} and the cell's tree ({ids.numel()} slots, "
          f"{snd.numel()} edges): all {checked} masked-in slots are CSR neighbours of their "
          f"parents; (e) both sampled under key({GNN_SEED}) through {launches} threefry "
          f"launches, bit-equal to the same samples through the plain version on the card",
          flush=True)
    return indptr, indices


def gnn_cell_inputs(shape_name: str, shape: dict, full, mini):
    """(step, args_at): the port's train step for the shape
    (`C.full_graph_step`, `C.minibatch_step`, `C.molecule_step`), called
    step(a, model, params, opt, *args), and step i -> its args on the
    card: the whole graph every step; fresh seeds and a fresh key, under
    which the step draws its fanout slots (`minibatch_step` takes the key
    as the reference's step takes its key data); `GraphBatchStream` batch
    i."""
    import torch
    from repro_torch.configs import gnn_cells as C
    from repro_torch.core import prng
    from repro_torch.data.pipeline import GraphBatchStream

    if shape_name == "full_graph_sm":
        g, feats, coords, labels = full
        args = (feats, coords, g.senders, g.receivers, g.edge_mask, labels)
        return C.full_graph_step, lambda i: args
    if shape_name == "minibatch_lg":
        indptr, indices, feats_tab, coords_tab, labels_tab = mini

        def mini_args(i):
            gen = torch.Generator(device="cuda").manual_seed(GNN_SEED + 1000 + i)
            B = shape["batch_nodes"]
            seeds = torch.randperm(indptr.numel() - 1, generator=gen,
                                   device="cuda")[:B].to(torch.int32)
            return (prng.fold_in(prng.key(GNN_SEED), 1000 + i), indptr, indices, feats_tab,
                    coords_tab, labels_tab, seeds)
        return C.minibatch_step, mini_args
    stream = GraphBatchStream(shape["batch"], shape["n_nodes"], shape["n_edges"],
                              shape["d_feat"], seed=GNN_SEED)
    return C.molecule_step, lambda i: tuple(torch.from_numpy(x).cuda()
                                            for x in stream.batch_at(i))


def step_loss(a, model, shape_name: str, args):
    """params -> the loss that the shape's step on `args` differentiates."""
    from repro_torch.configs import gnn_cells as C

    if shape_name == "full_graph_sm":
        return lambda p: C.full_graph_loss(a, model, p, *args)
    if shape_name == "minibatch_lg":
        key, indptr, indices, feats_tab, coords_tab, labels_tab, seeds = args
        draws = C.minibatch_draws(key, seeds.numel(), C.GNN_SHAPES["minibatch_lg"]["fanout"],
                                  seeds.device)
        tree = C.minibatch_tree(indptr, indices, seeds, draws)
        return lambda p: C.minibatch_loss(a, model, p, tree, feats_tab, coords_tab,
                                          labels_tab, seeds)
    return lambda p: C.molecule_loss(a, model, p, *args)


def nonfinite_leaves(grads: dict) -> list:
    import torch

    return sorted(k for k, g in grads.items() if not bool(torch.isfinite(g).all()))


def on_device(x, device, dtype):
    """A tensor, or a tuple of them, on `device`, floats as `dtype`."""
    from repro_torch.core import prng

    if isinstance(x, prng.Key):
        return x
    if isinstance(x, tuple):
        return tuple(on_device(y, device, dtype) for y in x)
    return x.to(device, dtype) if x.is_floating_point() else x.to(device)


def hold_to_cpu(a, state: dict, shape_name: str, shape: dict, args, label: str) -> tuple:
    """Step 0's loss and gradients on the card against the CPU's for the
    same state dict (`state`) and inputs (minibatch_lg: the step's first
    GNN_CPU_SEEDS seeds under its key, whose draws are the first rows of
    the whole batch's).  The loss and each leaf's
    gradient norm within GNN_CPU_TOL, relative; the non-finite leaves the
    same set; a leaf the loss does not reach zero on both.  The archs of
    GNN_CPU_F64 run the comparison in f64 on both sides: their f32
    gradients are ill-conditioned (`tools/gnn_f32_spread.py`: two f32 runs
    that differ only in the order of the edges put a leaf's norm up to
    1e-4 apart for PNA, 6e-5 for EGNN, against 2e-7 for GIN and MACE), too
    near the limit to tell a fault from rounding.  Returns (loss,
    non-finite leaves, worst relative error)."""
    import math

    import torch
    from repro_torch.configs import gnn_cells as C

    if shape_name == "minibatch_lg":     # the first seeds' draws are the key's first rows
        *rest, seeds = args
        args = (*rest, seeds[:GNN_CPU_SEEDS])
    dtype = torch.float64 if a.arch_id in GNN_CPU_F64 else torch.float32
    n_out = 1 if shape_name == "molecule" else shape["n_out"]
    runs = []
    for dev in ("cuda", "cpu"):
        m = a.init(shape["d_feat"], n_out, seed=GNN_SEED, device=dev)
        m.load_state_dict(state)
        m.to(dtype)
        loss, grads = C.loss_and_grads(step_loss(a, m, shape_name, on_device(args, dev, dtype)),
                                       C.train_params(m))
        runs.append((float(loss), grads))
    (card_loss, card), (cpu_loss, cpu) = runs
    bad = nonfinite_leaves(card)
    check(bad == nonfinite_leaves(cpu),
          f"{label}: non-finite leaves {bad} on the card, {nonfinite_leaves(cpu)} on the CPU")
    worst = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(math.isfinite(card_loss) and worst <= GNN_CPU_TOL,
          f"{label}: step 0's loss {card_loss} on the card, {cpu_loss} on the CPU")
    for k in cpu:
        if k in bad:
            continue
        got, want = float(card[k].double().norm()), float(cpu[k].double().norm())
        if want == 0.0:
            check(got == 0.0, f"{label}: {k}'s gradient is 0 on the CPU, not on the card")
            continue
        err = abs(got - want) / want
        check(err <= GNN_CPU_TOL, f"{label}: {k}'s gradient norm {got} on the card, "
              f"{want} on the CPU ({err:.3g} apart)")
        worst = max(worst, err)
    return card_loss, bad, worst


class StepMarks:
    """CUDA events inside the port's train step (`gnn_cells._step`): the
    module's `loss_and_grads` is wrapped while the marks are on, and the
    model's forward hooked, so a step called as the user calls it records
    [start, loss_and_grads entered, model output, gradients, end]; `start`
    and `end` are recorded by the caller around the step."""

    def __init__(self, model):
        self.model, self.marks = model, []

    def new(self):
        import torch

        self.marks.append([torch.cuda.Event(enable_timing=True) for _ in range(5)])
        self.marks[-1][0].record()

    def __enter__(self):
        from repro_torch.configs import gnn_cells as C

        inner = self.inner = C.loss_and_grads

        def loss_and_grads(*args, **kwargs):
            self.marks[-1][1].record()
            out = inner(*args, **kwargs)
            self.marks[-1][3].record()
            return out
        C.loss_and_grads = loss_and_grads
        self.hook = self.model.register_forward_hook(lambda *_: self.marks[-1][2].record())
        return self

    def __exit__(self, *exc):
        from repro_torch.configs import gnn_cells as C

        C.loss_and_grads = self.inner
        self.hook.remove()

    def medians(self) -> dict:
        return {name: statistics.median(m[i].elapsed_time(m[j]) for m in self.marks)
                for name, i, j in (("step", 0, 4), ("sample", 0, 1), ("forward", 1, 2),
                                   ("backward", 2, 3), ("optimizer", 3, 4))}


def phase_gnn_cell(a, shape_name: str, shape: dict, step, args_at) -> None:
    """(c) One cell, through the port's own train step (`step`): the loss
    falls over GNN_DESCENT_STEPS steps on step 0's inputs; GNN_TIMED_STEPS
    more on fresh inputs, each split by CUDA events (`StepMarks`) into
    sampling (minibatch_lg's tree), forward (to the model's output),
    backward (the rest of `loss_and_grads`) and optimizer
    (`adamw_update`); the peak memory; then step 0's loss and gradients
    held to the CPU's (`hold_to_cpu`), after the timing so that no CPU
    work runs beside it.  EGNN's molecule gradient is not finite in the
    reference and here: its forward and gradient run, the non-finite
    leaves are the CPU's (`hold_to_cpu`), and no step is taken."""
    import numpy as np
    import torch
    from repro_torch.configs import gnn_cells as C
    from repro_torch.train import adamw_init

    n_out = 1 if shape_name == "molecule" else shape["n_out"]
    model = a.init(shape["d_feat"], n_out, seed=GNN_SEED, device="cuda")
    params = C.train_params(model)
    opt = adamw_init(params)
    nan_cell = a.arch_id == "egnn" and shape_name == "molecule"
    label = f"{a.arch_id} {shape_name}"
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    args0 = args_at(0)
    if not nan_cell:
        losses = []
        for _ in range(GNN_DESCENT_STEPS + 1):
            params, opt, loss = step(a, model, params, opt, *args0)
            losses.append(float(loss))
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{label}: losses {losses} not finite or not falling")
    marks = StepMarks(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers().values():
        w.launches = 0
    timed = []
    with marks:
        for i in range(1, GNN_TIMED_STEPS + 1):
            args = args_at(i)
            marks.new()
            if nan_cell:
                loss, _ = C.loss_and_grads(step_loss(a, model, shape_name, args), params)
            else:
                params, opt, loss = step(a, model, params, opt, *args)
            marks.marks[-1][4].record()
            timed.append(loss)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers().items() if w.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = [float(x) for x in timed]
    check(all(np.isfinite(timed)), f"{label}: timed losses {timed}")
    # a minibatch step draws its two hops' slots under its key: one launch each
    want = {"threefry": 2 * GNN_TIMED_STEPS} if shape_name == "minibatch_lg" else {}
    check(counts == want, f"{label}: a train step launched port kernels {counts}, "
                          f"expected {want}")
    parts = marks.medians()
    n_leaves = len(params)
    del model, params, opt, marks
    loss0, bad, cpu_err = hold_to_cpu(a, state0, shape_name, shape, args0, label)
    check(bool(bad) == nan_cell, f"{label}: non-finite gradient leaves {bad}")
    if nan_cell:
        mlps = sorted({k.split(".layers.")[0] if ".layers." in k else k for k in bad})
        print(f"[gnn] (c) {label}: loss {loss0:.6g} finite; gradients non-finite in "
              f"{len(bad)} of {n_leaves} leaves (of {', '.join(mlps)}), the CPU run's set: "
              f"the reference's sqrt at the masked self-loops; no AdamW step", flush=True)
    on_cpu = (f"step 0 against the CPU ({'f64' if a.arch_id in GNN_CPU_F64 else 'f32'}"
              f"{f', first {GNN_CPU_SEEDS} seeds' if shape_name == 'minibatch_lg' else ''}): "
              f"loss and leaf gradient norms within {cpu_err:.3g} (tol {GNN_CPU_TOL}); ")
    fell = "" if nan_cell else (f"losses over {GNN_DESCENT_STEPS} steps on one batch "
                                f"{[round(x, 6) for x in losses]} (falls); ")
    sample = f"sample {parts['sample']:.3f}, " if shape_name == "minibatch_lg" else ""
    print(f"[gnn] (c) {label}: {on_cpu}{fell}median ms a step over {GNN_TIMED_STEPS} "
          f"{parts['step']:.3f} ({sample}forward {parts['forward']:.3f}, backward "
          f"{parts['backward']:.3f}, optimizer {parts['optimizer']:.3f}"
          f"{', none taken' if nan_cell else ''}); peak device memory {peak:.3f} GiB; "
          f"port kernel launches {counts or 0}", flush=True)
    del state0, args0
    torch.cuda.empty_cache()


def bits_equal(x, y) -> bool:
    """x and y of one shape and dtype with the same bits (-0.0 is not 0.0,
    a NaN equals itself)."""
    import torch

    view = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (x.shape == y.shape and x.dtype == y.dtype
            and torch.equal(x.view(view.get(x.dtype, x.dtype)), y.view(view.get(y.dtype, y.dtype))))


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms, warn-only (an op that has none
    warns): on the card `index_add_`, `index_put_(accumulate=True)` and
    `scatter_add_` then sum in one order, not by float atomics, so two
    runs of one step give the same bits."""
    import torch

    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def phase_gnn_split_tables(shape: dict, mini, args) -> None:
    """(d) minibatch_lg's tables split over the flat mesh as the reference
    places them (`dist.lookup.TableSplit`), on a one-rank NCCL group and a
    (1, 1) mesh: gin-tu's `minibatch_step(mesh=, tables=)` on the blocks
    against the step without a mesh on the whole tables, from the same
    state on the same seeds and key (`args`): the loss and every leaf of
    the parameters, m and v bit-equal.  Both run under
    `deterministic_algorithms` (the segment sums' float atomics put two
    runs of one step on the card a few ulps apart), and the step without a
    mesh run twice is bit-equal there too, the control.  Then the lookup
    alone, ms by CUDA events (median of 5): the tree sampled through
    `take` and its rows read through it, beside the same reads from the
    whole tables."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as C
    from repro_torch.dist.lookup import TableSplit
    from repro_torch.dist.sharding import local
    from repro_torch.train import adamw_init

    t0 = time.perf_counter()
    key, indptr, *_, seeds = args
    draws = C.minibatch_draws(key, seeds.numel(), shape["fanout"], "cuda")
    mesh = dist_mesh()
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"[gnn] (d) group {dist.get_backend()} of {dist.get_world_size()}")
        tables = TableSplit.of(mesh)
        blocks = [tables.block(x) for x in mini[1:]]
        a = GNN_ARCHS["gin-tu"]
        model = a.init(shape["d_feat"], shape["n_out"], seed=GNN_SEED, device="cuda")
        p0 = C.train_params(model)

        def values(new, opt, loss):
            return [loss] + [local(t[k]) for t in (new, opt.m, opt.v) for k in sorted(t)]

        with deterministic_algorithms():
            want = values(*C.minibatch_step(a, model, p0, adamw_init(p0), *args))
            again = values(*C.minibatch_step(a, model, p0, adamw_init(p0), *args))
            params, opt = C.place_gnn_state(p0, mesh)
            got = values(*C.minibatch_step(a, model, params, opt, key, indptr, *blocks, seeds,
                                           mesh=mesh, tables=tables))
        for name, run in (("the control (the step without a mesh again)", again),
                          ("split tables", got)):
            differ = sum(not bits_equal(x, y) for x, y in zip(want, run))
            check(not differ, f"[gnn] (d) {name}: {differ} of {len(want)} values differ from the "
                              f"step without a mesh (loss {float(run[0])} vs {float(want[0])})")

        def read(tabs, split):
            tree = C.minibatch_tree(indptr, tabs[0], seeds, draws, split)
            return C.minibatch_rows(tree, *tabs[1:], seeds, split)

        rows0, rows1 = read(mini[1:], None), read(blocks, tables)
        check(all(bits_equal(x, y) for x, y in zip(rows0, rows1)),
              "[gnn] (d) the rows read through take differ from the whole tables'")
        ms = {}
        for name, tabs, split in (("whole", mini[1:], None), ("split", blocks, tables)):
            runs = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                read(tabs, split)
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end))
            ms[name] = statistics.median(runs)
        held = sum(b.numel() * b.element_size() for b in blocks)
        print(f"[gnn] (d) minibatch_lg tables split over a one-rank NCCL (1, 1) mesh "
              f"(dist.lookup.TableSplit, {held / 2**20:.1f} MiB of blocks): gin-tu's "
              f"minibatch_step(mesh=, tables=) bit-equal to the step without a mesh under "
              f"deterministic algorithms (loss {float(got[0]):.6g} and {len(got) - 1} leaves of "
              f"params, m and v; the step without a mesh twice: bit-equal); lookup "
              f"(the tree's {seeds.numel() * (1 + draws[1].shape[1] * (1 + draws[1].shape[2]))} "
              f"rows) {ms['split']:.3f} ms through take against {ms['whole']:.3f} ms from the "
              f"whole tables (median of 5); {time.perf_counter() - t0:.1f} s; card "
              f"{card_line()}", flush=True)
        del blocks, model, want, again, got, params, opt, rows0, rows1
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def phase_gnn(errs: dict) -> None:
    """Phase 12: the GNN family on the card (see the module docstring)."""
    import torch
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as C

    t_phase = time.perf_counter()
    print(f"[gnn] card {card_line()}", flush=True)
    sm = C.GNN_SHAPES["full_graph_sm"]
    g = gnn_graph(sm, 2 * sm["n_edges"] / sm["n_nodes"])
    gen = torch.Generator(device="cuda").manual_seed(GNN_SEED)
    feats = torch.randn((g.n_nodes, sm["d_feat"]), generator=gen, device="cuda")
    coords = torch.randn((g.n_nodes, 3), generator=gen, device="cuda")
    labels = torch.randint(0, sm["n_out"], (g.n_nodes,), generator=gen, device="cuda",
                           dtype=torch.int32)
    tilings = phase_gin_kernel(g, feats, errs)
    phase_gin_forward(g, feats, tilings)
    del tilings

    lg = C.GNN_SHAPES["minibatch_lg"]
    indptr, indices = phase_gnn_sampler(lg)
    n = indptr.numel() - 1
    feats_tab = torch.randn((n, lg["d_feat"]), generator=gen, device="cuda")
    coords_tab = torch.randn((n, 3), generator=gen, device="cuda")
    labels_tab = torch.randint(0, lg["n_out"], (n,), generator=gen, device="cuda",
                               dtype=torch.int32)
    inputs = {"full_graph_sm": (g, feats, coords, labels),
              "minibatch_lg": (indptr, indices, feats_tab, coords_tab, labels_tab)}
    for shape_name in ("full_graph_sm", "minibatch_lg", "molecule"):
        shape = C.GNN_SHAPES[shape_name]
        step, args_at = gnn_cell_inputs(shape_name, shape, inputs["full_graph_sm"],
                                        inputs["minibatch_lg"])
        for a in GNN_ARCHS.values():
            phase_gnn_cell(a, shape_name, shape, step, args_at)
        if shape_name == "minibatch_lg":
            phase_gnn_split_tables(shape, inputs["minibatch_lg"], args_at(1))
    del inputs, indptr, indices, feats_tab, coords_tab, labels_tab, g, feats
    torch.cuda.empty_cache()
    print(f"[gnn] phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)


LM_SEED = 0
LM_PROMPT_SEED = 17
LM_MAIN = dict(batch=8, prompt=512, cache=32_768, steps=32)  # decode_32k's cache, batch 128 -> 8
LM_CACHE_BYTES = 8 * 32_768 * 114_688                        # 28 layers x 2 x 8 heads x 128 x bf16
LM_PREFILL_SEQ = 32_768                                      # prefill_32k's length, batch 32 -> 1
LM_KEYSTONE_TOL = 2e-3
# the keystone's runs in f32: arch -> (layers kept, batch, S, decode steps, max_len)
LM_KEYSTONES = {"qwen3-0.6b": (None, 2, 512, 4, 513),
                "mixtral-8x22b": (2, 1, 4612, 4, 8192)}    # prefill 4,608 into a ring of 4,096
LM_ARCH_CUTS = {"qwen1.5-0.5b": None, "mixtral-8x22b": 2, "deepseek-v3-671b": 4,
                "nemotron-4-340b": 2}                        # layers kept at full width
LM_ARCH_SHAPE = dict(batch=2, prompt=1024, steps=16)
LM_CPU_TOL = 1e-5
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 on the tensor cores


def lm_prompts(cfg, batch: int, seq: int, device="cuda"):
    import torch
    from repro_torch.data.pipeline import TokenStream

    toks = TokenStream(cfg.vocab, batch, seq, seed=LM_PROMPT_SEED).batch_at(0)[0]
    return torch.from_numpy(toks).to(device)


def lm_leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from lm_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def lm_tree_params(cfg, params) -> tuple:
    """The tree's parameter count, checked against `param_count()` plus the
    leaves the analytic count (the reference's too) leaves out: qk-norm
    weights, QKV biases and MLA's two latent norms in every layer and the
    MTP block, and one of the MTP block's four norms."""
    n = sum(v.numel() for _, v in lm_leaves(params))
    blocks = cfg.n_layers + (1 if cfg.mtp else 0)
    per_block = 2 * cfg.d_head if cfg.qk_norm else 0
    per_block += (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head if cfg.qkv_bias else 0
    per_block += cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank if cfg.mla else 0
    left_out = blocks * per_block + (cfg.d_model if cfg.mtp else 0)
    check(n == cfg.param_count() + left_out,
          f"{cfg.name}: {n} parameters, param_count() {cfg.param_count()} + {left_out}")
    return n, left_out


def lm_init(cfg):
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf

    return tf.init_lm(prng.key(LM_SEED), cfg, device="cuda")


class MoEDrops:
    """Records the drop fraction of every `moe_ffn` call the transformer
    makes inside the block (device scalars, read once at the end)."""

    def __enter__(self):
        from repro_torch.models import transformer as tf

        self.tf, self.orig, self.fracs = tf, tf.moe_ffn, []

        def recording(*args, **kw):
            out, metrics = self.orig(*args, **kw)
            self.fracs.append(metrics.drop_frac)
            return out, metrics

        tf.moe_ffn = recording
        return self

    def __exit__(self, *exc):
        self.tf.moe_ffn = self.orig


def lm_decode(params, cfg, logits, cache, steps: int, mesh=None):
    """`steps` greedy `serve_step`s (with `mesh`, the placed ones); returns
    the logits of each step, the last cache and each step's ms by CUDA
    events."""
    import torch
    from repro_torch.configs import lm_cells as C

    out, ms = [], []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = C.serve_step(params, cfg, cache, tok, mesh=mesh)
        end.record()
        out.append(logits)
        ms.append((start, end))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    return out, cache, [s.elapsed_time(e) for s, e in ms]


def all_finite(tensors) -> bool:
    import torch

    return all(bool(torch.isfinite(t).all()) for t in tensors)


def phase_lm_main():
    """(a): qwen3-0.6b at full width and depth serving a batch of 8."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C

    cfg = LM_ARCHS["qwen3-0.6b"].CONFIG
    params = lm_init(cfg)
    n_params, left_out = lm_tree_params(cfg, params)
    w_bytes = sum(v.numel() * v.element_size() for p, v in lm_leaves(params) if p != ("embed",))
    B, P, L, n = LM_MAIN["batch"], LM_MAIN["prompt"], LM_MAIN["cache"], LM_MAIN["steps"]
    prompts = lm_prompts(cfg, B, P)
    C.prefill_step(params, cfg, prompts[:1, :64])           # warm-up at a short prompt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def serve():
        t0 = time.perf_counter()
        logits, cache = C.prefill_step(params, cfg, prompts, max_len=L)
        torch.cuda.synchronize()
        t_prefill = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out, cache, step_ms = lm_decode(params, cfg, logits, cache, n)
        return logits, out, cache, t_prefill, step_ms, (time.perf_counter() - t0) * 1e3

    (logits, out, cache, t_prefill, step_ms, t_decode), launches = counted(serve)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(not any(launches.values()), f"the LM launched port kernels: {launches}")
    check(cache.nbytes() == LM_CACHE_BYTES and cache.length == L, "qwen3-0.6b cache size")
    check(int(cache.pos) == P + n, "cache position after the decode steps")
    check(all_finite([logits] + out), "qwen3-0.6b logits not finite")
    med = statistics.median(step_ms)
    bound = (w_bytes + cache.nbytes()) / HBM_BYTES_PER_S * 1e3
    print(f"[lm] (a) qwen3-0.6b full CONFIG ({cfg.param_count():,} parameters by param_count(), "
          f"{n_params:,} in the tree with the {left_out:,} qk-norm weights; bf16), batch {B}: "
          f"prefill {P} tokens into a {L:,}-slot cache {t_prefill:.3f} ms; {n} greedy decode "
          f"steps {t_decode:.3f} ms ({B * n / t_decode * 1e3:.1f} tokens/s), step median "
          f"{med:.3f} ms (min {min(step_ms):.3f}, max {max(step_ms):.3f}) against a bound of "
          f"{bound:.3f} ms (weights but embed {w_bytes / 1e9:.3f} GB + cache "
          f"{cache.nbytes() / 1e9:.3f} GB over HBM); peak device memory {peak:.3f} GiB; "
          f"port kernel launches 0; card {card_line()}", flush=True)
    tok = torch.argmax(out[-1], dim=-1).to(torch.int32)
    profile_call(lambda: C.serve_step(params, cfg, cache, tok),
                 f"qwen3-0.6b decode step (B = {B}, {L:,} slots)")
    del cache, out, logits
    torch.cuda.empty_cache()
    return cfg, params


def phase_lm_prefill_32k(cfg, params) -> None:
    """(b): one prompt at prefill_32k's length."""
    import torch
    from repro_torch.configs import lm_cells as C

    S = LM_PREFILL_SEQ
    tokens = lm_prompts(cfg, 1, S)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = C.prefill_step(params, cfg, tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all_finite([logits]) and cache.length == S and int(cache.pos) == S, "prefill_32k")
    attn = 4.0 * S * S * cfg.n_heads * cfg.d_head * cfg.n_layers
    gemm = 2.0 * S * (cfg.param_count() - 2 * cfg.vocab * cfg.d_model) + 2.0 * cfg.d_model * cfg.vocab
    bound = (attn / F32_OPS_PER_S + gemm / BF16_OPS_PER_S) * 1e3
    print(f"[lm] (b) qwen3-0.6b prefill 1 x {S:,}: {ms:.3f} ms, peak device memory "
          f"{peak:.3f} GiB; work {attn:.3e} f32 FLOPs in the attention recurrence (every chunk "
          f"for every query) + {gemm:.3e} bf16 GEMM FLOPs, bound {bound:.3f} ms "
          f"(operations); card {card_line()}", flush=True)
    del logits, cache
    torch.cuda.empty_cache()


def keystone(cfg, B: int, S: int, k: int, max_len: int, label: str) -> None:
    """Teacher-forced decode logits against the forward's, from a prefill
    of S - k tokens (the reference's test_decode_matches_forward)."""
    import torch
    from repro_torch.configs import lm_cells as C
    from repro_torch.models import transformer as tf

    params = lm_init(cfg)
    tokens = lm_prompts(cfg, B, S)
    h, _, _ = tf.forward(params, cfg, tokens)
    full = (h[:, S - k - 1:] @ tf._head_weight(params)).to(torch.float32)
    del h
    logits, cache = C.prefill_step(params, cfg, tokens[:, :S - k], max_len=max_len)
    errs = []
    for i in range(k + 1):
        if i:
            logits, cache = C.serve_step(params, cfg, cache, tokens[:, S - k - 1 + i])
        want = full[:, i]
        over = float(((logits - want).abs() - LM_KEYSTONE_TOL * (1 + want.abs())).max())
        check(over <= 0, f"{label}: decode diverges from the forward at position "
                         f"{S - k - 1 + i} by {over:.3e} past rtol = atol = {LM_KEYSTONE_TOL}")
        errs.append(float((logits - want).abs().max()))
    print(f"[lm] (c) keystone {label}: prefill {S - k} then {k} decode steps (ring "
          f"{cache.length:,}, last slot {(S - 1) % cache.length:,}) against the forward's "
          f"logits: max |err| per position {', '.join(f'{e:.3e}' for e in errs)} "
          f"(rtol = atol = {LM_KEYSTONE_TOL})", flush=True)
    del params, cache, full, logits
    torch.cuda.empty_cache()


def phase_lm_archs() -> None:
    """(d): the other four archs at full width, depth cut."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C

    B, P, n = LM_ARCH_SHAPE["batch"], LM_ARCH_SHAPE["prompt"], LM_ARCH_SHAPE["steps"]
    for arch, layers in LM_ARCH_CUTS.items():
        full = LM_ARCHS[arch].CONFIG
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        params = lm_init(cfg)
        n_params, _ = lm_tree_params(cfg, params)
        prompts = lm_prompts(cfg, B, P)
        C.prefill_step(params, cfg, prompts, max_len=P + n)     # warm-up, same shapes
        torch.cuda.synchronize()
        with MoEDrops() as drops:
            t0 = time.perf_counter()
            logits, cache = C.prefill_step(params, cfg, prompts, max_len=P + n)
            torch.cuda.synchronize()
            t_prefill = (time.perf_counter() - t0) * 1e3
            out, cache, step_ms = lm_decode(params, cfg, logits, cache, n)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all_finite([logits] + out), f"{arch}: logits not finite")
        n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0
        fracs = torch.stack(drops.fracs).view(1 + n, n_moe).cpu() if n_moe else None
        drop_txt = ("" if fracs is None else
                    "; drop fraction per MoE layer: prefill "
                    + ", ".join(f"{float(f):.4f}" for f in fracs[0])
                    + ", decode (mean of steps) "
                    + ", ".join(f"{float(f):.4f}" for f in fracs[1:].mean(0)))
        depth = "whole" if layers is None else f"{layers} of {full.n_layers} layers"
        print(f"[lm] (d) {arch} full width, {depth} ({n_params:,} parameters, bf16): prefill "
              f"{B} x {P} {t_prefill:.3f} ms; {n} greedy steps, median {statistics.median(step_ms):.3f} "
              f"ms; peak device memory {peak:.3f} GiB{drop_txt}; finite logits; card "
              f"{card_line()}", flush=True)
        tok = torch.argmax(out[-1], dim=-1).to(torch.int32)
        profile_call(lambda: C.serve_step(params, cfg, cache, tok), f"{arch} decode step")
        del params, cache, out, logits
        torch.cuda.empty_cache()


class ExpertIds:
    """Records, on the host, the expert ids of every MoE call made inside
    the block (`moe.assign_slots` wrapped)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.assign, self.ids = moe, moe.assign_slots, []

        def recording(e, n_experts, capacity):
            self.ids.append(e.cpu())
            return self.assign(e, n_experts, capacity)

        moe.assign_slots = recording
        return self

    def __exit__(self, *exc):
        self.moe.assign_slots = self.assign


def lm_numpy_tree(params) -> dict:
    """The tree's leaves as numpy arrays, as `lm_params_from_numpy` takes
    them."""
    tree: dict = {}
    for path, v in lm_leaves(params):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v.numpy()
    return tree


def lm_serve_trace(params, cfg, prompts, steps):
    """Prefill, then the steps teacher-forced; every call's logits and every
    MoE call's expert ids, on the host."""
    from repro_torch.configs import lm_cells as C

    with ExpertIds() as experts:
        logits, cache = C.prefill_step(params, cfg, prompts,
                                       max_len=prompts.shape[1] + steps.shape[1])
        out = [logits.cpu()]
        for i in range(steps.shape[1]):
            logits, cache = C.serve_step(params, cfg, cache, steps[:, i])
            out.append(logits.cpu())
    return out, experts.ids


def phase_lm_cpu() -> None:
    """(e): the SMOKE configs on the card against the CPU, same weights."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf

    for arch, mod in sorted(LM_ARCHS.items()):
        cfg = mod.SMOKE
        params = tf.init_lm(prng.key(LM_SEED), cfg, device="cpu")
        card = tf.lm_params_from_numpy(lm_numpy_tree(params), cfg, device="cuda")
        toks = lm_prompts(cfg, 2, 16, device="cpu")
        want, want_e = lm_serve_trace(params, cfg, toks[:, :12], toks[:, 12:])
        toks = toks.cuda()
        got, got_e = lm_serve_trace(card, cfg, toks[:, :12], toks[:, 12:])
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all_finite(got) and err <= LM_CPU_TOL, f"{arch} SMOKE: card vs CPU {err:.3e}")
        check(len(got_e) == len(want_e) and all(torch.equal(a, b) for a, b in zip(got_e, want_e)),
              f"{arch} SMOKE: expert ids differ between the card and the CPU")
        print(f"[lm] (e) {arch} SMOKE card vs CPU: prefill 2 x 12 + 4 decode steps, max |logit "
              f"err| {err:.3e} (<= {LM_CPU_TOL}), {len(got_e)} MoE calls with equal expert ids",
              flush=True)


def phase_lm_launcher() -> None:
    """(f): the serve launcher as users run it."""
    proc = run_module("repro_torch.launch.serve", timeout=300)
    check(proc.returncode == 0,
          f"python -m repro_torch.launch.serve exited {proc.returncode}: {proc.stderr[-2000:]}")
    print("[lm] (f) python -m repro_torch.launch.serve (defaults): exit 0; "
          + " | ".join(proc.stdout.strip().splitlines()), flush=True)


def phase_lm() -> None:
    """Phase 13: LM serving (see the module docstring)."""
    import torch

    t_phase = time.perf_counter()
    from repro_torch.configs import LM_ARCHS

    cfg, params = phase_lm_main()
    phase_lm_prefill_32k(cfg, params)
    del params
    torch.cuda.empty_cache()
    for arch, (layers, B, S, k, max_len) in LM_KEYSTONES.items():
        cfg = LM_ARCHS[arch].CONFIG
        cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, dtype=torch.float32)
        if cfg.moe is not None:     # decode and forward see other token counts: drop nothing
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
        keystone(cfg, B, S, k, max_len,
                 f"{arch} f32{'' if layers is None else f', {layers} layers'}")
    phase_lm_archs()
    phase_lm_cpu()
    phase_lm_launcher()
    print(f"[lm] phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)


LM_TRAIN_SEQ = 4096                  # train_4k's length
# train_4k's global batch of 256 cut to the largest power of two that fits
# one card: 16 peaks at 55.6 GiB (state 9 GB, ~2.4 GB a sequence for the
# recomputed layer's recurrence), so 32 would need ~100
LM_TRAIN_BATCH = 16
LM_TRAIN_TIMED = 3                   # timed steps after one warm-up, (a)
LM_TRAIN_ARCH_TIMED = 2              # the same, (c)
LM_TRAIN_OPT = dict(total_steps=10000)   # the reference train cell's OptConfig
LM_REMAT_TOL = 1e-6                  # (b): loss and leaf gradient norms, relative
LM_REMAT_CUT = dict(layers=2, batch=1)
# (c): arch -> (layers kept, dense layers only, batch, sequence, donate the state)
LM_TRAIN_ARCHS = {
    "qwen1.5-0.5b": (None, False, LM_TRAIN_BATCH, LM_TRAIN_SEQ, False),
    "mixtral-8x22b": (1, False, 1, LM_TRAIN_SEQ, True),
    "deepseek-v3-671b": (3, True, 1, LM_TRAIN_SEQ, True),
}
LM_TRAIN_CPU_TOL = 1e-5              # (d): rtol = atol on the loss, parameters and moments
TRAIN_LM_DIR = ROOT / "build" / "train_lm"


def lm_batch(cfg, B: int, S: int, i: int):
    """Batch i of `TokenStream(vocab, B, S, seed=17)` on the card."""
    import torch
    from repro_torch.data.pipeline import TokenStream

    return tuple(torch.from_numpy(a).cuda()
                 for a in TokenStream(cfg.vocab, B, S, seed=LM_PROMPT_SEED).batch_at(i))


class TrainMarks:
    """CUDA events inside `lm_cells.make_lm_train_step`: `transformer.lm_loss`
    and `lm_cells.adamw_update` are wrapped while the marks are on, so a
    step called as the user calls it records [start, loss returned,
    optimizer entered, end]; `start` and `end` are recorded by the caller
    around the step.  With `check_grads`, the optimizer's wrapper also
    lists the leaves whose gradient is not finite (outside the timing)."""

    def __init__(self):
        self.marks, self.check_grads, self.bad = [], False, None

    def new(self):
        import torch

        self.marks.append([torch.cuda.Event(enable_timing=True) for _ in range(4)])
        self.marks[-1][0].record()

    def end(self):
        self.marks[-1][3].record()

    def __enter__(self):
        from repro_torch.configs import lm_cells as C
        from repro_torch.models import transformer as tf
        from repro_torch.train import tree as T

        self.loss, self.update = tf.lm_loss, C.adamw_update

        def lm_loss(*args, **kw):
            out = self.loss(*args, **kw)
            self.marks[-1][1].record()
            return out

        def adamw_update(opt_cfg, grads, *args, **kw):
            self.marks[-1][2].record()
            if self.check_grads:
                import torch

                self.bad = [i for i, g in enumerate(T.leaves(grads))
                            if not bool(torch.isfinite(g).all())]
            return self.update(opt_cfg, grads, *args, **kw)

        tf.lm_loss, C.adamw_update = lm_loss, adamw_update
        return self

    def __exit__(self, *exc):
        from repro_torch.configs import lm_cells as C
        from repro_torch.models import transformer as tf

        tf.lm_loss, C.adamw_update = self.loss, self.update

    def medians(self, skip: int = 1) -> dict:
        marks = self.marks[skip:]
        return {name: statistics.median(m[i].elapsed_time(m[j]) for m in marks)
                for name, i, j in (("step", 0, 3), ("forward", 0, 1), ("backward", 1, 2),
                                   ("optimizer", 2, 3))}


def lm_train_bound(cfg, B: int, S: int) -> tuple:
    """(ms, bf16 FLOPs, f32 FLOPs): 6·N_active·B·S on the tensor cores in
    bf16, plus the attention recurrence's f32 products over every KV chunk
    (the masked half too) for every layer and the MTP block, 4x the
    forward's (forward, remat recompute, and backward's two)."""
    from repro_torch.configs import lm_cells as C

    if cfg.mla is not None:
        d_qk, d_v = cfg.mla.d_nope + cfg.mla.d_rope, cfg.mla.d_v
    else:
        d_qk = d_v = cfg.d_head
    blocks = cfg.n_layers + (1 if cfg.mtp else 0)
    f32 = 4 * 2.0 * S * S * cfg.n_heads * (d_qk + d_v) * blocks * B
    bf16 = C.lm_train_flops(cfg, B, S)
    return (bf16 / BF16_OPS_PER_S + f32 / F32_OPS_PER_S) * 1e3, bf16, f32


def lm_train_steps(cfg, B: int, S: int, timed: int, donate: bool = False, drops: bool = False):
    """One warm-up step (gradients checked finite) and `timed` more through
    `make_lm_train_step`, each on the next batch; returns (the last state,
    the losses, TrainMarks, peak GiB, drop fractions of the warm-up's
    forward MoE calls, launches)."""
    import torch
    from repro_torch.configs import lm_cells as C
    from repro_torch.train.optimizer import OptConfig, adamw_init

    from repro_torch.data.pipeline import TokenStream

    params = lm_init(cfg)
    opt = adamw_init(params)
    step = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT), donate=donate)
    batch_bytes = sum(a.nbytes for a in TokenStream(cfg.vocab, B, S, seed=LM_PROMPT_SEED)
                      .batch_at(0))
    before = step_memory_start()

    def run():
        nonlocal params, opt
        losses = []
        with TrainMarks() as marks, MoEDrops() as moe:
            for i in range(1 + timed):
                marks.check_grads = i == 0
                batch = lm_batch(cfg, B, S, i)
                marks.new()
                params, opt, loss, _ = step(params, opt, *batch)
                marks.end()
                losses.append(loss)
                if i == 0:
                    fracs = list(moe.fracs)
        return losses, marks, fracs

    (losses, marks, fracs), launches = counted(run)
    peak = torch.cuda.max_memory_allocated() / 2**30
    STEP_PEAKS[f"{cfg.name} train B={B}"] = step_peak(before, (params, opt), batch_bytes)
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0
    # the warm-up's forward calls come first; remat calls the layer again in backward
    fracs = [float(f) for f in fracs[:n_moe]]
    check(not marks.bad, f"{cfg.name}: gradient not finite in leaves {marks.bad}")
    check(all_finite(losses), f"{cfg.name}: loss not finite: {[float(x) for x in losses]}")
    return (params, opt, step), [float(x) for x in losses], marks, peak, fracs, launches


def split_txt(marks) -> str:
    m = marks.medians()
    return (f"step median {m['step']:.3f} ms = forward {m['forward']:.3f} + backward "
            f"{m['backward']:.3f} + optimizer {m['optimizer']:.3f}")


def phase_lm_train_main() -> None:
    """(a): qwen3-0.6b whole at train_4k's length."""
    from repro_torch.configs import LM_ARCHS

    cfg = LM_ARCHS["qwen3-0.6b"].CONFIG
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    (params, opt, step), losses, marks, peak, _, launches = lm_train_steps(
        cfg, B, S, LM_TRAIN_TIMED)
    check(not any(launches.values()), f"LM training launched port kernels: {launches}")
    bound, bf16, f32 = lm_train_bound(cfg, B, S)
    med = marks.medians()["step"]
    print(f"[lm-train] (a) qwen3-0.6b full CONFIG ({cfg.param_count():,} parameters, bf16, "
          f"remat {cfg.remat_policy!r}), batch {B} x {S:,} (train_4k's batch of 256 cut to "
          f"{B}): 1 warm-up + {LM_TRAIN_TIMED} steps through make_lm_train_step, "
          f"{split_txt(marks)} ({B * S / med * 1e3:,.0f} tokens/s); bound {bound:.3f} ms "
          f"({bf16:.3e} bf16 FLOPs = 6 N B S at {BF16_OPS_PER_S / 1e12:.0f} T/s + {f32:.3e} f32 "
          f"FLOPs in the recurrence at {F32_OPS_PER_S / 1e12:.0f} T/s), step / bound "
          f"{med / bound:.2f}; peak device memory {peak:.3f} GiB; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; every leaf's gradient finite; port "
          f"kernel launches 0; card {card_line()}", flush=True)
    batch = lm_batch(cfg, B, S, LM_TRAIN_TIMED + 1)
    profile_call(lambda: step(params, opt, *batch), f"qwen3-0.6b train step (B = {B}, S = {S:,})")


def phase_lm_train_remat() -> None:
    """(b): remat "full", "dots" and off give the same loss and gradients."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C

    full = LM_ARCHS["qwen3-0.6b"].CONFIG
    cfg = dataclasses.replace(full, n_layers=LM_REMAT_CUT["layers"])
    B, S = LM_REMAT_CUT["batch"], LM_TRAIN_SEQ
    params = lm_init(cfg)
    batch = lm_batch(cfg, B, S, 0)
    runs = {}
    for label, remat, policy in (("off", False, "full"), ("full", True, "full"),
                                 ("dots", True, "dots")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _, grads = C.lm_loss_and_grads(
            params, dataclasses.replace(cfg, remat=remat, remat_policy=policy), *batch)
        norms = [float(g.double().norm()) for _, g in lm_leaves(grads)]
        ms = (time.perf_counter() - t0) * 1e3
        runs[label] = (float(loss), norms, (torch.cuda.max_memory_allocated() - base) / 2**30, ms)
        del grads
    want_loss, want = runs["off"][:2]
    txt = []
    for label, (loss, norms, peak, ms) in runs.items():
        err = max([abs(loss - want_loss) / abs(want_loss)]
                  + [abs(a - b) / b if b else float(a != 0.0) for a, b in zip(norms, want)])
        check(math.isfinite(loss) and err <= LM_REMAT_TOL,
              f"remat {label}: loss {loss} or a gradient norm {err:.3e} apart from remat off")
        txt.append(f"{label}: loss {loss:.6f}, global gradient norm "
                   f"{math.sqrt(sum(n * n for n in norms)):.6f}, worst relative difference "
                   f"from off {err:.3e}, peak above the weights {peak:.3f} GiB, {ms:.0f} ms")
    print(f"[lm-train] (b) remat on qwen3-0.6b, {LM_REMAT_CUT['layers']} of {full.n_layers} "
          f"layers, {B} x {S:,}, step 0's loss and gradients (<= {LM_REMAT_TOL} relative): "
          + "; ".join(txt) + f"; card {card_line()}", flush=True)


def phase_lm_train_archs() -> None:
    """(c): the other archs at full width where the state fits one card."""
    import torch
    from repro_torch.configs import LM_ARCHS

    for arch, (layers, dense_only, B, S, donate) in LM_TRAIN_ARCHS.items():
        full = LM_ARCHS[arch].CONFIG
        cfg = full
        if layers is not None:
            cfg = dataclasses.replace(full, n_layers=layers,
                                      n_dense_layers=layers if dense_only else full.n_dense_layers)
        (params, opt, _), losses, marks, peak, fracs, _ = lm_train_steps(
            cfg, B, S, LM_TRAIN_ARCH_TIMED, donate=donate)
        n_params, _ = lm_tree_params(cfg, params)
        del params, opt
        torch.cuda.empty_cache()
        bound, _, _ = lm_train_bound(cfg, B, S)
        depth = ("whole" if layers is None else
                 f"{layers} of {full.n_layers} layers"
                 + (" (its dense layers)" if dense_only else ""))
        drop = (f"; drop fraction per MoE layer {', '.join(f'{f:.4f}' for f in fracs)}"
                if fracs else "")
        print(f"[lm-train] (c) {arch} full width, {depth}{', MLA, MTP loss' if cfg.mtp else ''} "
              f"({n_params:,} parameters, bf16), batch {B} x {S:,}, state "
              f"{'donated (in-place AdamW)' if donate else 'out of place'}: 1 warm-up + "
              f"{LM_TRAIN_ARCH_TIMED} steps, {split_txt(marks)}, bound {bound:.3f} ms; peak "
              f"device memory {peak:.3f} GiB; losses {', '.join(f'{x:.4f}' for x in losses)}; "
              f"every leaf's gradient finite{drop}; card {card_line()}", flush=True)
    print("[lm-train] (c) deepseek-v3-671b's MoE layers (15.797 B parameters with one) and "
          "nemotron-4-340b (12.891 B a layer) wait: their AdamW state does not fit one card "
          f"without ZeRO-1 and moe_shardmap; card {card_line()}", flush=True)


def lm_train_trace(params, opt, cfg, tokens, targets):
    """One f32 train step; (loss, new params, new moments, every MoE call's
    expert ids) on the host."""
    from repro_torch.configs import lm_cells as C
    from repro_torch.train.optimizer import OptConfig

    with ExpertIds() as experts:
        p, o, loss, _ = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT))(
            params, opt, tokens, targets)
    host = [v.cpu() for tree in (p, o.m, o.v) for _, v in lm_leaves(tree)]
    return float(loss), host, experts.ids


def phase_lm_train_cpu() -> None:
    """(d): one SMOKE train step on the card against the CPU, same weights."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import adamw_init

    for arch, mod in sorted(LM_ARCHS.items()):
        cfg = mod.SMOKE
        params = tf.init_lm(prng.key(LM_SEED), cfg, device="cpu")
        card = tf.lm_params_from_numpy(lm_numpy_tree(params), cfg, device="cuda")
        toks = lm_prompts(cfg, 2, 17, device="cpu")
        want_loss, want, want_e = lm_train_trace(params, adamw_init(params), cfg,
                                                 toks[:, :-1], toks[:, 1:])
        toks = toks.cuda()
        loss, got, got_e = lm_train_trace(card, adamw_init(card), cfg, toks[:, :-1], toks[:, 1:])
        pairs = list(zip(got + [torch.tensor(loss)], want + [torch.tensor(want_loss)]))
        over = max(float(((a - b).abs() - LM_TRAIN_CPU_TOL * (1 + b.abs())).max())
                   for a, b in pairs)
        err = max(float((a - b).abs().max()) for a, b in pairs)
        check(math.isfinite(loss) and over <= 0,
              f"{arch} SMOKE train step: card vs CPU {over:.3e} past rtol = atol = "
              f"{LM_TRAIN_CPU_TOL}")
        check(len(got_e) == len(want_e) and all(torch.equal(a, b) for a, b in zip(got_e, want_e)),
              f"{arch} SMOKE train step: expert ids differ between the card and the CPU")
        print(f"[lm-train] (d) {arch} SMOKE train step card vs CPU (f32, 2 x 16): loss "
              f"{loss:.6f} (CPU {want_loss:.6f}); the loss, the {len(got) // 3} updated leaves and "
              f"both moments within rtol = atol = {LM_TRAIN_CPU_TOL}, max |err| {err:.3e}; "
              f"{len(got_e)} MoE calls (forward and remat recompute) with equal expert ids; "
              f"card {card_line()}", flush=True)


def phase_lm_train_launcher() -> None:
    """(e): the train launcher as users run it, at its defaults."""
    import shutil

    shutil.rmtree(TRAIN_LM_DIR, ignore_errors=True)
    TRAIN_LM_DIR.mkdir(parents=True)
    log = TRAIN_LM_DIR / "log.jsonl"
    t0 = time.perf_counter()
    proc = run_module("repro_torch.launch.train", "--ckpt-dir", str(TRAIN_LM_DIR / "ckpt"),
                      "--log", str(log), timeout=300)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"python -m repro_torch.launch.train exited {proc.returncode}: {proc.stderr[-2000:]}")
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    recs = [r for r in recs if "loss" in r]
    vocab = 2048            # small_variant's
    last = recs[-1]["loss"]
    check(math.isfinite(last) and last < math.log(vocab) - 0.3,
          f"launch.train: last loss {last} not below ln({vocab}) - 0.3")
    print(f"[lm-train] (e) python -m repro_torch.launch.train (cpu-small, its defaults: "
          f"{len(recs)} steps) exit 0 in {secs:.1f} s: loss {recs[0]['loss']:.4f} at step 0, "
          f"{last:.4f} at step {recs[-1]['step']} (< ln {vocab} - 0.3 = "
          f"{math.log(vocab) - 0.3:.4f}), median step "
          f"{statistics.median(r['dt'] for r in recs) * 1e3:.3f} ms; "
          + " | ".join(proc.stdout.strip().splitlines()[:2]) + f"; card {card_line()}", flush=True)


def phase_lm_train() -> None:
    """Phase 14: LM training (see the module docstring)."""
    import torch

    t_phase = time.perf_counter()
    phase_lm_train_main()
    torch.cuda.empty_cache()
    phase_lm_train_remat()
    torch.cuda.empty_cache()
    phase_lm_train_archs()
    phase_lm_train_cpu()
    phase_lm_train_launcher()
    print(f"[lm-train] phase 14: {time.perf_counter() - t_phase:.1f} s; card {card_line()}",
          flush=True)


# --------------------------------------------------------------------------
# phase 19: the dry run held against the card
# --------------------------------------------------------------------------

DRYRUN_REL, DRYRUN_ABS = 0.10, 256 * 2 ** 20   # a predicted peak within 10 % + 256 MiB
STEP_PEAKS = {}      # steps earlier phases ran: name -> {"total", "peak", "before", "args"}


def tensor_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of `tree` hold."""
    import torch
    from torch.utils._pytree import tree_flatten

    seen = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def step_memory_start() -> int:
    """Sync, reset the peak, return the bytes allocated now."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def step_peak(before: int, args, extra_args: int = 0) -> dict:
    """A step's peak as the dry run counts it: its arguments' bytes plus
    the most it allocated above what was live when the peak was reset (the
    arguments among it), so that other phases' leftovers drop out."""
    import torch

    peak = torch.cuda.max_memory_allocated()
    arg = tensor_bytes(args) + extra_args
    return dict(total=peak - before + arg, peak=peak, before=before, args=arg)


def dryrun_pass(cell, shape=(1, 1), names=("data", "model")) -> dict:
    """`launch.dryrun.count_pass` of `cell`'s memory variant as rank 0 of a
    fake group of `shape` (fake CUDA tensors: nothing allocated)."""
    from repro_torch.launch.dryrun import count_pass, fake_group

    with fake_group(shape, names) as mesh:
        return count_pass(cell, mesh, "memory")


def hold_peak(label: str, predicted: dict, measured: dict) -> None:
    want, got = measured["total"], predicted["memory"]["total_per_device"]
    err = abs(got - want)
    print(f"[dryrun] {label}: predicted peak {got / 2**30:.3f} GiB (arguments "
          f"{predicted['memory']['argument_bytes'] / 2**30:.3f}, outputs "
          f"{predicted['memory']['output_bytes'] / 2**30:.3f}, temporaries "
          f"{predicted['memory']['temp_bytes'] / 2**30:.3f}), measured {want / 2**30:.3f} GiB "
          f"(arguments {measured['args'] / 2**30:.3f} + the step's "
          f"{(measured['peak'] - measured['before']) / 2**30:.3f} above what was live); off "
          f"by {err / 2**30:.3f} GiB = {100 * err / want:.2f} % (bound 10 % + 256 MiB); "
          f"dry-run host {predicted['build_s'] + predicted['run_s']:.1f} s; card "
          f"{card_line()}", flush=True)
    check(err <= DRYRUN_REL * want + DRYRUN_ABS,
          f"[dryrun] {label}: predicted peak {got} B against measured {want} B")


def phase_dryrun_lm() -> None:
    """(a): qwen3-0.6b train_4k at phase 14's batch on a one-rank mesh."""
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import common as C

    cfg = LM_ARCHS["qwen3-0.6b"].CONFIG
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    pred = dryrun_pass(C._lm_train_cell("qwen3-0.6b", cfg, "train_4k", batch=B))
    hold_peak(f"(a) qwen3-0.6b train_4k, batch {B} x {S:,}, one-rank mesh (phase 14's step)",
              pred, STEP_PEAKS[f"qwen3-0.6b train B={B}"])
    model = C.lm_train_flops(cfg, B, S)
    print(f"[dryrun] (a) counted FLOPs {pred['cost']['flops']:.4e} beside lm_train_flops "
          f"6 N B S = {model:.4e} (ratio {pred['cost']['flops'] / model:.3f}: remat's "
          f"recompute and the f32 recurrence); counted bytes "
          f"{pred['cost']['bytes_accessed']:.4e}; kernel records {pred['kernels']}; card "
          f"{card_line()}", flush=True)
    check(not pred["kernels"], f"[dryrun] (a) the LM step reported kernels {pred['kernels']}")


def phase_dryrun_deepfm() -> None:
    """(b): DeepFM train_batch on a one-rank mesh, against phase 11's step."""
    from repro_torch.configs import deepfm as DF

    pred = dryrun_pass(DF.ARCH.cells["train_batch"])
    hold_peak("(b) deepfm train_batch (B = 65,536), one-rank mesh (phase 11's step)", pred,
              STEP_PEAKS["deepfm train_batch"])
    got = {k: r["launches"] for k, r in pred["kernels"].items()}
    want = {"embedding_bag": 2, "embedding_bag_backward": 2, "sort_slots": 1}
    check(got == want, f"[dryrun] (b) fake-branch launches {got}, the card's step {want}")
    print(f"[dryrun] (b) fake-branch launches {got}, as phase 11's step launched them; "
          f"their reported bytes {sum(r['bytes'] for r in pred['kernels'].values()):.4e}; "
          f"card {card_line()}", flush=True)


def phase_dryrun_round() -> None:
    """(c): one G2 round of the sharded MIS on a one-rank NCCL group, the
    split SpMV launched, beside the dry run's fake round."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs.common import Cell
    from repro_torch.configs.tcmis import DRYRUN_LANES, round_step
    from repro_torch.core import distributed as D
    from repro_torch.core import prng
    from repro_torch.core.heuristics import make_priorities
    from repro_torch.core.tiling import build_block_tiles
    from repro_torch.graphs import grid2d
    from repro_torch.hopper import tc_spmv as K
    from repro_torch.hopper.launch import fake_mode

    g2 = grid2d(*G2_SHAPE, device="cuda")
    sh = D.shard_tiled(build_block_tiles(g2, tile_size=16), 1)
    slab, T, rps, n = sh.slab(0), sh.tile_size, sh.rows_per_shard, sh.n_padded
    cell = Cell(arch="tcmis", shape="G2 stand-in", kind="mis", model_flops=0.0,
                build=lambda mesh, variant="memory": round_step(
                    mesh, n_nodes=g2.n_nodes, tile_size=T, rows_per_shard=rps,
                    nt_pad=slab.n_tiles_pad, n_tiles=slab.n_tiles))
    pred = dryrun_pass(cell, (1,), ("flat",))

    D.process_group(torch.device("cuda", torch.cuda.current_device()))
    try:
        pri = make_priorities("h3", prng.key(0), g2.n_nodes, g2.degrees())
        select, resolve = (torch.nn.functional.pad(k, (0, n - g2.n_nodes), value=-(1 << 30))
                           for k in (pri.select, pri.resolve))

        def gather(x):
            return D.gather_bool(x, T)

        alive = gather(torch.arange(rps * T, dtype=torch.int32, device="cuda") < g2.n_nodes)
        in_mis = torch.zeros(rps * T, dtype=torch.bool, device="cuda")
        rhs = torch.zeros((n, DRYRUN_LANES), dtype=torch.float32, device="cuda")
        args = (slab.tiles, slab.tile_rows, slab.tile_cols, slab.row_starts, select, resolve,
                alive, in_mis, rhs)
        before = step_memory_start()
        out, counts = counted(lambda: D.mis_round(slab, gather, select, resolve, alive, in_mis,
                                                  rhs, off=0, two_pass=True))
        measured = step_peak(before, args)
        want = {k: 1 if k == "tc_spmv" else 0 for k in KERNELS}
        check(counts == want, f"[dryrun] (c) the round's launches {counts}, expected {want}")
        got = [(tuple(t.shape), str(t.dtype)) for t in out]
        check(got == pred["outputs"], f"[dryrun] (c) the round's outputs {got}, the dry "
              f"run's {pred['outputs']}")
        flags = torch.ones((slab.n_block_cols,), dtype=torch.int32, device="cuda")
        real = K.tc_spmv(slab, rhs, col_flags=flags)
        with fake_mode() as fm:
            fake_slab = dataclasses.replace(slab, **{
                f: fm.from_tensor(getattr(slab, f))
                for f in ("tiles", "tile_rows", "tile_cols", "row_starts")})
            fake = K.tc_spmv(fake_slab, fm.from_tensor(rhs), col_flags=fm.from_tensor(flags))
        check((tuple(real.shape), real.dtype) == (tuple(fake.shape), fake.dtype),
              f"[dryrun] (c) tc_spmv {tuple(real.shape)} {real.dtype}, its fake branch "
              f"{tuple(fake.shape)} {fake.dtype}")
        rec = pred["kernels"].get("tc_spmv", {})
        print(f"[dryrun] (c) one G2 round (T = 16, int8, {slab.n_tiles:,} tiles, {n:,} rows) on "
              f"a one-rank NCCL group: launches {counts['tc_spmv']} tc_spmv, every other "
              f"kernel 0; outputs {got} equal to the fake round's; tc_spmv {tuple(real.shape)} "
              f"{real.dtype} launched and from its fake branch alike (reported "
              f"{rec.get('bytes', 0):.4e} bytes, {rec.get('flops', 0):.4e} FLOPs); peak "
              f"predicted {pred['memory']['total_per_device'] / 2**30:.3f} GiB, measured "
              f"{measured['total'] / 2**30:.3f} GiB (arguments {measured['args'] / 2**30:.3f}); "
              f"card {card_line()}", flush=True)
    finally:
        dist.destroy_process_group()


def phase_dryrun() -> None:
    """Phase 19: the dry run's predictions held against the card (see the
    module docstring)."""
    import torch
    import torch.distributed as dist

    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "[dryrun] a process group outlived its phase")
    phase_dryrun_lm()
    phase_dryrun_deepfm()
    phase_dryrun_round()
    torch.cuda.empty_cache()
    print(f"[dryrun] phase 19: {time.perf_counter() - t_phase:.1f} s; card {card_line()}",
          flush=True)


# --------------------------------------------------------------------------
# phase 15: the distribution layer on a one-rank NCCL group
# --------------------------------------------------------------------------

DIST_TOL = 1e-6                      # (b), (c): against the step without a mesh
DIST_LM_BATCH = 4                    # (b): sequences of LM_TRAIN_SEQ tokens
# (b): the MoE arch whose step runs `moe_ffn(dp=)`: (arch, layers kept,
# sequences of LM_TRAIN_SEQ tokens); its state (2.9 B parameters, 35 GB
# with its gradient) is donated
DIST_LM_MOE = ("mixtral-8x22b", 1, 1)
DIST_DIR = ROOT / "build" / "dist"
# (a)'s tree: qwen3-0.6b at full width, its depth cut from 28 layers (the
# whole tree's 1.4 GiB took ~200 s in one zlib level-6 compressor)
DIST_SAVE_LAYERS = 4
# (d): deepseek-v3's MoE layer at full width on 8,192 tokens; capacity factor
# 8 leaves every expert 2,056 slots, 8x the mean load, so none drops (checked)
DIST_MOE_TOKENS = 8192
DIST_MOE_CAPACITY = 8.0
DIST_MOE_TOL = 2.0 ** -8             # of max |y|: one bf16 step at the output's scale


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (0 when both are 0)."""
    a, b = a.float(), b.float()
    den = float(b.abs().max()) if b.numel() else 0.0
    num = float((a - b).abs().max()) if b.numel() else 0.0
    return num / den if den else num


def dist_mesh():
    """A (1, 1) ("data", "model") DeviceMesh over the one-rank NCCL group."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core.distributed import process_group

    process_group(torch.device("cuda", torch.cuda.current_device()))
    return DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))


def phase_dist_placement(mesh) -> None:
    """(a): qwen3-0.6b's tree (full width, `DIST_SAVE_LAYERS` layers)
    placed and gathered back, and through a placed save and
    reshard_checkpoint."""
    import shutil

    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.dist import distribute, lm_param_specs, reshard_checkpoint
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import tree as T

    full = LM_ARCHS["qwen3-0.6b"].CONFIG
    cfg = dataclasses.replace(full, n_layers=DIST_SAVE_LAYERS)
    params = lm_init(cfg)
    t0 = time.perf_counter()
    import torch.distributed.tensor  # noqa: F401  (its first import, timed apart)

    t_import = time.perf_counter() - t0
    t0 = time.perf_counter()
    placed = distribute(params, lm_param_specs(params, mesh), mesh)
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    leaves = T.leaves(params)
    check(all(torch.equal(p.full_tensor(), q) for p, q in zip(T.leaves(placed), leaves)),
          "[dist] (a) distribute -> full_tensor() is not bit-equal")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(str(DIST_DIR), 0, placed)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = reshard_checkpoint(str(DIST_DIR), 0, mesh, lambda t, m: lm_param_specs(t, m))
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    check(T.flatten(back)[1] == T.flatten(params)[1], "[dist] (a) restored tree differs")
    check(all(torch.equal(p.full_tensor(), q) for p, q in zip(T.leaves(back), leaves)),
          "[dist] (a) save -> reshard_checkpoint is not bit-equal")
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"[dist] (a) qwen3-0.6b tree, full width, {cfg.n_layers} of {full.n_layers} layers "
          f"({len(leaves)} leaves, {nbytes / 2**30:.3f} GiB) "
          f"on the (1, 1) mesh: importing DTensor {t_import:.1f} s, distribute {t_place:.3f} s, "
          f"full_tensor() bit-equal; placed "
          f"save {t_save:.1f} s -> reshard_checkpoint {t_restore:.1f} s, bit-equal",
          flush=True)
    shutil.rmtree(DIST_DIR, ignore_errors=True)


def timed_step(fn):
    """(output, ms by CUDA events, peak GiB of the call)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), torch.cuda.max_memory_allocated() / 2**30


def phase_dist_lm(mesh) -> None:
    """(b): the data-parallel LM step on the (1, 1) mesh against the step
    without one, qwen3-0.6b whole at S = 4,096."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import batch_spec
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import OptConfig, adamw_init

    cfg = LM_ARCHS["qwen3-0.6b"].CONFIG
    B, S = DIST_LM_BATCH, LM_TRAIN_SEQ
    params = lm_init(cfg)
    opt = adamw_init(params)
    batches = [lm_batch(cfg, B, S, i) for i in range(2)]
    plain = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT))
    placed_step = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT), mesh=mesh)
    pp, po = C.place_lm_state(params, mesh)
    (p1, o1, loss1, _), plain_ms, plain_peak = timed_step(lambda: plain(params, opt, *batches[0]))
    (p2, o2, loss2, _), warm_ms, _ = timed_step(
        lambda: placed_step(pp, po, *shard_batch(batches[0], mesh, batch_spec(mesh, 1))))
    err = max(rel_err(b.full_tensor(), a) for a, b in
              zip(T.leaves((p1, o1.m, o1.v)), T.leaves((p2, o2.m, o2.v))))
    loss_err = abs(float(loss2) - float(loss1)) / abs(float(loss1))
    check(err <= DIST_TOL and loss_err <= DIST_TOL,
          f"[dist] (b) the placed LM step differs from the step without a mesh: leaves "
          f"{err:.3g}, loss {loss_err:.3g} (tol {DIST_TOL})")
    (_, _, loss3, _), ms, peak = timed_step(
        lambda: placed_step(p2, o2, *shard_batch(batches[1], mesh, batch_spec(mesh, 1))))
    (_, _, loss4, _), ms_plain, peak_plain = timed_step(lambda: plain(p1, o1, *batches[1]))
    check(math.isfinite(float(loss3)) and abs(float(loss3) - float(loss4)) <= DIST_TOL * abs(
        float(loss4)), f"[dist] (b) second step's loss {float(loss3)} vs {float(loss4)}")
    print(f"[dist] (b) make_lm_train_step(mesh=(1, 1)) on qwen3-0.6b whole, {B} x {S:,}, remat "
          f"{cfg.remat_policy!r}: loss {float(loss2):.6f}, every parameter and moment within "
          f"{err:.3g} (relative to the leaf's max; tol {DIST_TOL}) of the step without a mesh, "
          f"loss {loss_err:.3g}; warm-up {warm_ms:.3f} ms, timed step {ms:.3f} ms, peak "
          f"{peak:.3f} GiB, beside the step without a mesh: {ms_plain:.3f} ms, peak "
          f"{peak_plain:.3f} GiB (its first step {plain_ms:.3f} ms, peak {plain_peak:.3f} GiB; "
          f"phase 14 runs it at batch {LM_TRAIN_BATCH}); card {card_line()}", flush=True)


def phase_dist_lm_moe(mesh) -> None:
    """(b), the MoE arch: the placed step through `moe_ffn(dp=)` against
    the step without a mesh from the same seed, both donating their state;
    the first step's state is compared from a host copy (two would not fit
    the card)."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import batch_spec
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import OptConfig, adamw_init

    arch, layers, B = DIST_LM_MOE
    cfg = dataclasses.replace(LM_ARCHS[arch].CONFIG, n_layers=layers)
    S = LM_TRAIN_SEQ
    batch = lm_batch(cfg, B, S, 0)
    plain = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT), donate=True)
    params = lm_init(cfg)
    opt = adamw_init(params)
    with MoEDrops() as plain_drops:
        (params, opt, loss1, _), plain_ms, plain_peak = timed_step(
            lambda: plain(params, opt, *batch))
    want = [x.cpu() for x in T.leaves((params, opt.m, opt.v))]
    n_params = sum(x.numel() for x in T.leaves(params))
    del params, opt
    torch.cuda.empty_cache()
    placed_step = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT), donate=True, mesh=mesh)
    pp, po = C.place_lm_state(lm_init(cfg), mesh)
    with MoEDrops() as placed_drops:
        (pp, po, loss2, _), ms, peak = timed_step(
            lambda: placed_step(pp, po, *shard_batch(batch, mesh, batch_spec(mesh, 1))))
    err = max(rel_err(b.full_tensor(), a.cuda()) for a, b in
              zip(want, T.leaves((pp, po.m, po.v))))
    loss_err = abs(float(loss2) - float(loss1)) / abs(float(loss1))
    drops = [float(d) for d in plain_drops.fracs], [float(d) for d in placed_drops.fracs]
    del pp, po, want
    torch.cuda.empty_cache()
    check(err <= DIST_TOL and loss_err <= DIST_TOL and drops[0] == drops[1]
          and len(drops[0]) == layers,
          f"[dist] (b) the placed {arch} step differs from the step without a mesh: leaves "
          f"{err:.3g}, loss {loss_err:.3g} (tol {DIST_TOL}), drop fractions {drops}")
    print(f"[dist] (b) make_lm_train_step(mesh=(1, 1), donate=True) on {arch} full width, "
          f"{layers} of {LM_ARCHS[arch].CONFIG.n_layers} layers ({n_params:,} parameters, "
          f"bf16), {B} x {S:,}, through moe_ffn(dp=): loss {float(loss2):.6f}, drop fraction "
          f"{', '.join(f'{d:.4f}' for d in drops[1])} as without a mesh, every parameter and "
          f"moment within {err:.3g} (tol {DIST_TOL}), loss {loss_err:.3g}; first step "
          f"{ms:.3f} ms, peak {peak:.3f} GiB, beside the step without a mesh: {plain_ms:.3f} "
          f"ms, peak {plain_peak:.3f} GiB; card {card_line()}", flush=True)


def hold_shard_bag(mesh, model, params, fields, errs: dict) -> None:
    """(c): the vocab-parallel bag on the table's row block, kernel against
    plain: the forward sums and gathered rows, and the table's gradient."""
    import torch
    from repro_torch.dist.collectives import data_group
    from repro_torch.hopper import embedding_bag as E
    from repro_torch.models.deepfm import VocabParallelBag

    dp, tp = data_group(mesh, "the shard bag check")
    flat = fields + model.offsets[None, :]
    table = params["embed"].to_local().detach()
    outs = {}
    for name, bag in (("kernel", E.embedding_bag), ("plain", E.embedding_bag_plain)):
        leaf = table.clone().requires_grad_()
        with torch.enable_grad():
            s, v = VocabParallelBag(dp, tp, bag)(leaf, flat, gather=True)
            g_s = torch.ones_like(s)
            (grad,) = torch.autograd.grad((s, v), (leaf,), (g_s, torch.ones_like(v)))
        outs[name] = (s.detach(), v.detach(), grad)
        del leaf
    for i, what in enumerate(("sums", "gathered rows")):
        exact(errs, "embedding_bag", outs["kernel"][i], outs["plain"][i],
              f"vocab-parallel bag {what} on the row block")
    exact(errs, "embedding_bag_backward", outs["kernel"][2], outs["plain"][2],
          "vocab-parallel bag's table gradient on the row block")


def phase_dist_deepfm(mesh, errs: dict) -> None:
    """(c): DeepFM's full CONFIG train_step on the (1, 1) mesh through the
    vocab-parallel bag, against phase 11's step."""
    import torch
    from repro_torch.configs import deepfm as C
    from repro_torch.data.pipeline import ClickStream, shard_batch
    from repro_torch.dist import P, batch_spec, data_axes
    from repro_torch.hopper import embedding_bag as E
    from repro_torch.models import deepfm as M
    from repro_torch.train import adamw_init

    B = C.SHAPES["train_batch"]["batch"]
    model = M.DeepFM(C.CONFIG, seed=0, device="cuda")
    fields, labels = (torch.from_numpy(a).cuda()
                      for a in ClickStream(C.FIELD_VOCABS, B, seed=0).batch_at(0))
    params = C.train_params(model)
    opt = adamw_init(params)
    p1, o1, loss1 = C.train_step(model, params, opt, fields, labels)
    pp, po = C.place_deepfm_state(params, mesh)
    f = shard_batch(fields, mesh, batch_spec(mesh, 1))
    lab = shard_batch(labels, mesh, P(data_axes(mesh)))
    sorts = E.sort_slots.calls
    (p2, o2, loss2), counts = counted(lambda: C.train_step(model, pp, po, f, lab, mesh=mesh))
    sorts = E.sort_slots.calls - sorts
    # warm: one more of each, timed
    _, plain_ms, plain_peak = timed_step(lambda: C.train_step(model, params, opt, fields, labels))
    _, ms, peak = timed_step(lambda: C.train_step(model, pp, po, f, lab, mesh=mesh))
    want = {k: 0 for k in KERNELS}
    want.update(embedding_bag=2, embedding_bag_backward=2)
    check(counts == want, f"[dist] (c) placed train_step: launches {counts}, expected {want}")
    check(sorts == 1, f"[dist] (c) placed train_step: {sorts} slot sorts, expected 1")
    err = max(max_err(b[k].full_tensor(), a[k]) for a, b in ((p1, p2), (o1.m, o2.m), (o1.v, o2.v))
              for k in a)
    loss_err = abs(float(loss2) - float(loss1))
    check(err <= DIST_TOL and loss_err <= DIST_TOL,
          f"[dist] (c) placed DeepFM step vs phase 11's: max |err| {err}, loss {loss_err}")
    hold_shard_bag(mesh, model, pp, fields, errs)
    rows = pp["embed"].to_local().shape[0]
    print(f"[dist] (c) DeepFM CONFIG train_step(mesh=(1, 1)), B = {B:,}, {rows:,} table rows on "
          f"the rank, through the vocab-parallel bag: launches {counts}, {sorts} slot sort; loss "
          f"{float(loss2):.6f}, every parameter and moment within {err:.3g} of phase 11's step "
          f"(tol {DIST_TOL}), loss {loss_err:.3g}; warm {ms:.3f} ms, peak {peak:.3f} GiB (the "
          f"step without a mesh {plain_ms:.3f} ms, {plain_peak:.3f} GiB); the shard bag's "
          f"sums, rows and table "
          f"gradient bit-equal to its plain version; card {card_line()}", flush=True)


def moe_weights(cfg, E_lo: int, E_hi: int, seed: int = 0) -> dict:
    """deepseek-v3's MoE leaves for experts [E_lo, E_hi) (bf16, N(0, 0.02²),
    each expert drawn from its own seeded generator, so any rank can make
    any expert's), the router (f32) and the shared expert whole."""
    import torch

    D, F, E = cfg.d_model, cfg.moe.d_expert, cfg.moe.n_experts
    F_sh = F * cfg.moe.n_shared

    def normal(shape, s, dtype=torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(s)
        return (torch.randn(shape, generator=g, device="cuda", dtype=dtype) * 0.02).to(dtype)

    out = {"router": normal((D, E), seed, torch.float32)}
    for j, name in enumerate(("we1", "we3", "we2")):
        shape = (D, F) if name != "we2" else (F, D)
        stack = torch.empty((E_hi - E_lo,) + shape, dtype=torch.bfloat16, device="cuda")
        for e in range(E_lo, E_hi):
            stack[e - E_lo] = normal(shape, seed + 1 + 3 * e + j)
        out[name] = stack
    for j, (name, shape) in enumerate((("ws1", (D, F_sh)), ("ws3", (D, F_sh)),
                                       ("ws2", (F_sh, D)))):
        out[name] = normal(shape, seed + 1 + 3 * E + j)
    return out


class SlotSpy:
    """Records (expert ids, keep, slot) of every `assign_slots` call that
    `moe_ffn` and `moe_ffn_shardmap` make inside the block."""

    def __enter__(self):
        from repro_torch.models import moe, moe_shardmap

        self.mods, self.orig, self.calls = (moe, moe_shardmap), moe.assign_slots, []

        def spy(experts, E, C):
            plan = self.orig(experts, E, C)
            self.calls.append((experts.clone(), plan.keep.clone(), plan.slot.clone()))
            return plan

        for m in self.mods:
            m.assign_slots = spy
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.assign_slots = self.orig


def phase_dist_moe(mesh) -> None:
    """(d): moe_ffn_shardmap at deepseek-v3's MoE width against moe_ffn."""
    import dataclasses

    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.moe_shardmap import moe_ffn_shardmap

    cfg = LM_ARCHS["deepseek-v3-671b"].CONFIG
    moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=DIST_MOE_CAPACITY)
    E = moe_cfg.n_experts
    params = moe_weights(cfg, 0, E)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((DIST_MOE_TOKENS, cfg.d_model), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    with torch.inference_mode():
        with SlotSpy() as spy:
            want, metrics = moe_ffn(params, x, moe_cfg, cfg.act)
            got = moe_ffn_shardmap(params, x, moe_cfg, cfg.act, mesh)
        # warm: one more of each, timed
        _, ref_ms, ref_peak = timed_step(lambda: moe_ffn(params, x, moe_cfg, cfg.act))
        _, ms, peak = timed_step(lambda: moe_ffn_shardmap(params, x, moe_cfg, cfg.act, mesh))
    (ids_a, keep_a, slot_a), (ids_b, keep_b, slot_b) = spy.calls
    check(torch.equal(ids_a, ids_b) and torch.equal(keep_a, keep_b)
          and torch.equal(slot_a, slot_b), "[dist] (d) expert ids or kept slots differ")
    check(bool(keep_a.all()) and float(metrics.drop_frac) == 0.0,
          f"[dist] (d) capacity factor {DIST_MOE_CAPACITY} drops {float(metrics.drop_frac)}")
    err = rel_err(got, want)
    check(err <= DIST_MOE_TOL, f"[dist] (d) moe_ffn_shardmap vs moe_ffn: {err} of max |y|")
    load = int(torch.bincount(ids_a.reshape(-1).long(), minlength=E).max())
    print(f"[dist] (d) moe_ffn_shardmap on the (1, 1) mesh at deepseek-v3's MoE width (E = {E}, "
          f"k = {moe_cfg.top_k}, d_expert = {moe_cfg.d_expert}, D = {cfg.d_model}, "
          f"{moe_cfg.n_shared} shared, bf16), {DIST_MOE_TOKENS:,} tokens, capacity factor "
          f"{DIST_MOE_CAPACITY} (busiest expert {load} assignments, none dropped): expert ids, "
          f"keep and slots equal to moe_ffn's, output within {err:.3g} of max |y| (tol 2^-8); "
          f"warm {ms:.3f} ms, peak {peak:.3f} GiB, against moe_ffn's {ref_ms:.3f} ms, "
          f"{ref_peak:.3f} GiB; card "
          f"{card_line()}", flush=True)


def phase_dist(errs: dict) -> None:
    """Phase 15: the distribution layer (see the module docstring)."""
    import torch
    import torch.distributed as dist

    t_phase = time.perf_counter()
    mesh = dist_mesh()
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"[dist] group {dist.get_backend()} of {dist.get_world_size()}")
        phase_dist_placement(mesh)
        torch.cuda.empty_cache()
        phase_dist_lm(mesh)
        torch.cuda.empty_cache()
        phase_dist_lm_moe(mesh)
        torch.cuda.empty_cache()
        phase_dist_deepfm(mesh, errs)
        torch.cuda.empty_cache()
        phase_dist_moe(mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"[dist] phase 15: {time.perf_counter() - t_phase:.1f} s; card {card_line()}",
          flush=True)


# --------------------------------------------------------------------------
# phase 16: the 'model' axis on a one-rank NCCL group
# --------------------------------------------------------------------------

TP_LM_BATCH = 4                      # (a): sequences of LM_TRAIN_SEQ tokens
# (b): deepseek-v3's dense layers with the MTP block, phase 14 (c)'s cut: (layers,
# sequences of LM_TRAIN_SEQ tokens); its state (51.5 GB) is donated
TP_DEEPSEEK = (3, 1)
TP_SERVE = dict(batch=8, prompt=512, cache=32_768, steps=8)   # (c): phase 13's cell, 8 steps
# (e): (layers, sequences, their tokens, a prompt's tokens, decode steps)
TP_QUERY_HEADS = (4, 2, LM_TRAIN_SEQ, 512, 4)
_PRINT_BLOCK = 1 << 26


def fingerprints(tree) -> list:
    """An exact fingerprint of each leaf's bits (Σ bits · (i mod 65,521 +
    1) in int64, a block at a time): two trees too large to hold twice are
    compared leaf by leaf through them."""
    import torch
    from repro_torch.dist.sharding import local
    from repro_torch.train import tree as T

    out = []
    for x in T.leaves(tree):
        x = local(x).detach().reshape(-1)
        bits = x.view({2: torch.int16, 4: torch.int32}[x.element_size()])
        tot = torch.zeros((), dtype=torch.int64, device=x.device)
        for lo in range(0, bits.numel(), _PRINT_BLOCK):
            b = bits[lo:lo + _PRINT_BLOCK].to(torch.int64)
            tot += (b * (torch.arange(lo, lo + b.numel(), device=x.device) % 65_521 + 1)).sum()
        out.append(tot)
    return torch.stack(out).tolist()


def same_leaves(a, b) -> bool:
    """Every leaf of tree `a` bit-equal to the same leaf of placed tree `b`."""
    import torch
    from repro_torch.dist.sharding import local
    from repro_torch.train import tree as T

    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, local(y)) for x, y in zip(la, lb))


class Layouts:
    """The layouts the LM steps took over the 'model' axis while it is
    entered, as the transformer chose them: the residual stream between
    the layers (`_seq`), each attention block (`_attn_tp`: heads split,
    query heads split with the KV heads whole, or whole) and each dense
    FFN (`_ffn_tp`).  `kv_whole` makes attention read the KV heads as not
    splitting, so that the query-head path runs on the one-rank group."""

    def __init__(self, kv_whole: bool = False):
        self.kv_whole, self.seen = kv_whole, set()

    def __enter__(self):
        import copy

        from repro_torch.models import transformer as tf

        self.tf = tf
        self.saved = (tf._seq, tf._attn_tp, tf._ffn_tp)
        seq, attn_tp, ffn_tp = self.saved

        def seq_spy(tp, S):
            out = seq(tp, S)
            self.seen.add(f"residual stream {'sequence-parallel' if out else 'whole'} at S = "
                          f"{S:,}")
            return out

        def attn_spy(p, cfg, tp, seq=False):
            if self.kv_whole and tp is not None and cfg.mla is None:
                real, tp = tp, copy.copy(tp)
                tp.splits = lambda n: n != cfg.n_kv_heads and real.splits(n)
            p, blk, reads = attn_tp(p, cfg, tp, seq)
            self.seen.add("attention " + (
                "whole" if not blk.split else "heads split" if reads is None else
                f"query heads split, KV heads {reads[0]}-{reads[0] + reads[1] - 1} read of "
                f"{cfg.n_kv_heads} whole"))
            return p, blk, reads

        def ffn_spy(p, cfg, tp, seq=False):
            p, blk = ffn_tp(p, cfg, tp, seq)
            self.seen.add(f"FFN {'split' if blk.split else 'whole'}")
            return p, blk

        tf._seq, tf._attn_tp, tf._ffn_tp = seq_spy, attn_spy, ffn_spy
        return self

    def __exit__(self, *exc):
        self.tf._seq, self.tf._attn_tp, self.tf._ffn_tp = self.saved

    def text(self) -> str:
        return "; ".join(sorted(self.seen))


def phase_tp_lm(mesh) -> float:
    """(a): qwen3-0.6b whole through the tensor-parallel and FSDP step;
    returns the timed step's ms."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import batch_spec
    from repro_torch.train.optimizer import OptConfig, adamw_init

    cfg = LM_ARCHS["qwen3-0.6b"].CONFIG
    B, S = TP_LM_BATCH, LM_TRAIN_SEQ
    params = lm_init(cfg)
    opt = adamw_init(params)
    pp, po = C.place_lm_state(params, mesh, fsdp=True)
    plain = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT))
    placed = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT), mesh=mesh, fsdp=True)
    ms, peaks = {}, {}
    for i, what in enumerate(("warm-up", "timed")):
        batch = lm_batch(cfg, B, S, i)
        (params, opt, loss1, _), plain_ms, plain_peak = timed_step(
            lambda: plain(params, opt, *batch))
        with Layouts() as layouts:
            (pp, po, loss2, _), ms[what], peaks[what] = timed_step(
                lambda: placed(pp, po, *shard_batch(batch, mesh, batch_spec(mesh, 1))))
        check(torch.equal(loss1, loss2) and same_leaves((params, opt.m, opt.v), (pp, po.m, po.v)),
              f"[tp] (a) qwen3-0.6b's {what} step through the 'model' axis and FSDP is "
              f"not bit-equal to the step without a mesh (loss {float(loss2)!r} vs "
              f"{float(loss1)!r})")
    print(f"[tp] (a) make_lm_train_step(mesh=(1, 1), fsdp=True) on qwen3-0.6b whole, {B} x "
          f"{S:,}: tensor-parallel blocks (vocab-parallel embedding and log-sum-exp, "
          f"column / row projections), every layer's leaves gathered over 'data' as it runs; "
          f"layout: {layouts.text()}: "
          f"loss, every parameter and moment bit-equal to the step without a mesh after the "
          f"warm-up and the timed step; warm-up {ms['warm-up']:.3f} ms, timed step "
          f"{ms['timed']:.3f} ms, peak {peaks['timed']:.3f} GiB (without a mesh {plain_ms:.3f} "
          f"ms, {plain_peak:.3f} GiB); card {card_line()}", flush=True)
    check(f"residual stream sequence-parallel at S = {S:,}" in layouts.seen,
          f"[tp] (a) the layers did not run sequence-parallel: {layouts.text()}")
    return ms["timed"]


def phase_tp_deepseek(mesh) -> float:
    """(b): deepseek-v3's 3 dense layers with MTP (MLA's latent gather,
    MTP's gathered projection), both ways from the same seed, donated;
    returns the placed step's ms."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import batch_spec
    from repro_torch.train.optimizer import OptConfig, adamw_init

    layers, B = TP_DEEPSEEK
    full = LM_ARCHS["deepseek-v3-671b"].CONFIG
    cfg = dataclasses.replace(full, n_layers=layers, n_dense_layers=layers)
    S = LM_TRAIN_SEQ
    batch = lm_batch(cfg, B, S, 0)
    params = lm_init(cfg)
    step = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT), donate=True)
    (params, opt, loss1, _), plain_ms, plain_peak = timed_step(
        lambda: step(params, adamw_init(params), *batch))
    want = fingerprints((params, opt.m, opt.v))
    del params, opt
    torch.cuda.empty_cache()
    pp, po = C.place_lm_state(lm_init(cfg), mesh)
    placed = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT), donate=True, mesh=mesh)
    with Layouts() as layouts:
        (pp, po, loss2, _), ms, peak = timed_step(
            lambda: placed(pp, po, *shard_batch(batch, mesh, batch_spec(mesh, 1))))
    got = fingerprints((pp, po.m, po.v))
    del pp, po
    torch.cuda.empty_cache()
    check(torch.equal(loss1, loss2) and got == want,
          f"[tp] (b) deepseek's step through the 'model' axis is not bit-equal to the step "
          f"without a mesh: loss {float(loss2)!r} vs {float(loss1)!r}, "
          f"{sum(a != b for a, b in zip(got, want))} of {len(want)} leaves differ")
    print(f"[tp] (b) make_lm_train_step(mesh=(1, 1), donate=True) on deepseek-v3-671b full "
          f"width, its {layers} dense layers and the MTP block, {B} x {S:,}; layout: "
          f"{layouts.text()} (the MTP block's stream whole, as the reference's): loss "
          f"{float(loss2):.6f}, every parameter and moment bit-equal to the step without a "
          f"mesh ({len(want)} leaves by exact fingerprint); {ms:.3f} ms, peak {peak:.3f} GiB "
          f"(without a mesh {plain_ms:.3f} ms, {plain_peak:.3f} GiB); card {card_line()}",
          flush=True)
    return ms


def phase_tp_serve(mesh) -> tuple:
    """(c): qwen3-0.6b's prefill and decode with the cache under
    `cache_specs`, against the steps without a mesh; returns the placed
    prefill's ms and the decode steps' median."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import batch_spec, distribute, lm_param_specs

    cfg = LM_ARCHS["qwen3-0.6b"].CONFIG
    B, P, L, n = (TP_SERVE[k] for k in ("batch", "prompt", "cache", "steps"))
    params = lm_init(cfg)
    prompts = lm_prompts(cfg, B, P)
    logits, cache = C.prefill_step(params, cfg, prompts, max_len=L)
    want, cache, plain_ms = lm_decode(params, cfg, logits, cache, n)
    want.insert(0, logits)
    del cache
    torch.cuda.empty_cache()
    placed = distribute(params, lm_param_specs(params, mesh), mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Layouts() as layouts:
        logits, cache = C.prefill_step(placed, cfg,
                                       shard_batch(prompts, mesh, batch_spec(mesh, 1)),
                                       max_len=L, mesh=mesh)
        torch.cuda.synchronize()
        t_prefill = (time.perf_counter() - t0) * 1e3
        got, cache, ms = lm_decode(placed, cfg, logits, cache, n, mesh=mesh)
    got.insert(0, logits)
    check(int(cache.pos) == P + n and cache.nbytes() == LM_CACHE_BYTES,
          "[tp] (c) the placed cache's position or size")
    placements = sorted({str([str(q) for q in v.placements]) for v in cache.data.values()})
    del cache
    torch.cuda.empty_cache()
    check(all(torch.equal(a, b) for a, b in zip(want, got)),
          "[tp] (c) the placed prefill or decode logits are not bit-equal to the steps "
          "without a mesh")
    print(f"[tp] (c) prefill_step / serve_step(mesh=(1, 1)) on qwen3-0.6b whole, batch {B}: "
          f"{P} tokens into a {L:,}-slot cache placed by cache_specs ({placements[0]}), then "
          f"{n} greedy steps; layout: {layouts.text()} (decode's one token never splits): "
          f"prefill {t_prefill:.3f} ms, logits of the prefill and every step "
          f"bit-equal to the steps without a mesh; step median {statistics.median(ms):.3f} ms "
          f"(without a mesh {statistics.median(plain_ms):.3f}; phase 13's cell at 32 steps); "
          f"card {card_line()}", flush=True)
    check(f"residual stream sequence-parallel at S = {P:,}" in layouts.seen,
          f"[tp] (c) the prefill did not run sequence-parallel: {layouts.text()}")
    return t_prefill, statistics.median(ms)


def phase_tp_deepfm(mesh) -> tuple:
    """(d): DeepFM's full CONFIG train, serve_bulk and retrieval_cand steps
    with the tables over ('data', 'model') and the tower over 'model';
    returns (the bag kernels' launches, the warm train step's ms)."""
    import torch
    from repro_torch.configs import deepfm as C
    from repro_torch.data.pipeline import ClickStream, shard_batch
    from repro_torch.dist import P, batch_spec, data_axes
    from repro_torch.hopper import embedding_bag as E
    from repro_torch.models import deepfm as M
    from repro_torch.train import adamw_init

    model = M.DeepFM(C.CONFIG, seed=0, device="cuda")
    B = C.SHAPES["train_batch"]["batch"]
    fields, labels = (torch.from_numpy(a).cuda()
                      for a in ClickStream(C.FIELD_VOCABS, B, seed=0).batch_at(0))
    params = C.train_params(model)
    p1, o1, loss1 = C.train_step(model, params, adamw_init(params), fields, labels)
    pp, po = C.place_deepfm_state(params, mesh)
    f = shard_batch(fields, mesh, batch_spec(mesh, 1))
    lab = shard_batch(labels, mesh, P(data_axes(mesh)))
    sorts = E.sort_slots.calls
    (p2, o2, loss2), train_counts = counted(lambda: C.train_step(model, pp, po, f, lab,
                                                                 mesh=mesh))
    sorts = E.sort_slots.calls - sorts
    _, ms, _ = timed_step(lambda: C.train_step(model, pp, po, f, lab, mesh=mesh))
    want = {k: 0 for k in KERNELS}
    want.update(embedding_bag=2, embedding_bag_backward=2)
    check(train_counts == want and sorts == 1,
          f"[tp] (d) train_step launches {train_counts}, {sorts} slot sorts")
    check(torch.equal(loss1, loss2) and same_leaves((p1, o1.m, o1.v), (p2, o2.m, o2.v)),
          "[tp] (d) DeepFM's step over (data, model) is not bit-equal to the step without a "
          "mesh")
    del p1, o1, p2, o2
    bulk = torch.from_numpy(ClickStream(C.FIELD_VOCABS, C.SHAPES["serve_bulk"]["batch"],
                                        seed=0).batch_at(0)[0]).cuda()
    plain_bulk = C.serve_step(model, bulk)
    bulk_logits, bulk_counts = counted(lambda: C.serve_step(
        model, shard_batch(bulk, mesh, batch_spec(mesh, 1)), params=pp, mesh=mesh))
    gen = torch.Generator(device="cuda").manual_seed(13)
    cands = torch.randint(0, C.FIELD_VOCABS[ITEM_FIELD], (C.RETRIEVAL_CANDIDATES,),
                          generator=gen, device="cuda", dtype=torch.int32)
    user = bulk[0]
    plain_scores = C.retrieval_step(model, user, cands, ITEM_FIELD)
    scores, ret_counts = counted(lambda: C.retrieval_step(
        model, user, shard_batch(cands, mesh, P(tuple(mesh.mesh_dim_names))), ITEM_FIELD,
        params=pp, mesh=mesh))
    want = {k: 0 for k in KERNELS}
    want.update(embedding_bag=2)
    check(bulk_counts == want and ret_counts == want,
          f"[tp] (d) serve_bulk launches {bulk_counts}, retrieval_cand {ret_counts}")
    check(torch.equal(plain_bulk, bulk_logits) and torch.equal(plain_scores, scores),
          "[tp] (d) DeepFM's serve_bulk logits or retrieval scores over (data, model) are not "
          "bit-equal to the steps without a mesh")
    bags = {what: {k: c[k] for k in ("embedding_bag", "embedding_bag_backward")}
            for what, c in (("train_step", train_counts), ("serve_bulk", bulk_counts),
                            ("retrieval_cand", ret_counts))}
    print(f"[tp] (d) DeepFM CONFIG over (data, model) = (1, 1), the tables' rows on the "
          f"rank's block: train_step B = {B:,}, launches {bags['train_step']} and {sorts} slot "
          f"sort (the other kernels 0), loss and every parameter and moment bit-equal to the "
          f"step without a mesh, {ms:.3f} ms warm; serve_bulk B = {bulk.shape[0]:,} launches "
          f"{bags['serve_bulk']}, retrieval_cand {C.RETRIEVAL_CANDIDATES:,} candidates launches "
          f"{bags['retrieval_cand']}, both bit-equal; card {card_line()}", flush=True)
    return bags, ms


def phase_tp_query_heads(mesh) -> tuple:
    """(e): the query-head path on the one-rank group: qwen3-0.6b cut to
    `TP_QUERY_HEADS`'s layers, its KV heads read as not splitting
    (`Layouts(kv_whole=True)`), so each layer gathers wk / wv whole and
    computes the KV heads its query heads read (a prefill: all of them,
    into a whole cache); a train step and a prefill + decode, each held
    bit-equal to the steps without a mesh.  Returns (train ms, prefill ms)."""
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import P as Spec
    from repro_torch.dist import batch_spec, data_axes
    from repro_torch.train.optimizer import OptConfig, adamw_init

    layers, B, S, prompt, steps = TP_QUERY_HEADS
    cfg = dataclasses.replace(LM_ARCHS["qwen3-0.6b"].CONFIG, n_layers=layers)
    params = lm_init(cfg)
    opt = adamw_init(params)
    pp, po = C.place_lm_state(params, mesh)
    batch = lm_batch(cfg, B, S, 0)
    plain = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT))
    placed = C.make_lm_train_step(cfg, OptConfig(**LM_TRAIN_OPT), mesh=mesh)
    params, opt, loss1, _ = plain(params, opt, *batch)
    with Layouts(kv_whole=True) as layouts:
        (pp, po, loss2, _), ms, _ = timed_step(
            lambda: placed(pp, po, *shard_batch(batch, mesh, batch_spec(mesh, 1))))
    check(torch.equal(loss1, loss2) and same_leaves((params, opt.m, opt.v), (pp, po.m, po.v)),
          "[tp] (e) the train step through the query-head path is not bit-equal to the step "
          "without a mesh")
    prompts = lm_prompts(cfg, B, prompt)
    logits, cache = C.prefill_step(params, cfg, prompts, max_len=prompt + steps)
    want = [logits]
    for i in range(steps):
        logits, cache = C.serve_step(params, cfg, cache, logits.argmax(-1).to(torch.int32))
        want.append(logits)
    with Layouts(kv_whole=True) as serve_layouts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = C.prefill_step(pp, cfg, shard_batch(prompts, mesh, batch_spec(mesh, 1)),
                                       max_len=prompt + steps, mesh=mesh)
        torch.cuda.synchronize()
        t_prefill = (time.perf_counter() - t0) * 1e3
        got = [logits]
        for i in range(steps):
            toks = shard_batch(logits.argmax(-1).to(torch.int32), mesh, Spec(data_axes(mesh)))
            logits, cache = C.serve_step(pp, cfg, cache, toks, mesh=mesh)
            got.append(logits)
    check(all(torch.equal(a, b) for a, b in zip(want, got)),
          "[tp] (e) the prefill or decode logits through the query-head path are not "
          "bit-equal to the steps without a mesh")
    heads = f"query heads split, KV heads 0-{cfg.n_kv_heads - 1} read of {cfg.n_kv_heads} whole"
    check(f"attention {heads}" in layouts.seen and f"attention {heads}" in serve_layouts.seen,
          f"[tp] (e) the query-head path did not run: {layouts.text()}")
    print(f"[tp] (e) qwen3-0.6b full width, {layers} layers, its {cfg.n_kv_heads} KV heads read "
          f"as not splitting over the (1, 1) mesh: train step {B} x {S:,}, layout: "
          f"{layouts.text()}: loss, every parameter and moment bit-equal to the step without "
          f"a mesh, {ms:.3f} ms; prefill {B} x {prompt} + {steps} greedy steps, layout: "
          f"{serve_layouts.text()}: every logit bit-equal, prefill {t_prefill:.3f} ms; card "
          f"{card_line()}", flush=True)
    return ms, t_prefill


def phase_tp_bench(times: dict) -> None:
    """Phase 16's step times as a stamped bench document
    (`repro_torch.obs.bench.write_bench`) under a temporary directory, its
    history read back; prints the stamp as read on the card."""
    import tempfile

    import torch
    from repro_torch.obs import bench

    with tempfile.TemporaryDirectory() as tmp:
        doc = dict(bench="tp", quick=False, results=[
            dict(op=op, mesh="(1, 1)", us_per_call=round(ms * 1e3, 3))
            for op, ms in times.items()])
        stamped = bench.write_bench(doc, str(pathlib.Path(tmp) / "BENCH_tp.json"),
                                    history_dir=str(pathlib.Path(tmp) / "hist"))
        records = bench.load_records(str(pathlib.Path(tmp) / "hist"))
    check(len(records) == len(times) and stamped["backend"] == "cuda"
          and stamped["device_name"] != "none" and card_line().startswith(stamped["device_name"])
          and stamped["cuda_version"] == torch.version.cuda,
          f"[bench] the stamp or its {len(records)} history records: "
          f"{ {k: stamped[k] for k in ('backend', 'device_name', 'cuda_version')} }")
    print(f"[bench] phase 16's {len(records)} step times written as a stamped bench document "
          f"and read back from its history: device_name {stamped['device_name']!r}, "
          f"power_limit {stamped['power_limit']!r}, torch_version "
          f"{stamped['torch_version']!r}, cuda_version {stamped['cuda_version']!r}, backend "
          f"{stamped['backend']!r}, git_sha {stamped['git_sha']!r}", flush=True)


def phase_tp(errs: dict) -> None:
    """Phase 16: the 'model' axis (see the module docstring)."""
    import torch
    import torch.distributed as dist

    t_phase = time.perf_counter()
    mesh = dist_mesh()
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"[tp] group {dist.get_backend()} of {dist.get_world_size()}")
        times = {"qwen3-0.6b train": phase_tp_lm(mesh)}
        torch.cuda.empty_cache()
        times["deepseek-v3-671b train"] = phase_tp_deepseek(mesh)
        torch.cuda.empty_cache()
        times["qwen3-0.6b prefill"], times["qwen3-0.6b decode"] = phase_tp_serve(mesh)
        torch.cuda.empty_cache()
        launches, times["deepfm train"] = phase_tp_deepfm(mesh)
        torch.cuda.empty_cache()
        times["qwen3-0.6b train, query heads"], times["qwen3-0.6b prefill, query heads"] = \
            phase_tp_query_heads(mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    phase_tp_bench(times)
    print(f"[tp] phase 16: {time.perf_counter() - t_phase:.1f} s, the bag kernels' launches "
          f"{launches}; card {card_line()}", flush=True)


# --------------------------------------------------------------------------
# phase 17: ogb_products' full-graph step over a split graph
# --------------------------------------------------------------------------

# arch -> the fraction of ogb_products' 2,449,029 vertices phase 17 runs, at
# the shape's widths and average degree: gin-tu at a quarter (30.9 M
# half-edges, 12.4 GB a layer-1 message tensor); the others where their
# activations fit one card beside the inputs' relabelled copies (pna at
# 1/16 peaks at 74 GiB alone in f32 and ran out of memory beside them;
# PERF.md section 4); pna and egnn are checked in f64 (GNN_CPU_F64), at
# half the f32 cuts that fit: the same bytes
PRODUCTS_CUTS = {"gin-tu": 1 / 4, "pna": 1 / 64, "egnn": 1 / 32, "mace": 1 / 128}
PRODUCTS_SEED = 0
PRODUCTS_TIMED = 3
# the floor of a run-to-run spread (`spread_floor`): two runs that happen
# to round alike still differ from a third by a rounding of the dtype
SPREAD_SEEDS = (0, 1)       # the relabelled runs behind a spread
# more relabelled runs, taken only when the placed step lies over twice the
# spread of SPREAD_SEEDS: a third draw of pure summation-order noise lands
# over twice the larger of two such draws about one time in eight
SPREAD_MORE_SEEDS = (2, 3, 4, 5, 6, 7)


def spread_floor(dtype) -> float:
    """The least run-to-run spread of a step in `dtype`: its epsilon."""
    import torch

    return torch.finfo(dtype).eps


class UpdateMetrics:
    """While open, records the `grad_norm` (before clipping) of every AdamW
    update the GNN steps make, placed or not."""

    def __enter__(self):
        from repro_torch.configs import gnn_cells as C
        from repro_torch.train import optimizer as O

        self.names = [(C, "adamw_update"), (O, "adamw_update_placed")]
        self.orig = [getattr(mod, name) for mod, name in self.names]
        self.grad_norms = []

        def wrap(fn):
            def recording(*args, **kw):
                out = fn(*args, **kw)
                self.grad_norms.append(float(out[2]["grad_norm"]))
                return out
            return recording

        for (mod, name), fn in zip(self.names, self.orig):
            setattr(mod, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.names, self.orig):
            setattr(mod, name, fn)


def step_groups(loss, opt, grad_norm: float) -> dict:
    """One step's outputs as the groups phase 17 compares: the loss, the
    gradient norm and each leaf of m and of v (as sqrt(v), the gradient's
    scale), local blocks of placed leaves."""
    from repro_torch.dist.sharding import local

    return {"loss": float(loss), "grad_norm": grad_norm,
            "m": {k: local(x) for k, x in opt.m.items()},
            "v": {k: local(x).sqrt() for k, x in opt.v.items()}}


def l2_err(a, b) -> float:
    """||a - b|| / ||b|| in f64 (||a - b|| when b is 0)."""
    import torch

    num = float(torch.linalg.vector_norm((a.double() - b.double()).reshape(-1)))
    den = float(torch.linalg.vector_norm(b.double().reshape(-1)))
    return num / den if den else num


def group_errs(got: dict, want: dict) -> dict:
    """Per group: the relative error of the loss and gradient norm; for m
    and v the largest over the leaves of the relative error in L2."""
    out = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm")}
    for k in ("m", "v"):
        out[k] = max(l2_err(got[k][leaf], want[k][leaf]) for leaf in want[k])
    return out


def relabelled(edges, rows, seed: int) -> list:
    """The full-graph step's inputs (feats, coords, senders, receivers,
    mask, labels) on the same graph with its vertices and its edges in
    another order (permutations seeded with `seed`): the same loss and
    gradients in exact arithmetic, summed in another order."""
    import torch

    s, r, m = edges
    n = rows[0].shape[0]
    gen = torch.Generator().manual_seed(seed)
    order = torch.randperm(n, generator=gen).to(s.device)          # new row i: old order[i]
    new_id = torch.empty_like(order)
    new_id[order] = torch.arange(n, device=s.device)
    e_order = torch.randperm(s.shape[0], generator=gen).to(s.device)
    feats, coords, labels = (x[order] for x in rows)
    return [feats, coords, new_id[s[e_order].long()].to(s.dtype),
            new_id[r[e_order].long()].to(r.dtype), m[e_order], labels]


def products_arch(a, mesh, fraction: float) -> float:
    """One arch of phase 17 at `fraction` of ogb_products' vertices: the
    step without a mesh from one state, and again from it on the graph
    relabelled with each of SPREAD_SEEDS (`relabelled`: the largest
    difference from the first is the step's run-to-run spread, that of the
    order it sums in: `index_add_` sums with float atomics in an order that
    changes from run to run, as `tools/gnn_f32_spread.py` measures it on
    the CPU), then `full_graph_step(split=)` on the one-rank mesh from that state,
    held to the first within twice the spread per group (no less than
    twice `spread_floor`), the spread taken again over SPREAD_MORE_SEEDS as
    well when a group lies over it.  The archs of GNN_CPU_F64 take these
    steps in f64, then the f32 witness on the same graph (`f32_witness`).
    Then PRODUCTS_TIMED more placed steps in f32 split by CUDA events,
    with the launches of every port kernel counted from 0 before them
    (none may launch).  Returns the seconds it took."""
    import torch
    from repro_torch.configs import gnn_cells as C
    from repro_torch.dist.graph import split_graph
    from repro_torch.train import adamw_init

    t0 = time.perf_counter()
    n = C.products_nodes(fraction)
    dtype = torch.float64 if a.arch_id in GNN_CPU_F64 else torch.float32
    label = f"[products] {a.arch_id} at 1/{round(1 / fraction)} in {str(dtype)[6:]}"
    s, r, m, feats, coords, labels = C.products_inputs(n, seed=PRODUCTS_SEED, device="cuda")
    feats, coords = feats.to(dtype), coords.to(dtype)
    t_graph = time.perf_counter() - t0
    t1 = time.perf_counter()
    split = split_graph(s, r, m, n, mesh)
    t_split = time.perf_counter() - t1
    edges = [x.cuda() for x in (s, r, m)]
    n_edges = s.shape[0]
    del s, r, m
    shape = C.GNN_SHAPES["ogb_products"]
    model = a.init(shape["d_feat"], shape["n_out"], seed=PRODUCTS_SEED, device="cuda").to(dtype)
    params = C.train_params(model)
    opt = adamw_init(params)
    runs = []
    with UpdateMetrics() as rec:
        def reference(seed):
            """The step without a mesh from the one state, on the graph
            relabelled with `seed` (as it came for None)."""
            inputs = ([feats, coords, *edges, labels] if seed is None
                      else relabelled(edges, (feats, coords, labels), seed))
            _, o, loss = C.full_graph_step(a, model, params, opt, *inputs)
            runs.append(step_groups(loss, o, rec.grad_norms[-1]))
            del o, inputs
            torch.cuda.empty_cache()

        def spread_of():
            spreads = [group_errs(x, runs[0]) for x in runs[1:]]
            return {k: max(x[k] for x in spreads) for k in spreads[0]}

        for seed in (None,) + SPREAD_SEEDS:
            reference(seed)
        rows = [split.rows(x) for x in (feats, coords, labels)]
        placed, popt = C.place_gnn_state(params, mesh)
        placed, popt, loss = C.full_graph_step(a, model, placed, popt, *rows[:2], *split.edges,
                                               rows[2], split=split)
        got = step_groups(loss, popt, rec.grad_norms[-1])
        errs, spread = group_errs(got, runs[0]), spread_of()
        floor = spread_floor(dtype)
        over = [k for k in errs if errs[k] > 2 * max(spread[k], floor)]
        if over:
            print(f"{label}: " + ", ".join(f"{k} {errs[k]:.3g} (spread {spread[k]:.3g})"
                                           for k in over)
                  + f" over twice the spread of {len(SPREAD_SEEDS)} relabelled runs; "
                  f"{len(SPREAD_MORE_SEEDS)} more", flush=True)
            for seed in SPREAD_MORE_SEEDS:
                reference(seed)
            spread = spread_of()
    tols = {k: 2 * max(v, floor) for k, v in spread.items()}
    for k in errs:
        check(errs[k] <= tols[k], f"{label}: the placed step's {k} is {errs[k]:.3g} from the "
              f"step without a mesh, over twice the spread ({spread[k]:.3g})")
    n_relabelled = len(runs) - 1
    truth = runs[0]
    del runs, got, params, opt
    torch.cuda.empty_cache()
    if dtype != torch.float32:
        del placed, popt
        model, placed, popt, rows = f32_witness(a, mesh, split, edges, (feats, coords, labels),
                                                truth, label)
    del edges, feats, coords, labels, truth
    torch.cuda.empty_cache()

    marks = StepMarks(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers().values():
        w.launches = 0
    losses = []
    with marks:
        for _ in range(PRODUCTS_TIMED):
            marks.new()
            placed, popt, loss = C.full_graph_step(a, model, placed, popt, *rows[:2],
                                                   *split.edges, rows[2], split=split)
            marks.marks[-1][4].record()
            losses.append(loss)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {k: w.launches for k, w in wrappers().items() if w.launches}
    check(not counts, f"{label}: a train step launched port kernels {counts}")
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"{label}: timed losses {losses}")
    parts = marks.medians()
    errs_txt = ", ".join(f"{k} {errs[k]:.3g} (spread {spread[k]:.3g})" for k in errs)
    errs_txt += f" over {n_relabelled} relabelled runs"
    print(f"{label}: {n:,} vertices, {n_edges:,} half-edges (host graph {t_graph:.1f} s, "
          f"split {t_split:.1f} s); the placed step on the one-rank mesh against the step "
          f"without one: {errs_txt}, each within twice its spread; median ms a float32 step "
          f"over {PRODUCTS_TIMED} {parts['step']:.3f} (forward {parts['forward']:.3f}, backward "
          f"{parts['backward']:.3f}, optimizer {parts['optimizer']:.3f}); peak device memory "
          f"{peak:.3f} GiB; port kernel launches 0", flush=True)
    del placed, popt, rows, split, model, marks
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def f32_witness(a, mesh, split, edges, rows_f64, truth: dict, label: str):
    """The f32 witness of an arch that phase 17 checks in f64: on the same
    graph and from the same weights, the f32 step without a mesh in the
    original order and relabelled with each of SPREAD_SEEDS, and the f32
    placed step; each one's distance from the f64 step without a mesh
    (`truth`) per group, printed, not held.  Returns the f32 model, the
    placed state after its step and this rank's f32 rows, which the timed
    steps go on from."""
    import torch
    from repro_torch.configs import gnn_cells as C
    from repro_torch.train import adamw_init

    feats, coords, labels = rows_f64[0].float(), rows_f64[1].float(), rows_f64[2]
    shape = C.GNN_SHAPES["ogb_products"]
    model = a.init(shape["d_feat"], shape["n_out"], seed=PRODUCTS_SEED, device="cuda")
    params = C.train_params(model)
    opt = adamw_init(params)
    dists = []
    with UpdateMetrics() as rec:
        for seed in (None,) + SPREAD_SEEDS:
            inputs = ([feats, coords, *edges, labels] if seed is None
                      else relabelled(edges, (feats, coords, labels), seed))
            _, o, loss = C.full_graph_step(a, model, params, opt, *inputs)
            dists.append(group_errs(step_groups(loss, o, rec.grad_norms[-1]), truth))
            del o, inputs
            torch.cuda.empty_cache()
        rows = [split.rows(x) for x in (feats, coords, labels)]
        placed, popt = C.place_gnn_state(params, mesh)
        placed, popt, loss = C.full_graph_step(a, model, placed, popt, *rows[:2], *split.edges,
                                               rows[2], split=split)
        got = group_errs(step_groups(loss, popt, rec.grad_norms[-1]), truth)
    print(f"{label}: f32 witness on the same graph, each f32 step's distance from the f64 "
          f"step without a mesh: placed " + ", ".join(f"{k} {got[k]:.3g}" for k in got)
          + "; without a mesh, in the original order and "
          f"{len(SPREAD_SEEDS)} relabelled: "
          + ", ".join(f"{k} " + "/".join(f"{d[k]:.3g}" for d in dists) for k in got)
          + f" (printed, not held); card {card_line()}", flush=True)
    return model, placed, popt, rows


def phase_products() -> None:
    """Phase 17: ogb_products' full-graph step over a split graph (see the
    module docstring)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import GNN_ARCHS

    t_phase = time.perf_counter()
    mesh = dist_mesh()
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"[products] group {dist.get_backend()} of {dist.get_world_size()}")
        took = {a: products_arch(GNN_ARCHS[a], mesh, f) for a, f in PRODUCTS_CUTS.items()}
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"[products] phase 17: {time.perf_counter() - t_phase:.1f} s "
          f"({', '.join(f'{a} {t:.1f}' for a, t in took.items())}); ogb_products launches no "
          f"port kernel; card {card_line()}", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    from repro_torch.graphs import grid2d

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    t0 = time.perf_counter()
    g2 = grid2d(*G2_SHAPE, device="cuda")
    print(f"[graph] G2 grid2d{G2_SHAPE}: n={g2.n_nodes} half-edges={g2.n_edges} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    errs = phase_kernels(g2)
    phase_kernels_partition(g2, errs)
    paths = phase_paths(g2)
    baselines = phase_baselines(g2, paths)
    draws = phase_draws(g2, errs, paths)
    records = timing_dense(paths["main"], paths["launches"], errs)
    records += timing_packed(paths["packed"], paths["launches"], errs)
    records.append(draws)
    timing_solves(paths)
    timing_hybrid(g2, paths, baselines)
    plans = paths["plans"]             # phase 18 reuses phase 3's plans
    del paths, baselines
    phase_batched(g2, errs)
    phase_dynamic(g2, errs)
    phase_disk_cache(g2)
    phase_sharded(g2, errs)
    phase_serve(g2)
    phase_lint(g2, plans)
    del g2, plans
    deepfm = phase_deepfm(errs)
    records += timing_deepfm(deepfm, errs)
    del deepfm
    train = phase_train(errs)
    records += timing_train(train, errs)
    del train
    phase_train_loop()
    phase_gnn(errs)
    phase_lm()
    phase_lm_train()
    phase_dryrun()
    phase_dist(errs)
    phase_tp(errs)
    phase_products()
    for r in records:               # the later phases' checks too
        r["max_abs_err"] = errs[r["name"]]
    check(sorted(r["name"] for r in records) == sorted(KERNELS), "a kernel has no record")
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
