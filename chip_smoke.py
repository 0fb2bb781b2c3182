#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py           # on a machine with one CUDA card
    python3 chip_smoke.py --tiny    # CPU rehearsal at a tiny size (no result)

Phases:
  0. set-up: card name and power limit, torch/CUDA versions, kernel build
     (five libraries, one nvcc each, all started together: the attention
     kernels at Dqk = Dv and at MLA's pairs are two; phase 1's graph is
     generated on the host while nvcc runs);
  1. the partition-score kernel against its plain PyTorch version on the card
     at the main path's shapes (C=512 chunks of the phase-2 graph at K=8 and
     K=64, the chunk holding the highest-degree vertex, the dense entry),
     exact at alpha=0 and within 1e-6 with a penalty (the hub chunk also the
     same bits twice), timed with CUDA events beside the plain version, one
     ``torch.bincount`` of keys gathered beforehand (``library_ms``) and an
     empty kernel at the same launch shape (``floor_ms``); then the stream
     row ``stream8192_k8``: all 8,192 chunks of phase 2's random order, each
     launch on its own slice of the device ids, captured in one CUDA graph
     (total, mean a launch, the slowest launch), beside the empty kernel
     captured the same way, every launch's scores equal to one plain call
     over all the rows; each row names the design (``cluster_path``); and
     the zoo's shapes: ``chunk4096_k8`` (the first 4,096 rows of the random
     order, heistream's chunk) and ``dense_sampled_s<s>x512_k8`` (the
     ``[s, 512]`` matrix a ``cuttana-batched`` run samples for the first
     chunk holding a row above 512);
  2. the main path: ``fennel`` through ``repro_torch.api.partition`` on an
     R-MAT graph of 2^22 vertices and average degree 16 (the scale of SNAP's
     soc-LiveJournal1), k=8, edge balance, random order, seed 0; every chunk
     must launch the kernel once;
  3. ``fennel`` and ``cuttana`` on web-s with device="cuda" and "cpu" give
     identical assignments and the reference's edge-cuts; ``cuttana`` on
     social-m (K' = 12,496 sub-partitions, W = 1.25 GB on the card) gives
     the reference's edge-cut;
  4. ``fennel`` on social-m under ``torch.profiler``: the card's busy time,
     its idle share, and the kernel's device time per launch;
  5. the sharded partition-score kernel against its plain version on the
     card at the parallel path's shapes (a superstep of the 2^22 graph at
     S=4 and S=8, K=8; the superstep holding the highest-degree vertex;
     K=64; the dense [S,C,D] entry with random per-shard size rows), exact
     at alpha=0 and within 1e-6 with a penalty, timed like phase 1, and the
     stream row ``superstep_stream_s4_k8`` over all 2,048 supersteps;
  6. the parallel main path: ``fennel-parallel`` through
     ``repro_torch.api.partition`` on the 2^22 graph, S=4, max_workers=0,
     k=8, edge balance, random order, seed 0; the sharded kernel must launch
     once per superstep with candidates, equal to ``kernel_calls``; the
     same spec on one host thread must give the same assignment;
  7. ``fennel-parallel``, ``cuttana-parallel`` and ``cuttana-restream`` at
     S=4 on web-s with device="cuda" and "cpu" give identical assignments
     and the reference's edge-cuts; at S=1 the parallel algorithms equal
     ``fennel``/``cuttana``; ``cuttana-parallel`` on social-m at S=4 gives
     the reference's edge-cut;
  8. ``fennel-parallel`` on social-m at S=4 under ``torch.profiler``: the
     card's busy time and idle share, beside phase 4's sequential stream;
  9. the ``ell_spmv`` gather/reduce kernel against its plain version on the
     card, on both row loaders: the analytics engine's segment entry at the
     shape of phase 2's partition (all k=8 devices' CSR rows of the 2^22
     graph in one launch) and on a 32-row batch holding the hub row; the
     ELL entry at ``tests/test_kernels.py``'s shapes and on a padded ELL
     batch holding the hub row. Min exact, sum within rtol 1e-6, the engine
     launch the same bits twice; timed like phase 1, ``library_ms`` being
     ``x.gather`` + ``scatter_reduce_`` (two calls; ``x[cols]`` + ``sum`` /
     ``amin`` for the ELL entry); each row names the kernel's design
     (``merge_path``) and its achieved GB/s over the bytes of ``bound_ms``;
 10. the analytics path: ``result.analytics(program, iters,
     mode="simulated")`` on phase 2's ``fennel`` assignment for pagerank
     (30 iterations), cc and sssp (20): one kernel launch per iteration,
     values after ``CPU_PARITY_ITERS`` (5) iterations equal to the port's
     device="cpu" run at that depth (cc/sssp exactly, pagerank within rtol
     1e-5, atol 1e-9), a second pagerank run on the
     card bit-identical, ``halo_messages_per_iter`` equal to
     ``comm_volume * k * |V|``; web-s values against the float64 oracles;
 11. pagerank on social-m (phase 3's ``cuttana`` partition) under
     ``torch.profiler``: the card's busy time and idle share, beside
     phases 4 and 8;
 12. the flash-attention kernel against its plain version on the card:
     ``tests/test_kernels.py``'s shapes in float32 and bf16 and its
     decode-offset sweep (2e-5 / 2e-2), one qwen3-8b layer at prefill (B=1,
     Hq=32, Hkv=8, T=8192, Dh=128, bf16, causal; achieved TFLOP/s) and one
     at a 32k decode step (B=32 and B=8, Tq=1, Tk=32768, q_offset=32767; B
     cut from ``decode_32k``'s 128 so the plain version's float32 K/V fit)
     on the split-KV decode variant, and 65,536 (batch, head) blocks, past
     grid y's 65,535, on the decode and the tensor-core variants; and the
     slice-14 families' shapes (``FAMILY_FLASH_ROWS``): gemma3-12b's local
     (window 1024) and global layers at T=8192 (Hq=16, Hkv=8, Dh=256), its
     decode over the warm 1,024-slot ring and over the 8,192 cache at B=8,
     hubert-xlarge at B=8, T=1500 (Dh=80, bidirectional),
     llama-3.2-vision-90b's cross layer at T=8192 and at a decode step
     over 1,024 image tokens (Hq=64, Hkv=8, bidirectional), and float32
     ``fma`` / ``fma_short`` rows at Dh 80 and 256; and deepseek-v2-236b's
     MLA pairs (``MLA_FLASH_ROWS``): prefill at (Dqk, Dv) = (192, 128), B=1,
     T=8192, 128 heads in the model's layout on ``wgmma_bf16`` (the plain
     version 16 heads at a time), the absorbed decode at (576, 512), 128
     query heads on one latent KV head whose first 512 columns are the
     value, over a 32k cache at B=8 and the serve loop's 160 keys on
     ``latent_wgmma`` (tensor cores), the same 160 keys over a latent
     buffer one element off 16 bytes on ``decode_latent``'s bf16 instance,
     a 16-token prompt, float32 rows, and the reduced config's (48, 32);
     ``library_ms`` being ``F.scaled_dot_product_attention`` (with a
     boolean mask where a window or an offset diagonal needs one); each row
     names the variant that ran, and decode rows their split count;
 13. the selective-scan kernel against its plain version on the card:
     ``tests/test_kernels.py``'s shapes in float32 and bf16 (1e-4 / 3e-2),
     one falcon-mamba-7b layer at prefill (B=1, T=8192, D=8192, N=16,
     float32; ``SCAN_LAYER_TOL``) and batch 65,536 (past grid y's cap); no
     single PyTorch call computes the scan; each row names the states a
     thread holds (``states4``) and its share of the exponentials' bound;
 14. qwen3-8b at full width and depth with seeded random weights:
     ``make_prefill_step`` at B=1, T=8192 (36 flash launches, all on the
     tensor-core variant), then ``launch.serve.serve`` at B=8, prompt 128,
     32 generated tokens (36 launches a decode step: 36 x 159, on the
     split-KV decode variant with one split), prefill logits against the
     decode path's on a 16-token prompt, and one decode step under
     ``torch.profiler``;
 15. falcon-mamba-7b the same way: prefill with 64 scan launches, serve
     with none (decode is the plain recurrence, as in the reference), and
     one prefill under ``torch.profiler``;
 16. the ten reduced configs (qwen3-8b, falcon-mamba-7b, minitron-8b,
     deepseek-coder-33b, jamba-v0.1-52b, arctic-480b, gemma3-12b,
     hubert-xlarge, llama-3.2-vision-90b, deepseek-v2-236b) in float32
     with the same weights on the card and on the CPU: logits and the router loss within 1e-4,
     every MoE layer's expert ids and the greedy tokens equal (gemma3's
     serve of 8 + 8 tokens runs its 16-slot rings; hubert takes frames and
     runs ``forward`` only; llama's forward reads image embeddings); for
     each with a decode path and attention also one decode step over a
     seeded 8,192-long cache, where the decode kernel splits the cache;
     the card's serve loop of reduced deepseek-v2 runs ``decode_latent``
     (float32 at (48, 32)) on every attention call;
 17. qwen3-8b long-context decode at full width and depth, with phase 14's
     weights: B=8, a 32,768-position bf16 cache filled from a seeded
     generator, 8 ``decode_step``s from position 32,760 (36 launches a step,
     all on the split-KV decode variant), one layer's attention over that
     cache against the plain version, and one step under ``torch.profiler``
     (device busy time, idle share, attention device ms);
 18. (runs after phase 11, while the graphs are loaded) the partitioner zoo
     on web-s: each of the 16 algorithms ported after the first slices, at
     the committed rows' spec (k=8, seed 0, edge balance and random order
     where the algorithm takes them), with device="cuda" and "cpu" giving
     identical results (assignment, or the vertex-cut edge partition) equal
     to the reference's value (``WEB_S_ZOO``); the partition-score launches
     equal ``kernel_calls`` for the engine-backed ones, plus one dense-entry
     launch per chunk holding a row above ``sample_cap`` for
     ``cuttana-batched`` (counted from the graph), one dense launch a chunk
     for ``cuttana-batched-legacy``, none for the host loops; and
     ``cuttana-parallel`` at S=4 with the ``gain`` and ``completeness``
     buffers (sharded launches only); the CPU runs are a child process's
     (``--zoo-cpu-child``), started before phase 5 and collected here;
 19. social-s: ``cuttana-buffcut`` (gain) and ``cluster+cuttana``; social-m:
     ``heistream`` and ``cuttana-incremental`` (16 batches, S=1 and S=4);
     against the reference's edge cuts, launches equal to ``kernel_calls``;
     the gather entry against its plain version, timed like phase 1, on
     the chunk of the ``cluster+*`` coarse graph's random order that holds
     its longest supervertex row (``coarse_chunk512_k8``);
     ``IncrementalPartitioner`` on the churn suite's stream
     (``rmat_churn(25000, 16, seed 7, "random")``, 20 batches) against
     ``BENCH_partition.json``'s edge cut; ``heistream`` under
     ``torch.profiler`` (busy time, idle share);
 20. ``cuttana-batched`` (k=8, edge balance, random order, seed 0,
     ``sample_cap`` 512, ``use_refinement=False``) on the R-MAT of 2^20
     vertices (a quarter of phase 2's), device="cuda" and "cpu" giving
     identical assignments equal to the reference's edge cut
     (``RMAT_BATCHED_EDGE_CUT``), then again under ``torch.profiler``:
     2,048 gather launches plus one dense launch per chunk holding a row of
     degree above 512, the quality scan against a host recomputation,
     ``stream_seconds`` and the idle share;
 21. (runs after phase 20, while phase 2's graph is loaded) out-of-core
     graphs: (a) ``BENCH_partition.json``'s ``outofcore/rmat40000`` rows -
     the R-MAT of 40,000 vertices, average degree 12, seed 0, written as an
     ``.npy`` edge list and converted with ``convert_edge_list`` (1,172,517
     bytes), then ``fennel``, ``cuttana`` and ``cuttana-parallel`` S=4 (k=8,
     edge balance, random order, seed 0) resident and memory-mapped: the
     committed edge cuts (phase 28(b)'s out-of-core smoke run holds the
     mapped ``cuttana-parallel`` with ``prefetch="off"``), mapped
     assignments equal to resident ones, the mapped runs' launches on the
     rows entries only; (b) phase 20's 2^20 R-MAT
     partitioned resident with phase 2's spec (2,048 launches), written
     with ``convert_csr`` (v2), then a child process that only opens the
     file runs the same ``fennel`` on the card: its assignment equals the
     resident one, its 2,048 launches are all on the rows entry and equal
     ``kernel_calls``, and its peak device memory is below the resident
     run's by at least the graph's device arrays (its peak RSS,
     ``decode_wall_s`` and ``prefetch_hit_rate`` logged); (c) the rows
     entries against their plain
     versions at the mapped shapes (``mapped_chunk512_k8``: the first chunk
     of the random order, decoded from the file and packed as the engine
     packs it; ``mapped_superstep_s4x512_k8``: the first superstep at S=4),
     exact at alpha=0 and within 1e-6 with a penalty, timed like phase 1,
     with the packed buffer's bytes and its host-to-device copy time;
 22. (runs after phase 21, while phase 2's graph and partition are loaded)
     the graph-DB study and partition-aware serving, fed by partitions made
     on the card: (a) ``benchmarks/serving.py``'s recipe with the port (the
     R-MAT of 8,000 vertices, degree 12, seed 0; ``cuttana``, ``fennel``,
     ``hdrf`` and ``random`` at k=8; 2,000 queries of the default mix
     seeded 1 at concurrency 1,000): every field of the six committed
     ``serving/rmat8000/*`` rows of ``BENCH_partition.json`` but
     ``qps_wall`` (``SERVING_ROWS``), gather launches equal to
     ``kernel_calls`` (none for the host-placed ``cuttana``, ``hdrf`` and
     ``random``), ``qps_wall`` logged; the gather entry against its plain
     version on the first chunk of that cuttana stream
     (``serving_rmat8000_chunk512_k8``), timed like phase 1; (b) phase 2's
     2^22 ``fennel`` partition served at replication budget 0.05 with
     ``SERVING_QUERIES`` (200) queries (seed 1) at concurrency 1,000, at
     auto workers and at one worker: the same answers per query and the
     same sim metrics and counters, the answers equal to the
     ``QueryEngine``'s, the plan's and runs' seconds logged, and
     ``result.db(hops=1|2)`` with 256 and ``DB_TWO_HOP_QUERIES`` (32) queries;
     (c) ``python -m repro_torch.api.cli`` in child processes on the card:
     ``partition`` (cuttana, ``--with-db``) gives (a)'s quality and
     ``kernel_calls`` (0: cuttana places every vertex on the host),
     ``serve-bench`` (cuttana, 2,000 queries seeded 1, concurrency 1,000)
     the committed ``qps_sim`` and RPCs; ``partition`` on fennel, run in
     this process, gives (a)'s quality and launches the kernel once per
     ``kernel_calls`` (16);
 28. the reference's public surface on the port: (a) (runs after
     phase 22, while phase 2's graph and partition are loaded) the metric
     functions of ``repro_torch.graph.metrics`` (``edge_cut``,
     ``communication_volume``, ``vertex_imbalance``, ``edge_imbalance``,
     ``partition_vertex_counts``, ``partition_edge_counts``) on phase 2's
     2^22 partition on the card, each ``==`` the same function on the CPU
     and the card's ``quality_report`` field, with its ms; ``check_balance``
     of the edge counts at the spec's epsilon true; ``cuttana`` with
     ``return_detail=True`` on web-s on the card == the CPU (every field but
     the seconds, the edge-cut phase 3's); ``refine_with_swaps`` on that
     run's coarsened graph (W built on the card, and on the CPU) gives the
     same moves, swaps, improvement and sub-partition placement, with its
     seconds; (b) (runs last, after phase 24) every file of
     ``examples/torch/`` as a child process on the card
     (``--example-child``, the example run as ``__main__``; ``serve_lm`` with
     its default ``reduced:qwen3-8b`` and with ``reduced:jamba-v0.1-52b``
     (whose prompt, prefilled through decode steps, launches no scan),
     ``train_lm`` at 20 steps into a temp checkpoint directory), started
     together: each exits 0 with no ``jax`` or ``repro`` module loaded and
     prints its wrappers' launch counts (``EXAMPLE_RUNS`` names the ones
     that must be non-zero); meanwhile the four ``scripts/torch/*_smoke.py``
     modules' ``run()`` on the card in this process (churn and serving at
     their default sizes, out-of-core and threaded cut: ``SMOKE_ARGS``),
     with their deterministic gates (churn's cut and work ratios, serving's
     sim ordering, replication and determinism, out-of-core's compression
     and bit parity, and threaded's parallel runs == the same specs on one
     thread); the two host-timing ratios (threaded's parallel/sequential,
     out-of-core's prefetch on/off) are logged, not gated;
 23. (runs after phase 11, while phase 2's layout is loaded) the analytics
     engine's sharded mode: ``run_sharded`` on phase 2's partition, one
     process a partition (8 gloo ranks, all on the one card, the halo
     staged through pinned host buffers; NCCL takes a rank a card, and its
     refusal of shared cards is checked), pagerank 30, cc 20 and sssp 20 in
     one start: equal to phase 10's simulated values (cc and sssp ``==``,
     pagerank within rtol 1e-6), each rank one ``ell_spmv`` launch and one
     all-to-all an iteration, the elements sent an iteration equal to
     ``padded_halo_elements_per_iter``; the start's seconds, each rank's host
     ms an iteration and the staged bytes recorded (host times of ranks that
     share one card, not a multi-card speed); then the kernel at the largest
     rank's segment shape, timed like phase 9 with its empty-launch floor;
 25. (runs after phase 16) the MoE families and expert placement: (d)
     first, while the card is empty, the attention kernel at arctic-480b's
     shapes (g = 7: Hq=56, Hkv=8, Dh=128, bf16) against its plain version,
     timed like phase 12: prefill B=1, T=8192 on ``wgmma_bf16`` and decode
     B=8 over the serve loop's 160-key cache on ``decode_split``; (a)
     jamba-v0.1-52b (13.26B parameters) and then arctic-480b (14.07B) at
     full width cut to one block (jamba's eight-layer period: 7 Mamba, 1
     attention, 4 MoE and 4 dense FFNs; arctic's one layer of 128 experts
     beside a dense FFN), bf16, seeded, through ``lm_phase``: prefill B=1
     T=8192 (jamba 1 ``wgmma_bf16`` and 7 scan launches, arctic 1), serve B=8
     prompt 128 gen 32 (159 ``decode_split`` launches), finite logits, peak
     memory, tok/s, a decode step and the prefill under ``torch.profiler``
     with the MoE ranges' share of device time; each model freed before the
     next; (b) minitron-8b and deepseek-coder-33b at full width with two
     layers: prefill T=8192 (2 ``wgmma_bf16`` launches) and 8 decode steps
     at B=8 from the end of a seeded 8,192 cache (16 ``decode_split``); (c)
     ``place_experts`` on ``examples/moe_placement.py``'s trace (50,000
     tokens, E=160, top-6, 16 devices): the round-robin, contiguous and
     CUTTANA mean fanouts equal the reference's (``PLACEMENT_FANOUT``);
 26. (runs after phase 25) the slice-14 families at full width, bf16,
     seeded, one model at a time: (a) gemma3-12b cut to one block (5 local
     layers with window 1024, 1 global; Dh 256) through ``lm_phase``
     (prefill B=1 T=8192: 6 ``wgmma_bf16`` launches; serve B=8 prompt 128
     gen 32: 6 ``decode_split`` a step), then 8 ``decode_step``s at B=8
     from the end of a seeded 8,192-long cache (the 1,024-slot rings warm
     and wrapping; 6 ``decode_split`` a step), the last one held against
     the same step with every attention call on the plain version (phase
     17's bf16 gate on the logits); (b) hubert-xlarge at full depth (48
     layers): ``forward`` on seeded frames at B=8, T=1500, 48
     bidirectional ``wgmma_bf16`` launches at Dh 80; (c)
     llama-3.2-vision-90b cut to one block (4 self-attention layers, 1
     gated cross-attention layer, its gate seeded non-zero): prefill B=1
     T=8192 with seeded ``image_embeds`` [1, 1024, 8192] (5
     ``wgmma_bf16``, the cross one bidirectional), the image caches filled
     as the reference's tests fill them (``img @ wk``, ``img @ wv``), the
     serve loop at B=8 prompt 128 gen 32 (5 ``decode_split`` a step, the
     cross one bidirectional over the image keys), the gate's effect on a
     step's logits; each part with seconds, tokens a second, peak memory,
     launches by variant and a profiled call's idle share;
 27. (runs after phase 26) deepseek-v2-236b at full width, bf16, seeded,
     cut to its dense prefix layer and one MoE block of the 59 (5.36B
     parameters; ``reduced`` says why): through ``lm_phase``, prefill B=1
     T=8192 (2 ``wgmma_bf16`` launches at (192, 128), MLA's expanded form)
     and the serve loop at B=8 prompt 128 gen 32 (2 ``latent_wgmma``
     launches a step at (576, 512), the absorbed form over the latent
     cache, on the tensor cores), both profiled with the MoE ranges' share; then 8
     ``decode_step``s at B=8 from the end of a seeded 8,192-long latent
     cache (split into shares), the last held against the same step with
     every attention call on the plain version (phase 17's bf16 gate);
 24. (runs last) LM training: (a) the attention wrapper's gradient (the
     kernel forward, the plain version's backward) against plain autograd
     at ``repro-100m``'s shape (B=8, T=256, H=10, Hkv=5, Dh=64, bf16) and a
     qwen3-8b layer (T=2048, bf16), the scan's at a falcon layer's width
     (D=8192, T cut to 256 so plain autograd fits), relative L2 per tensor
     (``GRAD_TOL``), each with its forward, backward, plain and (attention)
     SDPA forward + backward times; (b) ``repro_torch.launch.train`` at
     ``repro-100m`` (bf16, global batch 8, seq 256) under deterministic
     algorithms: 30 steps with ``--ckpt-every 10 --fail-at 15`` leave
     ``latest_step`` 10, the resumed run ends at 30, and its losses for
     steps 11-30 equal an uninterrupted run's with ``==`` (the final loss
     below step 1's), 10 attention launches a step; the elastic demo (20
     steps, crash at 10, resume); (c) one float32 step of ``repro-100m``
     (TF32 off, global batch 2) on the card against the CPU port on the same
     parameters and batch, loss and grad norm within rtol 1e-3; (d) step ms,
     tokens a second, peak memory, attention launches a step by variant,
     one step under ``torch.profiler`` (busy time, idle share), and one
     checkpoint of the state saved and restored (bytes, seconds).

Phase 29 (after phase 24): the mesh path, tensor-parallel on the model
axis (each rank's products split as the specs place the weights: its query
heads, its hidden units, its Mamba channels, its vocabulary columns, the
row-parallel partials summed over the model axis). (a) ``launch.train``
at repro-100m on meshes 2x1 and 1x2, two gloo ranks sharing the card, to
step 5 against phase 24's 1x1 losses (``MESH_LOSS_RTOL``), 10
``wgmma_bf16`` a step in each rank (on 1x2 a rank's 5 of the 10 heads),
each rank's step ms and bytes all-gathered, reduce-scattered and
all-reduced a step; the 2x1 checkpoint resumed at 1x2 and 1x1 for a step;
(b) ``launch.serve --mesh 1x2`` of reduced qwen3-8b (bf16) and reduced
jamba with ``moe_weight_shard="f"`` in float32: the 1x1 loop's tokens; of
reduced jamba in bf16: the 1x1 run scores the mesh's tokens (teacher
forcing) with the mesh's expert choices, every step's logits within 2e-2
relative L2 and the same choice at every clear step; ``decode_split`` in each rank; (c) in the parent beside them, two dry-run cells at full width on
the fake group (qwen3-8b ``train_4k`` 16x16, deepseek-v2-236b
``decode_32k`` 2x16x16), the qwen3-8b cell on a model axis of 1 (16x1:
the 16x16 cell's dot FLOPs a shard at most a tenth of it) and the qwen3-8b
cell with ``activation_partitioning="seq"`` (within 10 % of the batch
cell's); (d) ``activation_partitioning="seq"`` at 1x2 in the same ranks
(Megatron's sequence parallelism: each region gathers the stripes and
reduce-scatters back to them): repro-100m to step 5 against phase 24's
losses (10 ``wgmma_bf16`` a step a rank, its 5 heads over all 256
positions), reduced jamba in float32 (the scan on the gathered sequence,
a rank's channels; ``moe_ffn_fshard`` in the train step) for 3 steps
against its 1x1 run on the card, the scan's launches counted. Phase 12
gains rows at a stripe's shapes (qwen3-8b's ``train_4k`` layer on a model
axis of 16: Tq = 256 of Tk = 4,096 at q_offset 0 and 3,840) and at a
tensor-parallel rank's heads (the same layer's 2 query heads over 1 KV
head, T = 4,096); phase 13 a row at a rank's channels (falcon-mamba-7b's
Di 8,192 over 16: 512 channels, T = 8,192). Phase 7's ``cuttana-parallel`` runs
on social-s and its CPU parity runs in a child (``--parallel-cpu-child``,
started before phase 3; phase 18's child now starts before phase 5), and
phase 21's two children (``--mapped-child`` for (b), ``--mapped-rows-child``
for (a)'s mapped runs) run beside its resident runs.

Every phase logs its seconds (``phase_seconds``).

Kernel times: ``ms`` is device time per launch (launches captured in a CUDA
graph and replayed, so the host's cost of a call is out); ``call_ms``,
``plain_ms`` and ``library_ms`` are per call back to back on the stream, host
cost included (the plain versions and ``torch.bincount`` synchronise, so they
cannot be captured). ``bound_ms`` is the larger of the bytes the function
must move over 3.35 TB/s and its operations over the card's peak rate.

The last lines are the ``{"kernels": [...]}`` summary, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line. Without a CUDA device (and without ``--tiny``)
the script exits 2 and prints no result. ``--tiny`` runs phases 12-17 at
the reduced configs and small kernel shapes, phase 25 at the reduced
configs and small arctic rows, phases 26 and 27 at the reduced configs,
phase 19 on social-s (its constants
unchecked), phase 20 on the 2^12 and 2^14 graphs, phase 21's
full-size part on a 2^12 R-MAT, phase 22(b) on phase 2's 2^14 partition
(phase 22's committed rows and the CLI run unchanged, on the CPU), phase
23 with CPU ranks, and phase 24 at reduced qwen3-8b and small gradient
shapes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/partition_score/csrc/partition_score.cu"
# the design of csrc/partition_score.cu, named in phases 1-2, 4-6 and 8
SCORE_VARIANT = "cluster_path"
TPU_KERNEL = "src/repro/kernels/partition_score/partition_score.py:105"
TPU_KERNEL_SHARDED = "src/repro/kernels/partition_score/partition_score.py:68"
SPMV_SOURCE = "src/repro_torch/kernels/ell_spmv/csrc/ell_spmv.cu"
TPU_KERNEL_SPMV = "src/repro/kernels/ell_spmv/ell_spmv.py:33"
SPMV_VARIANT = "merge_path"  # the design of csrc/ell_spmv.cu, named in phase 9's rows
# the attention kernels' templates; flash_attention.cu builds them at Dqk = Dv,
# FLASH_MLA_LIBRARY at MLA's pairs
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cuh"
FLASH_MLA_LIBRARY = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_mla.cu"
TPU_KERNEL_FLASH = "src/repro/kernels/flash_attention/flash_attention.py:89"
SCAN_SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
TPU_KERNEL_SCAN = "src/repro/kernels/mamba_scan/mamba_scan.py:46"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
FP64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# exponentials on the special-function units: 16 per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock behind the 67 TFLOP/s
EXP_PER_S = 132 * 16 * 1.98e9
ANALYTICS_ITERS = {"pagerank": 30, "cc": 20, "sssp": 20}  # benchmarks/analytics.py
# phase 10 holds the card's values against the CPU run after this many
# iterations of each program (the CPU run at full depth took 110-130 s of
# the smoke's time limit)
CPU_PARITY_ITERS = 5
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py's
# an attention output row is a softmax average over up to 32768 keys, so its
# entries are ~sqrt(e / keys) in size, at or below the bf16 allowance above;
# every (batch, head, query) row is also held to a relative L2 error scaled to
# its own data. Kernel and plain version both keep float32 statistics and
# round the output once to its dtype, <= 2^-8 relative per entry; the bf16
# tensor-core variant also rounds each key weight P to bf16 before P V, one
# more <= 2^-9 relative error per weight that averages down over a row (its
# worst row at the qwen3 prefill layer is 4.4e-3 on an H100). A fault such
# as skipping the last 64-key tile at the 32k decode shape keeps every entry
# within the elementwise rule but not its rows within this one.
FLASH_ROW_RTOL = 1e-2
SCAN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # tests/test_kernels.py's
# one falcon-mamba-7b layer at T=8192 in float32: the kernel rounds in
# another order (exp2 of dt * (A log2 e) by ex2.approx, within 2 ulp; fused
# multiply-adds; h.C summed over a thread's states, then over the warps),
# and the state carries each rounding over its decay horizon, about
# 1/(dt*|A|) <= 100 steps at dt >= 0.01 and |A| >= 1; the test shapes' 1e-4
# covers 8-32 steps
SCAN_LAYER_TOL = 1e-3
# phase 24(a): an autograd wrapper's output and every input's gradient
# against plain autograd on the card, relative L2 per tensor (the backward
# is the plain version itself; the forward is the kernel, within its
# tolerance, and a bf16 output rounds once)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LM_ARCHS = ("qwen3-8b", "falcon-mamba-7b")
MOE_ARCHS = ("jamba-v0.1-52b", "arctic-480b")  # phase 25(a), full width, one block
DENSE_ARCHS = ("minitron-8b", "deepseek-coder-33b")  # phase 25(b), full width, two layers
# phase 26: gemma3-12b and llama-3.2-vision-90b at full width cut to one
# block, hubert-xlarge at full depth
FAMILY_ARCHS = ("gemma3-12b", "hubert-xlarge", "llama-3.2-vision-90b")
MLA_ARCH = "deepseek-v2-236b"  # phase 27, full width, its prefix layer and one block
REDUCED_ARCHS = LM_ARCHS + DENSE_ARCHS + MOE_ARCHS + FAMILY_ARCHS + (MLA_ARCH,)  # phase 16
# examples/moe_placement.py's mean fanouts, computed with repro.core.placement
# on the CPU (50,000 tokens, E=160, top-6, 16 devices, skew 0.7, seed 0)
PLACEMENT_FANOUT = {"round_robin": 4.49486, "contiguous": 4.53496, "cuttana": 2.99758}
CHUNK = 512
NUM_SHARDS = 4
# the reference's values for these specs (repro.api.partition, k=8, edge
# balance, random order, seed 0; the parallel algorithms with num_shards=4)
WEB_S_EDGE_CUT = {
    "fennel": 0.6510985792934956,
    "cuttana": 0.5606603189477736,
    "fennel-parallel": 0.6862229956993926,
    "cuttana-parallel": 0.6669873993875399,
    "cuttana-restream": 0.3857912615672953,
}
# BENCH_partition.json's outofcore/rmat40000 rows (phase 21): the converted
# file's bytes and the edge cuts, resident and mapped alike
OUTOFCORE_FILE_BYTES = 1_172_517
OUTOFCORE_EDGE_CUT = {
    "fennel": 0.7964539101261845,
    "cuttana": 0.7836849769185488,
    "cuttana-parallel": 0.7905363837141883,
}
SOCIAL_M_CUTTANA_EDGE_CUT = 0.8217978285092379
# phase 7's cuttana-parallel at S=4 on social-s (20,000 vertices), the
# reference's value (repro on the CPU)
SOCIAL_S_CUTTANA_PARALLEL_EDGE_CUT = 0.7986736565468532
# the reference's values for the zoo (repro.api.partition on web-s, the spec
# of the committed quality rows: k=8, seed 0, edge balance and random order
# where the algorithm takes them): edge cut, or (replication factor, edge
# imbalance) for the vertex-cut algorithms
WEB_S_ZOO = {
    "chunked": 0.2763935139476899,
    "cluster+cuttana": 0.5425709934905203,
    "cluster+fennel": 0.6345822386586121,
    "cuttana-batched": 0.6185177128131327,
    "cuttana-batched-legacy": 0.6185177128131327,
    "cuttana-buffcut": 0.5029367961311267,
    "cuttana-incremental": 0.6459361769775264,
    "cuttana-legacy": 0.5606603189477736,
    "fennel-legacy": 0.6510985792934956,
    "ginger": [3.911, 1.0499506350507872],
    "hash": 0.8749477066215967,
    "hdrf": [5.541, 1.000016733881089],
    "heistream": 0.6341471577502971,
    "heistream-legacy": 0.6341471577502971,
    "ldg-legacy": 0.651299385866564,
    "random": 0.8755250255191687,
}
# cuttana-parallel at S=4 by buffer strategy
WEB_S_ZOO_PARALLEL = {"gain": 0.624131929918506, "completeness": 0.6729948626985056}
# social-m, the same spec; keys are algo/num_shards
# phase 19's specs and the reference's edge cuts (computed with repro on
# the CPU); cuttana-buffcut and cluster+cuttana run on social-s (20,000
# vertices): on social-m they took 42.7 and 108.6 s of host time beside
# the H100 (700 W) in a run that overran the smoke's limit (social-m:
# 0.8243048897411314 and 0.8247421678629733)
SOCIAL_ZOO_SPECS = (
    ("social-s", "cuttana-buffcut", {"strategy": "gain"}),
    ("social-s", "cluster+cuttana", {}),
    ("social-m", "heistream", {}),
    ("social-m", "cuttana-incremental", {"num_batches": 16}),
    ("social-m", "cuttana-incremental", {"num_batches": 16, "num_shards": NUM_SHARDS}),
)
SOCIAL_ZOO = {
    "social-s cuttana-buffcut/1": 0.790310438281913,
    "social-s cluster+cuttana/1": 0.8075433217443675,
    "social-m heistream/1": 0.8393051488689073,
    "social-m cuttana-incremental/1": 0.7922356680745942,
    "social-m cuttana-incremental/4": 0.7946412375942578,
}
# BENCH_partition.json churn/rmat25000/incremental
CHURN_EDGE_CUT = 0.7724772058256066
# the reference's edge cut of phase 20's spec (cuttana-batched, k=8, edge
# balance, random order, seed 0, sample_cap 512, use_refinement=False) on
# the R-MAT of 2^scale vertices, average degree 16, seed 0, for the scales
# phase 20 checks (a quarter of its graph: 2^20 on the card, 2^12 with --tiny)
RMAT_BATCHED_EDGE_CUT = {20: 0.8362624552954572, 12: 0.7886621145043896}
# phase 22(b)'s queries on the 2^22 partition: 2,000 took 71.5 s at one
# worker on the card's host, above the 60 s a run may take in the smoke;
# 1,000 took 18.9 s at auto workers and 36.8 s at one (run W22); cut to 500
# for phases 23-24's time within the smoke's limit, and to 200 for phase 25's
# (500: 12.3 s at auto and 40.1 s at one on a slower host)
SERVING_QUERIES = 200
# result.db's two-hop queries on the 2^22 partition (phase 22(b)): 256 took
# 58.4 s on that host; the one-hop run keeps 256
DB_TWO_HOP_QUERIES = 32
# BENCH_partition.json's serving/rmat8000/* rows (phase 22; benchmarks/
# serving.py: R-MAT 8000, degree 12, seed 0, k=8, 2,000 queries seeded 1 at
# concurrency 1,000), every field but qps_wall (the host's clock)
SERVING_ALGOS = ("cuttana", "fennel", "hdrf", "random")
SERVING_ROWS = {
    "serving/rmat8000/cuttana": {
        "algo": "cuttana", "bench": "serving/rmat8000/cuttana",
        "communication_volume": 0.252890625, "concurrency": 1000,
        "edge_cut": 0.771688622754491, "local_queries": 449, "messages": 28618,
        "num_queries": 2000, "p50_sim_ms": 0.20871840000000003,
        "p99_sim_ms": 0.9992079999999999, "qps_sim": 37263.08095863419, "rpcs": 14309,
        "wire_bytes": 54748496},
    "serving/rmat8000/fennel": {
        "algo": "fennel", "bench": "serving/rmat8000/fennel",
        "communication_volume": 0.256125, "concurrency": 1000,
        "edge_cut": 0.7868502994011976, "local_queries": 447, "messages": 28740,
        "num_queries": 2000, "p50_sim_ms": 0.2089012, "p99_sim_ms": 0.9924368,
        "qps_sim": 32496.31576269672, "rpcs": 14370, "wire_bytes": 54711888},
    "serving/rmat8000/hdrf": {
        "algo": "hdrf", "bench": "serving/rmat8000/hdrf",
        "communication_volume": 0.275453125, "concurrency": 1000,
        "edge_cut": 0.8608383233532935, "local_queries": 443, "messages": 28966,
        "num_queries": 2000, "p50_sim_ms": 0.2092504, "p99_sim_ms": 1.001914496,
        "qps_sim": 28558.3295999981, "rpcs": 14483, "wire_bytes": 55904016},
    "serving/rmat8000/random": {
        "algo": "random", "bench": "serving/rmat8000/random",
        "communication_volume": 0.2843125, "concurrency": 1000,
        "edge_cut": 0.8773652694610778, "local_queries": 436, "messages": 29256,
        "num_queries": 2000, "p50_sim_ms": 0.21794760000000002,
        "p99_sim_ms": 0.99607524, "qps_sim": 33467.25411246957, "rpcs": 14628,
        "wire_bytes": 56551816},
    "serving/rmat8000/cuttana/replication": {
        "algo": "cuttana", "answers_identical": True,
        "bench": "serving/rmat8000/cuttana/replication",
        "replication_adjacency_entries": 125160, "replication_budget": 0.05,
        "replication_budget_pairs": 400, "replication_demand_covered": 15802,
        "replication_num_replicas": 400, "rpc_reduction": 0.04881656804733725,
        "rpcs_base": 3380, "rpcs_replicated": 3215},
    "serving/rmat8000/ordering": {
        "bench": "serving/rmat8000/ordering", "p99_cuttana_over_fennel": 1.006822802217733,
        "p99_cuttana_over_hdrf": 0.9972986756746156,
        "qps_cuttana_over_random": 1.1134191300370333, "tail_ordering_ok": True,
        "throughput_ordering_ok": True},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class PhaseClock:
    """Logs each phase's seconds of host clock, from the end of the one
    before."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def mark(self, phase) -> None:
        now = time.perf_counter()
        log(json.dumps({"phase": phase, "phase_seconds": now - self.last,
                        "since_start_s": now - self.start}))
        self.last = now


class Timer:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after a warm-up:
    CUDA events on the card, the host clock on the CPU."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device

    def __call__(self, fn, reps: int = 200, warmup: int = 10) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def device_ms(self, fn, reps: int = 100, replays: int = 5) -> float:
        """Mean device milliseconds of ``fn()``'s kernel: ``reps`` calls
        captured in one CUDA graph and replayed, so the host's cost of a call
        (the Python wrapper, the launch) is out of the measurement. On the
        CPU it is the host time of a call."""
        torch = self.torch
        if self.device.type != "cuda":
            return self(fn, reps=reps)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * reps)


def launch_shape(num_rows: int, k: int, width=None) -> tuple:
    """The ablation script's ``launch_shape``, without the ``src`` entry that
    it puts on ``sys.path`` at every call: phases 1 and 5 call it for every
    chunk and superstep of a stream, and a ``sys.path`` thousands of entries
    long makes every later import crawl, above all in phase 23's spawned
    ranks, which start from the parent's ``sys.path`` (minutes instead of
    seconds to start eight ranks on the card's host)."""
    import kernel_ablation_partition_score as ablation

    path = list(sys.path)
    try:
        return ablation.launch_shape(num_rows, k, width)
    finally:
        sys.path[:] = path


def floor_ms(torch, timer, floor, num_rows: int, k: int, width=None):
    """Device ms of the empty kernel at the kernel's launch shape for
    ``num_rows`` rows at ``k`` (None on the CPU)."""
    if floor is None:
        return None
    import kernel_ablation_partition_score as ablation

    return timer.device_ms(ablation.floor_call(torch, floor, launch_shape(num_rows, k, width)))


def split_stats(np, ops, degrees, k: int, width=None) -> dict:
    """The kernel's split of one call (``ops.tile_plan``): its blocks and the
    rows whose items lie in more than one block."""
    plan = ops.tile_plan(np.asarray(degrees), k, width)
    return {"blocks": plan["blocks"], "split_rows": int(plan["split"].sum())}


def gather_row(torch, np, ops, ref, dgraph, graph, device, timer, floor, rng, name, batch, k):
    """One gather-entry row: the kernel on ``batch``'s rows of ``dgraph`` at
    ``k`` (a seeded ``part_of``, 30 % unassigned) against its plain version,
    exact at alpha=0 and within 1e-6 with a penalty, timed."""
    n = graph.num_vertices
    part_np = rng.integers(0, k, size=n).astype(np.int32)
    part_np[rng.random(n) < 0.3] = -1
    part_of = torch.from_numpy(part_np).to(device)
    b = torch.from_numpy(batch.astype(np.int64)).to(device)
    zeros = torch.zeros(k, dtype=torch.float32, device=device)
    sizes = torch.from_numpy((rng.random(k) * 100).astype(np.float32)).to(device)
    args = (dgraph.indptr, dgraph.indices, part_of, b)
    got0 = ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)
    want0 = ref.fennel_scores_gather_ref(*args, zeros, 0.0, 1.5)
    got1 = ops.fennel_scores_gather(*args, sizes, 0.37, 1.5)
    want1 = ref.fennel_scores_gather_ref(*args, sizes, 0.37, 1.5)
    sync(torch, device)
    err0 = float((got0 - want0).abs().max())
    err1 = float((got1 - want1).abs().max())
    check(err0 == 0.0, f"{name}: kernel differs from plain version at alpha=0 ({err0})")
    check(err1 <= 1e-6, f"{name}: kernel differs from plain version with penalty ({err1})")
    if "hub" in name:
        check(torch.equal(got0, ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)),
              f"{name}: two launches differ")
    rows, pos = ref.expand_rows(dgraph.indptr, b)
    parts = part_of[dgraph.indices[pos].long()]
    keep = parts >= 0
    keys = rows[keep] * k + parts[keep].long()
    nnz = int(rows.shape[0])
    c = int(b.shape[0])
    # each input read once, the output written once: the batch, two
    # indptr entries per row, the row's indices, one part_of gather per
    # entry, the size row; C*K float32 scores out
    nbytes = c * 8 + 2 * c * 8 + nnz * 4 + nnz * 4 + k * 4 + c * k * 4
    return {
        "shape": name, "variant": SCORE_VARIANT, "rows": c, "k": k, "nnz": nnz,
        "max_row": int(graph.degrees[batch].max()),
        **split_stats(np, ops, graph.degrees[batch], k),
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "ms": timer.device_ms(lambda: ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)),
        "call_ms": timer(lambda: ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)),
        "plain_ms": timer(lambda: ref.fennel_scores_gather_ref(*args, zeros, 0.0, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=c * k)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "floor_ms": floor_ms(torch, timer, floor, c, k),
    }


def dense_row(torch, np, ops, ref, device, timer, floor, rng, name, nbr_np, k):
    """One dense-entry row: the kernel on the int32 ``[B, D]`` matrix
    ``nbr_np`` at ``k`` against its plain version, exact at alpha=0 and
    within 1e-6 with a penalty, timed."""
    bsz, d = nbr_np.shape
    nbr = torch.from_numpy(nbr_np).to(device)
    zeros = torch.zeros(k, dtype=torch.float32, device=device)
    sizes = torch.from_numpy((rng.random(k) * 100).astype(np.float32)).to(device)
    err0 = float((ops.fennel_scores(nbr, zeros, 0.0) - ref.fennel_scores_ref(nbr, zeros, 0.0, 1.5)).abs().max())
    err1 = float((ops.fennel_scores(nbr, sizes, 0.37, 1.5) - ref.fennel_scores_ref(nbr, sizes, 0.37, 1.5)).abs().max())
    check(err0 == 0.0, f"{name}: kernel differs from plain version at alpha=0 ({err0})")
    check(err1 <= 1e-6, f"{name}: kernel differs from plain version with penalty ({err1})")
    flat = nbr.reshape(-1).long()
    keep = flat >= 0
    keys = (torch.arange(bsz, device=device).repeat_interleave(d)[keep] * k + flat[keep])
    return {
        "shape": name, "variant": SCORE_VARIANT, "rows": bsz, "k": k,
        "nnz": bsz * d, **split_stats(np, ops, np.full(bsz, d), k, d),
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "ms": timer.device_ms(lambda: ops.fennel_scores(nbr, sizes, 0.37, 1.5)),
        "call_ms": timer(lambda: ops.fennel_scores(nbr, sizes, 0.37, 1.5)),
        "plain_ms": timer(lambda: ref.fennel_scores_ref(nbr, sizes, 0.37, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=bsz * k)),
        "bound_ms": (bsz * d * 4 + k * 4 + bsz * k * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "floor_ms": floor_ms(torch, timer, floor, bsz, k, d),
    }


def sampled_matrix(np, graph, rng, k: int, sample_cap: int = 512) -> np.ndarray:
    """The ``[s, width]`` matrix a ``cuttana-batched`` run sends through the
    dense entry for the first chunk of the random order holding a row above
    ``sample_cap``: each such row's ``sample_cap`` neighbours drawn without
    replacement (from ``default_rng(0)``, in row order, as the engine draws
    them), their parts under a seeded ``part_of`` (30 % unassigned), padded
    with -1 to ``width``, a power of two of at least 8."""
    from repro_torch.graph.stream import stream_order

    ids = stream_order(graph, "random", 0)
    first = int(np.flatnonzero(graph.degrees[ids] > sample_cap)[0]) // CHUNK
    batch = ids[first * CHUNK : (first + 1) * CHUNK]
    over = batch[graph.degrees[batch] > sample_cap]
    n = graph.num_vertices
    part_np = rng.integers(0, k, size=n).astype(np.int32)
    part_np[rng.random(n) < 0.3] = -1
    width = max(8, 1 << (sample_cap - 1).bit_length())
    out = np.full((over.size, width), -1, dtype=np.int32)
    draw = np.random.default_rng(0)
    indptr, indices = graph.indptr, graph.indices
    for j, v in enumerate(over.tolist()):
        nb = indices[indptr[v] : indptr[v + 1]]
        out[j, :sample_cap] = part_np[nb[draw.choice(nb.size, size=sample_cap, replace=False)]]
    return out


def kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor):
    """Phase 1: kernel vs plain version at the main path's shapes."""
    rng = np.random.default_rng(0)
    order = rng.permutation(graph.num_vertices)
    hub = int(graph.degrees.argmax())
    gather_shapes = [
        ("chunk512_k8", order[:CHUNK], 8),
        ("chunk512_k64", order[CHUNK : 2 * CHUNK], 64),
        ("chunk512_hub_k8", np.concatenate([[hub], order[2 * CHUNK : 3 * CHUNK - 1]]), 8),
    ]
    rows_out = [gather_row(torch, np, ops, ref, dgraph, graph, device, timer, floor, rng,
                           name, batch, k) for name, batch, k in gather_shapes]
    # the dense entry (the JAX signature)
    rows_out.append(dense_row(torch, np, ops, ref, device, timer, floor, rng, "dense200x100_k16",
                              rng.integers(-1, 16, size=(200, 100)).astype(np.int32), 16))
    # the zoo's shapes (phases 18-20): heistream's 4,096-row chunks and the
    # sampled rows of cuttana-batched (sample_cap 512, so width 512)
    zoo_rng = np.random.default_rng(1)
    rows_out.append(gather_row(torch, np, ops, ref, dgraph, graph, device, timer, floor, zoo_rng,
                               "chunk4096_k8", order[: 8 * CHUNK], 8))
    sampled = sampled_matrix(np, graph, zoo_rng, 8)
    rows_out.append(dense_row(torch, np, ops, ref, device, timer, floor, zoo_rng,
                              f"dense_sampled_s{sampled.shape[0]}x512_k8", sampled, 8))
    rows_out.append(stream_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor,
                                  sharded=False))
    for row in rows_out:
        log(json.dumps({"phase": 1, **row}))
    return rows_out


def stream_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor, sharded: bool):
    """The stream rows of phases 1 and 5: every chunk of phase 2's random
    order (every superstep of phase 6's at S=4, shard after shard), each
    launch on its own slice of one device tensor of row ids, at alpha=0 as
    the engines score, captured in one CUDA graph (on the CPU: called in
    turn): total, mean and slowest launch, beside the empty kernel at each
    launch's shape captured the same way. L2 holds little of a launch's rows
    here, unlike a replay of one chunk. All launches' scores together must
    equal one plain call over all the rows (``plain_ms``)."""
    import kernel_ablation_partition_score as ablation
    from repro_torch.graph.stream import ShardedStream, stream_order

    n, k = graph.num_vertices, 8
    ids = stream_order(graph, "random", 0)
    if sharded:
        shards = ShardedStream.from_ids(ids, NUM_SHARDS)
        steps = [[sh[t * CHUNK : (t + 1) * CHUNK] for sh in shards.shards]
                 for t in range(shards.num_supersteps(CHUNK))]
        flat = np.concatenate([np.concatenate(bs) for bs in steps])
        counts = [[b.shape[0] for b in bs] for bs in steps]
        bounds = np.cumsum([0] + [sum(c) for c in counts]).tolist()
        starts = torch.from_numpy(np.array([np.concatenate([[0], np.cumsum(c)]) for c in counts],
                                           dtype=np.int64)).to(device)
        sizes = torch.zeros((NUM_SHARDS, k), dtype=torch.float32, device=device)
        name = f"superstep_stream_s{NUM_SHARDS}_k{k}"
    else:
        flat = ids
        bounds = list(range(0, n, CHUNK)) + [n]
        sizes = torch.zeros(k, dtype=torch.float32, device=device)
        name = f"stream{len(bounds) - 1}_k{k}"
    launches = len(bounds) - 1
    rng = np.random.default_rng(7)
    part_np = rng.integers(0, k, size=n).astype(np.int32)
    part_np[rng.random(n) < 0.3] = -1
    part_of = torch.from_numpy(part_np).to(device)
    b_dev = torch.from_numpy(flat.astype(np.int64)).to(device)
    args = (dgraph.indptr, dgraph.indices, part_of)

    def call(i):
        b = b_dev[bounds[i] : bounds[i + 1]]
        if sharded:
            return ops.fennel_scores_sharded_gather(*args, b, starts[i], sizes, 0.0, 1.5)
        return ops.fennel_scores_gather(*args, b, sizes, 0.0, 1.5)

    calls = [lambda i=i: call(i) for i in range(launches)]
    if device.type == "cuda":
        times, outs = ablation.stream_times(torch, calls)
        empty = ablation.stream_times(torch, [ablation.floor_call(
            torch, floor, launch_shape(bounds[i + 1] - bounds[i], k))
            for i in range(launches)])[0]
    else:
        t0 = time.perf_counter()
        outs = [c() for c in calls]
        total = (time.perf_counter() - t0) * 1e3
        times = {"total_ms": total, "mean_ms": total / launches, "slowest_ms": None,
                 "slowest": None}
        empty = {"total_ms": None, "mean_ms": None}
    got = torch.cat(outs)
    zeros = torch.zeros(k, dtype=torch.float32, device=device)
    want = ref.fennel_scores_gather_ref(*args, b_dev, zeros, 0.0, 1.5)
    if device.type == "cuda":
        torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err == 0.0, f"{name}: the stream's scores differ from the plain version ({err})")
    del got, outs, want
    degrees = graph.degrees[flat]
    nnz = int(degrees.sum())
    rows, pos = ref.expand_rows(dgraph.indptr, b_dev)
    parts = part_of[dgraph.indices[pos].long()]
    keep = parts >= 0
    keys = rows[keep] * k + parts[keep].long()
    del rows, pos, parts, keep
    # each launch reads its ids, two indptr entries a row, its rows' indices,
    # one part_of gather an entry, its size rows (and shard bounds), and
    # writes its scores
    nbytes = (24 * n + 8 * nnz + 4 * n * k
              + launches * (k * 4 if not sharded else NUM_SHARDS * k * 4 + (NUM_SHARDS + 1) * 8))
    slow = times["slowest"]
    slow_deg = degrees[bounds[slow] : bounds[slow + 1]] if slow is not None else None
    row = {
        "shape": name, "variant": SCORE_VARIANT, "launches": launches, "rows": n, "k": k,
        "nnz": nnz, "max_abs_err_alpha0": err, "ms": times["mean_ms"],
        "total_ms": times["total_ms"], "slowest_ms": times["slowest_ms"], "slowest_launch": slow,
        "slowest_launch_nnz": int(slow_deg.sum()) if slow is not None else None,
        "slowest_launch_max_degree": int(slow_deg.max()) if slow is not None else None,
        "floor_ms": empty["mean_ms"], "floor_total_ms": empty["total_ms"],
        # one call each (the plain version takes seconds at this size; the
        # check above has warmed it up)
        "plain_ms": timer(lambda: ref.fennel_scores_gather_ref(*args, b_dev, zeros, 0.0, 1.5),
                          reps=1, warmup=0),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=n * k), reps=1, warmup=1),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    del keys
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def profile_stream(torch, tapi, graph, device, algo="fennel", params=None) -> dict:
    """Phases 4 and 8: ``algo`` on ``graph`` under ``torch.profiler``: how
    much of the run the card is busy, and with what. Device events are summed
    by name (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0,
                              params=params)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = tapi.partition(graph, spec, device=device)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {
        "algo": algo, "params": params, "num_vertices": graph.num_vertices,
        "kernel_calls": res.telemetry["kernel_calls"], "variant": SCORE_VARIANT,
        "profiled_wall_s": wall, "stream_seconds": res.timings["stream_seconds"],
        **device_time(prof, wall, on_card, "score_path_kernel"),
    }


def device_time(prof, wall: float, on_card: bool, kernel_name: str) -> dict:
    """The card's busy time and idle share over a profiled window of
    ``wall`` seconds, and the device time of the kernels whose name holds
    ``kernel_name``. Device events are summed by name (one stream, so they
    do not overlap); user annotations such as a schedule's ``ProfilerStep#``
    span the window on the device's timeline and are no device work."""
    from torch.autograd import DeviceType

    by_name: dict[str, list] = {}
    for e in prof.events():
        annotation = getattr(e, "is_user_annotation", False) or e.name.startswith("ProfilerStep")
        if e.device_type == DeviceType.CUDA and not annotation:
            slot = by_name.setdefault(e.name, [0.0, 0])
            slot[0] += e.time_range.elapsed_us()
            slot[1] += 1
    busy_us = sum(us for us, _ in by_name.values())
    kernel = [v for k, v in by_name.items() if kernel_name in k]
    kernel_us = sum(us for us, _ in kernel)
    kernel_n = sum(n for _, n in kernel)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "device_busy_s": busy_us / 1e6 if on_card else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if on_card else None,
        "kernel_events": kernel_n if on_card else None,
        "kernel_device_ms_total": kernel_us / 1e3 if on_card else None,
        "kernel_device_ms_per_launch": kernel_us / 1e3 / kernel_n if kernel_n else None,
        "top_device_events_ms": [[k[:80], us / 1e3, n] for k, (us, n) in top],
    }


def profile_analytics(torch, res, spmv, device, iters: int = 30) -> dict:
    """Phase 11: ``res.analytics("pagerank", iters)`` under
    ``torch.profiler``: how much of the run the card is busy. The run is
    about 10 ms, and a window that short loses the device events of its
    first milliseconds, so one run warms the profiler up and the next one
    is recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            spmv.launches = 0
            t0 = time.perf_counter()
            out = res.analytics("pagerank", iters, mode="simulated")
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    return {
        "program": "pagerank", "iters": iters, "num_vertices": res.graph.num_vertices,
        "algo": res.spec.algo, "profiled_wall_s": wall, "seconds": out["seconds"],
        "launches": spmv.launches, **device_time(prof, wall, on_card, "spmv_kernel"),
    }


def sharded_kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor):
    """Phase 5: the sharded kernel vs its plain version at the parallel
    path's shapes: superstep batches of the random stream order (seed 0),
    shard after shard, as ``_SuperstepRunner`` packs them."""
    from repro_torch.graph.stream import ShardedStream, stream_order

    rng = np.random.default_rng(5)
    n = graph.num_vertices
    ids = stream_order(graph, "random", 0)
    hub = int(graph.degrees.argmax())
    s4 = ShardedStream.from_ids(ids, NUM_SHARDS)
    hub_shard = int(np.flatnonzero(ids == hub)[0]) % NUM_SHARDS
    t_hub = int(np.flatnonzero(s4.shards[hub_shard] == hub)[0]) // CHUNK
    cases = [
        (f"superstep_s{NUM_SHARDS}_k8", s4, 0, 8),
        ("superstep_s8_k8", ShardedStream.from_ids(ids, 8), 0, 8),
        (f"superstep_hub_s{NUM_SHARDS}_k8", s4, t_hub, 8),
        (f"superstep_s{NUM_SHARDS}_k64", s4, 1, 64),
    ]
    rows_out = []
    for name, sharded, step, k in cases:
        batches = [sh[step * CHUNK : (step + 1) * CHUNK] for sh in sharded.shards]
        counts = [b.shape[0] for b in batches]
        s = len(batches)
        part_np = rng.integers(0, k, size=n).astype(np.int32)
        part_np[rng.random(n) < 0.3] = -1
        part_of = torch.from_numpy(part_np).to(device)
        b = torch.from_numpy(np.concatenate(batches).astype(np.int64)).to(device)
        start = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)).to(device)
        zeros = torch.zeros((s, k), dtype=torch.float32, device=device)
        sizes = torch.from_numpy((rng.random((s, k)) * 100).astype(np.float32)).to(device)
        args = (dgraph.indptr, dgraph.indices, part_of, b, start)
        got0 = ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)
        want0 = ref.fennel_scores_sharded_gather_ref(*args, zeros, 0.0, 1.5)
        got1 = ops.fennel_scores_sharded_gather(*args, sizes, 0.37, 1.5)
        want1 = ref.fennel_scores_sharded_gather_ref(*args, sizes, 0.37, 1.5)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err0 = float((got0 - want0).abs().max())
        err1 = float((got1 - want1).abs().max())
        check(err0 == 0.0, f"{name}: sharded kernel differs from plain version at alpha=0 ({err0})")
        check(err1 <= 1e-6, f"{name}: sharded kernel differs from plain version with penalty ({err1})")
        if "hub" in name:
            check(torch.equal(got0, ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)),
                  f"{name}: two launches differ")
        rows, pos = ref.expand_rows(dgraph.indptr, b)
        parts = part_of[dgraph.indices[pos].long()]
        keep = parts >= 0
        keys = rows[keep] * k + parts[keep].long()
        nnz = int(rows.shape[0])
        c = int(b.shape[0])
        # each input read once, the output written once: the candidates, two
        # indptr entries per row, the rows' indices, one part_of gather per
        # entry, the shard bounds and size rows; C*K float32 scores out
        nbytes = c * 8 + 2 * c * 8 + nnz * 4 + nnz * 4 + (s + 1) * 8 + s * k * 4 + c * k * 4
        rows_out.append({
            "shape": name, "variant": SCORE_VARIANT, "shards": s, "superstep": step, "rows": c,
            "k": k, "nnz": nnz, **split_stats(np, ops, graph.degrees[np.concatenate(batches)], k),
            "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
            "ms": timer.device_ms(lambda: ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)),
            "call_ms": timer(lambda: ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)),
            "plain_ms": timer(lambda: ref.fennel_scores_sharded_gather_ref(*args, zeros, 0.0, 1.5)),
            "library_ms": timer(lambda: torch.bincount(keys, minlength=c * k)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "floor_ms": floor_ms(torch, timer, floor, c, k),
        })
    # the dense entry (the JAX signature) with random per-shard size rows
    s, c, d, k = NUM_SHARDS, CHUNK, 64, 8
    nbr = torch.from_numpy(rng.integers(-1, k, size=(s, c, d)).astype(np.int32)).to(device)
    zeros = torch.zeros((s, k), dtype=torch.float32, device=device)
    sizes = torch.from_numpy((rng.random((s, k)) * 100).astype(np.float32)).to(device)
    err0 = float((ops.fennel_scores_sharded(nbr, zeros, 0.0)
                  - ref.fennel_scores_sharded_ref(nbr, zeros, 0.0, 1.5)).abs().max())
    err1 = float((ops.fennel_scores_sharded(nbr, sizes, 0.37, 1.5)
                  - ref.fennel_scores_sharded_ref(nbr, sizes, 0.37, 1.5)).abs().max())
    check(err0 == 0.0, f"sharded dense: kernel differs from plain version at alpha=0 ({err0})")
    check(err1 <= 1e-6, f"sharded dense: kernel differs from plain version with penalty ({err1})")
    flat = nbr.reshape(-1).long()
    keep = flat >= 0
    keys = torch.arange(s * c, device=device).repeat_interleave(d)[keep] * k + flat[keep]
    rows_out.append({
        "shape": f"dense{s}x{c}x{d}_k{k}", "variant": SCORE_VARIANT, "shards": s, "rows": s * c,
        "k": k, "nnz": s * c * d, **split_stats(np, ops, np.full(s * c, d), k, d),
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "ms": timer.device_ms(lambda: ops.fennel_scores_sharded(nbr, sizes, 0.37, 1.5)),
        "call_ms": timer(lambda: ops.fennel_scores_sharded(nbr, sizes, 0.37, 1.5)),
        "plain_ms": timer(lambda: ref.fennel_scores_sharded_ref(nbr, sizes, 0.37, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=s * c * k)),
        "bound_ms": (s * c * d * 4 + s * k * 4 + s * c * k * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "floor_ms": floor_ms(torch, timer, floor, s * c, k, d),
    })
    rows_out.append(stream_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor,
                                  sharded=True))
    for row in rows_out:
        log(json.dumps({"phase": 5, **row}))
    return rows_out


def spmv_row(torch, timer, name, entry, reduce, got, want, call, plain, library,
             nbytes: int, ops: int, reps: int = 200, **extra) -> dict:
    """One phase-9 row: the kernel against its plain version (min exactly,
    sum within rtol 1e-6), its times, and its bound."""
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / want.double().abs().clamp(min=1e-30)).max()) if diff.numel() else 0.0
    if reduce == "min":
        check(torch.equal(got, want), f"{name}: min kernel differs from plain version ({err})")
    else:
        check(bool((diff <= 1e-6 * want.double().abs()).all()),
              f"{name}: sum kernel differs from plain version beyond rtol 1e-6 ({rel})")
    rate = FP64_OPS_PER_S if reduce == "sum" else FP32_OPS_PER_S
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    ms = timer.device_ms(call)
    return {
        "shape": name, "entry": entry, "reduce": reduce, "variant": SPMV_VARIANT, **extra,
        "max_abs_err": err, "max_rel_err": rel,
        "ms": ms, "gb_per_s": nbytes / ms / 1e6,
        "call_ms": timer(call, reps=reps),
        "plain_ms": timer(plain, reps=reps),
        "library_ms": timer(library, reps=reps),
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def spmv_kernel_checks(torch, np, spmv, spmv_ref, lg, device, timer):
    """Phase 9: the gather/reduce kernel vs its plain version on both row
    loaders, at the analytics engine's shape for phase 2's partition."""
    rng = np.random.default_rng(9)
    dev = lg.to(device)
    k, v_max, state_len, e_max = lg.k, lg.v_max, lg.state_len, lg.e_max
    rows_out = []
    x_np = rng.random((k, state_len)).astype(np.float32)
    rows64 = torch.from_numpy(lg.rows.astype(np.int64)).to(device)
    cols64 = dev.cols.long()
    ent_rows, ent_pos = spmv_ref.segment_entries(dev.row_ptr, e_max)
    nnz = int(ent_rows.shape[0])
    # distinct source values the real entries read: the x bytes the function needs
    x_read = int(torch.unique((ent_pos // e_max) * state_len + dev.cols.reshape(-1)[ent_pos]).shape[0])
    del ent_rows, ent_pos
    degs = (dev.row_ptr[:, 1:] - dev.row_ptr[:, :-1])
    p_hub, r_hub = divmod(int(degs.reshape(-1).argmax()), v_max)
    hub_deg = int(degs[p_hub, r_hub])
    for reduce, ident in (("sum", 0.0), ("min", 3e38)):
        x_np[:, -1] = ident
        x = torch.from_numpy(x_np).to(device)
        args = (x, dev.row_ptr, dev.cols, reduce)
        got = spmv.ell_spmv_segments(*args)
        again = spmv.ell_spmv_segments(*args)
        want = spmv_ref.ell_spmv_segments_ref(*args)
        if device.type == "cuda":
            torch.cuda.synchronize()
        check(torch.equal(got, again), f"engine {reduce}: two launches gave different bits")
        red = "sum" if reduce == "sum" else "amin"
        rows_out.append(spmv_row(
            torch, timer, f"engine_k{k}_{reduce}", "segments", reduce, got, want,
            lambda: spmv.ell_spmv_segments(*args),
            lambda: spmv_ref.ell_spmv_segments_ref(*args),
            lambda: torch.full((k, v_max + 1), ident, device=device).scatter_reduce_(
                1, rows64, x.gather(1, cols64), red, include_self=True),
            nbytes=k * (v_max + 1) * 8 + nnz * 4 + x_read * 4 + k * v_max * 4, ops=nnz,
            reps=10, rows=k * v_max, nnz=nnz, hub_degree=hub_deg, deterministic=True,
        ))
        # a 32-row batch of the hub's device holding the hub row: one warp
        # walks the hub's whole degree, the tail of the engine's launch
        r0 = max(0, min(r_hub, v_max - 32))
        rp = (dev.row_ptr[p_hub, r0 : r0 + 33] - dev.row_ptr[p_hub, r0]).reshape(1, -1).contiguous()
        lo, hi = int(dev.row_ptr[p_hub, r0]), int(dev.row_ptr[p_hub, r0 + rp.shape[1] - 1])
        hcols = dev.cols[p_hub, lo:hi].reshape(1, -1).contiguous()
        hx = x[p_hub : p_hub + 1].contiguous()
        hargs = (hx, rp, hcols, reduce)
        hrows = torch.arange(rp.shape[1] - 1, device=device).repeat_interleave(rp[0, 1:] - rp[0, :-1])
        rows_out.append(spmv_row(
            torch, timer, f"hub_batch32_{reduce}", "segments", reduce,
            spmv.ell_spmv_segments(*hargs), spmv_ref.ell_spmv_segments_ref(*hargs),
            lambda: spmv.ell_spmv_segments(*hargs),
            lambda: spmv_ref.ell_spmv_segments_ref(*hargs),
            lambda: torch.full((rp.shape[1] - 1,), ident, device=device).scatter_reduce_(
                0, hrows, hx[0][hcols[0].long()], red, include_self=True),
            nbytes=rp.numel() * 8 + hcols.numel() * 4
            + int(torch.unique(hcols).shape[0]) * 4 + (rp.shape[1] - 1) * 4,
            ops=hcols.numel(), rows=rp.shape[1] - 1, nnz=hcols.numel(), hub_degree=hub_deg,
        ))
        # the same batch as the dense ELL matrix the TPU kernel needs: every
        # row padded to the hub's degree with the identity slot
        ell = torch.full((rp.shape[1] - 1, hub_deg), state_len - 1, dtype=torch.int32, device=device)
        for r in range(rp.shape[1] - 1):
            a, b = int(rp[0, r]), int(rp[0, r + 1])
            ell[r, : b - a] = hcols[0, a:b]
        xe = hx[0]
        rows_out.append(spmv_row(
            torch, timer, f"hub_ell32x{hub_deg}_{reduce}", "ell", reduce,
            spmv.ell_spmv(xe, ell, reduce), spmv_ref.ell_spmv_ref(xe, ell, reduce),
            lambda: spmv.ell_spmv(xe, ell, reduce),
            lambda: spmv_ref.ell_spmv_ref(xe, ell, reduce),
            lambda: (torch.sum if reduce == "sum" else torch.amin)(xe[ell.long()], 1),
            nbytes=ell.numel() * 4 + int(torch.unique(ell).shape[0]) * 4 + ell.shape[0] * 4,
            ops=ell.numel(), rows=ell.shape[0], nnz=ell.numel(), hub_degree=hub_deg,
        ))
        # tests/test_kernels.py's ELL shapes and inputs
        for r, d, v in ((16, 8, 64), (128, 32, 300), (333, 17, 1000)):
            trng = np.random.default_rng(r + d)
            xt = np.concatenate([trng.random(v).astype(np.float32), [ident]]).astype(np.float32)
            ct = trng.integers(0, v + 1, size=(r, d)).astype(np.int32)
            xt, ct = torch.from_numpy(xt).to(device), torch.from_numpy(ct).to(device)
            rows_out.append(spmv_row(
                torch, timer, f"ell{r}x{d}_v{v}_{reduce}", "ell", reduce,
                spmv.ell_spmv(xt, ct, reduce), spmv_ref.ell_spmv_ref(xt, ct, reduce),
                lambda: spmv.ell_spmv(xt, ct, reduce),
                lambda: spmv_ref.ell_spmv_ref(xt, ct, reduce),
                lambda: (torch.sum if reduce == "sum" else torch.amin)(xt[ct.long()], 1),
                nbytes=r * d * 4 + int(torch.unique(ct).shape[0]) * 4 + r * 4,
                ops=r * d, rows=r, nnz=r * d,
            ))
    del rows64, cols64
    for row in rows_out:
        log(json.dumps({"phase": 9, **row}))
    return rows_out


def zoo_fields(tapi, name: str, **params) -> dict:
    """Spec fields of the committed quality rows: k=8, seed 0, edge balance
    and random order where the algorithm takes them."""
    info = tapi.get_info(name)
    fields = dict(algo=name, k=8, seed=0, params=params or None)
    if info.balance_modes:
        fields["balance_mode"] = "edge"
    if "order" in info.common:
        fields["order"] = "random"
    return fields


def zoo_value(res):
    """A run's committed quality value: the edge cut of an edge-cut run,
    (replication factor, edge imbalance) of a vertex-cut run."""
    q = res.quality()
    if res.is_vertex_cut:
        return [q["replication_factor"], q["edge_imbalance"]]
    return q["edge_cut"]


def sampled_chunks(np, graph, sample_cap: int, order: str = "random", seed: int = 0,
                   chunk: int = CHUNK) -> int:
    """Chunks of the stream holding a row above ``sample_cap``: the
    dense-entry launches of a ``cuttana-batched`` run, on top of one
    gather-entry launch a chunk."""
    from repro_torch.graph.stream import stream_order

    over = graph.degrees[stream_order(graph, order, seed)] > sample_cap
    return int(np.logical_or.reduceat(over, np.arange(0, over.size, chunk)).sum())


def cpu_result(np, res) -> dict:
    """What phase 18 holds a card run against: the CPU run's assignment
    (and a vertex cut's edge partition), its quality and its timings."""
    out = {"assignment": np.asarray(res.assignment), "quality": res.quality(),
           "timings": res.timings}
    if res.is_vertex_cut:
        out.update({f: np.asarray(getattr(res.edge_partition, f))
                    for f in ("replicas", "masters", "edge_counts")})
    return out


def web_zoo_specs(tapi) -> list:
    """Phase 18's specs in order: ``(key, PartitionSpec fields)``."""
    specs = [(name, zoo_fields(tapi, name)) for name in sorted(WEB_S_ZOO)]
    return specs + [(f"cuttana-parallel/{strategy}", zoo_fields(
        tapi, "cuttana-parallel", num_shards=NUM_SHARDS, strategy=strategy))
        for strategy in ("gain", "completeness")]


def zoo_cpu_child(out: str) -> int:
    """Phase 18's CPU side, in a child process the parent starts before
    phase 5: every web-s spec on the CPU, pickled to ``out`` for the parent
    to hold its card runs against (until PR 25 they ran one after the other
    in the parent: 56 s of its phase 18's 115 s on the H100 80GB HBM3
    (700 W) machine, run A24)."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.api as tapi
    from repro_torch.graph.generators import load_dataset

    web = load_dataset("web-s", seed=0)
    return dump_cpu_results(out, {key: cpu_result(np, tapi.partition(
        web, tapi.PartitionSpec(**fields), device="cpu")) for key, fields in web_zoo_specs(tapi)})


# phase 7's sharded algorithms on web-s, card and CPU
PARALLEL_ALGOS = ("fennel-parallel", "cuttana-parallel", "cuttana-restream")


def parallel_spec(tapi, algo: str):
    return tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0,
                              params={"num_shards": NUM_SHARDS})


def parallel_cpu_child(out: str) -> int:
    """Phase 7's CPU side, in a child process the parent starts before
    phase 3: the three sharded algorithms on web-s on the CPU, pickled to
    ``out`` (they once ran in the parent, between its card runs)."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.api as tapi
    from repro_torch.graph.generators import load_dataset

    web = load_dataset("web-s", seed=0)
    return dump_cpu_results(out, {algo: cpu_result(np, tapi.partition(
        web, parallel_spec(tapi, algo), device="cpu")) for algo in PARALLEL_ALGOS})


def dump_cpu_results(out: str, results: dict) -> int:
    import pickle

    with open(out, "wb") as f:
        pickle.dump(results, f)
    return 0


class CpuChild:
    """A running CPU-side child process (``flag``: ``--zoo-cpu-child`` for
    phase 18, ``--parallel-cpu-child`` for phase 7); killed at exit if a
    check fails before its phase collects it."""

    def __init__(self, flag: str, phase: int, tiny: bool):
        import atexit
        import tempfile

        fd, self.path = tempfile.mkstemp(prefix=f"chip_smoke_{phase}_", suffix=".pkl")
        os.close(fd)
        self.phase = phase
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag, self.path]
            + (["--tiny"] if tiny else []), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        atexit.register(self.proc.kill)

    def results(self) -> dict:
        """The child's results, waiting for it; logs how long it ran."""
        import pickle

        out, err = self.proc.communicate(timeout=900)
        check(self.proc.returncode == 0,
              f"phase {self.phase}'s CPU child failed:\n{out}\n{err}")
        with open(self.path, "rb") as f:
            results = pickle.load(f)
        os.unlink(self.path)
        log(json.dumps({"phase": self.phase, "cpu_child_seconds": time.perf_counter() - self.t0,
                        "cpu_child_waited": True}))
        return results


def same_as_cpu(np, on_dev, on_cpu: dict, fields, device) -> dict:
    """Checks that a card run's result (assignment, a vertex cut's edge
    partition, quality) is the CPU run's ``cpu_result``; the row's fields."""
    check(np.array_equal(on_dev.assignment, on_cpu["assignment"]),
          f"{fields['algo']}: {device.type} and cpu results differ")
    if on_dev.is_vertex_cut:
        for f in ("replicas", "masters", "edge_counts"):
            check(np.array_equal(getattr(on_dev.edge_partition, f), on_cpu[f]),
                  f"{fields['algo']}: {device.type} and cpu {f} differ")
    check(on_dev.quality() == on_cpu["quality"],
          f"{fields['algo']}: {device.type} and cpu quality differ")
    return {"identical_to_cpu": True, "timings_cpu": on_cpu["timings"]}


def zoo_run(torch, np, tapi, ops, counters, graph, device, fields, expect_launches,
            cpu_too: bool = True) -> tuple:
    """One spec on ``device`` (and on the CPU): identical results, and the
    partition-score launches of the device run, sequential and sharded
    entries together, equal to ``expect_launches(result)``. Returns the
    device result, the row to log and the launch counts."""
    spec = tapi.PartitionSpec(**fields)
    reset_counts(*counters)
    on_dev = tapi.partition(graph, spec, device=device)
    sync(torch, device)
    seq, sharded = ops.launches, ops.sharded_launches
    want = expect_launches(on_dev) if device.type == "cuda" else 0
    check(seq + sharded == want,
          f"{fields['algo']}: {seq} + {sharded} partition-score launches, expected {want}")
    row = {"algo": fields["algo"], "params": fields.get("params"), "value": zoo_value(on_dev),
           "kernel_calls": on_dev.telemetry.get("kernel_calls"), "launches": seq,
           "sharded_launches": sharded, "timings_device": on_dev.timings}
    if cpu_too:
        row.update(same_as_cpu(np, on_dev, cpu_result(np, tapi.partition(graph, spec,
                                                                         device="cpu")),
                               fields, device))
    return on_dev, row, (seq, sharded)


def profile_once(torch, fn, device, kernel_name: str) -> tuple:
    """One call of ``fn`` under ``torch.profiler`` (a window of seconds, so
    no warm-up call): its value and the card's busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(torch, device)
        wall = time.perf_counter() - t0
    return out, {"profiled_wall_s": wall, **device_time(prof, wall, on_card, kernel_name)}


def zoo_phases(torch, np, tapi, ops, ref, counters, device, timer, floor, web, social, graph,
               dataset: str, tiny: bool, ident: str, clock, zoo_cpu: CpuChild) -> tuple:
    """Phases 18-20: the partitioner zoo on the card, phase 18's CPU side
    from ``zoo_cpu``. Returns the launches of each path and the kernel rows
    at the zoo's own shapes, for the summary line, and phase 20's R-MAT (a
    quarter of phase 2's), which phase 21 partitions memory-mapped."""
    from repro_torch.core.cluster import build_coarse_graph, streaming_cluster
    from repro_torch.core.incremental import IncrementalPartitioner
    from repro_torch.graph.churn import rmat_churn
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.metrics import quality_report
    from repro_torch.graph.stream import stream_order

    paths: dict = {}
    kernel_rows: list = []

    def engine_launches(res):
        return res.telemetry["kernel_calls"]

    def batched_launches(res):
        cap = res.spec.params.sample_cap
        return res.telemetry["kernel_calls"] + sampled_chunks(np, res.graph, cap)

    def legacy_batched_launches(res):
        return -(-res.graph.num_vertices // res.spec.params.chunk)

    # ----------------------------------------------------------- phase 18
    dev_runs = []
    for name, fields in web_zoo_specs(tapi):
        if name.startswith("cuttana-parallel/"):
            continue
        info = tapi.get_info(name)
        if name == "cuttana-batched":
            expect = batched_launches
        elif name == "cuttana-batched-legacy":
            expect = legacy_batched_launches
        elif info.engine == "engine":
            expect = engine_launches
        else:
            expect = lambda res: 0  # host loops: no partition-score launch  # noqa: E731
        res, row, launched = zoo_run(torch, np, tapi, ops, counters, web, device, fields, expect,
                                     cpu_too=False)
        check(row["value"] == WEB_S_ZOO[name],
              f"web-s {name}: {row['value']} != the reference's {WEB_S_ZOO[name]}")
        if name == "cuttana-batched":
            row["dense_launches"] = launched[0] - row["kernel_calls"] if device.type == "cuda" else 0
        paths[f"web-s {name}"] = launched
        dev_runs.append((name, fields, res, {"dataset": "web-s", "kind": info.kind}, row))
    for strategy in ("gain", "completeness"):
        name = f"cuttana-parallel/{strategy}"
        fields = zoo_fields(tapi, "cuttana-parallel", num_shards=NUM_SHARDS, strategy=strategy)
        res, row, launched = zoo_run(torch, np, tapi, ops, counters, web, device, fields,
                                     engine_launches, cpu_too=False)
        check(launched[0] == 0, f"web-s {name}: the sequential entry launched")
        check(row["value"] == WEB_S_ZOO_PARALLEL[strategy],
              f"web-s {name}: {row['value']} != the reference's {WEB_S_ZOO_PARALLEL[strategy]}")
        paths[f"web-s {name} num_shards={NUM_SHARDS}"] = launched
        dev_runs.append((name, fields, res, {"dataset": "web-s", "num_shards": NUM_SHARDS}, row))
    # the CPU side, run by the child while the phases before this one ran:
    # each card run's result identical to the CPU's
    cpu = zoo_cpu.results()
    for name, fields, res, head, row in dev_runs:
        row.update(same_as_cpu(np, res, cpu[name], fields, device))
        log(json.dumps({"phase": 18, **head, **row}))

    clock.mark(18)

    # ----------------------------------------------------------- phase 19
    from repro_torch.graph.generators import load_dataset

    graphs = {"social-m": social, "social-s": social if tiny else load_dataset("social-s", seed=0)}
    for name_of, name, params in SOCIAL_ZOO_SPECS:
        on = dataset if tiny else name_of  # --tiny runs every spec on social-s
        res, row, launched = zoo_run(torch, np, tapi, ops, counters, graphs[name_of], device,
                                     zoo_fields(tapi, name, **params), engine_launches,
                                     cpu_too=False)
        key = f"{on} {name}/{params.get('num_shards', 1)}"
        if not tiny:
            check(row["value"] == SOCIAL_ZOO[key],
                  f"{key} {params}: {row['value']} != {SOCIAL_ZOO[key]}")
        paths[" ".join([on, name] + [f"{k}={v}" for k, v in params.items()])] = launched
        for extra in ("stream_seconds", "fm_moves", "clusters_found", "coarse_edges",
                      "prepass_seconds", "project_seconds", "restream_windows",
                      "buffer_strategy", "buffer_evictions", "refine_moves"):
            if extra in res.telemetry or extra in res.timings:
                row[extra] = res.telemetry.get(extra, res.timings.get(extra))
        log(json.dumps({"phase": 19, "dataset": on, **row}))
    # the gather entry on the coarse graph of cluster+* at this spec: the
    # chunk of its random order holding the longest supervertex row, which
    # the kernel splits over the blocks of its cluster
    k = 8
    ids = stream_order(social, "random", 0)
    cluster_of, num_clusters, _ = streaming_cluster(
        social, ids, max(0.1 * social.indices.shape[0] / k, 1.0),
        max(int(0.1 * social.num_vertices / k), 1), 1000)
    coarse = build_coarse_graph(social, cluster_of, num_clusters)
    cids = stream_order(coarse, "random", 0)
    at = int(np.flatnonzero(cids == int(coarse.degrees.argmax()))[0]) // CHUNK * CHUNK
    row = gather_row(torch, np, ops, ref, coarse.to(device), coarse, device, timer, floor,
                     np.random.default_rng(2), "coarse_chunk512_k8", cids[at : at + CHUNK], k)
    kernel_rows.append(row)
    log(json.dumps({"phase": 19, "dataset": dataset, "coarse_graph": "cluster+* prepass",
                    "coarse_vertices": coarse.num_vertices, **row}))
    del coarse
    # the churn suite's stream (benchmarks/churn.py): 20 arrival batches
    stream = rmat_churn(25_000, avg_degree=16, seed=7, ordering="random")
    final = stream.final_graph()
    reset_counts(*counters)
    t0 = time.perf_counter()
    inc = IncrementalPartitioner(stream.num_vertices, 8, balance_mode="edge", seed=7,
                                 device=device)
    batch_s = []
    for batch in stream.batches(20):
        t1 = time.perf_counter()
        inc.ingest(batch)
        sync(torch, device)
        batch_s.append(time.perf_counter() - t1)
    part = inc.finalize()
    stream_s = time.perf_counter() - t0
    cut = quality_report(final, part, 8, device)["edge_cut"]
    check(cut == CHURN_EDGE_CUT, f"churn incremental: edge_cut {cut} != {CHURN_EDGE_CUT}")
    want = inc.kernel_calls if device.type == "cuda" else 0
    check(ops.launches + ops.sharded_launches == want,
          f"churn incremental: {ops.launches} launches, expected {want}")
    paths["churn rmat25000 incremental"] = (ops.launches, ops.sharded_launches)
    log(json.dumps({
        "phase": 19, "stream": "rmat_churn(25000, 16, seed 7, random)", "batches": 20,
        "edge_cut": cut, "kernel_calls": inc.kernel_calls, "launches": ops.launches,
        "restream_windows": inc.restream_windows, "stream_seconds": stream_s,
        "mean_batch_ms": 1e3 * sum(batch_s) / len(batch_s), "device": ident,
    }))
    res, prof_row = profile_once(
        torch, lambda: tapi.partition(social, tapi.PartitionSpec(
            **zoo_fields(tapi, "heistream")), device=device), device, "score_path_kernel")
    log(json.dumps({"phase": 19, "dataset": dataset, "algo": "heistream", "profiled": True,
                    "kernel_calls": res.telemetry["kernel_calls"],
                    "stream_seconds": res.timings["stream_seconds"], **prof_row}))

    clock.mark(19)

    # ----------------------------------------------------------- phase 20
    fields = zoo_fields(tapi, "cuttana-batched", sample_cap=512, use_refinement=False)
    scale = int(np.log2(graph.num_vertices))
    # the same spec on a 4x smaller R-MAT: the card's run equals the CPU's
    # (every launch's kernel against its plain version along the path) and
    # the reference's value
    ref_scale = scale - 2
    small = rmat_graph(1 << ref_scale, avg_degree=16, seed=0)
    res, row, launched = zoo_run(
        torch, np, tapi, ops, counters, small, device, fields,
        lambda r: r.telemetry["kernel_calls"] + sampled_chunks(np, r.graph, 512))
    check(row["value"] == RMAT_BATCHED_EDGE_CUT[ref_scale],
          f"rmat 2^{ref_scale} cuttana-batched: {row['value']} != the reference's "
          f"{RMAT_BATCHED_EDGE_CUT[ref_scale]}")
    paths[f"rmat 2^{ref_scale} cuttana-batched"] = launched
    log(json.dumps({"phase": 20, "graph": f"rmat 2^{ref_scale} avg_degree 16",
                    "reference_edge_cut": RMAT_BATCHED_EDGE_CUT[ref_scale],
                    "rows_above_cap": int((small.degrees > 512).sum()),
                    "stream_seconds": res.timings["stream_seconds"], **row}))
    del res
    # the same spec under torch.profiler, with the quality scan against a
    # host recomputation (on phase 2's 2^22 graph until PR 25: a 22.8 s
    # stream on the H100 80GB HBM3 (700 W) machine, run A24; its checks the
    # same)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spec = tapi.PartitionSpec(**fields)
    reset_counts(*counters)
    res, prof_row = profile_once(
        torch, lambda: tapi.partition(small, spec, device=device), device, "score_path_kernel")
    chunks = -(-small.num_vertices // CHUNK)
    dense = sampled_chunks(np, small, 512)
    check(res.telemetry["kernel_calls"] == chunks,
          f"cuttana-batched: kernel_calls {res.telemetry['kernel_calls']} != {chunks} chunks")
    want = chunks + dense if device.type == "cuda" else 0
    check(ops.launches == want and ops.sharded_launches == 0,
          f"cuttana-batched: {ops.launches} launches, expected {chunks} gather + {dense} dense")
    paths[f"rmat 2^{ref_scale} cuttana-batched profiled"] = (ops.launches, ops.sharded_launches)
    launches = ops.launches
    q = res.quality()
    check_quality(np, small, res.assignment, q, 8, "cuttana-batched")
    log(json.dumps({
        "phase": 20, "algo": "cuttana-batched", "params": fields["params"], "profiled": True,
        "graph": f"rmat 2^{ref_scale} avg_degree 16", "edge_cut": q["edge_cut"],
        "edge_imbalance": q["edge_imbalance"], "kernel_calls": res.telemetry["kernel_calls"],
        "gather_launches": chunks if device.type == "cuda" else 0,
        "dense_launches": launches - chunks if device.type == "cuda" else 0,
        "rows_above_cap": int((small.degrees > 512).sum()),
        "stream_seconds": res.timings["stream_seconds"], "total_s": res.timings["total_s"],
        "max_memory_allocated": torch.cuda.max_memory_allocated() if device.type == "cuda" else None,
        "device": ident, **prof_row,
    }))
    del res
    return paths, kernel_rows, small


def main_spec(tapi):
    """Phase 2's spec (the main path): ``fennel``, k=8, edge balance, random
    order, seed 0."""
    return tapi.PartitionSpec(algo="fennel", k=8, epsilon=0.05, balance_mode="edge",
                              order="random", seed=0)


def mapped_child(path: str, out: str, tiny: bool) -> int:
    """The child of phase 21(b): open the file, run phase 2's spec on it,
    save the assignment to ``out`` and print one JSON line. Its peak RSS and
    device memory are its own."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from outofcore_decode_study import PeakRss

    rss = PeakRss()
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.api as tapi
    from repro_torch.graph.external import ExternalCSRGraph
    from repro_torch.kernels.partition_score import build, ops

    device = torch.device("cpu" if tiny else "cuda")
    if device.type == "cuda":
        build.LIBRARY.load()  # built by the parent's phase 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rss_base = rss.current()  # the interpreter, torch and the CUDA runtime
    t0 = time.perf_counter()
    graph = ExternalCSRGraph(path)
    open_s = time.perf_counter() - t0
    ops.reset()
    res = tapi.partition(graph, main_spec(tapi), device=device)
    sync(torch, device)
    launches = {"rows": ops.rows_launches, "sharded_rows": ops.sharded_rows_launches,
                "gather": ops.launches, "sharded": ops.sharded_launches}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    peak_rss = rss.stop()
    t0 = time.perf_counter()
    q = res.quality()  # the range scans, a row range's rows on the card at a time
    quality_s = time.perf_counter() - t0
    np.save(out, res.assignment)
    tel = res.telemetry
    print(json.dumps({
        "open_seconds": open_s, "stream_seconds": res.timings["stream_seconds"],
        "total_s": res.timings["total_s"], "kernel_calls": tel["kernel_calls"],
        "launches": launches, "decode_wall_s": tel.get("decode_wall_s"),
        "prefetch_hit_rate": tel.get("prefetch_hit_rate"),
        "prefetch_wait_s": tel.get("prefetch_wait_s"),
        "graph_backing": tel["graph_backing"], "peak_graph_bytes": tel["peak_graph_bytes"],
        "mapped_graph_bytes": tel["mapped_graph_bytes"],
        "compressed_graph_bytes": tel["compressed_graph_bytes"],
        "max_memory_allocated": peak, "peak_rss_bytes": peak_rss, "rss_before_graph_bytes": rss_base,
        "quality": q, "quality_seconds": quality_s,
    }), flush=True)
    return 0


OUTOFCORE_ALGOS = ("fennel", "cuttana", "cuttana-parallel")


def outofcore_spec(tapi, algo: str):
    """Phase 21(a)'s spec of ``algo`` (BENCH_partition.json's
    outofcore/rmat40000 rows)."""
    params = {"num_shards": NUM_SHARDS} if algo == "cuttana-parallel" else None
    return tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0,
                              params=params)


def mapped_rows_child(path: str, out: str, tiny: bool) -> int:
    """The child of phase 21(a): each of ``OUTOFCORE_ALGOS`` on the mapped
    rmat40000 file, beside the parent's resident runs; saves each
    assignment to ``<out>_<algo>.npy`` and prints one JSON line with each
    run's launches (this process's counts), quality and telemetry."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.api as tapi
    from repro_torch.graph.external import ExternalCSRGraph
    from repro_torch.kernels.partition_score import build, ops

    device = torch.device("cpu" if tiny else "cuda")
    if device.type == "cuda":
        build.LIBRARY.load()  # built by the parent's phase 0
    mapped = ExternalCSRGraph(path)
    runs = {}
    for algo in OUTOFCORE_ALGOS:
        spec = outofcore_spec(tapi, algo)
        reset_counts(ops)
        res = tapi.partition(mapped, spec, device=device)
        sync(torch, device)
        counts = (ops.launches, ops.sharded_launches, ops.rows_launches,
                  ops.sharded_rows_launches)
        np.save(f"{out}_{algo}.npy", res.assignment)
        tel = res.telemetry
        runs[algo] = {
            "edge_cut": res.quality()["edge_cut"], "timings": res.timings,
            "prefetch": spec.params.prefetch, "kernel_calls": tel.get("kernel_calls"),
            "launches": list(counts),
            **{key: tel.get(key) for key in (
                "peak_graph_bytes", "mapped_graph_bytes", "compressed_graph_bytes",
                "decode_wall_s", "prefetch_hit_rate", "prefetch_wait_s")}}
    print(json.dumps(runs), flush=True)
    return 0


def rows_row(torch, np, ops, ref, device, timer, floor, rng, name, graph, batches, k):
    """One rows-entry row at a mapped shape: the rows of ``batches`` (one
    batch: a chunk; several: a superstep's shards) decoded from the mapped
    ``graph`` and packed into one host buffer as the engine packs them,
    copied to the device, the kernel against its plain version (exact at
    alpha=0, within 1e-6 with a penalty), timed like phase 1, and the copy
    timed on its own."""
    from repro_torch.core.engine import _expand_csr_batch, _pack_rows, _unpack_rows

    sharded = len(batches) > 1
    big = np.concatenate(batches).astype(np.int64)
    degs = (graph.indptr[big + 1] - graph.indptr[big]).astype(np.int64)
    _, cols = _expand_csr_batch(graph.indptr, graph.indices, big, degs)
    c, nnz, s = big.shape[0], cols.shape[0], len(batches)
    bounds = np.concatenate([[0], np.cumsum([b.shape[0] for b in batches])]).astype(np.int64)
    head = [big, bounds] if sharded else []
    h = sum(a.shape[0] for a in head)
    packed = _pack_rows(head, degs, cols, device.type == "cuda")
    dev = packed.to(device, non_blocking=True)
    local_indptr, cols_dev = _unpack_rows(dev, h, c, nnz)
    n = graph.num_vertices
    part_np = rng.integers(0, k, size=n).astype(np.int32)
    part_np[rng.random(n) < 0.3] = -1
    part_of = torch.from_numpy(part_np).to(device)
    rows_s = (s, k) if sharded else (k,)
    zeros = torch.zeros(rows_s, dtype=torch.float32, device=device)
    sizes = torch.from_numpy((rng.random(rows_s) * 100).astype(np.float32)).to(device)
    if sharded:
        args = (local_indptr, cols_dev, part_of, dev[c:h])
        kern, plain = ops.fennel_scores_sharded_rows, ref.fennel_scores_sharded_rows_ref
    else:
        args = (local_indptr, cols_dev, part_of)
        kern, plain = ops.fennel_scores_rows, ref.fennel_scores_rows_ref
    got0, want0 = kern(*args, zeros, 0.0, 1.5), plain(*args, zeros, 0.0, 1.5)
    got1, want1 = kern(*args, sizes, 0.37, 1.5), plain(*args, sizes, 0.37, 1.5)
    sync(torch, device)
    err0 = float((got0 - want0).abs().max())
    err1 = float((got1 - want1).abs().max())
    check(err0 == 0.0, f"{name}: rows kernel differs from plain version at alpha=0 ({err0})")
    check(err1 <= 1e-6, f"{name}: rows kernel differs from plain version with penalty ({err1})")
    rows = torch.repeat_interleave(torch.arange(c, device=device), local_indptr.diff())
    parts = part_of[cols_dev.long()]
    keep = parts >= 0
    keys = rows[keep] * k + parts[keep].long()
    # each input read once, the output written once: the local offsets, the
    # rows' neighbour ids, one part_of gather per entry, the shard bounds and
    # size rows; C*K float32 scores out
    nbytes = (c + 1) * 8 + nnz * 4 + nnz * 4 + (s + 1) * 8 * sharded + zeros.numel() * 4 + c * k * 4
    return {
        "shape": name, "variant": SCORE_VARIANT, "entry": kern.__name__, "shards": s,
        "rows": c, "k": k, "nnz": nnz, "max_row": int(degs.max()),
        **split_stats(np, ops, degs, k),
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "packed_bytes": packed.numel() * 8,
        "copy_ms": timer(lambda: packed.to(device, non_blocking=True)),
        "ms": timer.device_ms(lambda: kern(*args, zeros, 0.0, 1.5)),
        "call_ms": timer(lambda: kern(*args, zeros, 0.0, 1.5)),
        "plain_ms": timer(lambda: plain(*args, zeros, 0.0, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=c * k)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "floor_ms": floor_ms(torch, timer, floor, c, k),
    }


def outofcore_phase(torch, np, tapi, ops, ref, counters, device, timer, floor, graph,
                    main_rss, tiny: bool, ident: str) -> tuple:
    """Phase 21: out-of-core graphs on the card. ``graph`` is phase 20's
    R-MAT (2^20 vertices, a quarter of phase 2's), which (b) partitions
    resident and memory-mapped; ``main_rss`` is the process's peak RSS after
    phase 2 (logged). Returns the kernel rows of the two rows entries and the
    launches of their main paths (the mapped ``fennel``, the mapped
    ``cuttana-parallel``)."""
    import tempfile

    from repro_torch.graph.external import ExternalCSRGraph, convert_csr, convert_edge_list
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.stream import ShardedStream, stream_order

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ooc") as td:
        # (b)'s child starts first and runs beside (a): phase 20's graph
        # written, then partitioned memory-mapped in a process of its own
        scale = int(np.log2(graph.num_vertices))
        full_path = str(Path(td) / f"rmat{scale}.bin")
        t0 = time.perf_counter()
        convert_csr(graph, full_path)
        write_s = time.perf_counter() - t0
        out = str(Path(td) / "assignment.npy")
        t_child = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mapped-child", full_path,
             "--child-out", out] + (["--tiny"] if tiny else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        # ------------------------------------------------- (a) rmat40000
        n = 40_000
        small = rmat_graph(n, avg_degree=12, seed=0)
        edges_path = str(Path(td) / "edges.npy")
        np.save(edges_path, small.edges_array())
        bin_path = str(Path(td) / "rmat40000.bin")
        t0 = time.perf_counter()
        stats = convert_edge_list(edges_path, bin_path, num_vertices=n)
        convert_s = time.perf_counter() - t0
        check(stats["file_bytes"] == OUTOFCORE_FILE_BYTES == Path(bin_path).stat().st_size,
              f"rmat40000: converted file has {stats['file_bytes']} bytes, "
              f"expected {OUTOFCORE_FILE_BYTES}")
        log(json.dumps({"phase": 21, "graph": "rmat40000 avg_degree 12", "convert_seconds":
                        convert_s, **{k_: stats[k_] for k_ in (
                            "file_bytes", "raw_bytes", "compression_ratio", "num_edges")}}))
        # the mapped runs in a child beside the resident runs here
        rows_out = str(Path(td) / "rows")
        rows_proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mapped-rows-child", bin_path,
             "--child-out", rows_out] + (["--tiny"] if tiny else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        resident = {}
        for algo in OUTOFCORE_ALGOS:
            spec = outofcore_spec(tapi, algo)
            reset_counts(*counters)
            res = tapi.partition(small, spec, device=device)
            sync(torch, device)
            resident[algo] = (res, (ops.launches, ops.sharded_launches, ops.rows_launches,
                                    ops.sharded_rows_launches))
        rows_stdout, rows_err = rows_proc.communicate(timeout=900)
        check(rows_proc.returncode == 0, f"mapped rows child failed:\n{rows_stdout}\n{rows_err}")
        mapped_runs = json.loads(rows_stdout.strip().splitlines()[-1])
        for algo in OUTOFCORE_ALGOS:
            res, counts = resident[algo]
            sharded = algo == "cuttana-parallel"
            for backing in ("resident", "mapped"):
                if backing == "resident":
                    tel = res.telemetry
                    run = {"edge_cut": res.quality()["edge_cut"], "timings": res.timings,
                           "prefetch": outofcore_spec(tapi, algo).params.prefetch,
                           "kernel_calls": tel.get("kernel_calls"), "launches": list(counts),
                           **{key: tel.get(key) for key in (
                               "peak_graph_bytes", "mapped_graph_bytes",
                               "compressed_graph_bytes", "decode_wall_s",
                               "prefetch_hit_rate", "prefetch_wait_s")}}
                    assignment = res.assignment
                else:
                    run = mapped_runs[algo]
                    assignment = np.load(f"{rows_out}_{algo}.npy")
                want = [0, 0, 0, 0]
                want[int(sharded) + (2 if backing == "mapped" else 0)] = (
                    run["kernel_calls"] or 0) if device.type == "cuda" else 0
                check(run["launches"] == want,
                      f"rmat40000 {algo} {backing}: launches {run['launches']}, expected {want}")
                if backing == "mapped" and sharded:
                    launches["sharded_rows"] = run["launches"][3]
                check(run["edge_cut"] == OUTOFCORE_EDGE_CUT[algo],
                      f"rmat40000 {algo} {backing}: edge_cut {run['edge_cut']} != "
                      f"{OUTOFCORE_EDGE_CUT[algo]}")
                check(np.array_equal(assignment, res.assignment),
                      f"rmat40000 {algo}: {backing} and resident assignments differ")
                log(json.dumps({
                    "phase": 21, "graph": "rmat40000", "algo": algo, "backing": backing,
                    **{key: value for key, value in run.items() if key != "launches"},
                    "launches": dict(zip(("gather", "sharded", "rows", "sharded_rows"),
                                         run["launches"]))}))
        del resident, small

        # ------------------------------------- (b) phase 20's R-MAT, resident
        # and mapped (phase 2's graph until PR 25: its mapped child took 96 s
        # on the H100 80GB HBM3 (700 W) machine, run A24)
        graph.to(device)  # the graph's arrays on the card before the run, as in phase 2
        sync(torch, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        main_base = torch.cuda.memory_allocated() if device.type == "cuda" else None
        reset_counts(*counters)
        main_res = tapi.partition(graph, main_spec(tapi), device=device)
        main_q = main_res.quality()  # inside the peak's window, as in phase 2
        sync(torch, device)
        chunks = -(-graph.num_vertices // CHUNK)
        check(main_res.telemetry["kernel_calls"] == chunks and ops.launches == chunks * (
            device.type == "cuda"), f"resident fennel on 2^{scale}: {ops.launches} launches, "
              f"{main_res.telemetry['kernel_calls']} kernel_calls, expected {chunks}")
        graph_device_bytes = graph.indptr.nbytes + graph.indices.nbytes
        # the resident run's own peak as phase 2 measures its: the graph's
        # arrays and what the run and its quality scan allocated (this
        # process holds other phases' tensors besides)
        main_peak = (torch.cuda.max_memory_allocated() - main_base + graph_device_bytes
                     if device.type == "cuda" else None)
        child_out, child_err = proc.communicate(timeout=900)
        child_s = time.perf_counter() - t_child  # beside (a) and the resident run
        check(proc.returncode == 0, f"mapped child failed:\n{child_out}\n{child_err}")
        child = json.loads(child_out.strip().splitlines()[-1])
        got = np.load(out)
        chunks = -(-graph.num_vertices // CHUNK)
        expect_rows = chunks if device.type == "cuda" else 0
        check(np.array_equal(got, main_res.assignment),
              f"rmat 2^{scale}: mapped and resident fennel assignments differ")
        check(child["kernel_calls"] == chunks,
              f"mapped fennel: kernel_calls {child['kernel_calls']} != {chunks} chunks")
        check(child["launches"] == {"rows": expect_rows, "sharded_rows": 0, "gather": 0,
                                    "sharded": 0},
              f"mapped fennel: launches {child['launches']}, expected {expect_rows} rows launches")
        check(child["quality"] == main_q,
              f"rmat 2^{scale}: mapped quality scan differs from the resident one")
        launches["rows"] = child["launches"]["rows"]
        saved = None
        if device.type == "cuda":
            saved = main_peak - child["max_memory_allocated"]
            check(saved >= graph_device_bytes,
                  f"mapped peak device memory {child['max_memory_allocated']} is not below the "
                  f"resident {main_peak} by the graph's {graph_device_bytes} bytes")
        log(json.dumps({
            "phase": 21, "graph": f"rmat 2^{scale} avg_degree 16", "file_bytes":
            Path(full_path).stat().st_size, "write_seconds": write_s, "child_seconds": child_s,
            "resident_max_memory_allocated": main_peak,
            "resident_allocated_before": main_base, "graph_device_bytes": graph_device_bytes,
            "device_bytes_saved": saved, "phase2_peak_rss_bytes": main_rss,
            "resident_stream_seconds": main_res.timings["stream_seconds"],
            "mapped": child, "device": ident,
        }))

        # --------------------------------------- (c) rows entries' shapes
        full = ExternalCSRGraph(full_path)
        ids = stream_order(full, "random", 0)
        rng = np.random.default_rng(21)
        s4 = ShardedStream.from_ids(ids, NUM_SHARDS)
        shapes = [
            rows_row(torch, np, ops, ref, device, timer, floor, rng, "mapped_chunk512_k8",
                     full, [ids[:CHUNK]], 8),
            rows_row(torch, np, ops, ref, device, timer, floor, rng,
                     f"mapped_superstep_s{NUM_SHARDS}x{CHUNK}_k8", full,
                     [sh[:CHUNK] for sh in s4.shards], 8),
        ]
        for row in shapes:
            log(json.dumps({"phase": 21, **row}))
        del full
    log(f"phase 21: {time.perf_counter() - t_phase:.3f} s")
    return shapes, launches


def serving_spec(tapi, algo: str):
    """``benchmarks/serving.py``'s ``_spec`` at k=8, seed 0."""
    if algo in ("random", "hdrf"):
        return tapi.PartitionSpec(algo=algo, k=8, seed=0)
    return tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0)


def sim_report(rep) -> dict:
    """A serving report without its wall-clock fields."""
    d = rep.to_dict()
    for key in ("wall_s", "qps_wall"):
        d.pop(key)
    d["latency_ms"] = {"sim": d["latency_ms"]["sim"]}
    return d


def same_answers(np, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(va, b[qid]) if isinstance(va, np.ndarray) else va == b[qid]
        for qid, va in a.items())


def serving_phase(torch, np, tapi, ops, ref, counters, device, timer, floor, graph, main_res,
                  tiny: bool, ident: str) -> tuple:
    """Phase 22: the graph-DB study and partition-aware serving, fed by
    partitions made on the card. (a) ``benchmarks/serving.py``'s recipe with
    the port against the committed ``serving/rmat8000/*`` rows; (b) phase 2's
    2^22 ``fennel`` partition served at replication budget 0.05, at auto and
    at one worker, against each other and the ``QueryEngine``, and the DB
    study on it; (c) the CLI on the card in child processes. Returns the
    kernel row ``serving_rmat8000_chunk512_k8`` and the gather launches of
    (a)'s partitions by algorithm."""
    import tempfile

    from repro_torch.db import QueryEngine
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.metrics import quality_report
    from repro_torch.graph.stream import stream_order
    from repro_torch.serve.graph import QueryMix, build_workload, run_load

    t_phase = time.perf_counter()
    # ------------------------------------------------ (a) serving/rmat8000
    small = rmat_graph(8000, avg_degree=12, seed=0)
    workload = build_workload(small, 2000, QueryMix(), seed=1)
    launches, reports, quality = {}, {}, {}
    for algo in SERVING_ALGOS:
        reset_counts(*counters)
        res = tapi.partition(small, serving_spec(tapi, algo), device=device)
        sync(torch, device)
        calls = res.telemetry.get("kernel_calls", 0)
        counts = (ops.launches, ops.sharded_launches, ops.rows_launches,
                  ops.sharded_rows_launches)
        want = (calls if device.type == "cuda" else 0, 0, 0, 0)
        check(counts == want, f"rmat8000 {algo}: launches {counts}, expected {want}")
        launches[algo] = counts[0]
        part = res.vertex_assignment()
        t0 = time.perf_counter()
        rep = run_load(res.serve(store_results=False), workload=workload, concurrency=1000)
        load_s = time.perf_counter() - t0
        reports[algo] = rep
        q = quality_report(small, part, 8, device)
        quality[algo] = (q, calls)
        row = {
            "bench": f"serving/rmat8000/{algo}", "algo": algo, "num_queries": rep.num_queries,
            "concurrency": rep.concurrency, "qps_sim": rep.qps_sim,
            "p99_sim_ms": rep.latency_ms["sim"]["p99"], "p50_sim_ms": rep.latency_ms["sim"]["p50"],
            "rpcs": rep.rpcs, "messages": rep.messages, "wire_bytes": rep.wire_bytes,
            "local_queries": rep.local_queries, "edge_cut": q["edge_cut"],
            "communication_volume": q["comm_volume"],
        }
        check(row == SERVING_ROWS[row["bench"]],
              f"{row['bench']}: {row} != the committed {SERVING_ROWS[row['bench']]}")
        log(json.dumps({"phase": 22, **row, "kernel_calls": calls, "launches": counts[0],
                        "qps_wall": rep.qps_wall, "wall_s": rep.wall_s, "load_seconds": load_s,
                        "partition_seconds": res.timings["total_s"], "device": ident}))
    res = tapi.partition(small, serving_spec(tapi, "cuttana"), device=device)
    base = run_load(res.serve(replication_budget=0.0), workload=workload[:500],
                    concurrency=1000)
    repl = run_load(res.serve(replication_budget=0.05), workload=workload[:500],
                    concurrency=1000)
    row = {
        "bench": "serving/rmat8000/cuttana/replication", "algo": "cuttana",
        "replication_budget": 0.05, "rpcs_base": base.rpcs, "rpcs_replicated": repl.rpcs,
        "rpc_reduction": 1.0 - repl.rpcs / max(base.rpcs, 1),
        "answers_identical": same_answers(np, base.answers(), repl.answers()),
        **{f"replication_{key}": val for key, val in repl.replication.items()},
    }
    check(row == SERVING_ROWS[row["bench"]], f"{row['bench']}: {row}")
    qps = {a: reports[a].qps_sim for a in SERVING_ALGOS}
    p99 = {a: reports[a].latency_ms["sim"]["p99"] for a in SERVING_ALGOS}
    order_row = {
        "bench": "serving/rmat8000/ordering",
        "qps_cuttana_over_random": qps["cuttana"] / qps["random"],
        "p99_cuttana_over_fennel": p99["cuttana"] / p99["fennel"],
        "p99_cuttana_over_hdrf": p99["cuttana"] / p99["hdrf"],
        "throughput_ordering_ok": bool(qps["cuttana"] > qps["random"]),
        "tail_ordering_ok": bool(p99["cuttana"] <= 1.05 * min(p99["fennel"], p99["hdrf"])),
    }
    check(order_row == SERVING_ROWS[order_row["bench"]], f"{order_row['bench']}: {order_row}")
    log(json.dumps({"phase": 22, **row}))
    log(json.dumps({"phase": 22, **order_row}))
    # the gather entry on the first chunk of that cuttana stream (random
    # order, seed 0), against its plain version
    kernel_row = gather_row(torch, np, ops, ref, small.to(device), small, device, timer, floor,
                            np.random.default_rng(22), "serving_rmat8000_chunk512_k8",
                            stream_order(small, "random", 0)[:CHUNK], 8)
    log(json.dumps({"phase": 22, **kernel_row}))

    # ---------------------------------------- (b) phase 2's 2^22 partition
    scale = int(np.log2(graph.num_vertices))
    big_workload = build_workload(graph, SERVING_QUERIES, QueryMix(), seed=1)
    runs = []
    for workers in (0, 1):
        t0 = time.perf_counter()
        svc = main_res.serve(replication_budget=0.05, max_workers=workers, store_results=True)
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = run_load(svc, workload=big_workload, concurrency=1000)
        runs.append((rep, plan_s, time.perf_counter() - t0, svc.workers))
        del svc
    (rep, _, _, _), (one, _, _, _) = runs
    check(same_answers(np, rep.answers(), one.answers()),
          f"rmat 2^{scale} serving: auto and one-worker answers differ")
    check(sim_report(rep) == sim_report(one),
          f"rmat 2^{scale} serving: auto and one-worker sim metrics or counters differ")
    answers = rep.answers()
    engine = QueryEngine(graph, main_res.vertex_assignment(), 8)
    t0 = time.perf_counter()
    for kind, run in (("one_hop", engine.one_hop), ("two_hop", engine.two_hop)):
        qids = [i for i, (kd, _) in enumerate(big_workload) if kd == kind]
        seeds = np.array([big_workload[i][1] for i in qids], dtype=np.int64)
        # queries are independent: the engine answers slices of them on 8
        # threads (numpy's unique and concatenate release the lock)
        with ThreadPoolExecutor(8) as pool:
            got = [a for part in pool.map(lambda idx: run(seeds[idx])[0],
                                          np.array_split(np.arange(seeds.size), 8))
                   for a in part]
        check(all(np.array_equal(answers[i], g.astype(np.int64)) for i, g in zip(qids, got)),
              f"rmat 2^{scale} serving: {kind} answers differ from the QueryEngine's")
    engine_s = time.perf_counter() - t0
    check(all(answers[i] == graph.degree(s) for i, (kd, s) in enumerate(big_workload)
              if kd == "point"), f"rmat 2^{scale} serving: point answers are not degrees")
    dbs = {}
    for hops in (1, 2):
        t0 = time.perf_counter()
        dbs[hops] = {**main_res.db(hops=hops,
                                   num_queries=256 if hops == 1 else DB_TWO_HOP_QUERIES),
                     "seconds": time.perf_counter() - t0}
        d = dbs[hops]
        check(d["total_rpcs"] > 0 and all(np.isfinite(d[key]) for key in (
            "qps", "p99_latency_ms", "mean_latency_ms")),
              f"rmat 2^{scale} db hops={hops}: {d}")
    log(json.dumps({
        "phase": 22, "graph": f"rmat 2^{scale} avg_degree 16", "algo": "fennel", "k": 8,
        "replication_budget": 0.05, "queries": len(big_workload), "concurrency": 1000,
        "replication": rep.replication, "qps_sim": rep.qps_sim,
        "latency_sim_ms": rep.latency_ms["sim"], "rpcs": rep.rpcs, "messages": rep.messages,
        "wire_bytes": rep.wire_bytes, "scanned_edges": rep.scanned_edges,
        "local_queries": rep.local_queries, "kind_counts": rep.kind_counts,
        "runs": [{"workers": w, "plan_seconds": p, "run_seconds": r, "wall_s": x.wall_s,
                  "qps_wall": x.qps_wall, "latency_wall_ms": x.latency_ms["wall"]}
                 for x, p, r, w in runs],
        "identical_across_workers": True, "equal_to_query_engine": True,
        "query_engine_seconds": engine_s, "db": dbs,
        "device": ident,
    }))
    del runs, rep, one, answers, engine

    # ------------------------------------------------ (c) the CLI on the card
    from repro_torch.api.cli import main as cli_main

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    dev = ["--device", device.type]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli") as td:
        specs = {}
        for algo in ("cuttana", "fennel"):
            specs[algo] = Path(td) / f"{algo}.json"
            specs[algo].write_text(serving_spec(tapi, algo).to_json())
        out = {}
        commands = {
            "partition": ["partition", "--rmat", "8000", "--avg-degree", "12", "--with-db"],
            "serve-bench": ["serve-bench", "--rmat", "8000", "--avg-degree", "12",
                            "--queries", "2000", "--concurrency", "1000", "--load-seed", "1"],
        }

        def run_cli(name):  # the two children run side by side
            path = Path(td) / f"{name}.json"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.api.cli", *commands[name], "--spec",
                 str(specs["cuttana"]), "--out", str(path), *dev],
                env=env, capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"cli {name} failed:\n{proc.stdout}\n{proc.stderr}")
            return name, (json.loads(path.read_text()), time.perf_counter() - t0)

        with ThreadPoolExecutor(len(commands)) as pool:
            out.update(pool.map(run_cli, commands))
        # the engine-backed spec through the CLI in this process, its launches
        # counted: cuttana places every vertex on the host, fennel scores a
        # chunk a launch
        path = Path(td) / "partition_fennel.json"
        reset_counts(*counters)
        t0 = time.perf_counter()
        check(cli_main(["partition", "--rmat", "8000", "--avg-degree", "12", "--spec",
                        str(specs["fennel"]), "--out", str(path), *dev]) == 0,
              "cli partition fennel failed")
        sync(torch, device)
        out["partition fennel"] = (json.loads(path.read_text()), time.perf_counter() - t0)
        cli_launches = ops.launches
        for name, algo in (("partition", "cuttana"), ("partition fennel", "fennel")):
            report, _ = out[name]
            q, calls = quality[algo]
            check(report["quality"]["edge_cut"] == q["edge_cut"]
                  and report["quality"]["comm_volume"] == q["comm_volume"],
                  f"cli {name}: quality {report['quality']} != phase 22(a)'s {algo}")
            check(report["telemetry"]["kernel_calls"] == calls,
                  f"cli {name}: kernel_calls {report['telemetry']['kernel_calls']} != "
                  f"phase 22(a)'s {calls}")
            check(report["device"].startswith(device.type), f"cli {name}: {report['device']}")
        calls = out["partition fennel"][0]["telemetry"]["kernel_calls"]
        check(calls > 0 and cli_launches == (calls if device.type == "cuda" else 0),
              f"cli partition fennel: {cli_launches} launches, kernel_calls {calls}")
        db = out["partition"][0]["db"]
        check(db["one_hop"]["total_rpcs"] > 0 and db["two_hop"]["total_rpcs"] > 0,
              f"cli partition cuttana: db {db}")
        serving = out["serve-bench"][0]["serving"]
        want = SERVING_ROWS["serving/rmat8000/cuttana"]
        check(serving["qps_sim"] == want["qps_sim"] and serving["rpcs"] == want["rpcs"],
              f"cli serve-bench: qps_sim {serving['qps_sim']} rpcs {serving['rpcs']} != the "
              f"committed {want['qps_sim']} / {want['rpcs']}")
        log(json.dumps({
            "phase": 22, "cli": {name: {"seconds": sec, "device": r.get("device"),
                                        "kernel_calls": r.get("telemetry", {}).get("kernel_calls")}
                                 for name, (r, sec) in out.items()},
            "cli_fennel_launches": cli_launches, "db_cuttana": db,
            "serve_bench": {key: serving[key] for key in (
                "qps_sim", "rpcs", "wire_bytes", "qps_wall", "wall_s")},
        }))
    log(f"phase 22: {time.perf_counter() - t_phase:.3f} s")
    return kernel_row, launches


def check_quality(np, graph, part, q, k: int, what: str) -> None:
    """The device quality scan against a host recomputation."""
    check(part.shape == (graph.num_vertices,) and part.min() >= 0 and part.max() < k,
          f"{what}: assignment has the wrong shape or ids")
    src = np.repeat(np.arange(graph.num_vertices, dtype=np.int64), graph.degrees)
    host_cut = int((part[src] != part[graph.indices]).sum()) // 2 / graph.num_edges
    del src
    check(q["edge_cut"] == host_cut, f"{what}: device edge_cut {q['edge_cut']} != host {host_cut}")
    e_mass = np.bincount(part, weights=graph.degrees.astype(np.float64), minlength=k)
    check(q["edge_imbalance"] == float(e_mass.max() / e_mass.mean()),
          f"{what}: edge imbalance differs from host")


def reset_counts(*modules) -> None:
    """Zero the launch counts of every kernel wrapper module."""
    for mod in modules:
        mod.reset()


def profile_totals(profile: dict) -> dict:
    """The parallel engine's profile without its per-superstep rows."""
    return {k: v for k, v in profile.items() if k != "per_superstep"}


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def attention_pairs(np, tq: int, tk: int, causal: bool, window, q_offset: int) -> int:
    """The (query, key) pairs the masks keep: the work the data needs."""
    qpos = np.arange(tq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, tk - 1) if causal else np.full(tq, tk - 1, np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(tq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def within(got, want, tol: float) -> tuple[bool, float]:
    """``assert_allclose(rtol=tol, atol=tol)``'s rule, and the max abs error."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def worst_row_rel_l2(got, want) -> float:
    """The largest ``|got - want| / |want|`` (L2 over the last axis) of any row."""
    want = want.float()
    diff = (got.float() - want).norm(dim=-1)
    return float((diff / want.norm(dim=-1).clamp_min(1e-30)).max())


def flash_row(torch, np, F, fa, fa_ref, timer, name, b, hq, hkv, tq, tk, dh, dtype,
              causal=True, window=None, q_offset=0, library_causal=None, reps=(100, 5), dv=None,
              latent=False, plain_heads=None):
    """Phase 12: one shape of the attention kernel against its plain version
    (``tests/test_kernels.py``'s tolerances), its device time and its bound;
    with ``library_causal`` set (the main shapes) also the per-call, plain
    and ``scaled_dot_product_attention`` times. ``dv`` (an MLA pair, Dv <
    Dqk = ``dh``) takes the model's prefill layout (q and k transposed
    ``[B, T, H, Dqk]``, v a view of a ``[B, T, H, 2 Dv]`` tensor); with
    ``latent`` (Hkv = 1) k is a ``[B, S, Dqk]`` latent buffer and v its first
    Dv columns, as the absorbed decode reads its cache (``"offset"``: the
    buffer starts one element past 16 bytes). ``plain_heads`` runs
    the plain version that many KV heads at a time (its float32 scores at
    128 heads and T=8192 would not fit the card at once)."""
    device = timer.device
    dv = dh if dv is None else dv
    gen = torch.Generator(device=device).manual_seed(tq * 7 + tk + dh)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)

    if latent:
        q, buf = randn(b, hq, tq, dh), randn(b, tk, dh)
        if latent == "offset":  # the buffer one element past a 16-byte boundary
            buf = randn(b * tk * dh + 1)[1:].view(b, tk, dh)
        k, v = buf[:, None], buf[:, None, :, :dv]
    elif dv != dh:
        q, k = randn(b, tq, hq, dh).transpose(1, 2), randn(b, tk, hkv, dh).transpose(1, 2)
        v = randn(b, tk, hkv, 2 * dv)[..., dv:].transpose(1, 2)
    else:
        q, k, v = randn(b, hq, tq, dh), randn(b, hkv, tk, dh), randn(b, hkv, tk, dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    g = hq // hkv

    def plain():
        if plain_heads is None:
            return fa_ref.flash_attention_ref(q, k, v, **kw)
        return torch.cat([fa_ref.flash_attention_ref(q[:, h * g:(h + plain_heads) * g],
                                                     k[:, h:h + plain_heads],
                                                     v[:, h:h + plain_heads], **kw)
                          for h in range(0, hkv, plain_heads)], dim=1)

    variant = fa.kernel_variant(dtype, tq, g, dh, fa.is_aligned(q, k, v), dv)
    before, splits_before = dict(fa.variant_launches), dict(fa.split_launches)
    got = fa.flash_attention(q, k, v, **kw)
    want = plain()
    sync(torch, device)
    ran = {n: fa.variant_launches[n] - before[n] for n in fa.VARIANTS}
    check(ran == {n: int(n == variant and device.type == "cuda") for n in fa.VARIANTS},
          f"flash {name}: expected one launch of {variant}, the variants ran {ran}")
    # the decode variant's shares of the cache, as the launch recorded them
    n_split = next((n for n, c in fa.split_launches.items() if c != splits_before.get(n, 0)),
                   None)
    tname = str(dtype).split(".")[1]
    ok, err = within(got, want, FLASH_TOL[tname])
    check(ok, f"flash {name}: kernel differs from plain version beyond {FLASH_TOL[tname]} ({err})")
    row_err = worst_row_rel_l2(got, want)
    check(row_err <= FLASH_ROW_RTOL,
          f"flash {name}: a row differs from the plain version by {row_err} relative L2 "
          f"(> {FLASH_ROW_RTOL})")
    del want
    call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    pairs = attention_pairs(np, tq, tk, causal, window, q_offset) * b * hq
    flops = 2 * pairs * (dh + dv)  # q k^T over Dqk, p v over Dv
    # q and o, and k and (unless it is k's own columns) v of the keys some
    # query sees, each once: a causal stripe skips the keys past its last
    # query, a window those before its first query's
    hi = min(q_offset + tq, tk) if causal else tk
    lo = max(q_offset - window + 1, 0) if window else 0
    keys = max(hi - lo, 0)
    nbytes = (b * hq * tq * (dh + dv) + b * hkv * keys * (dh + (0 if latent else dv))) * \
        q.element_size()
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(flops / rate, pairs / EXP_PER_S) * 1e3  # the products, or one exp a pair
    ms = timer.device_ms(call, reps=reps[0], replays=reps[1])
    row = {
        "shape": name, "variant": variant, "n_split": n_split, "b": b, "hq": hq, "hkv": hkv,
        "tq": tq, "tk": tk, "dh": dh, "dv": dv, "dtype": tname, "causal": causal, "window": window,
        "q_offset": q_offset,
        "max_abs_err": err, "max_row_rel_l2": row_err, "ms": ms,
        "tflops": flops / ms / 1e9, "flops": flops, "exps": pairs, "bytes": nbytes,
        "keys_read": keys,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    if library_causal is not None:
        n = max(2, reps[0] // 2)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=library_causal, enable_gqa=True)
        if latent:
            # the absorbed decode with every key visible: the query heads as
            # the query rows of the one latent head, the same function
            # (SDPA refuses a buffer off 16 bytes: it reads an aligned copy)
            check(not causal or q_offset + 1 >= tk, f"flash {name}: SDPA row needs every key")
            kl, vl = (k, v) if latent is True else (k.clone(), v.clone())
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), kl, vl).transpose(1, 2)
        elif window is not None or (library_causal and q_offset):
            # a window, or a causal diagonal below the top-left one that
            # is_causal draws: SDPA's boolean mask, the same function
            qpos = torch.arange(tq, device=device)[:, None] + q_offset
            kpos = torch.arange(tk, device=device)[None, :]
            keep = torch.ones((tq, tk), dtype=torch.bool, device=device)
            if causal:
                keep &= kpos <= qpos
            if window is not None:
                keep &= kpos > qpos - window
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=keep, enable_gqa=True)
        _, lib_err = within(lib(), got, FLASH_TOL[tname])
        row.update({
            "call_ms": timer(call, reps=n, warmup=1),
            "plain_ms": timer(plain, reps=2, warmup=1),
            "library_ms": timer(lib, reps=n, warmup=1), "library_max_abs_diff": lib_err,
        })
    return row


def flash_kernel_checks(torch, np, F, fa, fa_ref, timer, tiny: bool):
    """Phase 12: the attention kernel at the test shapes, the decode-offset
    sweep, and one qwen3-8b layer at prefill and at a 32k decode step (B=8,
    phase 17's batch, then B=32)."""
    rows = []
    if tiny:  # the reduced qwen3 layer (Hq=4, Hkv=2, Dh=32)
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "prefill_reduced", 1, 4, 2,
                              256, 256, 32, torch.bfloat16, library_causal=True, reps=(3, 1)))
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "decode_reduced", 2, 4, 2, 1,
                              512, 32, torch.bfloat16, q_offset=511, library_causal=False,
                              reps=(3, 1)))
    else:
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "qwen3_prefill_t8192", 1, 32, 8,
                              8192, 8192, 128, torch.bfloat16, library_causal=True, reps=(3, 2)))
        for b in (8, 32):
            rows.append(flash_row(torch, np, F, fa, fa_ref, timer, f"qwen3_decode_tk32768_b{b}",
                                  b, 32, 8, 1, 32768, 128, torch.bfloat16, q_offset=32767,
                                  library_causal=False, reps=(5, 2)))
    rows += family_flash_rows(torch, np, F, fa, fa_ref, timer, tiny)
    rows += mla_flash_rows(torch, np, F, fa, fa_ref, timer, tiny)
    rows += stripe_flash_rows(torch, np, F, fa, fa_ref, timer, tiny)
    rows += tp_flash_rows(torch, np, F, fa, fa_ref, timer, tiny)
    if timer.device.type == "cuda":
        torch.cuda.empty_cache()  # the plain version's scores at the prefill shape
    for dtype in (torch.float32, torch.bfloat16):
        for b, hq, hkv, tq, tk, dh, causal, window in (
            (1, 2, 2, 128, 128, 64, True, None), (2, 4, 2, 128, 128, 64, True, None),
            (1, 2, 1, 256, 256, 32, False, None), (1, 2, 2, 128, 128, 64, True, 32),
            (2, 2, 2, 64, 64, 128, True, None),
        ):
            rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "test_kernels", b, hq, hkv,
                                  tq, tk, dh, dtype, causal, window, reps=(20, 2)))
    for q_offset in (0, 1, 127, 128, 200):
        for tq in (1, 4):
            rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "decode_offset_sweep", 2, 4,
                                  4, tq, 256, 64, torch.float32, q_offset=q_offset, reps=(20, 2)))
    # 65,536 batches: one more than grid y holds, on every variant
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "grid_cap_b65536_decode", 65536,
                              1, 1, 1, 1, 32, dtype, reps=(5, 1)))
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "grid_cap_b65536_tq17", 65536,
                              1, 1, 17, 17, 32, dtype, reps=(5, 1)))  # fma, wgmma_bf16
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "grid_cap_b65536_hq2_tq16",
                              65536, 2, 1, 16, 16, 32, dtype, reps=(5, 1)))  # fma_short
    for row in rows:
        log(json.dumps({"phase": 12, **row}))
    return rows


# phase 12's rows at the slice-14 families' shapes: name, b, hq, hkv, tq, tk,
# dh, dtype, causal, window, q_offset (the reduced widths with --tiny)
FAMILY_FLASH_ROWS = (
    # gemma3-12b (H 16/8, Dh 256): a local layer (window 1024) and the
    # global one at prefill, a decode step over the 1,024-slot ring (warm:
    # every slot) and over the global layer's 8,192 cache
    ("gemma3_prefill_local_t8192", 1, 16, 8, 8192, 8192, 256, "bfloat16", True, 1024, 0),
    ("gemma3_prefill_global_t8192", 1, 16, 8, 8192, 8192, 256, "bfloat16", True, None, 0),
    ("gemma3_decode_ring_b8", 8, 16, 8, 1, 1024, 256, "bfloat16", True, None, 8195),
    ("gemma3_decode_global_b8_8k", 8, 16, 8, 1, 8192, 256, "bfloat16", True, None, 8191),
    # hubert-xlarge (H 16, Dh 80): 30 s of frames, bidirectional
    ("hubert_b8_t1500", 8, 16, 16, 1500, 1500, 80, "bfloat16", False, None, 0),
    # llama-3.2-vision-90b's cross layer (H 64/8) over 1,024 image tokens
    ("cross_prefill_t8192_i1024", 1, 64, 8, 8192, 1024, 128, "bfloat16", False, None, 0),
    ("cross_decode_b8_i1024", 8, 64, 8, 1, 1024, 128, "bfloat16", False, None, 0),
    # float32 on the FMA kernel at both new head dims, both tilings
    ("hubert_fma_f32_t1500", 1, 16, 16, 1500, 1500, 80, "float32", False, None, 0),
    ("hubert_fma_short_f32_tq16", 8, 16, 4, 16, 1500, 80, "float32", False, None, 0),
    ("gemma3_fma_f32_t2048", 1, 16, 8, 2048, 2048, 256, "float32", True, 1024, 0),
    ("gemma3_fma_short_f32_tq16", 8, 16, 8, 16, 1024, 256, "float32", True, None, 1008),
)
FAMILY_FLASH_ROWS_TINY = (
    ("gemma3_prefill_local_reduced", 1, 4, 2, 256, 256, 256, "bfloat16", True, 64, 0),
    ("gemma3_decode_ring_reduced", 2, 4, 2, 1, 64, 256, "bfloat16", True, None, 100),
    ("hubert_reduced", 2, 4, 4, 150, 150, 80, "bfloat16", False, None, 0),
    ("cross_prefill_reduced", 1, 16, 2, 64, 128, 128, "bfloat16", False, None, 0),
    ("hubert_fma_short_f32_reduced", 2, 8, 2, 16, 150, 80, "float32", False, None, 0),
)


# phase 12's rows at a sequence-parallel rank's shapes: qwen3-8b's
# train_4k layer (B=1, H 32/8, Dh 128, bf16) cut over a model axis of 16,
# each rank's 256-query stripe against the 4,096 gathered keys at q_offset =
# its start: the first stripe (a triangle of 256 x 256) and the last (all
# 4,096 keys), the causal stripes' imbalance. name, tq, tk, q_offset
STRIPE_FLASH_ROWS = (
    ("qwen3_stripe0_of16_t4096", 256, 4096, 0),
    ("qwen3_stripe15_of16_t4096", 256, 4096, 3840),
)
STRIPE_FLASH_ROWS_TINY = (
    ("qwen3_stripe0_of4_t256", 64, 256, 0),
    ("qwen3_stripe3_of4_t256", 64, 256, 192),
)


def stripe_flash_rows(torch, np, F, fa, fa_ref, timer, tiny: bool) -> list:
    """Phase 12's rows at a sequence-parallel rank's shapes (the query
    stripe against the gathered sequence at its ``q_offset``), each with
    its device time, bound, plain time and SDPA's (a boolean mask below the
    top-left diagonal that ``is_causal`` draws)."""
    hq, hkv, dh = (4, 2, 32) if tiny else (32, 8, 128)
    return [flash_row(torch, np, F, fa, fa_ref, timer, name, 1, hq, hkv, tq, tk, dh,
                      torch.bfloat16, True, None, q_offset, library_causal=True,
                      reps=(3, 1) if tiny else (20, 2))
            for name, tq, tk, q_offset in (STRIPE_FLASH_ROWS_TINY if tiny else STRIPE_FLASH_ROWS)]


# phase 12's rows at a tensor-parallel rank's shapes: qwen3-8b's train_4k
# layer (B=1, T=4,096, Dh 128, bf16) on a model axis of 16, each rank's 2
# query heads reading 1 KV head (group 2 where the model's is 4): 64 query
# tiles of 64 rows a head for 132 SMs. name, b, hq, hkv, t, dh
TP_FLASH_ROWS = (("qwen3_tp16_heads2_t4096", 1, 2, 1, 4096, 128),)
TP_FLASH_ROWS_TINY = (("qwen3_tp2_heads2_t256", 1, 2, 1, 256, 32),)


def tp_flash_rows(torch, np, F, fa, fa_ref, timer, tiny: bool) -> list:
    """Phase 12's rows at a tensor-parallel rank's shapes (its own query
    heads over the whole causal sequence), each with its device time,
    bound, plain time and SDPA's."""
    return [flash_row(torch, np, F, fa, fa_ref, timer, name, b, hq, hkv, t, t, dh,
                      torch.bfloat16, True, None, 0, library_causal=True,
                      reps=(3, 1) if tiny else (20, 2))
            for name, b, hq, hkv, t, dh in (TP_FLASH_ROWS_TINY if tiny else TP_FLASH_ROWS)]


# phase 12's rows at deepseek-v2-236b's MLA pairs: name, b, hq, hkv, tq, tk,
# (dqk, dv), dtype, q_offset, latent (v the first Dv columns of the latent
# cache), plain_heads (the plain version's KV heads at a time); all causal
MLA_FLASH_ROWS = (
    # prefill at (192, 128), 128 heads, in the model's layout: wgmma_bf16
    ("mla_prefill_t8192", 1, 128, 128, 8192, 8192, (192, 128), "bfloat16", 0, False, 16),
    # the absorbed decode at (576, 512), 128 query heads on one latent head:
    # a 32k cache at B=8 (302 MB of latent rows) and the serve loop's cache
    ("mla_decode_latent_b8_tk32768", 8, 128, 1, 1, 32768, (576, 512), "bfloat16", 32767, True,
     None),
    ("mla_decode_latent_b8_tk160", 8, 128, 1, 1, 160, (576, 512), "bfloat16", 159, True, None),
    # the FMA kernel's bf16 instance at (576, 512): a latent buffer one
    # element off 16 bytes, which latent_wgmma's TMA cannot read
    ("mla_decode_latent_unaligned_b8_tk160", 8, 128, 1, 1, 160, (576, 512), "bfloat16", 159,
     "offset", None),
    # a 16-token prompt (decode_latent at (192, 128)), float32 on fma and
    # decode_latent, and the reduced config's (48, 32) on both
    ("mla_prefill_t16", 1, 128, 128, 16, 16, (192, 128), "bfloat16", 0, False, None),
    ("mla_prefill_fma_f32_t2048", 1, 16, 16, 2048, 2048, (192, 128), "float32", 0, False, None),
    ("mla_decode_latent_f32_b8_tk4096", 8, 128, 1, 1, 4096, (576, 512), "float32", 4095, True,
     None),
    ("mla_reduced_prefill_f32_t24", 2, 4, 4, 24, 24, (48, 32), "float32", 0, False, None),
    ("mla_reduced_decode_f32_tk8192", 2, 4, 1, 1, 8192, (48, 32), "float32", 8191, True, None),
)
MLA_FLASH_ROWS_TINY = (
    ("mla_prefill_reduced_heads", 1, 4, 4, 64, 64, (192, 128), "bfloat16", 0, False, 2),
    ("mla_decode_latent_reduced", 2, 4, 1, 1, 256, (48, 32), "bfloat16", 255, True, None),
    ("mla_decode_latent_full_width_tk64", 2, 128, 1, 1, 64, (576, 512), "bfloat16", 63, True,
     None),
    ("mla_decode_latent_unaligned_tk64", 2, 128, 1, 1, 64, (576, 512), "bfloat16", 63, "offset",
     None),
)


def mla_flash_rows(torch, np, F, fa, fa_ref, timer, tiny: bool) -> list:
    """Phase 12's rows at MLA's (Dqk, Dv) pairs: deepseek-v2-236b's prefill
    at (192, 128) and its absorbed decode at (576, 512), the float32 and
    short-prompt instances, the reduced config's (48, 32); each with its
    device time, bound, plain and SDPA times."""
    rows = []
    for name, b, hq, hkv, tq, tk, (dqk, dv), dtype, q_offset, latent, heads in (
            MLA_FLASH_ROWS_TINY if tiny else MLA_FLASH_ROWS):
        big = tq * tk * hq * b >= 1 << 30
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, name, b, hq, hkv, tq, tk, dqk,
                              getattr(torch, dtype), True, None, q_offset,
                              library_causal=tq > 1, dv=dv, latent=latent, plain_heads=heads,
                              reps=(3, 1) if tiny else ((3, 2) if big else (10, 2))))
        if timer.device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def family_flash_rows(torch, np, F, fa, fa_ref, timer, tiny: bool) -> list:
    """Phase 12's rows at gemma3-12b's, hubert-xlarge's and
    llama-3.2-vision-90b's attention shapes (head dims 256 and 80, the
    sliding window, the ring, bidirectional Tq != Tk), each with its
    device time, bound, plain and SDPA times."""
    rows = []
    for name, b, hq, hkv, tq, tk, dh, dtype, causal, window, q_offset in (
            FAMILY_FLASH_ROWS_TINY if tiny else FAMILY_FLASH_ROWS):
        big = tq * tk * hq * b >= 1 << 30  # the plain version's float32 scores above 4 GB
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, name, b, hq, hkv, tq, tk, dh,
                              getattr(torch, dtype), causal, window, q_offset,
                              library_causal=causal and q_offset + 1 < tk,
                              reps=(3, 1) if tiny else ((3, 2) if big else (20, 2))))
        if timer.device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def scan_row(torch, scan, scan_ref, timer, name, bsz, t, d, n, dtype, tol, model_a=False,
             main=False):
    """Phase 13: one shape of the selective-scan kernel against its plain
    version (y and h_T), its device time and its bound."""
    device = timer.device
    gen = torch.Generator(device=device).manual_seed(d + t)
    rnd = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    x = rnd(bsz, t, d).to(dtype)
    dt = (rnd(bsz, t, d).abs() * 0.1 + 0.01).to(dtype)
    if model_a:  # the model's A = -exp(a_log) = -(1..N) on every channel
        a = -torch.arange(1, n + 1, dtype=torch.float32, device=device).expand(d, n).contiguous()
    else:
        a = -(rnd(d, n).abs() + 0.1)
    b, c = rnd(bsz, t, n).to(dtype), rnd(bsz, t, n).to(dtype)
    d_skip = rnd(d)
    args = (x, dt, a, b, c, d_skip)
    y, h = scan.selective_scan(*args)
    y_want, h_want = scan_ref.selective_scan_ref(*args)
    sync(torch, device)
    ok_y, err_y = within(y, y_want, tol)
    ok_h, err_h = within(h, h_want, tol)
    check(ok_y and ok_h, f"scan {name}: kernel differs from plain version beyond {tol} "
                         f"(y {err_y}, h_T {err_h})")
    call = lambda: scan.selective_scan(*args)  # noqa: E731
    item = x.element_size()
    nbytes = 3 * bsz * t * d * item + 2 * bsz * t * n * item + d * n * 4 + d * 4 + bsz * d * n * 4
    ops = 7 * bsz * t * d * n  # per (t, d, n): dt*A, exp, *h, *B, +, *C, the sum over N
    exps = bsz * t * d * n  # the exp of each (t, d, n) on the special-function units
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(ops / FP32_OPS_PER_S, exps / EXP_PER_S) * 1e3
    ms = timer.device_ms(call, reps=10 if main else 20, replays=2)
    row = {
        "shape": name, "b": bsz, "t": t, "d": d, "n": n, "dtype": str(dtype).split(".")[1],
        "variant": f"states{min(scan.STATES_PER_THREAD, n)}", "tol": tol,
        "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y, "max_abs_err_h": err_h,
        "ms": ms, "exp_bound_share": exps / EXP_PER_S * 1e3 / ms,
        "bytes": nbytes, "ops": ops, "exps": exps,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    if main:
        row.update({
            "call_ms": timer(call, reps=10, warmup=1),
            "plain_ms": timer(lambda: scan_ref.selective_scan_ref(*args), reps=1, warmup=1),
            "library_ms": None,  # no single PyTorch call computes the scan
        })
    return row


SCAN_TP_RANKS = 16  # the production mesh's model axis


def scan_kernel_checks(torch, scan, scan_ref, timer, tiny: bool):
    """Phase 13: the scan kernel at one falcon-mamba-7b layer and at the
    test shapes."""
    t, d = (256, 256) if tiny else (8192, 8192)
    rows = [scan_row(torch, scan, scan_ref, timer, f"falcon_layer_t{t}_d{d}", 1, t, d, 16,
                     torch.float32, SCAN_LAYER_TOL, model_a=True, main=True)]
    # a tensor-parallel rank's channels: the layer's Di over a model axis of
    # 16 (2 with --tiny)
    tp = 2 if tiny else SCAN_TP_RANKS
    rows.append(scan_row(torch, scan, scan_ref, timer, f"falcon_tp{tp}_t{t}_d{d // tp}", 1, t,
                         d // tp, 16, torch.float32, SCAN_LAYER_TOL, model_a=True, main=True))
    for dtype in (torch.float32, torch.bfloat16):
        for bsz, t, d, n in ((1, 16, 64, 8), (2, 32, 128, 16), (2, 8, 512, 16)):
            rows.append(scan_row(torch, scan, scan_ref, timer, "test_kernels", bsz, t, d, n,
                                 dtype, SCAN_TOL[str(dtype).split(".")[1]]))
    # batch 65,536, one more row than grid y holds, at the smallest width
    rows.append(scan_row(torch, scan, scan_ref, timer, "grid_cap_b65536", 65536, 3, 1, 8,
                         torch.float32, SCAN_TOL["float32"]))
    for row in rows:
        log(json.dumps({"phase": 13, **row}))
    return rows


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_numel(v) for v in tree)
    return tree.numel()


def profile_lm(torch, fn, device, kernel_name: str, annotation: str | None = None) -> dict:
    """One call of ``fn`` under ``torch.profiler`` after a profiled warm-up
    call (a short window loses its first device events otherwise). With
    ``annotation`` also the device time of the kernels launched inside the
    profiler ranges of that name (the MoE layers' ``MOE_RANGE``) and its
    share of the card's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            sync(torch, device)
            wall = time.perf_counter() - t0
            prof.step()
    out = {"profiled_wall_s": wall, **device_time(prof, wall, on_card, kernel_name)}
    if annotation is not None:
        ranges = [e for e in prof.events() if e.name == annotation
                  and e.device_type == DeviceType.CPU]
        ms = sum(e.device_time_total for e in ranges) / 1e3 if on_card else None
        busy = out["device_busy_s"]
        out.update({"range": annotation, "range_calls": len(ranges), "range_device_ms": ms,
                    "range_share_of_busy": ms / (busy * 1e3) if ms is not None and busy else None})
    return out


def lm_phase(torch, np, counters, device, arch: str, tiny: bool, ident: str,
             n_blocks: int | None = None) -> tuple:
    """Phases 14-15 and 25(a): ``arch`` at full width and depth (reduced
    with ``--tiny``; ``n_blocks`` cuts the depth at full width): prefill
    through ``make_prefill_step``, then the serve loop, with the launches of
    both kernels checked on each path. A model with MoE layers also gets its
    prefill profiled, and both profiles the MoE ranges' device time. Returns
    the record, the model and its weights (phase 17 decodes with qwen3's)."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.launch.serve import prefill_into_cache, serve
    from repro_torch.models import Model
    from repro_torch.models.layers import MOE_RANGE, moe_capacity
    from repro_torch.serve.lm import make_prefill_step

    cfg = get_model_config(("reduced:" if tiny else "") + arch)
    if n_blocks is not None and not tiny:
        cfg = dataclasses.replace(cfg, n_blocks=n_blocks)
    moe = cfg.n_experts > 0
    model = Model(cfg, device)
    on_card = device.type == "cuda"
    n_attn = sum(s.mixer == "attn" for s in cfg.layers())
    n_mamba = sum(s.mixer == "mamba" for s in cfg.layers())
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    sync(torch, device)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    seq = 64 if tiny else 8192
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, (1, seq)), device=model.device)
    prefill = make_prefill_step(model)
    reset_counts(*counters)
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    prefill_launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    expect = {"flash_attention": n_attn, "selective_scan": n_mamba} if on_card else \
        {"flash_attention": 0, "selective_scan": 0}
    check(prefill_launches == expect,
          f"{arch} prefill launched {prefill_launches}, expected {expect}")
    # a bf16 prefill of T=8192 runs every attention layer on the tensor cores
    prefill_variants = dict(fa.variant_launches)
    expect = {n: n_attn * (n == "wgmma_bf16") * on_card for n in fa.VARIANTS}
    check(prefill_variants == expect,
          f"{arch} prefill ran the attention variants {prefill_variants}, expected {expect}")
    check(all(m.launches == 0 for m in counters if m not in (fa, scan)),
          f"{arch} prefill launched a partitioning or analytics kernel")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
          f"{arch} prefill logits have the wrong shape or non-finite entries")
    prefill_peak = torch.cuda.max_memory_allocated() if on_card else None
    del logits
    # the full-sequence path (prefill kernel mode) against the decode path
    # (one token a step) on a short prompt at full width
    short = tokens[:, :16]
    lp = prefill(params, {"tokens": short}).float()
    ld, _ = prefill_into_cache(model, params, model.init_cache(1, 16), short)
    rel = float((lp - ld.float()).norm() / lp.norm())
    # not held with MoE layers: the capacity, so which (token, slot) pairs
    # drop, depends on the tokens of a call (16 in the prefill, 1 a step)
    check(moe or rel < 0.1, f"{arch}: prefill and decode-path logits differ by {rel} "
                            "(relative L2)")
    # the serve loop
    b, plen, gen = (2, 8, 4) if tiny else (8, 128, 32)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, plen)), device=model.device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    out, timings = serve(model, params, prompts, gen)
    serve_launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    expect = {"flash_attention": n_attn * (plen + gen - 1), "selective_scan": 0} if on_card \
        else {"flash_attention": 0, "selective_scan": 0}
    check(serve_launches == expect, f"{arch} serve launched {serve_launches}, expected {expect}")
    # a decode step: g * Tq = 4 <= 16 on decode_split; MLA's absorbed step
    # (128 query heads on the latent head) on latent_wgmma in bf16 at
    # (576, 512), on decode_latent at the reduced pair
    serve_variants = dict(fa.variant_launches)
    decode_variant = mla_decode_variant(fa, cfg, model.dtype) if cfg.use_mla else "decode_split"
    expect = {n: serve_launches["flash_attention"] * (n == decode_variant) for n in fa.VARIANTS}
    check(serve_variants == expect,
          f"{arch} serve ran the attention variants {serve_variants}, expected {expect}")
    # the serve loop's short cache is one share: one kernel a call, no merge
    serve_splits = dict(fa.split_launches)
    expect = {1: serve_launches["flash_attention"]} if on_card and n_attn else {}
    check(serve_splits == expect, f"{arch} serve split its cache as {serve_splits} "
                                  f"(n_split: launches), expected {expect}")
    check(tuple(out.shape) == (b, gen) and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"{arch} serve produced ids of the wrong shape or range")
    serve_peak = torch.cuda.max_memory_allocated() if on_card else None
    # profiled: one qwen3 decode step, one falcon prefill; with MoE layers
    # both, each with the MoE ranges' device time
    annotation = MOE_RANGE if moe else None
    prefill_prof = None
    if not n_attn or moe:
        prefill_prof = {"what": f"prefill b=1 t={seq}", **profile_lm(
            torch, lambda: prefill(params, {"tokens": tokens}), device,
            "scan_kernel" if n_mamba else "attn_", annotation)}
    if n_attn:
        cache = model.init_cache(b, plen + gen)
        tok = prompts[:, :1]
        prof = profile_lm(torch, lambda: model.decode_step(params, cache, tok, plen), device,
                          "attn_", annotation)
        profiled = f"decode_step b={b} pos={plen}"
    else:
        prof, profiled = prefill_prof, prefill_prof.pop("what")
        prefill_prof = None
    record = {
        "arch": cfg.name, "params": tree_numel(params), "param_count": cfg.param_count(),
        "layers": cfg.num_layers, "dtype": cfg.dtype, "init_s": init_s,
        "prefill": {"batch": 1, "seq": seq, "seconds": prefill_s, "launches": prefill_launches,
                    "flash_variants": prefill_variants, "tokens_per_s": seq / prefill_s,
                    "max_memory_allocated": prefill_peak},
        "prefill_vs_decode_path_rel_l2": rel,
        "serve": {"batch": b, "prompt_len": plen, "gen": gen, **timings,
                  "launches": serve_launches, "flash_variants": serve_variants,
                  "split_launches": serve_splits, "max_memory_allocated": serve_peak,
                  "first_ids": out[0, :8].tolist()},
        "profile": {"what": profiled, **prof}, "device": ident,
    }
    if prefill_prof is not None:
        record["profile_prefill"] = prefill_prof
    if moe:
        record["active_param_count"] = cfg.active_param_count()
        record["moe"] = {"n_experts": cfg.n_experts, "top_k": cfg.top_k,
                         "moe_layers": sum(s.ffn in ("moe", "moe_dense") for s in cfg.layers()),
                         "capacity_prefill": moe_capacity(seq, cfg),
                         "capacity_serve_step": moe_capacity(b, cfg)}
    return record, model, params


def fill_cache(torch, cache: list, generator) -> None:
    """Every tensor of a decode cache drawn from ``generator`` (N(0, 1)), in
    place: keys and values of the magnitude qk-norm and RoPE give."""
    for layer in cache:
        for t in layer.values():
            t.normal_(generator=generator)


def long_decode_phase(torch, np, counters, device, model, params, tiny: bool, ident: str) -> dict:
    """Phase 17: qwen3-8b decoding over a long cache at full width and depth
    (the reduced config and a 2,048 cache with ``--tiny``), with phase 14's
    weights: one layer's attention over the cache against the plain version,
    then ``decode_step``s from near the cache's end with their launches
    counted, then one step under ``torch.profiler``."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.models.attention import gqa_flash_decode

    cfg = model.cfg
    on_card = device.type == "cuda"
    n_attn = sum(s.mixer == "attn" for s in cfg.layers())
    b, seq, steps = (8, 2048, 4) if tiny else (8, 32768, 8)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # phase 14's activations and serve cache are gone
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = model.init_cache(b, seq)
    fill_cache(torch, cache, torch.Generator(device=model.device).manual_seed(17))
    sync(torch, device)
    fill_s = time.perf_counter() - t0
    # one layer's attention over the filled cache against the plain version
    gen = torch.Generator(device=model.device).manual_seed(18)
    q = torch.randn((b, cfg.n_heads, cfg.head_dim), generator=gen, device=model.device,
                    dtype=torch.float32).to(model.dtype)
    pos = seq - 1
    got = gqa_flash_decode(q, cache[0]["k"], cache[0]["v"], pos, None)
    want = fa_ref.flash_attention_ref(q[:, :, None], cache[0]["k"].transpose(1, 2),
                                      cache[0]["v"].transpose(1, 2), causal=True,
                                      q_offset=pos)[:, :, 0]
    tname = str(model.dtype).split(".")[1]
    ok, err = within(got, want, FLASH_TOL[tname])
    check(ok, f"long decode: layer attention differs from the plain version ({err})")
    row_err = worst_row_rel_l2(got, want)
    check(row_err <= FLASH_ROW_RTOL, f"long decode: a row differs by {row_err} relative L2")
    del q, got, want
    # the main path: decode steps from near the end of the cache
    rng = np.random.default_rng(17)
    tok = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, 1)), device=model.device)
    start = seq - steps
    sync(torch, device)
    reset_counts(*counters)
    step_s = []
    for i in range(steps):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok, start + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        sync(torch, device)
        step_s.append(time.perf_counter() - t0)
    launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    variants = dict(fa.variant_launches)
    splits = dict(fa.split_launches)
    expect = {"flash_attention": n_attn * steps * on_card, "selective_scan": 0}
    check(launches == expect, f"long decode launched {launches}, expected {expect}")
    # every launch split the long cache, all with one count
    n_split = next(iter(splits)) if len(splits) == 1 else None
    check(not on_card or (n_split is not None and n_split > 1),
          f"a {seq}-long cache at B={b} was not split into one count > 1: {splits}")
    expect = {n: n_attn * steps * on_card * (n == "decode_split") for n in fa.VARIANTS}
    check(variants == expect, f"long decode ran the attention variants {variants}, "
                              f"expected {expect}")
    check(all(m.launches == 0 for m in counters if m not in (fa, scan)),
          "long decode launched a partitioning or analytics kernel")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
          "long decode logits have the wrong shape or non-finite entries")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    per_step = sum(step_s[1:]) / (steps - 1)  # the first step warms the caches up
    prof = profile_lm(torch, lambda: model.decode_step(params, cache, tok, pos), device, "attn_")
    del cache, logits
    if on_card:
        torch.cuda.empty_cache()
    kv_bytes = 2 * n_attn * b * seq * cfg.n_kv_heads * cfg.head_dim * \
        torch.finfo(model.dtype).bits // 8
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": b,
        "cache_len": seq, "first_pos": start, "steps": steps, "n_split": n_split,
        "blocks_per_sm": fa.decode_blocks_per_sm(device, model.dtype, cfg.head_dim,
                                                 cfg.n_heads // cfg.n_kv_heads)
        if on_card else None,
        "cache_fill_s": fill_s, "kv_cache_bytes": kv_bytes,
        "attention_bound_ms_per_step": kv_bytes / HBM_BYTES_PER_S * 1e3,
        "layer_check": {"max_abs_err": err, "max_row_rel_l2": row_err},
        "step_seconds": step_s, "seconds_per_step": per_step, "tokens_per_s": b / per_step,
        "launches": launches, "flash_variants": variants, "max_memory_allocated": peak,
        "first_ids": tok[:, 0].tolist(),
        "profile": {"what": f"decode_step b={b} pos={pos}", **prof}, "device": ident,
    }


def long_cache_step(torch, cpu, params, card, dparams, toks) -> dict:
    """Phase 16: one decode step at the end of a seeded 8,192-long cache on
    the card and on the CPU; on the card the decode kernel splits it (a
    ring or an image cache, 16 entries, is one share)."""
    from repro_torch.kernels.flash_attention import ops as fa

    b, seq = toks.shape[0], 8192
    cache = cpu.init_cache(b, seq)
    fill_cache(torch, cache, torch.Generator().manual_seed(16))
    dcache = tree_to(cache, card.device)
    before = dict(fa.split_launches)
    got, _ = card.decode_step(dparams, dcache, toks[:, :1].to(card.device), seq - 1)
    sync(torch, card.device)
    ran = {n: c - before.get(n, 0) for n, c in fa.split_launches.items()
           if c != before.get(n, 0)}
    # the layers over the whole cache split it (MLA's latent cache too); a
    # ring (gemma3's 16 slots) or an image cache (llama's 16 tokens) is one
    # share
    length = [c["k"].shape[1] if "k" in c else c["ckv"].shape[1] for c in cache
              if "k" in c or "ckv" in c]
    whole = sum(n == seq for n in length)
    short = sum(n < seq for n in length) + sum("k_img" in c for c in cache)
    splits = {n: c for n, c in ran.items() if n > 1}
    n_split = next(iter(splits)) if len(splits) == 1 else None
    check(card.device.type != "cuda" or (n_split is not None and splits[n_split] == whole
                                         and ran.get(1, 0) == short),
          f"reduced decode at {seq}: {whole} layers' caches not split into one count > 1 "
          f"and {short} short caches not one share ({ran})")
    want, _ = cpu.decode_step(params, cache, toks[:, :1], seq - 1)
    ok, err = within(got.cpu(), want, 1e-4)
    check(ok, f"reduced decode at a {seq} cache: card and cpu logits differ beyond 1e-4 ({err})")
    check(torch.equal(got.argmax(-1).cpu(), want.argmax(-1)),
          f"reduced decode at a {seq} cache: greedy tokens differ")
    return {"cache_len": seq, "n_split": n_split, "split_launches": ran, "max_abs_err": err,
            "greedy_tokens_equal": True}


def reduced_parity(torch, np, device) -> list:
    """Phase 16: each reduced config in float32 with the same weights on the
    card and on the CPU; with MoE layers also every layer's expert ids and
    the router loss. hubert-xlarge takes frames and runs ``forward`` only;
    llama-3.2-vision-90b's forward reads image embeddings. The card's serve
    loop records its attention variants: reduced deepseek-v2's runs MLA's
    float32 FMA kernel, ``decode_latent``, at (48, 32) on every call."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    from repro_torch.models import layers

    top_k, chosen = layers.top_k, []

    def recording(probs, k):  # every MoE layer's expert ids, in call order
        vals, idx = top_k(probs, k)
        chosen.append(idx.cpu())
        return vals, idx

    rows = []
    for arch in REDUCED_ARCHS:
        cfg = dataclasses.replace(get_model_config(f"reduced:{arch}"), dtype="float32")
        cpu = Model(cfg, "cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        card = Model(cfg, device)
        dparams = tree_to(params, card.device)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
        inputs = {"tokens": toks}
        if cfg.frontend == "frames":  # hubert-xlarge: frames in place of tokens
            inputs = {"frames": torch.from_numpy(rng.standard_normal(
                (2, 24, cfg.d_model)).astype(np.float32))}
        if cfg.n_img_tokens:  # llama-3.2-vision-90b: its cross layers read images
            inputs["image_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
        layers.top_k = recording
        try:
            got, got_aux = card.forward(dparams, tree_to(inputs, card.device))
            ids_card = list(chosen)
            chosen.clear()
            want, want_aux = cpu.forward(params, inputs)
            ids_cpu = list(chosen)
            chosen.clear()
        finally:
            layers.top_k = top_k
        ok, err = within(got.cpu(), want, 1e-4)
        check(ok, f"reduced {arch}: {device.type} and cpu logits differ beyond 1e-4 ({err})")
        ok, aux_err = within(got_aux.cpu(), want_aux, 1e-4)
        check(ok, f"reduced {arch}: router losses differ beyond 1e-4 ({aux_err})")
        check(len(ids_card) == len(ids_cpu) == sum(s.ffn in ("moe", "moe_dense")
                                                   for s in cfg.layers())
              and all(torch.equal(a, b) for a, b in zip(ids_card, ids_cpu)),
              f"reduced {arch}: the card and the cpu chose other experts")
        row = {"arch": f"reduced:{arch}", "dtype": "float32", "max_abs_err": err,
               "aux": float(want_aux), "aux_abs_err": aux_err, "moe_layers": len(ids_cpu),
               "expert_ids_equal": True}
        if cfg.is_encoder_only:  # hubert-xlarge has no decode path
            rows.append(row)
            continue
        # 8 + 8 tokens: gemma3's 16-slot rings (window 16) at init_cache(seq=16)
        fa.reset()
        g_card, _ = serve(card, dparams, toks[:, :8].to(card.device), 8)
        row["serve_flash_variants"] = {n: c for n, c in fa.variant_launches.items() if c}
        check(device.type != "cuda" or not cfg.use_mla
              or set(row["serve_flash_variants"]) == {"decode_latent"},
              f"reduced {arch}: serve ran the attention variants {row['serve_flash_variants']}")
        g_cpu, _ = serve(cpu, params, toks[:, :8], 8)
        check(torch.equal(g_card.cpu(), g_cpu), f"reduced {arch}: greedy tokens differ")
        row["greedy_tokens_equal"] = True
        if any(s.mixer == "attn" for s in cfg.layers()):
            row["long_cache_decode"] = long_cache_step(torch, cpu, params, card, dparams, toks)
        rows.append(row)
    for row in rows:
        log(json.dumps({"phase": 16, **row}))
    return rows


def dense_family_phase(torch, np, counters, device, arch: str, tiny: bool) -> dict:
    """Phase 25(b): ``arch`` at full width with two layers (reduced with
    ``--tiny``): ``make_prefill_step`` at B=1, T=8192 (a launch a layer on
    the tensor-core variant), then 8 ``decode_step``s at B=8 from the end of
    a seeded 8,192-long cache (a ``decode_split`` launch a layer a step)."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.models import Model
    from repro_torch.serve.lm import make_prefill_step

    t_start = time.perf_counter()
    cfg = get_model_config(("reduced:" if tiny else "") + arch)
    if not tiny:
        cfg = dataclasses.replace(cfg, n_blocks=2)
    on_card = device.type == "cuda"
    n_attn = cfg.num_layers
    model = Model(cfg, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    seq, b, steps = (64, 2, 4) if tiny else (8192, 8, 8)
    rng = np.random.default_rng(25)
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, (1, seq)), device=model.device)
    reset_counts(*counters)
    t0 = time.perf_counter()
    logits = make_prefill_step(model)(params, {"tokens": tokens})
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    variants = dict(fa.variant_launches)
    check(launches == {"flash_attention": n_attn * on_card, "selective_scan": 0}
          and variants == {n: n_attn * on_card * (n == "wgmma_bf16") for n in fa.VARIANTS},
          f"{arch} prefill launched {launches}, variants {variants}")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
          f"{arch} prefill logits have the wrong shape or non-finite entries")
    del logits
    cache = model.init_cache(b, seq)
    fill_cache(torch, cache, torch.Generator(device=model.device).manual_seed(25))
    tok = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, 1)), device=model.device)
    sync(torch, device)
    reset_counts(*counters)
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode_step(params, cache, tok, seq - steps + i)
        tok = logits[:, -1].argmax(-1)[:, None]
    sync(torch, device)
    decode_s = time.perf_counter() - t0
    dec_launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    dec_variants = dict(fa.variant_launches)
    check(dec_launches == {"flash_attention": n_attn * steps * on_card, "selective_scan": 0}
          and dec_variants == {n: n_attn * steps * on_card * (n == "decode_split")
                               for n in fa.VARIANTS},
          f"{arch} decode launched {dec_launches}, variants {dec_variants}")
    check(bool(logits.isfinite().all()), f"{arch} decode logits are not finite")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    rec = {
        "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
        "params": tree_numel(params), "group": cfg.n_heads // cfg.n_kv_heads,
        "activation": cfg.activation, "prefill": {"batch": 1, "seq": seq, "seconds": prefill_s,
                                                  "launches": launches, "flash_variants": variants},
        "decode": {"batch": b, "cache_len": seq, "steps": steps, "seconds": decode_s,
                   "tokens_per_s": b * steps / decode_s, "launches": dec_launches,
                   "flash_variants": dec_variants, "split_launches": dict(fa.split_launches)},
        "max_memory_allocated": peak, "seconds": time.perf_counter() - t_start,
    }
    del model, params, cache, logits
    if on_card:
        torch.cuda.empty_cache()
    return rec


def moe_phase(torch, np, F, fa, fa_ref, counters, device, timer, tiny: bool, ident: str) -> dict:
    """Phase 25: the MoE families, minitron-8b and deepseek-coder-33b, and
    CUTTANA expert placement. (d) first, while the card is empty: the attention
    kernel at arctic-480b's shapes (g = 7) against its plain version; then
    (a) jamba-v0.1-52b and arctic-480b at full width cut to one block,
    served through ``lm_phase``; (b) minitron-8b and deepseek-coder-33b at
    two layers; (c) ``place_experts`` on ``examples/moe_placement.py``'s
    trace against the reference's fanouts. Each part logs its seconds."""
    from repro_torch.core import placement

    out = {"seconds": {}}
    t0 = time.perf_counter()
    if tiny:  # arctic's g = 7 and Dh at the reduced width
        rows = [flash_row(torch, np, F, fa, fa_ref, timer, "arctic_prefill_reduced", 1, 14, 2,
                          256, 256, 128, torch.bfloat16, library_causal=True, reps=(3, 1)),
                flash_row(torch, np, F, fa, fa_ref, timer, "arctic_decode_reduced", 8, 14, 2, 1,
                          40, 128, torch.bfloat16, q_offset=39, library_causal=False,
                          reps=(3, 1))]
    else:
        rows = [flash_row(torch, np, F, fa, fa_ref, timer, "arctic_prefill_t8192", 1, 56, 8,
                          8192, 8192, 128, torch.bfloat16, library_causal=True, reps=(3, 2)),
                flash_row(torch, np, F, fa, fa_ref, timer, "arctic_decode_tk160_b8", 8, 56, 8,
                          1, 160, 128, torch.bfloat16, q_offset=159, library_causal=False,
                          reps=(20, 2))]
    for row in rows:
        log(json.dumps({"phase": 25, "part": "d", **row}))
    out["rows"] = rows
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the plain version's scores at the prefill shape
    out["seconds"]["d"] = time.perf_counter() - t0
    out["launches"] = {"flash_attention": 0, "selective_scan": 0}
    out["flash_variants"] = dict.fromkeys(fa.VARIANTS, 0)
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        rec, model, params = lm_phase(torch, np, counters, device, arch, tiny, ident, n_blocks=1)
        del model, params
        if device.type == "cuda":
            torch.cuda.empty_cache()  # one big model at a time
        for path in ("prefill", "serve"):
            for name, n in rec[path]["launches"].items():
                out["launches"][name] += n
            for name, n in rec[path]["flash_variants"].items():
                out["flash_variants"][name] += n
        rec["seconds"] = out["seconds"][f"a_{arch}"] = time.perf_counter() - t0
        log(json.dumps({"phase": 25, "part": "a", **rec}))
        out[arch] = rec
    for arch in DENSE_ARCHS:
        rec = dense_family_phase(torch, np, counters, device, arch, tiny)
        for path in ("prefill", "decode"):
            for name, n in rec[path]["launches"].items():
                out["launches"][name] += n
            for name, n in rec[path]["flash_variants"].items():
                out["flash_variants"][name] += n
        out["seconds"][f"b_{arch}"] = rec["seconds"]
        log(json.dumps({"phase": 25, "part": "b", **rec}))
        out[arch] = rec
    # (c) host numpy, as in the reference
    t0 = time.perf_counter()
    e, devices, k = 160, 16, 6  # examples/moe_placement.py: deepseek-v2's experts on 16 devices
    trace = placement.synthetic_routing_trace(50_000, e, k, skew=0.7, seed=0)
    placed = placement.place_experts(trace, e, devices, seed=0)
    layouts = {"round_robin": np.arange(e) % devices,
               "contiguous": np.repeat(np.arange(devices), e // devices), "cuttana": placed}
    scores = {name: placement.evaluate_placement(trace, pl) for name, pl in layouts.items()}
    for name, want in PLACEMENT_FANOUT.items():
        check(scores[name]["mean_fanout"] == want,
              f"placement {name}: mean fanout {scores[name]['mean_fanout']} != {want}")
    check(bool((np.bincount(placed, minlength=devices) == e // devices).all()),
          "placement: a device holds another count of experts")
    out["seconds"]["c"] = time.perf_counter() - t0
    out["placement"] = {"tokens": 50_000, "experts": e, "top_k": k, "devices": devices,
                        "scores": scores, "seconds": out["seconds"]["c"]}
    log(json.dumps({"phase": 25, "part": "c", **out["placement"]}))
    log(json.dumps({"phase": 25, "part_seconds": out["seconds"]}))
    return out


def swapped_attention(fa_ref, calls: list | None = None):
    """A context in which every attention call of the models runs the
    kernel's plain version (``flash_attention_ref``) instead of the kernel,
    or, given ``calls``, the kernel with each call held against the plain
    version on its own inputs (phase 17's bf16 gate; each call's errors
    appended to ``calls``)."""
    import contextlib

    from repro_torch.models import attention

    kernel = attention.flash_attention

    def checked(q, k, v, causal=True, window=None, q_offset=0):
        got = kernel(q, k, v, causal=causal, window=window, q_offset=q_offset)
        want = fa_ref.flash_attention_ref(q, k, v, causal, window, q_offset)
        ok, err = within(got, want, FLASH_TOL[str(q.dtype).split(".")[1]])
        row = worst_row_rel_l2(got, want)
        check(ok and row <= FLASH_ROW_RTOL,
              f"attention call {len(calls)} (k {tuple(k.shape)}, causal {causal}, q_offset "
              f"{q_offset}) differs from the plain version ({err}, row relative L2 {row})")
        calls.append({"tk": k.shape[2], "max_abs_err": err, "max_row_rel_l2": row})
        return got

    @contextlib.contextmanager
    def swapped():
        attention.flash_attention = fa_ref.flash_attention_ref if calls is None else checked
        try:
            yield
        finally:
            attention.flash_attention = kernel

    return swapped()


def clone_cache(cache: list) -> list:
    return [{name: t.clone() for name, t in layer.items()} for layer in cache]


def variant_counts(fa, n: int, variant: str, on_card: bool) -> dict:
    return {name: n * on_card * (name == variant) for name in fa.VARIANTS}


def mla_decode_variant(fa, cfg, dtype) -> str:
    """The attention variant of an MLA model's absorbed decode step: 128
    query heads on the one latent head, the value the key's first
    ``kv_lora_rank`` columns (the model's cache buffers are aligned)."""
    r = cfg.kv_lora_rank
    return fa.kernel_variant(dtype, 1, cfg.n_heads, r + cfg.qk_rope_dim, True, r)


def fill_images(torch, model, params, cache: list, img) -> None:
    """Each cross-attention layer's image keys and values from the image
    embeddings ``img`` [B, N, D], as the reference's tests fill them
    (``img @ wk``, ``img @ wv``)."""
    cfg = model.cfg
    b, n = img.shape[:2]
    for spec, p, c in zip(cfg.layers(), params["layers"], cache):
        if spec.mixer == "cross_attn":
            c["k_img"].copy_((img @ p["attn"]["wk"]).reshape(b, n, cfg.n_kv_heads, cfg.head_dim))
            c["v_img"].copy_((img @ p["attn"]["wv"]).reshape(b, n, cfg.n_kv_heads, cfg.head_dim))


def ring_decode_part(torch, np, fa, fa_ref, counters, device, model, params,
                     tiny: bool) -> dict:
    """Phase 26(a)'s long decode: 8 ``decode_step``s at B=8 from the end of a
    seeded 8,192-long cache (the local layers' 1,024-slot rings warm and
    wrapping), then one more step held against the same step with every
    attention call on the plain version."""
    from repro_torch.kernels.mamba_scan import ops as scan

    cfg = model.cfg
    on_card = device.type == "cuda"
    n_attn = cfg.num_layers
    b, seq, steps = (2, 64, 4) if tiny else (8, 8192, 8)
    cache = model.init_cache(b, seq)
    rings = [c["k"].shape[1] for c, s in zip(cache, cfg.layers()) if s.window]
    fill_cache(torch, cache, torch.Generator(device=model.device).manual_seed(26))
    rng = np.random.default_rng(26)
    tok = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, 1)), device=model.device)
    sync(torch, device)
    reset_counts(*counters)
    t0 = time.perf_counter()
    for i in range(steps):
        if i == steps - 1:  # the last step's cache and token, for the plain version
            spare, last = clone_cache(cache), tok
        logits, cache = model.decode_step(params, cache, tok, seq - steps + i)
        tok = logits[:, -1].argmax(-1)[:, None]
    sync(torch, device)
    decode_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    variants = dict(fa.variant_launches)
    check(launches == {"flash_attention": n_attn * steps * on_card, "selective_scan": 0}
          and variants == variant_counts(fa, n_attn * steps, "decode_split", on_card),
          f"{cfg.name} ring decode launched {launches}, variants {variants}")
    check(bool(logits.isfinite().all()), f"{cfg.name} ring decode logits are not finite")
    # the last step again from its cache: each attention call against the
    # plain version on its own inputs (phase 17's bf16 gate: the rings, warm
    # and wrapped, and the global cache), and the logits against the same
    # step with every call on the plain version (each row within 1e-2
    # relative L2; bf16 roundings compound over the layers and the head)
    calls: list = []
    with swapped_attention(fa_ref, calls):
        got, _ = model.decode_step(params, clone_cache(spare), last, seq - 1)
    with swapped_attention(fa_ref):
        want, _ = model.decode_step(params, spare, last, seq - 1)
    check(len(calls) == n_attn, f"{cfg.name}: {len(calls)} attention calls checked, "
                                f"expected {n_attn}")
    row_err = worst_row_rel_l2(got, want)
    check(row_err <= FLASH_ROW_RTOL, f"{cfg.name} decode step at position {seq - 1}: logits "
                                     f"differ from the plain version's by {row_err} relative L2")
    gate = {"calls": calls, "logits_max_row_rel_l2": row_err,
            "logits_max_abs_diff": float((got.float() - want.float()).abs().max()),
            "same_as_timed_step": bool(torch.equal(got, logits))}
    del cache, spare, logits, want, got
    return {"batch": b, "cache_len": seq, "ring_slots": rings, "first_pos": seq - steps,
            "steps": steps, "seconds": decode_s, "tokens_per_s": b * steps / decode_s,
            "launches": launches, "flash_variants": variants,
            "split_launches": dict(fa.split_launches), "plain_step": gate}


def encoder_part(torch, np, counters, device, tiny: bool, ident: str) -> dict:
    """Phase 26(b): hubert-xlarge at full depth (48 layers, about 0.95B
    parameters): ``forward`` on seeded frames at B=8, T=1500 (30 s of audio
    at 50 frames a second), a bidirectional ``wgmma_bf16`` launch a layer at
    Dh 80; one forward under ``torch.profiler``."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.models import Model

    cfg = get_model_config(("reduced:" if tiny else "") + "hubert-xlarge")
    on_card = device.type == "cuda"
    model = Model(cfg, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    b, t = (2, 150) if tiny else (8, 1500)
    gen = torch.Generator(device=model.device).manual_seed(260)
    frames = torch.randn((b, t, cfg.d_model), generator=gen, device=model.device)
    with torch.no_grad():
        reset_counts(*counters)
        t0 = time.perf_counter()
        logits, _ = model.forward(params, {"frames": frames})
        sync(torch, device)
        forward_s = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
        variants = dict(fa.variant_launches)
        check(launches == {"flash_attention": cfg.num_layers * on_card, "selective_scan": 0}
              and variants == variant_counts(fa, cfg.num_layers, "wgmma_bf16", on_card),
              f"hubert forward launched {launches}, variants {variants}")
        check(tuple(logits.shape) == (b, t, cfg.vocab_size) and bool(logits.isfinite().all()),
              "hubert logits have the wrong shape or non-finite entries")
        peak = torch.cuda.max_memory_allocated() if on_card else None
        prof = profile_lm(torch, lambda: model.forward(params, {"frames": frames}), device,
                          "attn_")
    rec = {"arch": cfg.name, "params": tree_numel(params), "param_count": cfg.param_count(),
           "layers": cfg.num_layers, "head_dim": cfg.head_dim, "causal": cfg.causal,
           "dtype": cfg.dtype, "forward": {
               "batch": b, "frames": t, "seconds": forward_s, "frames_per_s": b * t / forward_s,
               "launches": launches, "flash_variants": variants, "max_memory_allocated": peak},
           "profile": {"what": f"forward b={b} t={t}", **prof}, "device": ident}
    del model, params, logits, frames
    return rec


def vision_part(torch, np, counters, device, tiny: bool, ident: str) -> dict:
    """Phase 26(c): llama-3.2-vision-90b at full width cut to one block (4
    self-attention layers and 1 gated cross-attention layer), its gate set
    to a seeded non-zero value: ``make_prefill_step`` at B=1, T=8192 with
    seeded ``image_embeds`` [1, 1024, D] (5 ``wgmma_bf16`` launches, the
    cross one bidirectional over the image), then the serve loop at B=8
    (prompt 128, 32 generated) with the image caches filled from the
    images (``fill_images``): 5 ``decode_split`` launches a step, the cross
    one bidirectional over 1,024 image keys; the gate's effect on a step's
    logits; one decode step under ``torch.profiler``."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models import Model
    from repro_torch.serve.lm import make_prefill_step

    cfg = get_model_config(("reduced:" if tiny else "") + "llama-3.2-vision-90b")
    if not tiny:
        cfg = dataclasses.replace(cfg, n_blocks=1)
    on_card = device.type == "cuda"
    n_layers = cfg.num_layers
    model = Model(cfg, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = model.init(gen)
    cross = [p["attn"] for s, p in zip(cfg.layers(), params["layers"]) if s.mixer == "cross_attn"]
    for attn in cross:  # the reference's init closes the gate: tanh(0) = 0
        attn["gate"].uniform_(0.5, 1.0, generator=gen)
    gates = [float(attn["gate"]) for attn in cross]
    rng = np.random.default_rng(26)
    seq = 64 if tiny else 8192
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, (1, seq)), device=model.device)
    img = torch.randn((1, cfg.n_img_tokens, cfg.d_model), generator=gen,
                      device=model.device).to(model.dtype)
    prefill = make_prefill_step(model)
    with torch.no_grad():
        reset_counts(*counters)
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens, "image_embeds": img})
        sync(torch, device)
        prefill_s = time.perf_counter() - t0
        pre_launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
        pre_variants = dict(fa.variant_launches)
        check(pre_launches == {"flash_attention": n_layers * on_card, "selective_scan": 0}
              and pre_variants == variant_counts(fa, n_layers, "wgmma_bf16", on_card),
              f"llama prefill launched {pre_launches}, variants {pre_variants}")
        check(tuple(logits.shape) == (1, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
              "llama prefill logits have the wrong shape or non-finite entries")
        prefill_peak = torch.cuda.max_memory_allocated() if on_card else None
        del logits
        # the serve loop over image caches filled from B=8 images
        b, plen, n_gen = (2, 8, 4) if tiny else (8, 128, 32)
        prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, plen)),
                                  device=model.device)
        imgs = torch.randn((b, cfg.n_img_tokens, cfg.d_model), generator=gen,
                           device=model.device).to(model.dtype)
        cache = model.init_cache(b, plen + n_gen)
        fill_images(torch, model, params, cache, imgs)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts(*counters)
        t0 = time.perf_counter()
        logits, cache = prefill_into_cache(model, params, cache, prompts)
        tok = logits[:, -1].argmax(-1)[:, None]
        sync(torch, device)
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for i in range(n_gen - 1):
            logits, cache = model.decode_step(params, cache, tok, plen + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
        sync(torch, device)
        t_decode = time.perf_counter() - t0
        out = torch.cat(out, dim=1)
        steps = plen + n_gen - 1
        launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
        variants = dict(fa.variant_launches)
        check(launches == {"flash_attention": n_layers * steps * on_card, "selective_scan": 0}
              and variants == variant_counts(fa, n_layers * steps, "decode_split", on_card),
              f"llama serve launched {launches}, variants {variants}")
        check(tuple(out.shape) == (b, n_gen) and int(out.min()) >= 0
              and int(out.max()) < cfg.vocab_size, "llama serve ids of the wrong shape or range")
        serve_peak = torch.cuda.max_memory_allocated() if on_card else None
        # the cross path shows in the logits: the same step with the gates closed
        pos = plen + n_gen - 1
        step, _ = model.decode_step(params, clone_cache(cache), tok, pos)
        for attn in cross:
            attn["gate"].zero_()
        closed, _ = model.decode_step(params, clone_cache(cache), tok, pos)
        for attn, value in zip(cross, gates):
            attn["gate"].fill_(value)
        gate_effect = float((step.float() - closed.float()).norm() / step.float().norm())
        check(gate_effect > 1e-3, f"llama: the gated cross path moved a step's logits by only "
                                  f"{gate_effect} (relative L2)")
        prof = profile_lm(torch, lambda: model.decode_step(params, cache, tok, pos - 1), device,
                          "attn_")
    rec = {
        "arch": cfg.name, "params": tree_numel(params), "param_count": cfg.param_count(),
        "layers": n_layers, "cross_layers": len(gates), "gates": gates,
        "n_img_tokens": cfg.n_img_tokens, "dtype": cfg.dtype,
        "prefill": {"batch": 1, "seq": seq, "seconds": prefill_s, "tokens_per_s": seq / prefill_s,
                    "launches": pre_launches, "flash_variants": pre_variants,
                    "max_memory_allocated": prefill_peak},
        "serve": {"batch": b, "prompt_len": plen, "gen": n_gen, "prefill_s": t_prefill,
                  "decode_s": t_decode, "decode_tok_per_s": b * (n_gen - 1) / t_decode,
                  "launches": launches, "flash_variants": variants,
                  "split_launches": dict(fa.split_launches), "max_memory_allocated": serve_peak,
                  "first_ids": out[0, :8].tolist()},
        "gate_effect_rel_l2": gate_effect,
        "profile": {"what": f"decode_step b={b} pos={pos - 1}", **prof}, "device": ident,
    }
    del model, params, cache, imgs, img
    return rec


def families_phase(torch, np, fa, fa_ref, counters, device, tiny: bool, ident: str) -> dict:
    """Phase 26: gemma3-12b, hubert-xlarge and llama-3.2-vision-90b at full
    width on the card (the reduced configs with ``--tiny``), one model at a
    time: (a) gemma3-12b cut to one block (5 local layers, window 1024, and
    1 global; head dim 256) through ``lm_phase`` (prefill B=1 T=8192: 6
    ``wgmma_bf16`` launches; serve B=8 prompt 128 gen 32: 6 ``decode_split``
    a step), then ``ring_decode_part``; (b) ``encoder_part``; (c)
    ``vision_part``. Each part logs its seconds, tokens a second, peak
    memory, launches by variant and the card's idle share."""
    out = {"seconds": {}, "launches": {"flash_attention": 0, "selective_scan": 0},
           "flash_variants": dict.fromkeys(fa.VARIANTS, 0)}

    def count(rec, paths):
        for path in paths:
            for name, n in rec[path]["launches"].items():
                out["launches"][name] += n
            for name, n in rec[path]["flash_variants"].items():
                out["flash_variants"][name] += n

    def free():
        if device.type == "cuda":
            torch.cuda.empty_cache()  # one big model at a time

    t0 = time.perf_counter()
    rec, model, params = lm_phase(torch, np, counters, device, "gemma3-12b", tiny, ident,
                                  n_blocks=1)
    with torch.no_grad():
        rec["ring_decode"] = ring_decode_part(torch, np, fa, fa_ref, counters, device, model,
                                              params, tiny)
    del model, params
    free()
    count(rec, ("prefill", "serve", "ring_decode"))
    rec["seconds"] = out["seconds"]["a"] = time.perf_counter() - t0
    log(json.dumps({"phase": 26, "part": "a", **rec}))
    t0 = time.perf_counter()
    rec = encoder_part(torch, np, counters, device, tiny, ident)
    free()
    count(rec, ("forward",))
    rec["seconds"] = out["seconds"]["b"] = time.perf_counter() - t0
    log(json.dumps({"phase": 26, "part": "b", **rec}))
    t0 = time.perf_counter()
    rec = vision_part(torch, np, counters, device, tiny, ident)
    free()
    count(rec, ("prefill", "serve"))
    rec["seconds"] = out["seconds"]["c"] = time.perf_counter() - t0
    log(json.dumps({"phase": 26, "part": "c", **rec}))
    log(json.dumps({"phase": 26, "part_seconds": out["seconds"]}))
    return out


def latent_decode_part(torch, np, fa, fa_ref, counters, device, model, params,
                       tiny: bool) -> dict:
    """Phase 27's long decode: 8 ``decode_step``s at B=8 from the end of a
    seeded 8,192-long latent cache (one ``latent_wgmma`` launch an MLA layer
    a step, the cache split into shares), then the last step again held
    against the same step with every attention call on the plain version
    (phase 17's bf16 gate, as phase 26 holds gemma3's)."""
    from repro_torch.kernels.mamba_scan import ops as scan

    cfg = model.cfg
    on_card = device.type == "cuda"
    n_attn = cfg.num_layers
    variant = mla_decode_variant(fa, cfg, model.dtype)
    b, seq, steps = (2, 64, 4) if tiny else (8, 8192, 8)
    cache = model.init_cache(b, seq)
    fill_cache(torch, cache, torch.Generator(device=model.device).manual_seed(27))
    rng = np.random.default_rng(27)
    tok = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, 1)), device=model.device)
    sync(torch, device)
    reset_counts(*counters)
    step_s = []
    for i in range(steps):
        if i == steps - 1:  # the last step's cache and token, for the plain version
            spare, last = clone_cache(cache), tok
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok, seq - steps + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        sync(torch, device)
        step_s.append(time.perf_counter() - t0)
    launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    variants = dict(fa.variant_launches)
    splits = dict(fa.split_launches)
    check(launches == {"flash_attention": n_attn * steps * on_card, "selective_scan": 0}
          and variants == variant_counts(fa, n_attn * steps, variant, on_card),
          f"{cfg.name} latent decode launched {launches}, variants {variants}")
    n_split = next(iter(splits)) if len(splits) == 1 else None
    check(not on_card or (n_split is not None and n_split > 1),
          f"{cfg.name}: a {seq}-long latent cache at B={b} was not split into one count > 1: "
          f"{splits}")
    check(bool(logits.isfinite().all()), f"{cfg.name} latent decode logits are not finite")
    calls: list = []
    with swapped_attention(fa_ref, calls):
        got, _ = model.decode_step(params, clone_cache(spare), last, seq - 1)
    with swapped_attention(fa_ref):
        want, _ = model.decode_step(params, spare, last, seq - 1)
    check(len(calls) == n_attn, f"{cfg.name}: {len(calls)} attention calls checked, "
                                f"expected {n_attn}")
    row_err = worst_row_rel_l2(got, want)
    check(row_err <= FLASH_ROW_RTOL, f"{cfg.name} decode step at position {seq - 1}: logits "
                                     f"differ from the plain version's by {row_err} relative L2")
    gate = {"calls": calls, "logits_max_row_rel_l2": row_err,
            "logits_max_abs_diff": float((got.float() - want.float()).abs().max())}
    per_step = sum(step_s[1:]) / (steps - 1)  # the first step warms the caches up
    latent_bytes = n_attn * b * seq * (cfg.kv_lora_rank + cfg.qk_rope_dim) * \
        torch.finfo(model.dtype).bits // 8
    del cache, spare, logits, want, got
    return {"batch": b, "cache_len": seq, "first_pos": seq - steps, "steps": steps,
            "step_seconds": step_s, "seconds_per_step": per_step, "tokens_per_s": b / per_step,
            "latent_cache_bytes": latent_bytes,
            "attention_bound_ms_per_step": latent_bytes / HBM_BYTES_PER_S * 1e3,
            "launches": launches, "variant": variant, "flash_variants": variants,
            "split_launches": splits, "n_split": n_split,
            "blocks_per_sm": fa.latent_blocks_per_sm(
                device, model.dtype, cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.kv_lora_rank,
                variant) if on_card else None,
            "plain_step": gate}


def mla_phase(torch, np, fa, fa_ref, counters, device, tiny: bool, ident: str) -> dict:
    """Phase 27: deepseek-v2-236b at full width (the reduced config with
    ``--tiny``), bf16, seeded: its dense prefix layer and one MoE block of
    the 59 (5.36B parameters; all 60 layers are 236B, 472 GB in bf16, which
    no one card holds) through ``lm_phase`` (prefill B=1 T=8192: 2
    ``wgmma_bf16`` launches at (192, 128); serve B=8 prompt 128 gen 32: 2
    ``latent_wgmma`` launches a step at (576, 512); both profiled with the
    MoE ranges' share), then ``latent_decode_part``. Logs its seconds."""
    t0 = time.perf_counter()
    rec, model, params = lm_phase(torch, np, counters, device, MLA_ARCH, tiny, ident,
                                  n_blocks=1)
    with torch.no_grad():
        rec["latent_decode"] = latent_decode_part(torch, np, fa, fa_ref, counters, device, model,
                                                  params, tiny)
    del model, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec["reduced"] = {"n_blocks": {"published": 59, "run": 1},
                      "why": "236B parameters (472 GB in bf16) do not fit one 80 GB card; the "
                             "prefix layer and one block are 5.36B (10.7 GB)"} if not tiny else \
        {"config": f"reduced:{MLA_ARCH}"}
    out = {"launches": {"flash_attention": 0, "selective_scan": 0},
           "flash_variants": dict.fromkeys(fa.VARIANTS, 0), "record": rec}
    for path in ("prefill", "serve", "latent_decode"):
        for name, n in rec[path]["launches"].items():
            out["launches"][name] += n
        for name, n in rec[path]["flash_variants"].items():
            out["flash_variants"][name] += n
    rec["seconds"] = out["seconds"] = time.perf_counter() - t0
    log(json.dumps({"phase": 27, **rec}))
    return out


def sharded_phase(torch, np, spmv, spmv_ref, lg, sim_values: dict, device, timer, floor,
                  ident: str) -> tuple:
    """Phase 23: the analytics engine's sharded mode on phase 2's partition:
    one process a partition (k=8 gloo ranks, all on the one card; NCCL takes
    a rank a card and waits for a box with eight), pagerank, cc and sssp in
    one start, held against phase 10's simulated values; then the kernel at
    the largest rank's segment shape. Returns the kernel row and the ranks'
    launches."""
    from repro_torch.analytics import PROGRAMS, GraphEngine
    from repro_torch.analytics.engine import check_backend, rank_devices, run_sharded

    on_card = device.type == "cuda"
    k = lg.k
    if on_card:
        devices = rank_devices(k, "cuda", torch.cuda.device_count())
        if len(set(devices)) < k:
            try:
                check_backend("nccl", devices)
                check(False, "NCCL accepted ranks that share a card")
            except ValueError as err:
                check('backend="gloo"' in str(err), f"NCCL refusal names no way out: {err}")
    runs = [(PROGRAMS[prog](), None, iters) for prog, iters in ANALYTICS_ITERS.items()]
    values, report = run_sharded(lg, runs, device, backend="gloo")
    padded = GraphEngine(lg, runs[0][0], device=device).stats(1).padded_halo_elements_per_iter
    launches = 0
    for (prog, iters), got, run in zip(ANALYTICS_ITERS.items(), values, report["runs"]):
        want = sim_values[prog]
        if prog == "pagerank":
            check(np.allclose(got, want, rtol=1e-6, atol=0),
                  "sharded pagerank differs from the simulated run beyond rtol 1e-6")
        else:
            check(np.array_equal(got, want), f"sharded {prog} differs from the simulated run")
        expect = [iters if on_card else 0] * k
        check(run["spmv_launches"] == expect,
              f"sharded {prog}: ranks launched {run['spmv_launches']}, expected {expect}")
        check(run["all_to_all_calls"] == [iters] * k,
              f"sharded {prog}: all-to-all calls {run['all_to_all_calls']} != {iters} a rank")
        check(run["elements_sent_per_iter"] == padded,
              f"sharded {prog}: {run['elements_sent_per_iter']} elements an iteration != "
              f"padded_halo_elements_per_iter {padded}")
        launches += sum(run["spmv_launches"])
        log(json.dumps({
            "phase": 23, "program": prog, "iters": iters, "ranks": k,
            "backend": report["backend"], "route": report["route"],
            "identical_to_simulated": bool(np.array_equal(got, want)),
            "max_rel_diff_to_simulated": float(np.max(np.abs(got - want)
                                                      / np.maximum(np.abs(want), 1e-30))),
            "spmv_launches": run["spmv_launches"], "all_to_all_calls": run["all_to_all_calls"],
            "elements_sent_per_iter": run["elements_sent_per_iter"],
            "host_ms_per_iter": run["iter_ms"], "staged_bytes": run["staged_bytes"],
            "note": "host times of ranks sharing one card, not a multi-card speed",
        }))
    log(json.dumps({"phase": 23, "spawn_seconds": report["spawn_seconds"],
                    "rank_timeline": report["rank_timeline"], "devices": report["devices"],
                    "route": report["route"], "device": ident}))
    # the kernel at the largest rank's shape: one device's CSR rows (k=1)
    row_ptr = lg.row_ptr()
    p = int(np.argmax(row_ptr[:, -1]))
    nnz = int(row_ptr[p, -1])
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.random((1, lg.state_len)).astype(np.float32)).to(device)
    rp = torch.from_numpy(row_ptr[p : p + 1]).to(device)
    cols = torch.from_numpy(np.ascontiguousarray(lg.cols[p : p + 1])).to(device)
    rows64 = torch.from_numpy(lg.rows[p : p + 1].astype(np.int64)).to(device)
    cols64 = cols.long()
    x_read = int(np.unique(lg.cols[p, :nnz]).shape[0])
    args = (x, rp, cols, "sum")
    row = spmv_row(
        torch, timer, f"rank{p}_of_k{k}_sum", "segments", "sum",
        spmv.ell_spmv_segments(*args), spmv_ref.ell_spmv_segments_ref(*args),
        lambda: spmv.ell_spmv_segments(*args), lambda: spmv_ref.ell_spmv_segments_ref(*args),
        lambda: torch.zeros((1, lg.v_max + 1), device=device).scatter_reduce_(
            1, rows64, x.gather(1, cols64), "sum", include_self=True),
        nbytes=(lg.v_max + 1) * 8 + nnz * 4 + x_read * 4 + lg.v_max * 4, ops=nnz, reps=20,
        rows=lg.v_max, nnz=nnz)
    if floor is not None:
        import kernel_ablation_partition_score as ablation

        row["floor_ms"] = timer.device_ms(ablation.floor_call(
            torch, floor, (spmv.tiles(lg.v_max, lg.e_max), spmv.THREADS, 0, 1)))
    log(json.dumps({"phase": 23, **row}))
    return row, launches


def grad_row(torch, timer, name, fn, plain, inputs, grad_out, tol, library=None,
             bound=None) -> dict:
    """Phase 24(a): one kernel's autograd wrapper against plain autograd on
    the card: the output and every input's gradient within ``tol`` relative
    L2; the kernel forward, its backward (the plain version recomputed and
    differentiated), plain forward + backward and (attention)
    ``scaled_dot_product_attention`` forward + backward, each timed."""
    device = timer.device
    out = fn(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    check(all(o.grad_fn is not None for o in outs), f"grad {name}: an output has no grad_fn")
    got = torch.autograd.grad(outs, inputs, grad_out)
    want_out = plain(*inputs)
    want_outs = want_out if isinstance(want_out, tuple) else (want_out,)
    want = torch.autograd.grad(want_outs, inputs, grad_out)

    def rel(a, b):
        a, b = a.detach().double(), b.detach().double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    out_err = max(rel(a, b) for a, b in zip(outs, want_outs))
    grad_errs = [rel(a, b) for a, b in zip(got, want)]
    check(out_err <= tol and max(grad_errs) <= tol,
          f"grad {name}: output {out_err} / gradients {grad_errs} beyond {tol} relative L2")
    del out, outs, got, want_out, want_outs, want
    sync(torch, device)

    def forward():
        with torch.no_grad():
            return fn(*inputs)

    def backward():
        o = fn(*inputs)
        return torch.autograd.grad(o if isinstance(o, tuple) else (o,), inputs, grad_out)

    def plain_both():
        o = plain(*inputs)
        return torch.autograd.grad(o if isinstance(o, tuple) else (o,), inputs, grad_out)

    fwd_ms = timer.device_ms(forward, reps=20, replays=3)
    both_ms = timer(backward, reps=5, warmup=2)
    row = {
        "shape": name, "dtype": str(inputs[0].dtype).split(".")[1], "output_rel_l2": out_err,
        "grad_rel_l2": grad_errs, "tol": tol, "ms": fwd_ms,
        "backward_ms": both_ms - timer(forward, reps=5, warmup=1),
        "fwd_bwd_ms": both_ms, "plain_fwd_bwd_ms": timer(plain_both, reps=3, warmup=1),
        "library_fwd_bwd_ms": None,
    }
    if library is not None:
        def lib_both():
            o = library(*inputs)
            return torch.autograd.grad((o,), inputs, grad_out)
        row["library_fwd_bwd_ms"] = timer(lib_both, reps=5, warmup=2)
    if bound is not None:
        row.update(bound)
    return row


def attention_grad_row(torch, np, F, fa, fa_ref, timer, name, b, hq, hkv, t, dh, dtype):
    device = timer.device
    gen = torch.Generator(device=device).manual_seed(b * t + dh)
    q, k, v = (torch.randn(s, generator=gen, device=device).to(dtype).requires_grad_(True)
               for s in ((b, hq, t, dh), (b, hkv, t, dh), (b, hkv, t, dh)))
    grad_out = (torch.randn((b, hq, t, dh), generator=gen, device=device).to(dtype),)
    pairs = attention_pairs(np, t, t, True, None, 0) * b * hq
    flops = 4 * pairs * dh
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    nbytes = (2 * b * hq * t * dh + 2 * b * hkv * t * dh) * q.element_size()
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    # forward + backward: the forward's two products, the backward's five
    # (S and P recomputed, dV, dP, dQ, dK: 2.5x the forward's flops)
    train_ms = max(3.5 * flops / rate, 3 * nbytes / HBM_BYTES_PER_S) * 1e3
    before = dict(fa.variant_launches)
    variant = fa.kernel_variant(dtype, t, hq // hkv, dh, fa.is_aligned(q, k, v))
    row = grad_row(
        torch, timer, name,
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
        lambda q, k, v: fa_ref.flash_attention_ref(q, k, v, causal=True),
        (q, k, v), grad_out, GRAD_TOL[str(dtype).split(".")[1]],
        library=lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                               enable_gqa=True),
        bound={"bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "fwd_bwd_bound_ms": train_ms, "flops": flops})
    check(device.type != "cuda" or fa.variant_launches[variant] > before[variant],
          f"grad {name}: the {variant} variant did not run")
    row.update({"variant": variant, "b": b, "hq": hq, "hkv": hkv, "t": t, "dh": dh})
    log(json.dumps({"phase": 24, "part": "a", **row}))
    return row


def scan_grad_row(torch, scan, scan_ref, timer, name, bsz, t, d, n):
    device = timer.device
    gen = torch.Generator(device=device).manual_seed(t + d)

    def leaf(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).requires_grad_(True)

    dt_raw, a_log = leaf((bsz, t, d)), leaf((d, n), 0.5)
    x, b, c, d_skip = leaf((bsz, t, d)), leaf((bsz, t, n)), leaf((bsz, t, n)), leaf((d,))
    with torch.no_grad():
        dt = torch.nn.functional.softplus(dt_raw - 4.0)  # dt ~ 0.02, the model's range
        a = -torch.exp(a_log)
    inputs = (x, dt.requires_grad_(True), a.requires_grad_(True), b, c, d_skip)
    gen_out = torch.Generator(device=device).manual_seed(5)
    grad_out = (torch.randn((bsz, t, d), generator=gen_out, device=device),
                torch.randn((bsz, d, n), generator=gen_out, device=device))
    exps = bsz * t * d * n
    nbytes = 4 * (2 * bsz * t * d + d * n + 2 * bsz * t * n + d + bsz * t * d + bsz * d * n)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, exps / EXP_PER_S * 1e3
    row = grad_row(torch, timer, name, scan.selective_scan, scan_ref.selective_scan_ref,
                   inputs, grad_out, GRAD_TOL["float32"],
                   bound={"bound_ms": max(bytes_ms, ops_ms),
                          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    row.update({"b": bsz, "t": t, "d": d, "n": n})
    log(json.dumps({"phase": 24, "part": "a", **row}))
    return row


def training_phase(torch, np, F, counters, device, timer, tiny: bool, ident: str) -> dict:
    """Phase 24: LM training. (a) the attention and scan wrappers' gradients
    against plain autograd on the card; (b) ``repro_torch.launch.train``
    at ``repro-100m`` (bf16, the reference's defaults): a crash at step 15
    with checkpoints every 10, the resumed run to 30 and an uninterrupted
    run, their losses for steps 11-30 equal under deterministic algorithms,
    and the elastic demo; (c) one float32 step on the card against the CPU
    port; (d) step time, tokens a second, peak memory, the idle share of a
    profiled step and its attention launches by variant."""
    import tempfile

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.launch import elastic
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model
    from repro_torch.train.checkpoint import latest_step
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step

    on_card = device.type == "cuda"
    record = {"device": ident}
    # (a) gradients
    dt16 = torch.bfloat16
    if tiny:
        grad_rows = [attention_grad_row(torch, np, F, fa, fa_ref, timer, "attn_tiny_bf16",
                                        2, 4, 2, 64, 64, dt16),
                     scan_grad_row(torch, scan, scan_ref, timer, "scan_tiny", 1, 16, 64, 16)]
    else:
        grad_rows = [
            attention_grad_row(torch, np, F, fa, fa_ref, timer, "repro100m_b8_t256_bf16",
                               8, 10, 5, 256, 64, dt16),
            attention_grad_row(torch, np, F, fa, fa_ref, timer, "qwen3_8b_layer_t2048_bf16",
                               1, 32, 8, 2048, 128, dt16),
            scan_grad_row(torch, scan, scan_ref, timer, "falcon_layer_d8192_t256",
                          1, 256, 8192, 16),
        ]
    record["grad_rows"] = grad_rows
    if on_card:
        torch.cuda.empty_cache()
    # (b) the driver: crash, resume, and the uninterrupted run
    arch = "reduced:qwen3-8b" if tiny else "repro-100m"
    steps, base = 30, ["--arch", arch, "--steps", "30", "--log-every", "10",
                       "--device", str(device.type)]
    if tiny:
        base += ["--global-batch", "2", "--seq-len", "32"]
    cfg = train_mod.get_model_config(arch)
    n_attn = sum(s.mixer == "attn" for s in cfg.layers())
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="smoke_train_") as tmp:
            ck = os.path.join(tmp, "ckpt")
            for name, extra in (("crashed", ["--ckpt-dir", ck, "--ckpt-every", "10",
                                             "--fail-at", "15"]),
                                ("resumed", ["--ckpt-dir", ck, "--ckpt-every", "10"]),
                                ("whole", [])):
                history = []
                reset_counts(*counters)
                t0 = time.perf_counter()
                try:
                    train_mod.main(base + extra, history)
                    check(name != "crashed", "the run with --fail-at 15 did not crash")
                except RuntimeError as err:
                    check(name == "crashed" and "injected failure" in str(err),
                          f"train run {name} raised {err}")
                seconds = time.perf_counter() - t0
                expect = n_attn * len(history) if on_card else 0
                check(fa.launches == expect,
                      f"train {name}: {fa.launches} attention launches, expected {expect}")
                check(all(m.launches == 0 for m in counters if m is not fa),
                      f"train {name}: another kernel launched")
                if name == "crashed":
                    check(latest_step(ck) == 10,
                          f"the crash left latest_step {latest_step(ck)}, expected 10")
                runs[name] = {"history": history, "seconds": seconds, "launches": fa.launches,
                              "variants": dict(fa.variant_launches)}
            check(latest_step(ck) == steps, f"the resumed run ended at {latest_step(ck)}")
            elastic_dir = os.path.join(tmp, "elastic")
            t0 = time.perf_counter()
            # the demo resumes on 1x1 here: phase 29 resumes a mesh's
            # checkpoint on 1x2 and 1x1
            elastic_loss = elastic.main(["--ckpt-dir", elastic_dir, "--steps", "20",
                                         "--arch", arch, "--device", str(device.type),
                                         "--resume-mesh", "1x1"])
            elastic_s = time.perf_counter() - t0
            check(np.isfinite(elastic_loss) and latest_step(elastic_dir) == 20,
                  "the elastic demo did not finish at step 20 with a finite loss")
    finally:
        torch.use_deterministic_algorithms(False)
    crashed, resumed, whole = (runs[n]["history"] for n in ("crashed", "resumed", "whole"))
    check([h["step"] for h in resumed] == list(range(11, steps + 1)),
          "the resumed run did not take steps 11-30")
    same = [a["loss"] == b["loss"] for a, b in zip(resumed, whole[10:])]
    check(all(same), f"resumed losses differ from the uninterrupted run's at steps "
                     f"{[11 + i for i, s in enumerate(same) if not s]}")
    check([h["loss"] for h in crashed] == [h["loss"] for h in whole[:15]],
          "the crashed run's losses differ from the uninterrupted run's")
    last, first = resumed[-1]["loss"], whole[0]["loss"]
    check(np.isfinite(last) and last < first, f"final loss {last} not below step 1's {first}")
    record["driver"] = {
        "arch": arch, "steps": steps, "losses_equal_steps_11_30": True,
        "deterministic_algorithms": True, "first_loss": first, "final_loss": last,
        "losses": [h["loss"] for h in whole], "grad_norms": [h["grad_norm"] for h in whole],
        "seconds": {n: r["seconds"] for n, r in runs.items()},
        "launches": {n: r["launches"] for n, r in runs.items()},
        "elastic_seconds": elastic_s, "elastic_final_loss": elastic_loss,
    }
    log(json.dumps({"phase": 24, "part": "b", **record["driver"]}))
    # (c) one float32 step on the card against the CPU port
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = Model(cfg32, "cpu")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        batch_np = TokenPipeline(cfg.vocab_size, 32 if tiny else 256, 2, seed=1234)
        batch = next(batch_np)
        batch_np.close()
        outs = []
        for model, params in ((Model(cfg32, device), tree_to(p_cpu, device)), (cpu, p_cpu)):
            step = make_train_step(model, total_steps=steps, warmup=1)
            tb = {k: torch.from_numpy(v).to(model.device, torch.int64) for k, v in batch.items()}
            opt = adamw_init(params)
            opt.step += 1  # past warm-up: a step at the peak rate
            _, _, m = step(params, opt, tb)
            outs.append({k: float(v) for k, v in m.items()})
        del p_cpu, params
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    card, host = outs
    for key in ("loss", "grad_norm"):
        check(abs(card[key] - host[key]) <= 1e-3 * abs(host[key]),
              f"float32 step: {key} {card[key]} on the card, {host[key]} on the cpu")
    record["float32_step"] = {"card": card, "cpu": host, "global_batch": 2,
                              "rtol": 1e-3, "tf32": False}
    log(json.dumps({"phase": 24, "part": "c", **record["float32_step"]}))
    # (d) step time, throughput, memory, idle share, launches by variant
    model = Model(cfg, device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    opt = adamw_init(params, cfg.opt_state_dtype)
    step = make_train_step(model, total_steps=100, warmup=10)
    gb, seq = (2, 32) if tiny else (8, 256)
    pipe = TokenPipeline(cfg.vocab_size, seq, gb, seed=1234)
    batches = [{k: torch.from_numpy(v).to(model.device, torch.int64)
                for k, v in next(pipe).items()} for _ in range(6)]
    pipe.close()
    state = {"params": params, "opt": opt}

    def one(i):
        state["params"], state["opt"], m = step(state["params"], state["opt"], batches[i % 6])
        return m

    one(0)
    sync(torch, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    t0 = time.perf_counter()
    for i in range(5):
        one(i + 1)
    sync(torch, device)
    step_s = (time.perf_counter() - t0) / 5
    launches, variants = fa.launches / 5, {n: c / 5 for n, c in fa.variant_launches.items()}
    check(launches == (n_attn if on_card else 0),
          f"a train step launched {launches} attention kernels, expected {n_attn}")
    prof = profile_lm(torch, lambda: one(0), device, "attn_")
    # one checkpoint of this state, written in the foreground and read back
    from repro_torch.train.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory(prefix="smoke_ckpt_") as tmp:
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, 1, train_mod.checkpoint_tree(cfg, state["params"],
                                                                 state["opt"]))
        ckpt_save_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(os.path.join(path, "leaves.npz"))
        t0 = time.perf_counter()
        _, _, restored = train_mod.restore(tmp, cfg, state["params"], state["opt"], device)
        sync(torch, device)
        ckpt_restore_s = time.perf_counter() - t0
        check(restored == 1, "the checkpoint did not restore its step")
    record["step"] = {
        "arch": arch, "global_batch": gb, "seq_len": seq, "dtype": cfg.dtype,
        "step_ms": step_s * 1e3, "tokens_per_s": gb * seq / step_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated() if on_card else None,
        "attention_launches_per_step": launches, "attention_variants_per_step": variants,
        "params": tree_numel(params), "profile": prof, "checkpoint_bytes": ckpt_bytes,
        "checkpoint_save_s": ckpt_save_s, "checkpoint_restore_s": ckpt_restore_s,
    }
    log(json.dumps({"phase": 24, "part": "d", **record["step"]}))
    del state, params, opt, model, batches
    if on_card:
        torch.cuda.empty_cache()
    return record


# phase 29 (meshes): sharded training at repro-100m's full width on
# two gloo ranks sharing the card, against phase 24's 1x1 run of the same
# seed; the mesh serve loop; two dry-run cells at full width
MESH_TRAIN = ("2x1", "1x2")
MESH_STEPS = 5  # each mesh's steps, then the checkpoint of step 5
MESH_RESUME_TO = 6  # the resumed runs take step 6
# bf16 losses of a mesh against phase 24's 1x1 run: halving the batch changes
# cuBLAS's kernels for the products, and the gradients' shards are summed in
# bf16 by the reduce-scatter, so bits differ; 1e-2 relative (the prediction in
# PERF.md: within 5e-3)
MESH_LOSS_RTOL = 1e-2
# (name, arch, --opt, check): the model axis adds the row-parallel
# products' partials in another order than one card's product, so bits may
# differ. "tokens": the 1x1 loop's tokens (qwen3 in bf16, jamba in float32).
# "forced": reduced jamba in bf16, where a one-ulp gap can flip an expert
# choice (and move a row's logits by a tenth): the one-card run scores the
# mesh's tokens (teacher forcing, launch.serve.forced_logits) with the
# mesh's expert choices (routing()), every step's logits within
# SERVE_LOGITS_RTOL relative L2 of the mesh's, and the mesh's token the
# one-card run's choice wherever that is clear (ahead of the second logit
# by SERVE_MARGIN of its size: 4 bf16 ulps)
MESH_SERVE = (("qwen3", "reduced:qwen3-8b", None, "tokens"),
              ("jamba_f32", "reduced:jamba-v0.1-52b", "moe_weight_shard=f,dtype=float32",
               "tokens"),
              ("jamba_bf16", "reduced:jamba-v0.1-52b", "moe_weight_shard=f", "forced"))
SERVE_LOGITS_RTOL = 2e-2  # tests/test_torch_gpu.py's bf16 relative L2
SERVE_MARGIN = 2.0 ** -5
MESH_PROMPT, MESH_GEN = 8, 8
MESH_SERVE_ARGS = ["--batch", "4", "--prompt-len", str(MESH_PROMPT), "--gen", str(MESH_GEN)]
DRYRUN_CELLS = (("qwen3-8b", "train_4k", False, None), ("deepseek-v2-236b", "decode_32k", True,
                                                        None))
DRYRUN_CELLS_TINY = (("reduced:qwen3-8b", "train_4k", False, (2, 2)),
                     ("reduced:deepseek-v2-236b", "decode_32k", True, (2, 2, 2)))
# (d): activation_partitioning="seq" on the model axis of 1x2 (each
# rank its stripe of the positions); repro-100m against phase 24's losses as
# (a), then reduced jamba in float32 through the scan on the gathered
# sequence and moe_ffn_fshard in the train step, against its 1x1 run on the
# card (float32 on the card: 1e-4, tests/test_torch_gpu.py's)
SEQ = {"activation_partitioning": "seq"}
SEQ_STEPS = 5
SEQ_JAMBA_ARGS = ["--arch", "reduced:jamba-v0.1-52b", "--steps", "3", "--global-batch", "4",
                  "--seq-len", "64", "--log-every", "100", "--dtype", "float32"]
SEQ_JAMBA_OVER = {"moe_weight_shard": "f"}
SEQ_JAMBA_RTOL = 1e-4
# the dry run's cells beside the batch cell of DRYRUN_CELLS' first: the same
# cell on a model axis of 1 (16x1; 2x1 with --tiny), whose dot FLOPs a shard
# the batch cell's may be at most TP_MAX_SHARE of (16 model ranks split the
# products: 1/16 expected; 2 with --tiny: 1/2), and the seq cell, within
# SEQ_BATCH_RTOL of the batch cell (the model axis splits the products in
# both modes)
DRYRUN_TP1_CELL = ("qwen3-8b", "train_4k", False, (16, 1))
DRYRUN_TP1_CELL_TINY = ("reduced:qwen3-8b", "train_4k", False, (2, 1))
TP_MAX_SHARE, TP_MAX_SHARE_TINY = 0.1, 0.55
DRYRUN_SEQ_CELL = ("qwen3-8b", "train_4k", False, None)
DRYRUN_SEQ_CELL_TINY = ("reduced:qwen3-8b", "train_4k", False, (2, 2))
SEQ_BATCH_RTOL = 0.1


def mesh_train_args(tiny: bool, device) -> list:
    """Phase 24's train-launcher arguments (its whole run: 30 steps, the schedule
    those steps give), the steps cut by ``--fail-at``."""
    base = ["--arch", "reduced:qwen3-8b" if tiny else "repro-100m", "--steps", "30",
            "--log-every", "10", "--device", str(device.type)]
    return base + (["--global-batch", "2", "--seq-len", "32"] if tiny else [])


def counted_train(train_mod, fa, scan, argv: list, overrides=None) -> dict:
    """One launcher run in a rank, stopped by ``--fail-at``: its history,
    the kernels' launches (counts zeroed first) and its collectives' bytes
    a step (``op_analysis.OpCounter``; the checkpoint's gathers apart)."""
    from repro_torch.launch.op_analysis import OpCounter

    fa.reset()
    scan.reset()
    history, counter = [], OpCounter(sources=True)
    with counter:
        try:
            train_mod.main(argv, history, overrides)
        except RuntimeError as err:
            check("injected failure" in str(err), f"{argv} raised {err}")
    steps = [r for r in counter.records if " save" not in (r[3] or "")]
    per_step: dict = {}
    for kind, nbytes, _, _, times in steps:
        per_step[kind] = per_step.get(kind, 0) + nbytes * times / max(len(history), 1)
    return {"history": history, "launches": fa.launches, "variants": dict(fa.variant_launches),
            "scan_launches": scan.launches, "collective_bytes_per_step": per_step,
            "checkpoint_gather_bytes": sum(r[1] * r[4] for r in counter.records
                                           if " save" in (r[3] or ""))}


def mesh_rank(rank: int, world: int, store: str, work: str, tiny: bool) -> None:
    """Phase 29's spawned rank (two share the card over gloo): the train launcher at
    2x1 and 1x2 to step 5 (each run's collectives counted), the 2x1
    checkpoint resumed at 1x2 for a step, the serve loop at 1x2, and (d)
    the sequence-parallel runs at 1x2. Writes ``rank<r>.json``."""
    import shutil

    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.ranks import join

    import torch.distributed as dist

    device = torch.device("cpu" if tiny else "cuda")
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))  # AdamW runs on the host
    join(rank, world, str(device.type), store)
    out = {"rank": rank, "train": {}, "serve": {}}
    try:
        base = mesh_train_args(tiny, device)
        for mesh in MESH_TRAIN:
            out["train"][mesh] = counted_train(
                train_mod, fa, scan, base + ["--mesh", mesh, "--fail-at", str(MESH_STEPS),
                                             "--ckpt-dir", os.path.join(work, f"ck_{mesh}"),
                                             "--ckpt-every", str(MESH_STEPS)])
        # (d) the model axis splits the positions: phase 24's run to step 5,
        # then reduced jamba (scan, moe_ffn_fshard) for its 3 steps
        out["seq"] = counted_train(train_mod, fa, scan,
                                   base + ["--mesh", "1x2", "--fail-at", str(SEQ_STEPS)], SEQ)
        out["seq_jamba"] = counted_train(
            train_mod, fa, scan, SEQ_JAMBA_ARGS + ["--mesh", "1x2", "--device", device.type],
            {**SEQ_JAMBA_OVER, **SEQ})
        if rank == 0:
            shutil.copytree(os.path.join(work, "ck_2x1"), os.path.join(work, "ck_resume_1x2"))
        dist.barrier()
        fa.reset()
        history = []
        try:
            train_mod.main(base + ["--mesh", "1x2", "--fail-at", str(MESH_RESUME_TO),
                                   "--ckpt-dir", os.path.join(work, "ck_resume_1x2"),
                                   "--ckpt-every", str(MESH_STEPS)], history)
        except RuntimeError as err:
            check("injected failure" in str(err), f"resume at 1x2 raised {err}")
        out["resume_1x2"] = {"history": history, "launches": fa.launches,
                             "variants": dict(fa.variant_launches)}
        for name, arch, opt, how in MESH_SERVE:
            fa.reset()
            argv = ["--arch", arch, *MESH_SERVE_ARGS, "--mesh", "1x2", "--device",
                    str(device.type), *(["--opt", opt] if opt else [])]
            model, params, prompts = serve_mod.setup(serve_mod._parser().parse_args(argv))
            gen, timing = serve_mod.serve(model, params, prompts, MESH_GEN)
            out["serve"][name] = {"gen": gen.cpu().tolist(), "timings": timing,
                                  "launches": fa.launches,
                                  "variants": dict(fa.variant_launches)}
            if how == "forced":  # the mesh's own tokens scored, for the check
                record = out["serve"][name]["routing"] = []
                with routing(record):
                    out["serve"][name]["logits"] = serve_mod.forced_logits(
                        model, params, prompts, gen).tolist()
            del model, params
    finally:
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def mesh_parent_part(counters, device, tiny: bool, t0: float) -> tuple:
    """Phase 29's work in the parent while the ranks run: (c) the dry-run
    cells, then (d)'s jamba baseline (its 1x1 run on the card) and (b)'s
    (the 1x1 serve loops). Returns ``(cells, cells_s, jamba_11 history,
    jamba_11 launches, {arch: 1x1 tokens})``."""
    from repro_torch.configs import SHAPES
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    cells = []
    for arch, shape, multi, mesh_shape in (DRYRUN_CELLS_TINY if tiny else DRYRUN_CELLS):
        res = dryrun.run_cell(arch, shape, multi, peak=False, mesh_shape=mesh_shape)
        check(res["status"] == "ok", f"dry run {arch} {shape}: {res.get('error')}")
        model_cfg = dryrun._config(arch, None)[0]
        want_flops = dryrun.analytic_model_flops(model_cfg, SHAPES[shape],
                                                 SHAPES[shape]["kind"])["model_flops"]
        check(res["model_flops"] == want_flops,
              f"dry run {arch} {shape}: model_flops {res['model_flops']} != {want_flops}")
        cells.append({key: res.get(key) for key in (
            "arch", "shape", "mesh", "status", "chips", "accum", "wall_s", "lower_s",
            "trace_s", "dot_flops_per_shard", "total_collective_bytes_per_shard",
            "collective_bytes_per_shard", "collective_counts", "model_flops", "memory")})
        log(json.dumps({"phase": 29, "part": "c", **cells[-1]}))
    keys = ("arch", "shape", "mesh", "status", "chips", "accum", "wall_s", "trace_s",
            "dot_flops_per_shard", "total_collective_bytes_per_shard",
            "collective_bytes_per_shard", "collective_counts", "model_flops")
    arch, shape, multi, mesh_shape = DRYRUN_TP1_CELL_TINY if tiny else DRYRUN_TP1_CELL
    batch_cell = next(c for c in cells if (c["arch"], c["shape"]) == (arch, shape))
    res = dryrun.run_cell(arch, shape, multi, peak=False, mesh_shape=mesh_shape)
    check(res["status"] == "ok", f"dry run {arch} {shape} {res['mesh']}: {res.get('error')}")
    max_share = TP_MAX_SHARE_TINY if tiny else TP_MAX_SHARE
    share = batch_cell["dot_flops_per_shard"] / res["dot_flops_per_shard"]
    check(share <= max_share,
          f"dry run {arch} {shape}: the {batch_cell['mesh']} cell's dot FLOPs a shard are "
          f"{share:.4g} of the {res['mesh']} cell's (> {max_share})")
    cells.append({**{key: res.get(key) for key in keys}, "batch_share_of_this": share})
    log(json.dumps({"phase": 29, "part": "c", **cells[-1]}))
    arch, shape, multi, mesh_shape = DRYRUN_SEQ_CELL_TINY if tiny else DRYRUN_SEQ_CELL
    res = dryrun.run_cell(arch, shape, multi, SEQ, peak=False, mesh_shape=mesh_shape)
    check(res["status"] == "ok", f"dry run {arch} {shape} seq: {res.get('error')}")
    seq_share = res["dot_flops_per_shard"] / batch_cell["dot_flops_per_shard"]
    check(abs(seq_share - 1) <= SEQ_BATCH_RTOL,
          f"dry run {arch} {shape} seq: dot FLOPs a shard {seq_share:.4g} of the batch cell's "
          f"(beyond {SEQ_BATCH_RTOL} relative)")
    cells.append({**{key: res.get(key) for key in keys}, "overrides": SEQ,
                  "dot_flops_share_of_batch": seq_share})
    log(json.dumps({"phase": 29, "part": "c", **cells[-1]}))
    cells_s = time.perf_counter() - t0
    # (d)'s jamba baseline: the 1x1 run on the card, beside the ranks
    reset_counts(*counters)
    jamba_11 = []
    train_mod.main(SEQ_JAMBA_ARGS + ["--device", device.type], jamba_11, SEQ_JAMBA_OVER)
    jamba_11_launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    # the 1x1 serve loops (b)'s tokens are held against
    serve_11 = {}
    for name, arch, opt, how in MESH_SERVE:
        if how == "tokens":
            argv = ["--arch", arch, *MESH_SERVE_ARGS, "--mesh", "1x1", "--device",
                    str(device.type), *(["--opt", opt] if opt else [])]
            gen, _ = serve_mod.run(serve_mod._parser().parse_args(argv))
            serve_11[name] = gen.cpu().tolist()
    return cells, cells_s, jamba_11, jamba_11_launches, serve_11


def routing(record: list, replay: bool = False):
    """A context in which the MoE's expert choices (``layers.top_k``, one
    entry a routing call) are kept in ``record``, or with ``replay`` taken
    from it, each token's weights its own probabilities at those experts."""
    import contextlib

    import torch

    from repro_torch.models import layers

    @contextlib.contextmanager
    def ctx():
        saved, calls = layers.top_k, iter(list(record))

        def top_k(probs, k):
            if replay:
                idx = torch.tensor(next(calls), device=probs.device)
                return probs.gather(-1, idx), idx
            vals, idx = saved(probs, k)
            record.append(idx.tolist())
            return vals, idx

        layers.top_k = top_k
        try:
            yield
        finally:
            layers.top_k = saved
        check(not replay or next(calls, None) is None, "replayed routing: calls left over")

    return ctx()


def serve_forced_check(torch, arch: str, opt, got: dict, device) -> dict:
    """Phase 29(b)'s bf16 check: the one-card loop (here) scores the mesh's
    tokens ``got["gen"]`` (teacher forcing) with the mesh's expert choices
    ``got["routing"]``; every step's logits within ``SERVE_LOGITS_RTOL``
    relative L2 of the mesh's ``got["logits"]``, and the mesh's token the
    one-card run's choice at every step where that is clear
    (``SERVE_MARGIN``). Returns what the record keeps."""
    from repro_torch.launch import serve as serve_mod

    argv = ["--arch", arch, *MESH_SERVE_ARGS, "--mesh", "1x1", "--device", str(device.type),
            *(["--opt", opt] if opt else [])]
    tokens = torch.tensor(got["gen"])
    with routing(got["routing"], replay=True):
        want = serve_mod.forced_logits(*serve_mod.setup(serve_mod._parser().parse_args(argv)),
                                       tokens).double()
    mesh = torch.tensor(got["logits"]).double()
    check(mesh.shape == want.shape, f"serve {arch} ({opt}): logits {tuple(mesh.shape)} against "
                                    f"{tuple(want.shape)}")
    rel = max(float((m - w).norm() / w.norm()) for m, w in zip(mesh, want))
    check(rel <= SERVE_LOGITS_RTOL, f"serve {arch} ({opt}) at 1x2: a step's logits {rel:.3g} "
                                    f"relative L2 off the 1x1 run's")
    top2 = want.topk(2, -1).values
    clear = top2[..., 0] - top2[..., 1] > SERVE_MARGIN * top2[..., 0].abs().clamp(min=1)
    agree = want.argmax(-1) == tokens.t()
    check(bool(clear.any()) and bool(agree[clear].all()),
          f"serve {arch} ({opt}) at 1x2: {int((~agree & clear).sum())} clear steps where the "
          f"mesh's token is not the 1x1 run's choice")
    return {"worst_step_logits_rel_l2": rel, "routing_calls": len(got["routing"]),
            "clear_steps": int(clear.sum()),
            "steps": clear.numel(), "tokens_equal_1x1_choice": int(agree.sum())}


def mesh_phase(torch, np, counters, device, tiny: bool, ident: str, train_rec: dict) -> dict:
    """Phase 29: the mesh path. (a) ``launch.train`` at repro-100m (bf16,
    B=8, T=256) on meshes 2x1 and 1x2, two gloo ranks sharing the card:
    steps 1-5 against phase 24's 1x1 losses, ``wgmma_bf16`` 10 launches a
    step in each rank, each rank's step ms and bytes gathered and reduced a
    step; the 2x1 checkpoint of step 5 resumed at 1x1 (here) and at 1x2
    for a step. (b) ``launch.serve --mesh 1x2`` of reduced qwen3-8b and of
    reduced jamba with ``moe_weight_shard="f"`` (``moe_ffn_fshard``; in
    float32 and in bf16): the 1x1 loop's tokens, in bf16 jamba's the
    teacher-forced check (``serve_forced_check``); ``decode_split`` in each
    rank. (c) beside (a) and
    (b): two dry-run cells at full width on the fake group, qwen3-8b
    ``train_4k`` on 16x16 and deepseek-v2-236b ``decode_32k`` on 2x16x16,
    ``status: ok`` and the analytic MODEL_FLOPS the port's own; the
    qwen3-8b cell on a model axis of 1 (16x1), of whose dot FLOPs a shard
    the 16x16 cell's are at most a tenth; and the qwen3-8b cell with
    ``activation_partitioning="seq"``, within 10 % of the batch cell's. (d)
    ``activation_partitioning="seq"`` at 1x2 in the same ranks: repro-100m
    to step 5 against phase 24's losses, 10 ``wgmma_bf16`` a step in each
    rank on its 5 heads over all 256 positions, each rank's bytes a step;
    reduced jamba in float32 (the scan on the gathered sequence, a rank's
    channels; ``moe_ffn_fshard`` in the train step) for 3 steps against its
    1x1 run on the card here, the scan's launches counted. The model axis
    splits every product in (a), (b) and (d)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train as train_mod

    base = mesh_train_args(tiny, device)
    cfg = train_mod.get_model_config(base[1])
    n_attn = sum(s.mixer == "attn" for s in cfg.layers())
    want = train_rec["driver"]["losses"]  # phase 24's 1x1 run, steps 1-30
    on_card = device.type == "cuda"
    variant = "wgmma_bf16" if on_card else None
    record = {"device": ident}
    with tempfile.TemporaryDirectory(prefix="smoke_mesh_") as work:
        t0 = time.perf_counter()
        ctx = mp.start_processes(mesh_rank, args=(2, (Path(work) / "store").as_uri(), work, tiny),
                                 nprocs=2, join=False, start_method="spawn")
        try:
            cells, cells_s, jamba_11, jamba_11_launches, serve_11 = mesh_parent_part(
                counters, device, tiny, t0)
            while not ctx.join():
                pass
        except BaseException:  # a failed check here: stop the ranks too
            for proc in ctx.processes:
                proc.kill()
            raise
        ranks_s = time.perf_counter() - t0
        ranks = [json.loads((Path(work) / f"rank{r}.json").read_text()) for r in range(2)]
        # the 2x1 checkpoint resumed here, at 1x1
        history = []
        reset_counts(*counters)
        shutil.copytree(os.path.join(work, "ck_2x1"), os.path.join(work, "ck_resume_1x1"))
        try:
            train_mod.main(base + ["--mesh", "1x1", "--fail-at", str(MESH_RESUME_TO),
                                   "--ckpt-dir", os.path.join(work, "ck_resume_1x1"),
                                   "--ckpt-every", str(MESH_STEPS)], history)
        except RuntimeError as err:
            check("injected failure" in str(err), f"resume at 1x1 raised {err}")
        resume_11 = {"history": history, "launches": fa.launches}

    def close(got: list, steps: range, what: str) -> float:
        worst = 0.0
        for h, step in zip(got, steps):
            ref = want[step - 1]
            rel = abs(h["loss"] - ref) / abs(ref)
            worst = max(worst, rel)
            check(h["step"] == step, f"{what}: step {h['step']} where {step} was due")
            check(np.isfinite(h["loss"]) and rel <= MESH_LOSS_RTOL,
                  f"{what}: step {step} loss {h['loss']} against phase 24's {ref} "
                  f"({rel:.3g} relative > {MESH_LOSS_RTOL})")
        check(len(got) == len(steps), f"{what}: {len(got)} steps, expected {len(steps)}")
        return worst

    mesh_launches = 0
    train = {}
    for mesh in MESH_TRAIN:
        runs = [r["train"][mesh] for r in ranks]
        worst = close(runs[0]["history"], range(1, MESH_STEPS + 1), f"mesh {mesh}")
        for r, run in enumerate(runs):
            if on_card:
                check(run["variants"][variant] == n_attn * MESH_STEPS,
                      f"mesh {mesh} rank {r}: {run['variants'][variant]} {variant} launches, "
                      f"expected {n_attn} a step")
            mesh_launches += run["launches"]
        train[mesh] = {
            "losses": [h["loss"] for h in runs[0]["history"]], "worst_rel_loss": worst,
            "launches_per_rank": [run["launches"] for run in runs],
            "step_ms_per_rank": [[1e3 * h["step_s"] for h in run["history"]] for run in runs],
            "collective_bytes_per_step_per_rank": [run["collective_bytes_per_step"]
                                                   for run in runs],
            "checkpoint_gather_bytes": [run["checkpoint_gather_bytes"] for run in runs]}
        log(json.dumps({"phase": 29, "part": "a", "mesh": mesh, **train[mesh]}))
    resume = {"1x2": close(ranks[0]["resume_1x2"]["history"],
                           range(MESH_STEPS + 1, MESH_RESUME_TO + 1), "resume 2x1 -> 1x2"),
              "1x1": close(resume_11["history"], range(MESH_STEPS + 1, MESH_RESUME_TO + 1),
                           "resume 2x1 -> 1x1")}
    for r in ranks:
        mesh_launches += r["resume_1x2"]["launches"]
    log(json.dumps({"phase": 29, "part": "a", "resume_from": f"2x1 step {MESH_STEPS}",
                    "worst_rel_loss": resume,
                    "losses_1x2": [h["loss"] for h in ranks[0]["resume_1x2"]["history"]],
                    "losses_1x1": [h["loss"] for h in resume_11["history"]]}))
    # (d) sequence-parallel
    jcfg = train_mod.get_model_config(SEQ_JAMBA_ARGS[1])
    n_mamba = sum(s.mixer == "mamba" for s in jcfg.layers())
    seq_runs = [r["seq"] for r in ranks]
    seq = {"losses": [h["loss"] for h in seq_runs[0]["history"]],
           "worst_rel_loss": close(seq_runs[0]["history"], range(1, SEQ_STEPS + 1), "seq 1x2"),
           "launches_per_rank": [run["launches"] for run in seq_runs],
           "variants_per_rank": [run["variants"] for run in seq_runs],
           "step_ms_per_rank": [[1e3 * h["step_s"] for h in run["history"]] for run in seq_runs],
           "collective_bytes_per_step_per_rank": [run["collective_bytes_per_step"]
                                                  for run in seq_runs]}
    for r, run in enumerate(seq_runs):
        if on_card:
            check(run["variants"][variant] == n_attn * SEQ_STEPS,
                  f"seq 1x2 rank {r}: {run['variants'][variant]} {variant} launches, expected "
                  f"{n_attn} a step")
        mesh_launches += run["launches"]
    log(json.dumps({"phase": 29, "part": "d", "mesh": "1x2", **SEQ, **seq}))
    jamba_runs = [r["seq_jamba"] for r in ranks]
    steps = int(SEQ_JAMBA_ARGS[SEQ_JAMBA_ARGS.index("--steps") + 1])
    check(len(jamba_11) == steps and all(len(run["history"]) == steps for run in jamba_runs),
          "seq jamba: a run took fewer steps than asked")
    worst = 0.0
    for key in ("loss", "grad_norm"):
        for got, ref in zip(jamba_runs[0]["history"], jamba_11):
            rel = abs(got[key] - ref[key]) / abs(ref[key])
            worst = max(worst, rel)
            check(np.isfinite(got[key]) and rel <= SEQ_JAMBA_RTOL,
                  f"seq jamba 1x2: step {got['step']} {key} {got[key]} against the 1x1 run's "
                  f"{ref[key]} ({rel:.3g} relative > {SEQ_JAMBA_RTOL})")
    scan_launches = 0
    for r, run in enumerate(jamba_runs):
        if on_card:
            check(run["scan_launches"] == n_mamba * steps,
                  f"seq jamba rank {r}: {run['scan_launches']} scan launches, expected "
                  f"{n_mamba} a step")
        mesh_launches += run["launches"]
        scan_launches += run["scan_launches"]
    seq_jamba = {"losses": [h["loss"] for h in jamba_runs[0]["history"]],
                 "losses_1x1": [h["loss"] for h in jamba_11], "worst_rel": worst,
                 "launches_per_rank": [run["launches"] for run in jamba_runs],
                 "variants_per_rank": [run["variants"] for run in jamba_runs],
                 "scan_launches_per_rank": [run["scan_launches"] for run in jamba_runs],
                 "launches_1x1": jamba_11_launches,
                 "collective_bytes_per_step_per_rank": [run["collective_bytes_per_step"]
                                                        for run in jamba_runs]}
    log(json.dumps({"phase": 29, "part": "d", "arch": SEQ_JAMBA_ARGS[1], **SEQ_JAMBA_OVER,
                    **SEQ, **seq_jamba}))
    serve = {}
    for name, arch, opt, how in MESH_SERVE:
        scfg = train_mod.get_model_config(arch)
        expect = sum(s.mixer == "attn" for s in scfg.layers()) * (MESH_PROMPT + MESH_GEN - 1)
        forced = serve_forced_check(torch, arch, opt, ranks[0]["serve"][name], device) \
            if how == "forced" else {}
        for r, rank in enumerate(ranks):
            got = rank["serve"][name]
            check(got["gen"] == (serve_11[name] if how == "tokens" else ranks[0]["serve"][name][
                "gen"]), f"serve {name} ({opt}) at 1x2, rank {r}: tokens differ from "
                         f"{'the 1x1 loop' if how == 'tokens' else 'rank 0'}'s")
            if on_card:
                check(got["variants"]["decode_split"] == expect,
                      f"serve {name} rank {r}: {got['variants']['decode_split']} decode_split "
                      f"launches, expected {expect}")
            mesh_launches += got["launches"]
        serve[name] = {"arch": arch, "opt": opt, "check": how, **forced,
                       "decode_split_per_rank": [rk["serve"][name]["variants"]["decode_split"]
                                                 for rk in ranks],
                       "decode_tok_per_s_rank0": ranks[0]["serve"][name]["timings"][
                           "decode_tok_per_s"]}
        if how == "tokens":
            serve[name]["tokens_equal_1x1"] = True
        log(json.dumps({"phase": 29, "part": "b", "name": name, **serve[name]}))
    record.update(train=train, resume=resume, serve=serve, cells=cells, seq=seq,
                  seq_jamba=seq_jamba, cells_seconds=cells_s, ranks_seconds=ranks_s,
                  launches=mesh_launches, scan_launches=scan_launches)
    log(json.dumps({"phase": 29, "launches": mesh_launches, "cells_seconds": cells_s,
                    "ranks_seconds": ranks_s, "device": ident}))
    return record


# phase 28(b): each example of examples/torch (name, extra arguments) and the
# launch counts its run on the card must show (> 0)
EXAMPLE_RUNS = (
    ("quickstart", (), ("partition_score", "ell_spmv")),
    ("analytics_pagerank", (), ("ell_spmv",)),
    ("moe_placement", (), ()),
    ("serve_lm", (), ("decode_split",)),
    # the launcher prefills through decode steps, as the reference's does, so
    # jamba's Mamba layers take their recurrent step and the scan no launch
    ("serve_lm", ("--arch", "reduced:jamba-v0.1-52b"), ("decode_split",)),
    ("train_lm", ("--steps", "20"), ("wgmma_bf16",)),
)
SMOKE_SCRIPTS = ("churn", "serving", "outofcore", "threaded")
# the smoke scripts' sizes in phase 28(b): churn and serving at their
# defaults; out-of-core and threaded cut (standalone at their defaults they
# took 123 s and 27 s on an H100 machine's 8 host cores; the gates applied
# here do not depend on size); --tiny at
# tests/test_torch_surface.py's small sizes
SMOKE_ARGS = {"churn": [], "serving": [], "outofcore": ["--n", "8000"],
              "threaded": ["--n", "10000"]}
SMOKE_TINY_ARGS = {"churn": ["--n", "3000"], "serving": ["--n", "2000", "--queries", "200"],
                   "outofcore": ["--n", "4000"], "threaded": ["--n", "3000"]}


def wrapper_launches(ops, spmv, fa, scan) -> dict:
    """Every wrapper's launch count, the attention kernel's by variant too."""
    return {"partition_score": ops.launches + ops.sharded_launches + ops.rows_launches
            + ops.sharded_rows_launches, "ell_spmv": spmv.launches,
            "flash_attention": fa.launches, "selective_scan": scan.launches,
            **fa.variant_launches}


def example_child(path: str, args: list) -> int:
    """Phase 28(b)'s child: runs ``path`` (a file of ``examples/torch``) as
    ``__main__`` with ``args``, then prints on its last line the wrappers'
    launch counts and every ``jax`` or ``repro`` module it loaded (none)."""
    import runpy

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ell_spmv import ops as spmv
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.partition_score import ops

    sys.argv = [path, *args]
    t0 = time.perf_counter()
    runpy.run_path(str(ROOT / path), run_name="__main__")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps({"example": path, "args": args, "seconds": time.perf_counter() - t0,
                      "launches": wrapper_launches(ops, spmv, fa, scan), "forbidden": bad}),
          flush=True)
    return 1 if bad else 0


def surface_phase(torch, np, tapi, graph, main_res, web, device, ident: str) -> dict:
    """Phase 28(a): the metric functions on phase 2's partition, card == CPU
    == ``quality_report``; ``cuttana(return_detail=True)`` and
    ``refine_with_swaps`` on web-s, card == CPU."""
    from repro_torch.core import cuttana
    from repro_torch.core.refinement import Refiner, build_subpartition_graph, refine_with_swaps
    from repro_torch.graph import metrics

    part, k = main_res.assignment, main_res.k
    q = main_res.quality()
    calls = {
        "edge_cut": lambda d: metrics.edge_cut(graph, part, device=d),
        "communication_volume": lambda d: metrics.communication_volume(graph, part, k, device=d),
        "vertex_imbalance": lambda d: metrics.vertex_imbalance(part, k, device=d),
        "edge_imbalance": lambda d: metrics.edge_imbalance(graph, part, k, device=d),
        "partition_vertex_counts": lambda d: metrics.partition_vertex_counts(part, k, device=d),
        "partition_edge_counts": lambda d: metrics.partition_edge_counts(graph, part, k, device=d),
    }
    got, rows = {}, {}
    for name, fn in calls.items():
        fn(device)  # warm: the caching allocator, the graph's sources
        sync(torch, device)
        t0 = time.perf_counter()
        got[name] = fn(device)
        sync(torch, device)
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = fn("cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(got[name], want)
              and np.asarray(got[name]).dtype == np.asarray(want).dtype,
              f"phase 28: {name} on {device.type} != on the cpu")
        rows[name] = {"ms": ms, "cpu_ms": cpu_ms}
    for name, field in (("edge_cut", "edge_cut"), ("communication_volume", "comm_volume"),
                        ("vertex_imbalance", "vertex_imbalance"),
                        ("edge_imbalance", "edge_imbalance")):
        check(got[name] == q[field], f"phase 28: {name} {got[name]} != quality_report {q[field]}")
    eps = main_spec(tapi).epsilon
    balanced = metrics.check_balance(got["partition_edge_counts"], float(graph.indices.shape[0]),
                                     k, eps)
    check(balanced, "phase 28: phase 2's edge counts break the balance condition")
    log(json.dumps({"phase": "28a", "graph": graph.num_vertices, "edges": graph.num_edges,
                    "k": k, "metrics": {n: (v if np.ndim(v) == 0 else np.asarray(v).tolist())
                                        for n, v in got.items()},
                    "ms": rows, "check_balance": balanced, "epsilon": eps,
                    "identical_to_cpu": True, "identical_to_quality_report": True,
                    "device": ident}))

    # cuttana's detail on web-s (phase 3's spec), card and CPU
    t0 = time.perf_counter()
    det = {d: cuttana.partition(web, 8, balance_mode="edge", order="random", seed=0,
                                return_detail=True, device=d) for d in (device, "cpu")}
    detail_s = time.perf_counter() - t0
    a, b = det[device], det["cpu"]
    for field in ("part", "sub_of", "sub_part"):
        check(np.array_equal(getattr(a, field), getattr(b, field)),
              f"phase 28: cuttana detail {field} differs between {device.type} and cpu")
    check((a.refine_moves, a.refine_improvement) == (b.refine_moves, b.refine_improvement),
          "phase 28: cuttana detail refinement stats differ")
    cut = metrics.edge_cut(web, a.part, device=device)
    check(cut == WEB_S_EDGE_CUT["cuttana"], f"phase 28: web-s cuttana detail edge_cut {cut}")
    # refine_with_swaps over the run's coarsened graph, from the home placement
    kp = a.sub_part.shape[0]
    size = np.bincount(a.sub_of, weights=web.degrees.astype(np.float64), minlength=kp)
    swaps = {}
    for d in (device, "cpu"):
        t0 = time.perf_counter()
        w = build_subpartition_graph(web, a.sub_of, kp, d).cpu().numpy()
        r = Refiner(w, np.repeat(np.arange(8), kp // 8), size, 8, 0.05,
                    total_mass=float(web.indices.shape[0]))
        w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = refine_with_swaps(r)
        swaps[d] = (res, r.sub_part.copy(), w_s, time.perf_counter() - t0, r.current_cut())
    check(swaps[device][0] == swaps["cpu"][0]
          and np.array_equal(swaps[device][1], swaps["cpu"][1]),
          f"phase 28: refine_with_swaps differs: {swaps[device][0]} vs {swaps['cpu'][0]}")
    rec = {"phase": "28a", "dataset": "web-s", "algo": "cuttana", "return_detail": True,
           "subpartitions": kp, "refine_moves": a.refine_moves,
           "refine_improvement": a.refine_improvement, "edge_cut": cut,
           "phase1_seconds": a.phase1_seconds, "phase2_seconds": a.phase2_seconds,
           "detail_seconds_both": detail_s, "swaps": swaps[device][0],
           "coarse_cut_after_swaps": swaps[device][4], "w_seconds": swaps[device][2],
           "refine_with_swaps_seconds": swaps[device][3],
           "cpu_refine_with_swaps_seconds": swaps["cpu"][3], "identical_to_cpu": True}
    log(json.dumps(rec))
    return {"metrics_ms": rows, **rec}


def smoke_scripts(np, tapi, device, tiny: bool, tmp: str) -> dict:
    """Phase 28(b): the four smoke scripts' ``run()`` in this process, their
    deterministic gates applied; host-timing ratios logged only."""
    import importlib.util

    out = {}
    for name in SMOKE_SCRIPTS:
        spec = importlib.util.spec_from_file_location(
            f"port_{name}_smoke", ROOT / "scripts" / "torch" / f"{name}_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        argv = ["--device", device.type, "--out", os.path.join(tmp, f"{name}.json")]
        args = mod.parser().parse_args(argv + (SMOKE_TINY_ARGS if tiny else SMOKE_ARGS)[name])
        t0 = time.perf_counter()
        report = mod.run(args)
        run_s = time.perf_counter() - t0
        rec = {"run_seconds": run_s}
        if name == "threaded":
            # the bound is host timing: logged; the gate is the thread pool's
            # invariance, the parallel runs == the same specs on one thread
            for algo, base in mod.ALGOS:
                _, par_spec = mod.specs(args, algo, base)
                one = tapi.partition(report["_graph"], par_spec.replace(
                    params={"num_shards": args.num_shards, "max_workers": 1}), device=device)
                check(np.array_equal(one.assignment, report["_assignments"][algo]),
                      f"phase 28: threaded smoke {algo} differs from one thread")
                rec[algo] = {key: report[algo][key] for key in (
                    "sequential_s", "parallel_s", "ratio", "max_workers", "boundary_conflicts")}
                rec[algo]["one_thread_s"] = mod.stream_seconds(one)
            failures = []
        elif name == "outofcore":
            failures = mod.gates(report, args, timing=False)
            rec.update(file_ratio=report["file_ratio"], parity=report["_parity"],
                       prefetch_ratio=report["_prefetch_ratio"],
                       prefetch_on_s=report["stream"]["prefetch_on_s"],
                       prefetch_off_s=report["stream"]["prefetch_off_s"])
        else:
            failures = mod.gates(report, args)
            if name == "churn":
                rec.update(cut_ratio=report["cut_ratio"], work_ratio=report["work_ratio"])
            else:
                rec.update(qps_sim={a: report[a]["qps_sim"] for a in ("cuttana", "random")},
                           replication=report["replication"])
        check(not failures, f"phase 28: scripts/torch/{name}_smoke.py gates failed: {failures}")
        out[name] = rec
    return out


def examples_phase(torch, np, tapi, counters, device, tiny: bool, ident: str) -> dict:
    """Phase 28(b): every example of ``examples/torch`` as a child process on
    the card, all started together, beside the smoke scripts' runs here."""
    import atexit
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    children = []
    t0 = time.perf_counter()
    for i, (name, extra, need) in enumerate(EXAMPLE_RUNS):
        args = [*extra, "--device", device.type]
        if name == "train_lm":
            args += ["--ckpt-dir", os.path.join(tmp, "ckpt")]
            if tiny:
                args[args.index("--steps") + 1] = "2"
        log_path = os.path.join(tmp, f"example{i}.log")
        with open(log_path, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--example-child",
                 f"examples/torch/{name}.py", *args],
                env=env, cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT, text=True)
        atexit.register(proc.kill)
        children.append((name, args, need, proc, log_path))
    reset_counts(*counters)
    scripts = smoke_scripts(np, tapi, device, tiny, tmp)
    scripts_s = time.perf_counter() - t0
    runs = []
    for name, args, need, proc, log_path in children:
        rc = proc.wait(timeout=900)
        with open(log_path) as fh:
            lines = fh.read().splitlines()
        check(rc == 0 and lines, f"phase 28: examples/torch/{name}.py {args} exited {rc}:\n"
              + "\n".join(lines[-30:]))
        rec = json.loads(lines[-1])
        check(rec["forbidden"] == [], f"phase 28: {name} loaded {rec['forbidden']}")
        if device.type == "cuda":
            for key in need:
                check(rec["launches"][key] > 0, f"phase 28: {name} {args} launched no {key}")
        runs.append({"example": name, "args": args, "seconds": rec["seconds"],
                     "launches": {key: n for key, n in rec["launches"].items() if n},
                     "printed": lines[-6:-1]})
    shutil.rmtree(tmp, ignore_errors=True)
    out = {"phase": "28b", "examples": runs, "smoke_scripts": scripts,
           "scripts_seconds": scripts_s, "wall_seconds": time.perf_counter() - t0,
           "device": ident}
    log(json.dumps(out))
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--example-child":  # phase 28(b)'s child
        return example_child(sys.argv[2], sys.argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="rehearse every phase on the CPU at a tiny size (prints no result)")
    ap.add_argument("--mapped-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mapped-rows-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--zoo-cpu-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-cpu-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mapped_child:  # phase 21(b)'s child process
        return mapped_child(args.mapped_child, args.child_out, args.tiny)
    if args.mapped_rows_child:  # phase 21(a)'s child process
        return mapped_rows_child(args.mapped_rows_child, args.child_out, args.tiny)
    if args.zoo_cpu_child:  # phase 18's CPU side
        return zoo_cpu_child(args.zoo_cpu_child)
    if args.parallel_cpu_child:  # phase 7's CPU side
        return parallel_cpu_child(args.parallel_cpu_child)

    # phase 24(b) runs the train driver under deterministic algorithms; cuBLAS
    # needs this before its first handle to give the same bits run to run
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not args.tiny and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "(--tiny rehearses it on the CPU)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run it from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    import kernel_ablation_partition_score as score_ablation
    from outofcore_decode_study import PeakRss

    rss = PeakRss()  # phase 21 reports the process's peak RSS through phase 2
    import repro_torch.api as tapi
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.stream import ShardedStream
    from repro_torch.analytics import programs
    from repro_torch.kernels.ell_spmv import build as spmv_build
    from repro_torch.kernels.ell_spmv import ops as spmv
    from repro_torch.kernels.ell_spmv import ref as spmv_ref
    from repro_torch.kernels.partition_score import build, ops, ref
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import build as scan_build
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.mamba_scan import ref as scan_ref

    device = torch.device("cpu" if args.tiny else "cuda")
    timer = Timer(torch, device)
    counters = (ops, spmv, fa, scan)  # every kernel wrapper's launch count

    # ------------------------------------------------------------ phase 0
    clock = PhaseClock()
    ident = "cpu rehearsal" if args.tiny else gpu_identity()
    log(f"phase 0: {ident} | torch {torch.__version__} | cuda {torch.version.cuda}")
    floor = None  # the empty kernel of phases 1 and 5's launch floors
    scale = 14 if args.tiny else 22
    # one nvcc per kernel source, all started together; phase 1's graph is
    # generated on the host while they compile
    libraries = [] if args.tiny else [
        build.LIBRARY, spmv_build.LIBRARY, fa_build.LIBRARY, fa_build.MLA_LIBRARY,
        scan_build.LIBRARY]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries) + 1) as pool:
        floor_job = None if args.tiny else pool.submit(score_ablation.floor_library)
        build_jobs = [pool.submit(lib.load) for lib in libraries]
        t1 = time.perf_counter()
        graph = rmat_graph(1 << scale, avg_degree=16, seed=0)
        gen_s = time.perf_counter() - t1
        for job in build_jobs:
            job.result()
        if floor_job is not None:
            floor = floor_job.result()
    if not args.tiny:
        log(f"phase 0: kernels built (beside phase 1's graph) in "
            f"{time.perf_counter() - t0:.3f} s")
        for lib in libraries:
            log(f"phase 0: {lib.path.name}: nvcc {lib.build_seconds:.3f} s")
            for line in lib.build_log.splitlines():
                if "registers" in line or "Compiling entry" in line or "spill" in line:
                    log(f"phase 0: ptxas: {line.strip()}")

    # ------------------------------------------------------------ phase 1
    clock.mark(0)
    log(f"phase 1: rmat 2^{scale} generated in {gen_s:.3f} s (beside the builds): "
        f"{graph.num_vertices} vertices, {graph.num_edges} edges, "
        f"max degree {int(graph.degrees.max())}")
    dgraph = graph.to(device)
    shapes = kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor)
    clock.mark(1)

    # ------------------------------------------------------------ phase 2
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # allocated before the run: the graph's arrays (uploaded in phase 1) and
    # what phase 1's checks still hold
    main_base = torch.cuda.memory_allocated() if device.type == "cuda" else None
    reset_counts(*counters)
    res = tapi.partition(graph, main_spec(tapi), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    main_launches = ops.launches
    check(ops.sharded_launches == 0, "the sequential path launched the sharded kernel")
    q = res.quality()
    chunks = -(-graph.num_vertices // CHUNK)
    expect_launches = chunks if device.type == "cuda" else 0
    check(res.telemetry["kernel_calls"] == chunks,
          f"kernel_calls {res.telemetry['kernel_calls']} != {chunks} chunks")
    check(main_launches == expect_launches,
          f"kernel launched {main_launches} times on the main path, expected {expect_launches}")
    check_quality(np, graph, res.assignment, q, 8, "fennel")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    log(json.dumps({
        "phase": 2, "algo": "fennel", "graph": f"rmat 2^{scale} avg_degree 16",
        "num_vertices": graph.num_vertices, "num_edges": graph.num_edges,
        "edge_cut": q["edge_cut"], "comm_volume": q["comm_volume"],
        "vertex_imbalance": q["vertex_imbalance"], "edge_imbalance": q["edge_imbalance"],
        "stream_seconds": res.timings["stream_seconds"], "total_s": res.timings["total_s"],
        "kernel_calls": res.telemetry["kernel_calls"], "launches": main_launches,
        "variant": SCORE_VARIANT, "max_memory_allocated": peak,
        "memory_allocated_before": main_base, "device": ident,
    }))
    main_res = res  # phase 10 runs the analytics on this assignment
    # phase 21 logs the process's RSS so far (phases 0-2: the graph generated
    # and partitioned resident)
    main_rss = rss.read()
    clock.mark(2)

    # phase 7's CPU runs start now, in a child, beside phases 3-7's card runs
    # (after phase 2's timed main path)
    parallel_cpu = CpuChild("--parallel-cpu-child", 7, args.tiny)

    # ------------------------------------------------------------ phase 3
    from repro_torch.graph.generators import load_dataset

    web = load_dataset("web-s", seed=0)
    for algo in ("fennel", "cuttana"):
        spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0)
        reset_counts(*counters)
        on_dev = tapi.partition(web, spec, device=device)
        dev_launches = ops.launches
        on_cpu = tapi.partition(web, spec, device="cpu")
        check(np.array_equal(on_dev.assignment, on_cpu.assignment),
              f"web-s {algo}: {device.type} and cpu assignments differ")
        for r in (on_dev, on_cpu):
            check(r.quality()["edge_cut"] == WEB_S_EDGE_CUT[algo],
                  f"web-s {algo}: edge_cut {r.quality()['edge_cut']} != {WEB_S_EDGE_CUT[algo]}")
        log(json.dumps({
            "phase": 3, "dataset": "web-s", "algo": algo, "edge_cut": on_dev.quality()["edge_cut"],
            "identical_to_cpu": True, "kernel_calls": on_dev.telemetry["kernel_calls"],
            "launches": dev_launches, "timings_device": on_dev.timings,
            "timings_cpu": on_cpu.timings,
        }))
    dataset = "social-s" if args.tiny else "social-m"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res = tapi.partition(
        tapi.PartitionSpec(algo="cuttana", k=8, balance_mode="edge", order="random",
                           seed=0, source=f"dataset:{dataset}"),
        device=device,
    )
    q = res.quality()
    kp = res.telemetry["subpartitions"]
    if not args.tiny:
        check(q["edge_cut"] == SOCIAL_M_CUTTANA_EDGE_CUT,
              f"social-m cuttana: edge_cut {q['edge_cut']} != {SOCIAL_M_CUTTANA_EDGE_CUT}")
    log(json.dumps({
        "phase": 3, "dataset": dataset, "algo": "cuttana", "subpartitions": kp,
        "w_bytes": kp * kp * 8, "phase1_seconds": res.timings["phase1_seconds"],
        "phase2_seconds": res.timings["phase2_seconds"], "edge_cut": q["edge_cut"],
        "comm_volume": q["comm_volume"], "refine_moves": res.telemetry["refine_moves"],
        "max_memory_allocated": torch.cuda.max_memory_allocated() if device.type == "cuda" else None,
    }))

    clock.mark(3)

    # ------------------------------------------------------------ phase 4
    social_res = res  # phase 11 profiles pagerank on this partition
    social = res.graph
    log(json.dumps({"phase": 4, "dataset": dataset, **profile_stream(torch, tapi, social, device)}))
    clock.mark(4)

    # ------------------------------------------------------------ phase 5
    # phase 18's CPU runs start now, in a child, beside phases 5-11 and 23
    zoo_cpu = CpuChild("--zoo-cpu-child", 18, args.tiny)
    sharded_shapes = sharded_kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor)
    clock.mark(5)

    # ------------------------------------------------------------ phase 6
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spec = tapi.PartitionSpec(algo="fennel-parallel", k=8, epsilon=0.05, balance_mode="edge",
                              order="random", seed=0,
                              params={"num_shards": NUM_SHARDS, "max_workers": 0})
    reset_counts(*counters)
    res = tapi.partition(graph, spec, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    sharded_launches = ops.sharded_launches
    check(ops.launches == 0, "the parallel path launched the sequential kernel")
    tel = res.telemetry
    # every superstep of fennel-parallel has candidates
    steps = ShardedStream.from_ids(np.arange(graph.num_vertices), NUM_SHARDS).num_supersteps(CHUNK)
    check(tel["supersteps"] == tel["kernel_calls"] == steps,
          f"supersteps {tel['supersteps']} / kernel_calls {tel['kernel_calls']} != {steps}")
    expect = tel["kernel_calls"] if device.type == "cuda" else 0
    check(sharded_launches == expect,
          f"sharded kernel launched {sharded_launches} times, expected {expect}")
    q = res.quality()
    check_quality(np, graph, res.assignment, q, 8, "fennel-parallel")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    # the same spec on one host thread: the assignment must not change, and
    # the stream time shows what the pool threads buy on this host
    one = tapi.partition(graph, spec.replace(params={"num_shards": NUM_SHARDS, "max_workers": 1}),
                         device=device)
    check(np.array_equal(one.assignment, res.assignment),
          "fennel-parallel: max_workers=1 and max_workers=0 assignments differ")
    log(json.dumps({
        "phase": 6, "algo": "fennel-parallel", "graph": f"rmat 2^{scale} avg_degree 16",
        "num_shards": NUM_SHARDS, "max_workers": tel["max_workers"],
        "edge_cut": q["edge_cut"], "comm_volume": q["comm_volume"],
        "vertex_imbalance": q["vertex_imbalance"], "edge_imbalance": q["edge_imbalance"],
        "stream_seconds": res.timings["stream_seconds"], "total_s": res.timings["total_s"],
        "supersteps": tel["supersteps"], "boundary_conflicts": tel["boundary_conflicts"],
        "kernel_calls": tel["kernel_calls"], "launches": sharded_launches,
        "variant": SCORE_VARIANT, "profile": profile_totals(res.profile),
        "max_memory_allocated": peak,
        "workers1_stream_seconds": one.timings["stream_seconds"],
        "workers1_profile": profile_totals(one.profile), "device": ident,
    }))
    del dgraph, res, one
    clock.mark(6)

    # ------------------------------------------------------------ phase 7
    dev_runs = []
    for algo in PARALLEL_ALGOS:
        reset_counts(*counters)
        on_dev = tapi.partition(web, parallel_spec(tapi, algo), device=device)
        dev_launches = ops.sharded_launches
        check(ops.launches == 0, f"web-s {algo}: the sequential kernel launched")
        expect = on_dev.telemetry["kernel_calls"] if device.type == "cuda" else 0
        check(dev_launches == expect, f"web-s {algo}: {dev_launches} launches, expected {expect}")
        dev_runs.append((algo, on_dev, dev_launches))
    # the CPU side, run by the child beside phases 3-7
    cpu = parallel_cpu.results()
    for algo, on_dev, dev_launches in dev_runs:
        on_cpu = cpu[algo]
        check(np.array_equal(on_dev.assignment, on_cpu["assignment"]),
              f"web-s {algo}: {device.type} and cpu assignments differ")
        for q_ in (on_dev.quality(), on_cpu["quality"]):
            check(q_["edge_cut"] == WEB_S_EDGE_CUT[algo],
                  f"web-s {algo}: edge_cut {q_['edge_cut']} != {WEB_S_EDGE_CUT[algo]}")
        log(json.dumps({
            "phase": 7, "dataset": "web-s", "algo": algo, "num_shards": NUM_SHARDS,
            "edge_cut": on_dev.quality()["edge_cut"], "identical_to_cpu": True,
            "kernel_calls": on_dev.telemetry["kernel_calls"], "launches": dev_launches,
            "supersteps": on_dev.telemetry.get("supersteps"),
            "boundary_conflicts": on_dev.telemetry.get("boundary_conflicts"),
            "timings_device": on_dev.timings, "timings_cpu": on_cpu["timings"],
        }))
    del dev_runs, cpu
    for seq_algo, par_algo in (("fennel", "fennel-parallel"), ("cuttana", "cuttana-parallel")):
        seq = tapi.partition(web, tapi.PartitionSpec(
            algo=seq_algo, k=8, balance_mode="edge", order="random", seed=0), device=device)
        one = tapi.partition(web, tapi.PartitionSpec(
            algo=par_algo, k=8, balance_mode="edge", order="random", seed=0,
            params={"num_shards": 1}), device=device)
        check(np.array_equal(seq.assignment, one.assignment),
              f"web-s {par_algo} at S=1 differs from {seq_algo}")
        log(json.dumps({"phase": 7, "dataset": "web-s", "algo": par_algo, "num_shards": 1,
                        "identical_to": seq_algo, "edge_cut": one.quality()["edge_cut"]}))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    # on social-s (on social-m its refinement took 35-52 s of host time)
    res = tapi.partition(tapi.PartitionSpec(
        algo="cuttana-parallel", k=8, balance_mode="edge", order="random", seed=0,
        source="dataset:social-s", params={"num_shards": NUM_SHARDS}), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    q = res.quality()
    tel = res.telemetry
    expect = tel["kernel_calls"] if device.type == "cuda" else 0
    check(ops.sharded_launches == expect,
          f"social-s cuttana-parallel: {ops.sharded_launches} launches, expected {expect}")
    check(q["edge_cut"] == SOCIAL_S_CUTTANA_PARALLEL_EDGE_CUT,
          f"social-s cuttana-parallel: edge_cut {q['edge_cut']} != "
          f"{SOCIAL_S_CUTTANA_PARALLEL_EDGE_CUT}")
    log(json.dumps({
        "phase": 7, "dataset": "social-s", "algo": "cuttana-parallel", "num_shards": NUM_SHARDS,
        "edge_cut": q["edge_cut"], "comm_volume": q["comm_volume"],
        "phase1_seconds": res.timings["phase1_seconds"],
        "phase2_seconds": res.timings["phase2_seconds"],
        "supersteps": tel["supersteps"], "kernel_calls": tel["kernel_calls"],
        "launches": ops.sharded_launches, "boundary_conflicts": tel["boundary_conflicts"],
        "refine_moves": tel["refine_moves"], "profile": profile_totals(res.profile),
        "max_memory_allocated": torch.cuda.max_memory_allocated() if device.type == "cuda" else None,
    }))
    del res
    clock.mark(7)

    # ------------------------------------------------------------ phase 8
    log(json.dumps({"phase": 8, "dataset": dataset, **profile_stream(
        torch, tapi, social, device, "fennel-parallel", {"num_shards": NUM_SHARDS})}))
    clock.mark(8)

    # ------------------------------------------------------------ phase 9
    lg = main_res.localized()
    t0 = time.perf_counter()
    lg.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    to_device_s = time.perf_counter() - t0
    log(json.dumps({
        "phase": 9, "layout": f"rmat 2^{scale} fennel k=8", "localize_seconds":
        main_res.timings["localize_seconds"], "layout_to_device_seconds": to_device_s,
        "k": lg.k, "v_max": lg.v_max, "h_max": lg.h_max, "e_max": lg.e_max,
        "state_len": lg.state_len, "max_local_edges": lg.max_local_edges(),
    }))
    spmv_shapes = spmv_kernel_checks(torch, np, spmv, spmv_ref, lg, device, timer)
    clock.mark(9)

    # ----------------------------------------------------------- phase 10
    q = main_res.quality()
    n = graph.num_vertices
    on_cpu = dataclasses.replace(main_res, device=torch.device("cpu"))  # shares the layout
    spmv_launches = 0
    sim_values = {}  # phase 23 holds the sharded mode against these
    for prog, iters in ANALYTICS_ITERS.items():
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts(*counters)
        out = main_res.analytics(prog, iters, mode="simulated")
        launches = spmv.launches
        check(ops.launches == 0 and ops.sharded_launches == 0,
              f"analytics {prog}: a partition-score kernel launched")
        expect = iters if device.type == "cuda" else 0
        check(launches == expect, f"analytics {prog}: {launches} launches, expected {expect}")
        spmv_launches += launches
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
        got = sim_values[prog] = out["values"]
        check(got.shape == (n,) and got.dtype == np.float32 and np.isfinite(got).all(),
              f"analytics {prog}: values have the wrong shape, type or non-finite entries")
        short = main_res.analytics(prog, CPU_PARITY_ITERS, mode="simulated")["values"]
        want = on_cpu.analytics(prog, CPU_PARITY_ITERS, mode="simulated")
        if prog == "pagerank":
            check(np.allclose(short, want["values"], rtol=1e-5, atol=1e-9),
                  f"analytics pagerank: {device.type} and cpu values differ beyond rtol 1e-5")
            check((got > 0).all() and got.sum() <= 1.0 + 1e-3, "analytics pagerank: not a distribution")
            again = main_res.analytics(prog, iters, mode="simulated")
            check(np.array_equal(again["values"], got), "analytics pagerank: two runs differ")
        else:
            check(np.array_equal(short, want["values"]),
                  f"analytics {prog}: {device.type} and cpu values differ")
        check(abs(out["halo_messages_per_iter"] - q["comm_volume"] * lg.k * n) < 1e-3,
              f"analytics {prog}: halo messages {out['halo_messages_per_iter']} != "
              f"comm_volume * k * |V| = {q['comm_volume'] * lg.k * n}")
        log(json.dumps({
            "phase": 10, "program": prog, "iters": iters, "launches": launches,
            "seconds": out["seconds"], "cpu_parity_iters": CPU_PARITY_ITERS,
            "cpu_seconds": want["seconds"],
            "localize_seconds": main_res.timings["localize_seconds"],
            "halo_messages_per_iter": out["halo_messages_per_iter"],
            "padded_halo_elements_per_iter": out["padded_halo_elements_per_iter"],
            "max_local_edges": out["max_local_edges"], "mean_local_edges": out["mean_local_edges"],
            "identical_to_cpu": bool(np.array_equal(short, want["values"])),
            "max_rel_diff_to_cpu": float(np.max(np.abs(short - want["values"])
                                                / np.maximum(np.abs(want["values"]), 1e-30))),
            "second_run_seconds": again["seconds"] if prog == "pagerank" else None,
            "max_memory_allocated": peak, "device": ident,
        }))
    # a small input against the float64 dense oracles (tests/test_analytics.py's tolerances)
    web_res = tapi.partition(web, tapi.PartitionSpec(algo="fennel", k=8, balance_mode="edge",
                                                     order="random", seed=0), device=device)
    pr = web_res.analytics("pagerank", 30, mode="simulated")["values"]
    check(np.allclose(pr, programs.reference_pagerank(web, 30), rtol=2e-4, atol=1e-9),
          "web-s pagerank differs from the float64 oracle")
    cc = web_res.analytics("cc", 20, mode="simulated")["values"]
    check(np.array_equal(cc, programs.reference_cc(web, 20)), "web-s cc differs from the oracle")
    sp = web_res.analytics("sssp", 20, mode="simulated")["values"]
    want = programs.reference_sssp(web, 20)
    finite = np.isfinite(want)
    check(np.array_equal(sp[finite], want[finite]) and (sp[~finite] > 1e30).all(),
          "web-s sssp differs from the oracle")
    log(json.dumps({"phase": 10, "dataset": "web-s", "oracles_agree": True}))
    clock.mark(10)

    # ----------------------------------------------------------- phase 11
    social_res.localized().to(device)  # layout built and placed outside the profile
    log(json.dumps({"phase": 11, "dataset": dataset, **profile_analytics(
        torch, social_res, spmv, device)}))
    clock.mark(11)

    # ----------------------------------------------------------- phase 23
    sharded_row, sharded_spmv_launches = sharded_phase(
        torch, np, spmv, spmv_ref, lg, sim_values, device, timer, floor, ident)
    clock.mark(23)

    # ------------------------------------------------------ phases 18-20
    del lg, on_cpu
    main_res._localized = None  # the analytics layout of phases 9-10
    zoo_paths, zoo_rows, zoo_graph = zoo_phases(
        torch, np, tapi, ops, ref, counters, device, timer, floor, web, social, graph, dataset,
        args.tiny, ident, clock, zoo_cpu)
    clock.mark(20)

    # ----------------------------------------------------------- phase 21
    rows_shapes, rows_launches = outofcore_phase(
        torch, np, tapi, ops, ref, counters, device, timer, floor, zoo_graph, main_rss,
        args.tiny, ident)
    del zoo_graph
    clock.mark(21)

    # ----------------------------------------------------------- phase 22
    serving_row, serving_launches = serving_phase(
        torch, np, tapi, ops, ref, counters, device, timer, floor, graph, main_res, args.tiny,
        ident)
    clock.mark(22)

    # ---------------------------------------------------------- phase 28(a)
    surface_phase(torch, np, tapi, graph, main_res, web, device, ident)
    clock.mark("28a")

    # ----------------------------------------------------------- phase 12
    del graph, main_res, social_res, social, web_res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    import torch.nn.functional as F

    flash_shapes = flash_kernel_checks(torch, np, F, fa, fa_ref, timer, args.tiny)
    decode_shapes = [r for r in flash_shapes if r["variant"] == "decode_split"]
    clock.mark(12)

    # ----------------------------------------------------------- phase 13
    scan_shapes = scan_kernel_checks(torch, scan, scan_ref, timer, args.tiny)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    clock.mark(13)

    # ------------------------------------------------------ phases 14, 15
    lm_launches = {"flash_attention": 0, "selective_scan": 0}
    flash_variants = dict.fromkeys(fa.VARIANTS, 0)
    for phase, arch in zip((14, 15), LM_ARCHS):
        rec, model, params = lm_phase(torch, np, counters, device, arch, args.tiny, ident)
        for path in ("prefill", "serve"):
            for name, n in rec[path]["launches"].items():
                lm_launches[name] += n
            for name, n in rec[path]["flash_variants"].items():
                flash_variants[name] += n
        log(json.dumps({"phase": phase, **rec}))
        clock.mark(phase)
        if arch == "qwen3-8b":
            # ------------------------------------------------------- phase 17
            long_rec = long_decode_phase(torch, np, counters, device, model, params, args.tiny,
                                         ident)
            log(json.dumps({"phase": 17, **long_rec}))
            clock.mark(17)
        del model, params
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- phase 16
    reduced_rows = reduced_parity(torch, np, device)
    clock.mark(16)

    # ----------------------------------------------------------- phase 25
    moe_rec = moe_phase(torch, np, F, fa, fa_ref, counters, device, timer, args.tiny, ident)
    for name, n in moe_rec["launches"].items():
        lm_launches[name] += n
    for name, n in moe_rec["flash_variants"].items():
        flash_variants[name] += n
    clock.mark(25)

    # ----------------------------------------------------------- phase 26
    fam_rec = families_phase(torch, np, fa, fa_ref, counters, device, args.tiny, ident)
    for name, n in fam_rec["launches"].items():
        lm_launches[name] += n
    for name, n in fam_rec["flash_variants"].items():
        flash_variants[name] += n
    clock.mark(26)

    # ----------------------------------------------------------- phase 27
    mla_rec = mla_phase(torch, np, fa, fa_ref, counters, device, args.tiny, ident)
    for name, n in mla_rec["launches"].items():
        lm_launches[name] += n
    for name, n in mla_rec["flash_variants"].items():
        flash_variants[name] += n
    clock.mark(27)

    # ----------------------------------------------------------- phase 24
    train_rec = training_phase(torch, np, F, counters, device, timer, args.tiny, ident)
    clock.mark(24)

    # ----------------------------------------------------------- phase 29
    mesh_rec = mesh_phase(torch, np, counters, device, args.tiny, ident, train_rec)
    clock.mark(29)

    # ---------------------------------------------------------- phase 28(b)
    examples_phase(torch, np, tapi, counters, device, args.tiny, ident)
    clock.mark("28b")

    # ------------------------------------------------------------ summary
    def stream_summary(row):
        return {key: row[key] for key in ("shape", "launches", "total_ms", "ms", "slowest_ms",
                                          "floor_ms", "bound_ms")}

    def summary(name, shapes_, launches, replaces, source=KERNEL_SOURCE, **extra):
        main_shape = shapes_[0]
        err = max(r.get("max_abs_err", max(r.get("max_abs_err_alpha0", 0.0),
                                           r.get("max_abs_err_penalty", 0.0))) for r in shapes_)
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": main_shape["ms"], "call_ms": main_shape["call_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"], **extra,
        }

    # phase 12's rows at MLA's pairs, by the kernel they ran; the latent
    # kernels' launches on their main paths: latent_wgmma on phase 27's (the
    # serve loop and the long decode, bf16 at (576, 512)), decode_latent on
    # phase 16's reduced deepseek-v2 serve loop (float32 at (48, 32)) and any
    # of phase 27's
    mla_shapes = [r for r in flash_shapes if r["dv"] != r["dh"]]
    mla_prefill = [r for r in mla_shapes if r["variant"] == "wgmma_bf16"]
    mla_latent = [r for r in mla_shapes if r["variant"] == "decode_latent"]
    mla_wgmma = [r for r in mla_shapes if r["variant"] == "latent_wgmma"]
    mla_wgmma_launches = {path: mla_rec["record"][path]["flash_variants"]["latent_wgmma"]
                          for path in ("serve", "latent_decode")}
    mla_reduced = next(r for r in reduced_rows if r["arch"] == f"reduced:{MLA_ARCH}")
    mla_latent_launches = {
        "phase16_reduced_serve": mla_reduced["serve_flash_variants"].get("decode_latent", 0),
        **{f"phase27_{path}": mla_rec["record"][path]["flash_variants"]["decode_latent"]
           for path in ("serve", "latent_decode")}}
    mla_row_keys = ("shape", "variant", "n_split", "dh", "dv", "dtype", "ms", "call_ms",
                    "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
                    "max_row_rel_l2")
    # the zoo's kernel shapes (phases 1 and 19): 4,096-row chunks, a sampled
    # dense matrix, the longest coarse row's chunk; and phase 22's chunk of
    # the served cuttana stream
    zoo_shapes = [{key: row[key] for key in (
        "shape", "rows", "max_row", "ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
        "floor_ms", "split_rows") if key in row}
        for row in [r for r in shapes if r["shape"].startswith(("chunk4096", "dense_sampled"))]
        + zoo_rows + [serving_row]]
    log(json.dumps({"kernels": [
        summary("partition_score", shapes + zoo_rows + [serving_row], main_launches,
                TPU_KERNEL, variant=SCORE_VARIANT, floor_ms=shapes[0]["floor_ms"],
                stream=stream_summary(shapes[-1]), zoo_shapes=zoo_shapes,
                zoo_launches={path: n[0] for path, n in zoo_paths.items() if n[0]},
                serving_launches=serving_launches),
        summary("partition_score_sharded", sharded_shapes, sharded_launches, TPU_KERNEL_SHARDED,
                variant=SCORE_VARIANT, floor_ms=sharded_shapes[0]["floor_ms"],
                stream=stream_summary(sharded_shapes[-1]),
                zoo_launches={path: n[1] for path, n in zoo_paths.items() if n[1]}),
        # the rows entries: the same kernel on a memory-mapped graph's
        # chunks (phase 21's full-size fennel) and supersteps (its
        # cuttana-parallel), at phase 21's mapped shapes
        summary("partition_score_rows", rows_shapes[:1], rows_launches["rows"], TPU_KERNEL,
                variant=SCORE_VARIANT, entry="fennel_scores_rows",
                floor_ms=rows_shapes[0]["floor_ms"], copy_ms=rows_shapes[0]["copy_ms"],
                packed_bytes=rows_shapes[0]["packed_bytes"]),
        summary("partition_score_sharded_rows", rows_shapes[1:], rows_launches["sharded_rows"],
                TPU_KERNEL_SHARDED, variant=SCORE_VARIANT, entry="fennel_scores_sharded_rows",
                floor_ms=rows_shapes[1]["floor_ms"], copy_ms=rows_shapes[1]["copy_ms"],
                packed_bytes=rows_shapes[1]["packed_bytes"]),
        # phase 23: the same kernel, k=1 a rank, in the sharded mode's ranks
        summary("ell_spmv", spmv_shapes, spmv_launches, TPU_KERNEL_SPMV, SPMV_SOURCE,
                variant=SPMV_VARIANT, gb_per_s=spmv_shapes[0]["gb_per_s"],
                sharded_launches=sharded_spmv_launches, sharded_rank_row={
                    key: sharded_row.get(key) for key in (
                        "shape", "rows", "nnz", "ms", "call_ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_by", "floor_ms", "gb_per_s", "max_abs_err")}),
        summary("flash_attention", flash_shapes + moe_rec["rows"],
                lm_launches["flash_attention"] + mesh_rec["launches"],
                TPU_KERNEL_FLASH, FLASH_SOURCE, variant=flash_shapes[0]["variant"],
                # phase 29: both ranks' launches on the mesh path (in
                # ``launches`` too), (d)'s sequence-parallel runs among them;
                # phase 12's rows at a stripe's shapes
                mesh_launches=mesh_rec["launches"],
                seq_variants_per_rank=mesh_rec["seq"]["variants_per_rank"],
                stripe_rows=[{key: r.get(key) for key in (
                    "shape", "variant", "tq", "tk", "q_offset", "ms", "call_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "keys_read", "tflops",
                    "max_abs_err", "max_row_rel_l2")} for r in flash_shapes
                    if "stripe" in r["shape"]],
                # and at a tensor-parallel rank's heads (phase 29's path)
                tp_rows=[{key: r.get(key) for key in (
                    "shape", "variant", "hq", "hkv", "tq", "tk", "ms", "call_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "tflops", "max_abs_err",
                    "max_row_rel_l2")} for r in flash_shapes if "_tp" in r["shape"]],
                tflops=flash_shapes[0]["tflops"], variant_launches=flash_variants,
                # phase 24: the training path (the driver's three runs and
                # the elastic demo) and the gradient rows
                train_launches=train_rec["driver"]["launches"],
                train_variants_per_step=train_rec["step"]["attention_variants_per_step"],
                grad_rows=[r for r in train_rec["grad_rows"] if "hq" in r],
                # phase 25: the slice-13 families' launches (in ``launches``
                # too) and the rows at arctic-480b's shapes (g = 7)
                moe_family_launches=moe_rec["launches"],
                # phase 26: the slice-14 families' launches (in ``launches``
                # too), and phase 12's rows at their shapes (Dh 80 and 256)
                family_launches=fam_rec["launches"],
                family_variants=fam_rec["flash_variants"],
                family_rows=[{key: r.get(key) for key in (
                    "shape", "variant", "n_split", "dh", "dtype", "ms", "call_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "tflops", "max_abs_err",
                    "max_row_rel_l2")} for r in flash_shapes if r["dh"] in (80, 256)],
                g7_rows=[{key: r.get(key) for key in (
                    "shape", "variant", "n_split", "ms", "call_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "tflops", "max_abs_err", "max_row_rel_l2")}
                    for r in moe_rec["rows"]]),
        # the decode variant on its own: phase 17's long-context decode is its main
        # path, and its timed shape is phase 12's layer at phase 17's batch (B=8)
        summary("flash_attention_decode_split", decode_shapes,
                long_rec["flash_variants"]["decode_split"], TPU_KERNEL_FLASH, FLASH_SOURCE,
                variant="decode_split", shape=decode_shapes[0]["shape"],
                n_split=decode_shapes[0]["n_split"], main_path_n_split=long_rec["n_split"],
                tb_per_s=decode_shapes[0]["bytes"] / decode_shapes[0]["ms"] / 1e9,
                second_shape={key: decode_shapes[1].get(key) for key in (
                    "shape", "n_split", "ms", "bound_ms", "library_ms", "plain_ms")}),
        # MLA (phase 27, deepseek-v2-236b): the tensor-core prefill at
        # (Dqk, Dv) = (192, 128) and the absorbed decode's latent kernel at
        # (576, 512), timed at phase 12's MLA rows
        summary("flash_attention_mla_prefill", mla_prefill,
                mla_rec["record"]["prefill"]["flash_variants"]["wgmma_bf16"], TPU_KERNEL_FLASH,
                FLASH_SOURCE, variant="wgmma_bf16", dqk_dv=[192, 128],
                library=FLASH_MLA_LIBRARY, tflops=mla_prefill[0]["tflops"]),
        # the absorbed decode on the tensor cores (bf16, (576, 512)): its
        # main shape phase 12's B=8 over a 32k latent cache, then 160 keys
        summary("flash_attention_latent_wgmma", mla_wgmma, sum(mla_wgmma_launches.values()),
                TPU_KERNEL_FLASH, FLASH_SOURCE, variant="latent_wgmma", dqk_dv=[576, 512],
                library=FLASH_MLA_LIBRARY, path_launches=mla_wgmma_launches,
                n_split=mla_wgmma[0]["n_split"],
                main_path_n_split=mla_rec["record"]["latent_decode"]["n_split"],
                blocks_per_sm=mla_rec["record"]["latent_decode"]["blocks_per_sm"],
                tb_per_s=mla_wgmma[0]["bytes"] / mla_wgmma[0]["ms"] / 1e9,
                rows=[{key: r.get(key) for key in mla_row_keys} for r in mla_wgmma]),
        # MLA's FMA latent kernel: float32, unaligned bf16, short prompts at
        # (192, 128) and the reduced pair; its main shape phase 12's
        # unaligned bf16 row at (576, 512)
        summary("flash_attention_decode_latent", mla_latent, sum(mla_latent_launches.values()),
                TPU_KERNEL_FLASH, FLASH_SOURCE, variant="decode_latent", dqk_dv=[576, 512],
                library=FLASH_MLA_LIBRARY, path_launches=mla_latent_launches,
                n_split=mla_latent[0]["n_split"],
                tb_per_s=mla_latent[0]["bytes"] / mla_latent[0]["ms"] / 1e9,
                rows=[{key: r.get(key) for key in mla_row_keys} for r in mla_latent]),
        summary("selective_scan", scan_shapes,
                lm_launches["selective_scan"] + mesh_rec["scan_launches"],
                TPU_KERNEL_SCAN, SCAN_SOURCE, variant=scan_shapes[0]["variant"],
                exp_bound_share=scan_shapes[0]["exp_bound_share"],
                moe_family_launches=moe_rec["launches"]["selective_scan"],
                # phase 29(d): both ranks' scans of the gathered sequence on
                # their channels (in ``launches`` too), and phase 13's row at
                # a tensor-parallel rank's channels
                mesh_launches=mesh_rec["scan_launches"],
                tp_row={key: r.get(key) for r in scan_shapes if "_tp" in r["shape"]
                        for key in ("shape", "d", "t", "ms", "call_ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by", "exp_bound_share",
                                    "max_abs_err")},
                grad_rows=[r for r in train_rec["grad_rows"] if "n" in r]),
    ]}))
    if args.tiny:
        log("tiny rehearsal finished on the CPU: every phase ran; no device result")
        return 0
    log(gpu_identity())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
