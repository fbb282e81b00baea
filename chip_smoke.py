#!/usr/bin/env python3
"""Smoke test of the repro_torch port on one NVIDIA card.

    python3 chip_smoke.py [--n 500000] [--check-n 20000] [--seed 0]
                          [--storage-n 2000000]

Run from the root of a checkout on a machine with a CUDA card.  It

1. builds the port's five CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and prints the build time and
   ptxas' register, shared memory, stack and spill lines (per entry
   function for ``semiring_matmul``);
2. drives the port's main path through ``Q ... .engine("torch")`` (its
   default plan, statistics on) on the paper's synthetic chain C1 at
   ``--n`` rows per relation (Table IV scale by default) with an integer
   measure on R3: COUNT, SUM, AVG, MIN and MAX grouped by R1.g1 and
   R4.g2.  It prints prepare, cold and warm
   execute times, result rows, peak device memory, the stream tile, each
   kernel's launch count (``segment_sum``, ``coo_spmm`` and
   ``segment_reduce`` must be > 0, ``fused_hop`` 0) and the device's
   idle share in a warm execute under ``torch.profiler``;
3. drives the fused path, the same bundle on the same data with
   ``.fused(True)``, and prints the same numbers; there only
   ``fused_hop`` may launch, once per hop, per pass, per stream tile,
   besides the launches with which the cold execute times each hop
   shape's candidate launch shapes (``kernels/autotune.py``: the script
   points ``REPRO_TORCH_AUTOTUNE_CACHE`` at a file in a temporary
   directory of its own, removed at the end, so every run tunes from
   scratch; the later legs' fused plans run tuned too); each launch must
   take its tuned shape, on the routes and sizes that ``explain`` shows;
4. checks the results: Σ COUNT and Σ SUM against an independent numpy
   count of the chain join, every fused column bit-identical to the
   unfused one, and, at ``--check-n`` rows, each path's result on the
   card bit-identical to the same plan on the CPU;
5. holds each kernel against its plain PyTorch version on the card, at
   the largest shape the paths launched it with (``fused_hop``: per kind
   and child count; ``segment_sum`` and ``segment_reduce`` also at the
   largest launch of their widest rows, the general hops' edge chunks,
   with ``out=`` at that launch's alignment) and on edge cases (see
   ``kernel_cases``, ``fused_hop_cases`` and, for the slab-major warp walk
   of ``coo_spmm`` and one-child ``fused_hop`` hops, ``gather_cases``,
   with operand and output pointers off 16 bytes), with tolerance 0 (integer-valued
   float32 below 2**24: every sum is exact), and times kernel, plain
   version, one PyTorch library call as a yardstick where one computes
   the same function, ``fused_hop``'s three-dispatch counterpart on the
   same hop, and the bound from bytes and operations.  No engine calls
   ``semiring_matmul``: it is held and timed at (2048, 2048) x (2048,
   2048), held at (3000, 1000) x (1000, 2500), on fractional values, on
   ragged shapes, with ±inf in the last values of k and with operands off
   16-byte alignment, all at tolerance 0, and each semiring's time stands
   beside its bound and its instruction floor (``semiring_floor``);
6. drives the split leg: the catalog's SKEWCHAIN (``data/queries.py``, 30 %
   of both sides on one hot key of p0) at ``--n`` rows per relation, its
   COUNT through ``Q.from_query``, once with the default plan (statistics
   on: it must split p0 into key ranges) and once with ``.stats(False)``
   (unsplit), each with the numbers of 2 and its peak device memory above
   what was allocated before planning; checks split = unsplit bit for bit,
   Σ COUNT against numpy's Σ_p0 c1[p0]·c2[p0] in int64, the fused split
   plan (only ``fused_hop`` launches) and, at ``--check-n``, card = CPU;
7. drives the cyclic leg: TRIANGLE (40,000 edges per relation), FOURCYCLE
   (20,000) and FOFGROUP (40,000) through the GHD compiler, printing the
   host prepare split into encode, ``build_ghd``, bag materialization and
   ``finish_prepare`` beside warm execute, bag rows and peak bytes, and
   the decomposition left after the fold; checks each group's COUNT
   against an int64 count with ``scipy.sparse`` (exact below 2**24, within
   ``count_rtol`` above it), at 4,000 edges card = CPU bit for bit, and
   runs each query once more with ``mode="sparse"``, bit-identical, so
   that ``segment_sum`` still launches in this leg;
8. drives the dense leg: the catalog's TPCH with an integer
   ``lineitem.quantity`` in [1, 50] (TPC-H's ``l_quantity``) and the
   COUNT/SUM/AVG/MIN/MAX bundle of it, at the largest ``n`` of the
   doubling series 600, 1200, ... for which ``choose_path`` still says
   dense, printing the relation tensors' element counts; the default
   (dense) plan and a ``mode="sparse"`` plan, each with the numbers of 2;
   checks dense = sparse bit for bit, Σ COUNT and Σ SUM against numpy,
   card = CPU at 4,800 rows, and the dense result again under a global
   ``torch.backends.cuda.matmul.allow_tf32 = True``: unchanged, and the
   setting still on afterwards; then times both paths, each pinned, at
   every size of the series and one doubling past it (``path_sweep``),
   beside what ``choose_path`` picks there;
9. prints ``plan.explain(actuals=True)`` of TPCH at 600 rows on the card
   and checks that ``verify()`` finds no broken invariant in any leg's
   plan (V-OVERFLOW, an estimate the legs' exact count checks settle,
   is printed);
10. drives the maintain leg: Table VIII's B2 star (``data/synth.py``) at
   ``--maintain-n`` rows per relation (250,000; ``--n``, 500,000, until a
   whole run with leg 22's served cells took 1,113.2 s) with an integer
   measure on R2, a COUNT
   handle through ``Q.maintain(db)`` and a COUNT/SUM/AVG bundle through
   ``Plan.maintain()``, both caching their messages on the card, through
   inserts of 1, 100 and 10,000 rows into R2 (Table VIII's five sizes
   cut to three for the script's time limit), a delete of
   1,000 present R2 tuples, an insert into the leaf R3 that grows two
   domains and an insert into the root R1.  After each batch both
   handles equal a from-scratch execute on the card bit for bit and Σ
   COUNT equals numpy's; per batch and handle it prints refresh and
   full-recompute ms and their ratio, ``delta_rows``,
   ``rows_rescanned``, ``peak_delta_bytes``, the device peak above
   resident, the launches and the device→host syncs of the refresh
   (only ``segment_sum`` and ``coo_spmm`` may launch).  The largest
   batch is then deleted, its launches captured and held against the
   plain versions (``maintain_kernels``), and inserted again under the
   profiler (idle share); a MIN handle takes a delete (the
   non-invertible fallback, on ``segment_reduce``); and at
   ``--check-n`` the same sequence runs on card and ``device="cpu"``
   handles, bit for bit;
11. drives the storage leg, the repo's Table XIV on the card: its
   measured chain R1(g1, p0), R2(p0, p1, m), R3(p1, g2) at
   ``--storage-n`` rows per relation (2,000,000 by default, cut from
   Table XIV's 5,000,000 for the script's time limit; join domains
   n / 50, group domains 32) is written with ``write_database`` to a
   temporary directory (removed at the end) and mounted with
   ``open_database``.  It prints
   the write and open seconds; prepare's seconds and host peak
   (tracemalloc) mounted, with chunk_rows
   ``max(4096, n / 25)``, and in memory, and fails unless the mounted
   peak is below twice the largest column; the Table XIV query,
   SUM(R2.m) by R1.g1 and R3.g2, planned and executed mounted and in
   memory, bit for bit, with the first execute's host peak; the storage
   smoke bundle (COUNT, SUM, MIN, MAX, AVG) on the mounted database
   driven as in 2 (``segment_sum``, ``coo_spmm`` and ``segment_reduce``
   must launch), its ``coo_spmm`` launch also held at tolerance 0 on
   exact operands at the same rows and columns (``spmm_exact_check``);
   Σ COUNT and Σ SUM against numpy in int64 (exact below
   2**24, within ``count_rtol`` above); ``verify()`` clean, V-STORE-CSR
   included; and at ``--check-n`` the mounted bundle with forced tiny
   chunks (the k-way merge), with ``.fused(True)``, on the CPU and with
   the default chunk, each bit-identical to the in-memory run, and a
   ``Q.maintain`` handle over the mounted database equal to one over the
   in-memory twin through three 100-row R2 inserts;
12. drives the serve leg: ``JoinAggServer(db, device="cuda", workers=8,
   fusion_window=0.002)`` over C1 at ``--n`` / 2 with the reference demo's
   integer ``R2.w`` in [1, 100) (``launch/serve.py``), answering its five
   shapes (count, sum, multi, minmax, two_group) and ``count`` with
   ``.fused(True)``; every answer is held against a solo
   ``plan(db).execute()`` of its spec on the card, bit for bit.  It
   prints each shape's cold and warm query time; two rounds of 8 client
   threads x 6 queries (the first while two served views take 6 insert
   batches each and 2 readers per view check every read against a
   shadow handle's prefix: ``by_g1``, COUNT by R1.g1, whose R1 batches
   recompute because the chain folds into R1, and ``pairs``, the
   two_group shape on g1 < 40 and g2 < 40, whose R2 batches must all
   propagate through the device message caches, its last prefix also
   equal to a fresh execute; the second round warm and under the
   profiler): p50/p99
   latency, queries per second, the device idle share and the device
   peak above what the full plan cache holds; 8 identical queries as one
   burst (one execute) against one after another; a count/sum/multi
   burst (a channel merge); one TCP round trip; the plan-cache and
   fusion counters (compiles fewer than queries); the dense leg's TPCH
   bundle from 4 concurrent clients of a second server under a global
   ``allow_tf32 = True`` (every einsum term run with TF32 off, read by a
   spy on ``contract_term``; the FP32 result bit for bit; the setting
   kept);
   at ``--check-n`` a ``device="cpu"`` server against a ``device="cuda"``
   one, answer by answer; and the served plans' own ``segment_sum``,
   ``coo_spmm``, ``segment_reduce`` and ``fused_hop`` launches against
   their plain versions (tolerance 0), each timed beside its library
   call.  Each of the four must launch;
13. drives the shard leg, the sharded path of DESIGN.md §8: the bundle of
   2 on C1 at ``--n`` through ``Q ... .mesh(S).plan(db).execute()`` on
   process groups of S = 1, 2 and 4 ranks (``multiprocessing`` spawns each
   rank on ``cuda:{rank % device_count}``; NCCL where there are at least S
   cards, else gloo, which gathers on the host; the kernels are built
   before the spawn), unfused and fused.  Every rank's gathered answer
   must equal 2's single-device answer bit for bit and Σ COUNT / Σ SUM
   numpy's, and every rank must launch ``segment_sum`` and
   ``segment_reduce`` (unfused) or ``fused_hop`` (fused).  It prints the
   backend and ranks per card, each rank's cold and warm execute split
   into the walk and the ``all_gather``, its peak device memory above
   resident beside the S = 1 peak (the ratio; nothing is claimed), and
   ``per_device_bytes()`` beside that peak.  At S = 4 a C1 at
   ``--check-n`` whose group attributes take 2 codes (the last two
   shards own no rows) runs meshed and alone, bit for bit, and rank 0
   holds its largest launches against the plain versions (tolerance 0).
   The S = 2 group then serves meshed on the same C1: every rank calls
   ``serve_mesh(db, device="cuda", workers=4)``, and rank 0's server
   answers the bundle ``.mesh(2)`` cold and 5 times warm, then with
   ``.fused(True)`` cold and warm, a burst of 4
   concurrent ``.mesh(2)`` count/sum specs (one channel merge, one lane
   execute) with one unmeshed sum sent in its middle, and one TCP request
   with ``"mesh": 2``, then closes, which ends rank 1's follower loop.
   Every served answer must equal the rank's direct ``.mesh(2)`` execute
   and 2's single-device answer bit for bit (the count/sum columns and
   the TCP answer those of the served bundle); it prints ``serve-mesh
   leg:`` lines with cold and warm ms per shape, the lane's own ms per
   execute (control message and confirm, apart from ``execute()``), the
   compiles and the kernel launches on each rank.
14. drives the comparison leg, the paper's Tables II and III on the card
   through the port's own baselines and oracle (``repro_torch.baselines``,
   ``repro_torch.relational.oracle``; host numpy in the reference, torch
   tensors on the card here).  Table III: S1, S2 and S3
   (``data/synth.py``) at ``--n`` rows, each through the legacy
   ``join_agg`` (once: it prepares on every call), ``binary_join_agg`` and
   ``preagg_join_agg``, printing each one's synchronised wall ms, device
   peak above resident and largest intermediate (rows and bytes); the
   three answers must have the same groups and equal counts.  Table II:
   B2 at ``--n`` / 16, / 8, / 4, / 2 and ``--n`` rows, ``join_agg``
   against ``preagg_join_agg`` on peak and ms, equal answers.  The oracle
   on the card must equal S3's ``join_agg`` answer and the main path's C1
   bundle at 100,000 rows (a join of about 10**8 rows) group by group:
   COUNT, SUM, MIN and MAX exactly, AVG within 1 ulp.  At ``--check-n``
   every baseline and oracle call on the card equals the same call with
   ``device="cpu"``, answers and statistics, and launches no kernel.
15. drives the launcher leg: the port's two command-line gates, each in a
   subprocess with ``PYTHONPATH=src`` (the kernels already built), all
   three at once: ``python -m repro_torch.launch.storage --smoke --rows
   40000`` on the card, and ``python -m repro_torch.analysis
   --verify-catalog`` on the card and with ``--device cpu``, whose
   ``catalog[...]`` lines must be equal line for line.  Meanwhile a user
   engine registered as ``user-sparse`` (``register_engine``; a ``run``
   with the reference's 4-argument signature, no ``fused``, no
   ``memory_budget``, no streaming, over ``TorchChannelEngine(mode=
   "sparse")``) answers the C1 bundle at ``--check-n`` through
   ``Q.engine("user-sparse")``, bit for bit the same as
   ``.engine(TorchChannelEngine(mode="sparse"))``, and must launch
   ``segment_sum``, ``coo_spmm`` and ``segment_reduce``.  Any non-zero
   exit code fails the script; it prints each part's seconds.
16. drives the ref leg, the paper's own engine (``"ref"``: the data graph
   built on the card and walked breadth-first over tiles of sources,
   ``repro_torch.core.datagraph`` and ``core/ref_engine.py``).  Table I:
   the data graph of every ``synth.ALL`` dataset at 500,000 rows
   (``TABLE_ONE_N``), its rows, nodes, edges, ``memory_bytes()``, device
   bytes and build seconds; at ``--check-n`` each graph built on the card
   equals the one built with ``device="cpu"``, tensor for tensor.  The
   main path's C1 bundle on leg 2's data through ``.engine("ref")``, its
   launch counts set to 0 just before and read just after
   (``segment_sum`` and ``segment_reduce`` must launch): bit-identical
   to leg 2's result by digest, Σ COUNT and Σ SUM against numpy, Stage 2
   and Stage 3 seconds, the frontier's peak rows, tiles, and the device
   peak against the torch engine's.  B2 COUNT/SUM over (g1, g2, g3) at
   ``REF_B2_N`` rows, path-ids and cross products, bit-identical to the
   torch engine and Σ COUNT against numpy; C1 and B2 at ``--check-n``
   on the card bit-identical to ``RefChannelEngine(device="cpu")``; a
   ``"ref"`` COUNT handle on B2 at ``REF_MAINTAIN_N`` rows through three
   inserts and a delete, each equal to a from-scratch ``"ref"`` run.  The
   largest ``segment_sum`` and ``segment_reduce`` launches of the C1 run
   are held against their plain versions (tolerance 0) and timed beside
   the bound and the library call.
17. drives the autotune leg, the fused hop's launch shapes tuned on the
   card (``kernels/autotune.py``, ``launch/roofline.py``): for every hop
   shape of 3's fused C1 bundle that 3 tuned, each measured candidate's
   ms, the model's pick, the winner and the fixed plan's ms (the hop's own
   operands, in a fused execute of the bundle), every candidate's output
   bit-identical to the fixed plan's; the two few-row one-child sum hops
   of PERF.md §6 (2,530,424 edges into 32 rows of d = 64 from a
   (100000, 64) operand, 81,675 into 50 rows of d = 2,600 from a
   (50000, 2600) one; integer-valued from ``--seed``) tuned by their first
   launch through the engine's ``contract_hop``, tuned against fixed ms
   beside the bound and ``torch.sparse.mm``, every candidate and the
   plain version bit-identical; then ``reset_cache()`` and the bundle
   again: no measurement, the same plans read back from the file, 2's
   digest; and what tuning cost 3's cold execute.  The leg must take
   less than 30 s.  The ``fused_hop`` entry of the kernels line carries
   each tuned key's plan, ms and fixed ms (``tuned``).
18. drives the train leg, the LM substrate's dense decoder at full width
   (``repro_torch.models``, ``repro_torch.train``): (a)
   ``repro_torch.launch.train.main`` trains qwen2-1.5b at full width
   (d_model 1,536, 151,936 tokens) and 8 of its 28 layers
   (``TRAIN_LAYERS``; 607,715,328 parameters, f32 with f32 AdamW state,
   bf16 activations) for 6 steps of 4 x 4,096 tokens
   (``SHAPES["train_4k"]``'s sequence; its global batch of 256 cut to 4
   for one card), checkpointing at steps 3 and 6 into a temporary
   directory, and prints each step's ms, tokens/s, loss, global gradient
   norm (both must be finite) and peak device memory, and the
   checkpoint's save, wait and restore seconds; (b) resumes from step_3
   and holds steps 4 and 5 to the uninterrupted run's losses and norms
   (``RESUME_RTOL``); (c) at all 28 layers (1,543,569,408 parameters)
   prefills 4 x 4,096 tokens, decodes 8 more on the
   cache, and holds the last decode's logits to a prefill of all 4,104
   within rtol = atol = 0.15 (the reference's bound for bf16
   activations); (d) takes one train step of the reduced qwen2-1.5b on
   the card and on the CPU from the same parameters and batch, with f32
   activations (TF32 off; loss, norm, AdamW's moments and the
   parameters) and with bf16 ones (loss and norm).  None of the five
   kernels may launch.
19. drives the moe/vlm leg, the LM substrate's ``moe`` and ``vlm``
   families at full width with ``n_layers`` cut (``MOE_VLM_RUNS``; no
   config's state fits one card at full depth): (a) ``launch.train.main``
   trains moonshot-v1-16b-a3b (64 experts, top-6, 48 -> 4 layers) for 3
   steps of 4 x 4,096 tokens, no checkpoints, and prints each step's ms,
   tokens/s, 6 N_active D rate, loss, gradient norm, summed MoE auxiliary
   loss (all finite, the auxiliary loss above 0) and peak; then a 4 x
   4,096 prefill (with the share of (token, choice) pairs dropped at
   capacity) and 8 decoded tokens; (b) the same for qwen2-vl-7b (M-RoPE,
   28 -> 8 layers) on 2 x 4,096 text tokens, each row behind its 256 zero
   patches as the launcher adds them, and a prefill behind 256 normal
   patches; (c) llama4-scout-17b-a16e (16 experts, top-1, 48 -> 2 layers,
   23.2 GiB of f32 weights) prefills 4 x 4,096 tokens and decodes 8,
   without gradients.  Decode is not held to prefill in this leg: MoE
   capacity depends on the call's tokens and M-RoPE decodes at the raw
   position, in the reference too.  Each model is freed before the next
   (the GiB left allocated is printed).  (d) For each of the three
   ``REDUCED`` configs, one f32 train step (loss, norm, AdamW's moments,
   parameters) and one f32 prefill (logits within 1e-5) on the card and
   the CPU, and one bf16 step (loss and norm within 2e-2); for the MoE
   configs an f32 forward and prefill on the CPU come first, and before
   any value is compared the leg asserts that their router probabilities
   keep every token's k-th and (k+1)-th choice ``ROUTE_MARGIN`` apart.  None of the
   five kernels may launch.
20. drives the ssm/hybrid leg, the LM substrate's recurrent families
   (``models/ssm.py``: chunked RWKV6 and Mamba2 recurrences in plain
   PyTorch, each chunk's terms at once and the state carried chunk by
   chunk) at full width: (a) ``launch.train.main`` trains rwkv6-3b
   (d_model 2,560, 40 heads of 64, d_ff 8,960, 65,536 tokens, chunk 16)
   at 4 of its 32 layers (``SSM_HYBRID_RUNS``; 679,723,776 counted
   parameters, f32 with f32 AdamW state, bf16 activations) for 3 steps of
   4 x 4,096 tokens, no checkpoints, and prints each step's ms, tokens/s,
   6ND rate (N counted leaf by leaf: the analytic ``param_count`` is not
   that count for these families), loss, gradient norm (both must be
   finite) and peak; (b) the same for zamba2-2.7b (80 SSD heads of 64,
   d_state 64, chunk 128, the shared attention block after every 6
   Mamba2 layers) at 12 of its 54 layers (2 groups; 747,240,512
   parameters).  The depth is cut for the script's time limit: at 16 B a
   parameter, 46.03 and 36.09 GiB at full depth would fit the card, 10.13
   and 11.13 GiB are trained; (c) each at the same cut depth (4 and 12
   layers; cut from full depth, 32 and 54, after a whole run with leg 21
   took 1,184.6 s), without gradients, prefills and
   decodes (D the config's chunk: 16 and 128) in two ways: with bf16
   activations, as shipped, a prompt of 4 x (4,096 - D) tokens prefilled
   and 8 tokens decoded from its state, timed (prefill ms, decode ms a
   token, peak); with f32 activations and TF32 off, the same prompt, D
   tokens decoded (the hybrid's shared-block keys and values copied into
   a 4,096-slot cache) and the last decode's logits of all 4 rows held to
   a prefill of all 4,096 within rtol = atol = ``F32_DECODE_TOL`` (1e-3;
   no capacity, no M-RoPE: decode and prefill compute the same function
   here).  With bf16 activations the two drift apart with depth, past
   the reference's 0.15 at full depth (``tools/decode_drift.py``, which
   serves at any depth); (d)
   as leg 18's (d), for both ``REDUCED`` configs on 4 x 256 tokens: one
   f32 train step (loss, norm, AdamW's moments, parameters), one f32
   prefill (logits within 1e-5) and one bf16 step (loss and norm within
   2e-2) on the card and the CPU, TF32 off, held to leg 18's bounds.
   Each model is freed before the next.  None of the five kernels may
   launch.  (c)'s depth was the first cut for the script's time; if a
   whole run passes 1,100 s again, an earlier leg's is the next.
21. drives the audio leg, the LM substrate's encoder-decoder
   (whisper-medium: d_model 1,024, 16 heads of 64, d_ff 4,096, 51,865
   tokens, 1,500 audio frames; LayerNorm blocks, GELU MLPs, sinusoidal
   positions) at full width and full depth, 24 encoder and 24 decoder
   layers (811,357,184 counted parameters, 12.09 GiB at 16 B a
   parameter: no cut): (a) ``launch.train.main`` trains it for 3 steps of
   4 x 4,096 decoder tokens behind the launcher's zero frames (4 x 1,500
   x 1,024), no checkpoints, and prints each step's ms, tokens/s, loss,
   gradient norm (both must be finite), peak and FLOP rate (6 x (the
   encoder's parameters x 6,000 frames + the rest x 16,384 tokens)); (b)
   without gradients, behind seeded normal bf16 frames, prefills 4 x
   (4,096 - 8) tokens with bf16 activations, as shipped, and decodes 8
   tokens from the cache (the decoder's keys and values and the memory's
   per layer), timed; then, with f32 activations and TF32 off, the same
   prompt and 8 decoded tokens, the last decode's logits of all 4 rows
   held to a prefill of all 4,096 within ``F32_DECODE_TOL`` (decode
   positions are f32 sinusoids on the card, the prefill's a float64
   table, as in the reference); at 4,096 tokens the cross-attention
   (4,096 queries over 1,500 keys) takes the chunked path, its keys
   padded by 548 masked slots; (c) as leg 20's (d), for the ``REDUCED``
   config on 4 x 256 tokens behind seeded normal frames, held to leg
   18's bounds.  None of the five kernels may launch.  The leg must take
   at most 35 s inside the script.
22. drives the mesh leg, the LM substrate's mesh on ``torch.distributed``
   (``launch/{mesh,sharding,dryrun}.py``, ``models/{shard_ctx,moe_ep}.py``,
   ``train/compression.py``, ``build_train_step(mesh=)``): one group of 4
   ranks, each a process that ``multiprocessing`` spawns, mesh (data 2,
   model 2); NCCL for the card's tensors with 4 or more cards, else gloo
   with the 4 ranks sharing the card (gloo moves every collective through
   the host).  The sharded step computes the dense layers over ``model``
   where the reference's pins cut them and the recurrent mixers by their
   heads (``train.leaf_layouts``: the attention's heads, the MLPs' hidden
   width, the vocabulary of the embedding, the head and the cross-entropy;
   RWKV6's time mix by heads and its channel mix by ffn columns, Mamba2 by
   heads, its ``in_proj`` and conv a selection of columns) and gathers a
   leaf over ``model`` only where its layer runs whole.  (a) the reduced
   configs of ``MESH_CHECK`` (qwen2-1.5b, moonshot-v1-16b-a3b, qwen2-vl-7b,
   rwkv6-3b, zamba2-2.7b, whisper-medium, minitron-4b, whose 3 heads keep
   the attention whole, and qwen2-1.5b at a vocabulary of 511, whose head
   stays whole; the vlm and audio batches behind seeded patches and
   frames), ``MESH_STEPS`` sharded
   f32 steps each (TF32 off) on 4 x 32 tokens, on the card and then on the
   CPU in the same ranks, from the same parameters (drawn on the host):
   losses, norms and every rank's blocks within leg 18's bounds (a block's
   elements beyond 1e-4 only where |g| <= 1e-4, on at most ``FLIP_SHARE``,
   and within 2 x Σ lr everywhere), within the ``EP_*`` bounds for
   moonshot (the bf16 ``model`` sum and bf16 gate sums: gradients agree to
   bf16), each rank's CPU routing margin above ``ROUTE_MARGIN`` first,
   AdamW's moments' elements beyond 1e-4 printed, and ``moe_block_ep``
   taken for the MoE config only; then each served on the mesh
   (``launch/dryrun.py:MeshServe``) from the CPU's blocks after the steps,
   on the card and on the CPU: a prefill of 4 x 32 tokens laid out for a
   cache of ``mesh_slots`` positions and ``MESH_CHECK_DECODE`` decode steps,
   every step's logits and the cache blocks within ``F32_RTOL`` (relative
   and of the largest), the MoE's CPU routing margin first; (b) each
   config of ``MESH_ARCHS`` at full width and cut depth, moonshot-v1-16b-a3b
   at 2 of its 48 layers, qwen2-1.5b at 2 of its 28, rwkv6-3b at 2 of its
   32 and zamba2-2.7b at one group (6 of its 54 Mamba2 layers and the
   shared block), ``MESH_STEPS`` sharded steps of 4 x 1,024 tokens (2
   sequences a data rank), bf16 but for ``MESH_F32`` (rwkv6-3b, whose bf16
   gradient after one update rides on rounding): each rank's ms a step,
   peak, parameters held, the dense elements it computes with beside the
   whole leaves' (``train.dense_held``), the bytes its gathers returned a
   step, the ``model`` sums' and every other collective's seconds and
   bytes by kind (``launch/mesh.py``'s recorder, by the calling module),
   and for moonshot the ``all_to_all`` bytes (the expert exchanges, made
   from ``models/moe_ep.py``: forward, recompute and backward) beside the
   forward's predicted 2 x E x C x d x 2 B; every
   rank's loss finite and equal; each rank samples ``MESH_SAMPLE`` seeded
   elements of every leaf its blocks hold; ``MESH_SERVE`` (qwen2-1.5b and
   rwkv6-3b) are then served on the mesh from the blocks the steps left,
   bf16: a prefill of 4 x 1,024 tokens laid out for ``MESH_SLOTS`` (1,032)
   positions, 516 a rank, then ``MESH_DECODE`` tokens, and for qwen2-1.5b
   one row (the positions over data x model, 258 a rank) and
   ``MESH_ONE_ROW_DECODE`` tokens; prefill ms, decode ms a token and the
   collectives a token by kind printed; rank 0 gathers the parameters
   whole and holds the logits of every step and the cache after the
   prefill and after the decode to the unsharded prefill and decode within
   ``BF16_LOGIT_TOL``; after the ranks exit, the parent runs the unsharded
   step with ``accum = 2`` from the same seed on the same batches and
   holds losses, norms and samples to ``MESH_*`` bounds (the ``model``
   sums' bf16 roundings are the only expected gap); (c)
   ``compressed_psum_tree`` over the data group on each rank's local
   gradients of (a)'s reduced qwen2-1.5b, within the int8 bound of the
   plain all-reduce, timed beside it; (a)'s reduced qwen2-1.5b saved from
   the 4 ranks (``Checkpointer.save(shardings=)``), restored by the parent
   as one rank bit for bit, and its next step (``accum = 2``) equal to the
   4-rank run's within leg 18's f32 bounds.  Before the ranks start, a
   subprocess runs (b)'s cells dry (``MESH_DRY``:
   ``launch/dryrun.py:run_cell`` on a fake world of 4 ranks, fake CUDA
   tensors: each config's train cell, and ``MESH_SERVE``'s prefill and
   decode at ``MESH_SLOTS``) and qwen2-1.5b x decode_32k x single at full
   size with its roofline row; every rank's real (b) steps, served prefill
   and decode steps must then move the dry record's collective bytes by
   kind, hold its argument bytes, and each step's peak lie within
   ``MESH_PEAK_RTOL`` (plus ``MESH_PEAK_SLACK``) of its argument + temp
   bytes (``mesh_hold_dry``).  None of the five kernels may
   launch, in the parent or a rank.  With moonshot and qwen2-1.5b only the
   leg took 103.9 s inside the script on an H100, most of it gloo moving
   the dense leaves and their gradients through the host.

Every leg prints its ``torch path:`` line — per key range for the split
leg — and checks the path each run took against ``choose_path``: a dense
run launches no hop kernel but ``segment_reduce`` (its MIN/MAX), a
sparse one does.

The last three lines of standard output are the card's name and power
limit, one JSON object of per-kernel numbers (with each kernel's launches
in every leg, the maintain leg's refreshes summed under ``maintain``),
and ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import cProfile
import gc
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2  # float32 instructions (an FMA counts 2 operations)
# 32-bit logic and float32 min/max: 64 a clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132 SMs
# x 1.98 GHz boost clock
LOGIC_OPS_PER_S = 64 * 132 * 1.98e9
SPIN_CYCLES = 100_000_000  # about 50 ms at the H100's 1.98 GHz boost clock

KERNEL_SOURCES = {
    "segment_sum": ("src/repro_torch/csrc/segment_sum.cu", "src/repro/kernels/segment_sum.py:27"),
    "coo_spmm": ("src/repro_torch/csrc/coo_spmm.cu", "src/repro/kernels/coo_spmm.py:35"),
    "segment_reduce": ("src/repro_torch/csrc/segment_reduce.cu", "src/repro/kernels/segment_reduce.py:36"),
    "fused_hop": ("src/repro_torch/csrc/fused_hop.cu", "src/repro/kernels/fused_hop.py:92"),
    "semiring_matmul": ("src/repro_torch/csrc/semiring_matmul.cu", "src/repro/kernels/semiring_matmul.py:29"),
}
UNFUSED_KERNELS = ("segment_sum", "coo_spmm", "segment_reduce")
SEGMENT_KERNELS = ("segment_sum", "segment_reduce")


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def say(tag: str, msg: str) -> None:
    print(f"{msg} [{tag}]", flush=True)


# ----------------------------------------------------------------------
# measurement helpers
# ----------------------------------------------------------------------


def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after two warm-up calls.  The timed launches queue behind a device-side
    spin of about 50 ms, so the host's time to enqueue them is not counted
    unless ``fn`` itself waits for the device."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(torch, a, b) -> float:
    """Largest |a - b|; equal infinities count as no error, a shape or
    infinity mismatch as an infinite one."""
    if a.shape != b.shape:
        return float("inf")
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    return float((a[~same] - b[~same]).abs().max())


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# main path
# ----------------------------------------------------------------------


def chain_db(n: int, seed: int):
    """Synthetic chain C1 at ``n`` rows per relation, plus an integer
    measure column ``m`` on R3 in [0, 100)."""
    import numpy as np

    from repro_torch.data import synth
    from repro_torch.relational.relation import Database

    db, _ = synth.chain("C1", n, seed=seed)
    cols = {r: dict(db[r].columns) for r in ("R1", "R2", "R3", "R4")}
    cols["R3"]["m"] = np.random.default_rng(seed + 1).integers(0, 100, n)
    return Database.from_mapping(cols), cols


def chain_totals(cols) -> tuple[int, int]:
    """Σ COUNT and Σ SUM(R3.m) over the chain join, counted in numpy
    without the port: path counts propagated R4 -> R1 by bincount."""
    import numpy as np

    dom = 1 + max(int(cols[r][a].max()) for r, a in (
        ("R1", "p0"), ("R2", "p0"), ("R2", "p1"), ("R3", "p1"),
        ("R3", "p2"), ("R4", "p2"),
    ))
    c4 = np.bincount(cols["R4"]["p2"], minlength=dom).astype(np.float64)
    w3 = np.bincount(cols["R3"]["p1"], weights=c4[cols["R3"]["p2"]], minlength=dom)
    s3 = np.bincount(
        cols["R3"]["p1"],
        weights=cols["R3"]["m"] * c4[cols["R3"]["p2"]],
        minlength=dom,
    )
    w2 = np.bincount(cols["R2"]["p0"], weights=w3[cols["R2"]["p1"]], minlength=dom)
    s2 = np.bincount(cols["R2"]["p0"], weights=s3[cols["R2"]["p1"]], minlength=dom)
    return int(w2[cols["R1"]["p0"]].sum()), int(s2[cols["R1"]["p0"]].sum())


def bundle_query(engine):
    from repro_torch.api import Avg, Count, Max, Min, Q, Sum

    return (
        Q.over("R1", "R2", "R3", "R4")
        .group_by("R1.g1", "R4.g2")
        .agg(n=Count(), s=Sum("R3.m"), a=Avg("R3.m"), lo=Min("R3.m"), hi=Max("R3.m"))
        .engine(engine)
    )


def idle_share(torch, run, cpu: bool = True) -> tuple[float, float, list[tuple[str, float, int]]]:
    """Run ``run()`` under torch.profiler; return (wall s, device-busy s,
    top device ops by time).  Busy time is the union of the intervals of
    all device events (kernels and copies).  ``cpu=False`` traces the
    device alone, for runs whose host threads issue too many ops to
    trace cheaply."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = []
    by_name: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        lo, hi = ev.time_range.start, ev.time_range.end
        spans.append((lo, hi))
        acc = by_name.setdefault(ev.name, [0.0, 0])
        acc[0] += (hi - lo) / 1e3
        acc[1] += 1
    spans.sort()
    busy_us, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in spans:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy_us += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy_us += cur_hi - cur_lo
    top = sorted(
        ((name, ms, cnt) for name, (ms, cnt) in by_name.items()),
        key=lambda t: -t[1],
    )[:16]
    return wall, busy_us / 1e6, top


def _numel(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_numel(v) for v in x)
    return x.numel() if hasattr(x, "numel") else 0


class Launch(NamedTuple):
    args: tuple
    kw: dict  # without ``out``
    offset: int  # floats from ``out``'s start back to a 16-byte boundary
    count: int  # launches with this key in the run
    size: int  # elements read and written


def capture_launches(run, key_of, modules=()) -> dict:
    """Run ``run()`` with the engine's kernel wrappers wrapped (those
    that ``torch_engine`` and ``modules`` call), keeping for each key
    ``key_of(name, args, kwargs)`` (None: not kept) the largest launch
    (by elements read and written) and the number of launches.  This run
    is outside any counted or timed one."""
    from repro_torch.core import torch_engine

    largest: dict = {}
    counts: dict = {}
    names = UNFUSED_KERNELS + ("fused_hop",)
    originals = {
        (mod, name): getattr(mod, name)
        for mod in (torch_engine, *modules) for name in names if hasattr(mod, name)
    }

    def wrap(name, fn):
        def capturing(*args, **kwargs):
            out = fn(*args, **kwargs)
            key = key_of(name, args, kwargs)
            if key is None:
                return out
            counts[key] = counts.get(key, 0) + 1
            size = out.numel() + _numel(args)
            if key not in largest or size > largest[key][0]:
                kw = {k: v for k, v in kwargs.items() if k != "out"}
                dst = kwargs.get("out")
                offset = 0 if dst is None else (dst.data_ptr() // 4) % 4
                largest[key] = (size, args, kw, offset)
            return out

        return capturing

    for (mod, name), fn in originals.items():
        setattr(mod, name, wrap(name, fn))
    try:
        run()
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    return {
        key: Launch(args, kw, offset, counts[key], size)
        for key, (size, args, kw, offset) in largest.items()
    }


def main_path_key(name, args, kwargs):
    """``segment_sum`` and ``segment_reduce`` launches by row width (the
    leaf hops are narrow, the edge chunks of general hops wide);
    ``coo_spmm`` by name."""
    if name in SEGMENT_KERNELS:
        return name, args[0].shape[1]
    return name if name in UNFUSED_KERNELS else None


def hop_class(name, args, kwargs):
    """A fused_hop launch's class: (kind, children, channel-uniform
    weights); the other kernels are not kept."""
    if name != "fused_hop":
        return None
    keys, w, msgs, idxs, num_segments, k, kind = args
    return kind, len(msgs), bool((w == w[:, :1]).all())


# ----------------------------------------------------------------------
# kernels vs plain versions
# ----------------------------------------------------------------------


def compare(torch, tag, name, label, kernel, plain, args, kw=None, out=None, tol=None):
    """Run ``kernel`` and ``plain`` on the same inputs; fail unless they
    agree exactly, or, with ``tol`` (a tensor of the result's shape),
    within ``tol`` element by element.  With ``out`` (a view into a
    larger buffer), the kernel writes there and must leave the rest of
    the buffer as it was.  Returns max |kernel - plain|."""
    kw = kw or {}
    if out is None:
        got = kernel(*args, **kw)
    else:
        buf = out._base
        before = buf.clone()
        got = kernel(*args, **kw, out=out)
        check(got is out, f"{name} [{label}] did not return its out argument")
        inside = torch.zeros(buf.shape, dtype=torch.bool, device=buf.device)
        inside.view(-1)[out.storage_offset() - buf.storage_offset():][: out.numel()] = True
        check(bool((buf == before)[~inside].all()),
              f"{name} [{label}] wrote outside its out slice")
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)

    def shape(a):
        if isinstance(a, (list, tuple)):
            return [shape(v) for v in a] if len(a) <= 4 else f"{len(a)} x {shape(a[0])}"
        return tuple(a.shape) if hasattr(a, "shape") else a

    where = "" if out is None else f", out at float offset {out.storage_offset()}"
    within = err == 0.0 if tol is None else bool(((got - want).abs() <= tol).all())
    stated = "0" if tol is None else f"elementwise, largest {float(tol.max()):.6g}"
    say(tag, f"kernels: {name} [{label}] args {[shape(a) for a in args]} {kw}{where}: "
             f"max |kernel - plain| = {err} (tolerance {stated}): {within}")
    check(within, f"{name} [{label}] disagrees with its plain version: {err}")
    return err


def out_view(torch, rows: int, d: int, offset: int, dev, fill: float = 7777.0):
    """A contiguous ``(rows, d)`` float32 view starting ``offset`` floats
    into a buffer filled with ``fill``: what ``out[k_lo:k_hi]`` of a larger
    output looks like to a kernel."""
    buf = torch.full((rows * d + offset + 5,), fill, device=dev)
    return buf[offset: offset + rows * d].view(rows, d)


class SegCase(NamedTuple):
    label: str
    data: object
    ids: object
    num_segments: int
    out_rows: int | None  # out= slice this many rows into a larger output


def kernel_cases(torch, dev):
    """Edge cases per kernel, integer-valued float32.  Segment kernels:
    empty input, ids out of range on both ends, one segment, a segment
    count that is a multiple of nothing, all-empty segments (narrow and
    wide); widths 1, 2, 3, 5, 33, 2250, 4097 and 4500; ``out=`` slices at
    odd row offsets (not 16-byte aligned) and input rows that are a slice
    too; many tiles with empty tiles between runs; a run longer than a
    tile, than a marking batch and than the unroll; runs across tile and
    column-slab boundaries; thousands of tiles."""
    g = torch.Generator(device="cpu").manual_seed(7)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)

    def sorted_ids(n, lo, hi):
        return torch.sort(ints(lo, hi, (n,))).values.contiguous()

    def data(n, d, skip=0):
        return ints(-50, 50, (n + skip, d)).float()[skip:]

    seg = []
    for n, d, s, id_lo, id_hi, out_rows in [
        (0, 4, 5, 0, 5, None),  # empty input
        (300, 1, 17, -4, 21, None),  # out of range on both ends, width 1
        (257, 33, 1, 0, 1, None),  # one segment, width 33
        (1000, 33, 97, -2, 100, None),  # 97 segments, width 33
        (40, 3, 11, 11, 20, None),  # every id out of range: all segments empty
        (300, 1, 17, -4, 21, 3),
        (500, 2, 50, 0, 50, 1),
        (500, 3, 50, -1, 52, 5),
        (700, 5, 61, 0, 61, 7),
        (2000, 2250, 150, -2, 152, 1),  # slabs of 752, 8-byte aligned out
        (1200, 4500, 300, -3, 305, None),  # slabs of 900, 16-byte vectors
        (1500, 4500, 97, 0, 97, 3),
        (3000, 4097, 20, 0, 20, 1),  # odd width: one column per thread
        (500, 2250, 30, 30, 60, 1),  # every id out of range, wide
        (50_000, 1, 9000, 0, 9000, None),  # dense runs across two tiles
        (100_000, 1, 30_000_000, 0, 30_000_000, None),  # 1,832 narrow tiles
        (3000, 4500, 1000, 0, 1000, None),  # 2,500 tiles x slabs
    ]:
        seg.append(SegCase(f"n={n} d={d} s={s} ids [{id_lo}, {id_hi})",
                           data(n, d), sorted_ids(n, id_lo, id_hi), s, out_rows))
    # input rows that are themselves a slice (8-byte aligned rows at d=2250)
    seg.append(SegCase("data rows sliced, d=2250", data(800, 2250, skip=1),
                       sorted_ids(800, 0, 90), 90, None))
    # three clusters of ids in 100,000 segments: tiles of 8,192 empty rows
    for d, out_rows in ((1, None), (2, 1)):
        centers = torch.tensor([5, 70_000, 99_999], device=dev)
        ids = torch.sort(centers[ints(0, 3, (4000,))] + ints(-2, 1, (4000,))).values
        seg.append(SegCase(f"clustered ids, 100000 segments, d={d}", data(4000, d),
                           ids.clamp(0, 99_999).contiguous(), 100_000, out_rows))
    # one run longer than a narrow tile's rows, a marking batch and the unroll
    for d, n in ((1, 20_000), (2250, 3000)):
        ids = torch.cat([torch.full((n,), 3, device=dev), sorted_ids(97, 0, 20)])
        seg.append(SegCase(f"one run of {n} edges, d={d}", data(n + 97, d),
                           torch.sort(ids).values.contiguous(), 20, 2))
    spmm = []
    for nnz, k, w, s, r_lo, r_hi, c_lo, c_hi in [
        (0, 6, 5, 4, 0, 4, 0, 6),
        (500, 30, 1, 13, -3, 16, -2, 32),  # rows and cols out of range
        (200, 9, 33, 1, 0, 1, 0, 9),
        (2000, 50, 33, 97, 0, 97, 0, 50),
    ]:
        rows = sorted_ids(nnz, r_lo, r_hi)
        cols = ints(c_lo, c_hi, (nnz,))
        vals = ints(1, 9, (nnz,)).float()
        dense = data(k, w)
        spmm.append(((rows, cols, vals, dense, s), {}))
    return seg, spmm


def gather_cases(torch, dev):
    """Edge cases of the slab-major warp walk (``csrc/gathered_rows.cuh``)
    that ``coo_spmm`` and one-child ``fused_hop`` hops of width >= 32 run
    on, as (label, kernel name, args, out offset or None): d % 4 != 0,
    d below the slab width and one past it, mostly empty rows, one run of
    thousands of edges, operand rows out of range, ±inf child rows for
    MIN/MAX, and operand and output pointers 4 or 8 bytes past a 16-byte
    boundary (scalar and 8-byte lanes).  Integer-valued float32."""
    from repro_torch.kernels import ops

    g = torch.Generator(device="cpu").manual_seed(17)
    slab = ops.GATHER_SLAB

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)

    def operand(rows, d, offset, lo=-3, hi=4):
        """(rows, d) integers starting ``offset`` floats into a buffer."""
        buf = ints(lo, hi, (rows * d + offset,)).float()
        return buf[offset:].view(rows, d)

    cases = []
    for n, s, rows, d, offset, key_lo, key_hi, label in [
        (20_000, 300, 500, 4500, 0, 0, 300, "d=4500"),
        (5000, 97, 200, 130, 0, 0, 97, "d % 4 != 0"),
        (4000, 60, 90, slab - 28, 0, 0, 60, "d < slab width"),
        (4000, 60, 90, slab + 1, 0, -3, 63, "d = slab width + 1, keys out of range"),
        (600, 30_000, 90, 256, 0, 0, 30_000, "mostly empty rows"),
        (5000, 97, 200, 512, 1, 0, 97, "pointers 4 bytes past 16"),
        (5000, 97, 200, 512, 2, 0, 97, "pointers 8 bytes past 16"),
    ]:
        keys = torch.sort(ints(key_lo, key_hi, (n,))).values.contiguous()
        cols = ints(-2, rows + 2, (n,))  # some out of range
        vals = ints(1, 9, (n,)).float()
        cases.append((f"gather walk, {label}", "coo_spmm",
                      (keys, cols, vals, operand(rows, d, offset), s), offset))
        for kind, k in (("sum", 1), ("sum", 2), ("sum", 3), ("min", 1), ("max", 1)):
            dk = d - d % k
            w = ints(0, 4 if kind == "sum" else 50, (n, k)).float()
            msg = operand(rows, dk, offset)
            if kind != "sum":
                msg[ints(0, rows, (5,))] = float("inf" if kind == "min" else "-inf")
            cases.append((f"gather walk, {label}, {kind} k={k}", "fused_hop",
                          (keys, w, [msg], [cols], s, k, kind), offset))
    long = torch.sort(torch.cat([torch.full((6000,), 2, device=dev), ints(0, 9, (50,))])).values
    cols = ints(-1, 41, (long.shape[0],))
    cases.append(("gather walk, one run of 6000 edges", "coo_spmm",
                  (long.contiguous(), cols, ints(1, 3, cols.shape).float(),
                   operand(40, 300, 0, -1, 2), 9), 0))
    for kind in ("sum", "min", "max"):
        cases.append((f"gather walk, one run of 6000 edges, {kind}", "fused_hop",
                      (long.contiguous(), ints(0, 3, (cols.shape[0], 1)).float(),
                       [operand(40, 300, 0, -1, 2)], [cols], 9, 1, kind), 0))
    return cases


def gather_phase(torch, tag) -> dict[str, list[float]]:
    """``coo_spmm`` and ``fused_hop`` on the slab-major warp walk's edge
    cases against their plain versions, ``out=`` at the case's alignment;
    returns each kernel's errors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.coo_spmm import coo_spmm
    from repro_torch.kernels.fused_hop import fused_hop

    dev = torch.device("cuda")
    kernels = {"coo_spmm": (coo_spmm, ref.coo_spmm), "fused_hop": (fused_hop, ref.fused_hop)}
    errs = {name: [] for name in kernels}
    for label, name, args, offset in gather_cases(torch, dev):
        kernel, plain = kernels[name]
        s = args[4]
        d = args[3].shape[1] if name == "coo_spmm" else args[2][0].shape[1]
        errs[name].append(compare(torch, tag, name, label, kernel, plain, args,
                                  out=out_view(torch, s, d, offset, dev)))
    return errs


def segment_regime(torch, tag, name, label, launch, path="main path"):
    """One captured ``segment_sum`` / ``segment_reduce`` launch: held
    against its plain version with ``out=`` at the launch's own alignment,
    and timed beside the plain version, the library call and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.segment_sum import segment_sum

    dev = torch.device("cuda")
    data, ids, s = launch.args[:3]
    n, d = data.shape
    kind = launch.kw.get("kind")
    out = out_view(torch, s, d, launch.offset, dev)
    if name == "segment_sum":
        args = (data, ids, s)
        kernel, plain = segment_sum, ref.segment_sum

        def library():
            return torch.zeros((s, d), device=dev).index_add_(0, ids, data)
    else:
        args = (data, ids, s, kind)
        kernel, plain = segment_reduce, ref.segment_reduce
        red = "amin" if kind == "min" else "amax"
        ident = float("inf") if kind == "min" else float("-inf")
        index = ids[:, None].expand(n, d)

        def library():
            return torch.full((s, d), ident, device=dev).scatter_reduce_(
                0, index, data, red, include_self=True
            )
    err = compare(torch, tag, name, f"{path}, {label}", kernel, plain, args, out=out)
    b, by = bound(n * d * 4 + n * 8 + s * d * 4, n * d)
    row = dict(
        shapes={"data": [n, d], "segment_ids": [n], "num_segments": s,
                **({"kind": kind} if kind else {})},
        launches=launch.count, out_offset=launch.offset, max_abs_err=err,
        ms=time_ms(torch, lambda: kernel(*args, out=out)),
        plain_ms=time_ms(torch, lambda: plain(*args)),
        library_ms=time_ms(torch, library),
        bound_ms=b, bound_by=by,
    )
    say(tag, f"kernels: {name} [{label}] at {row['shapes']}, out offset "
             f"{launch.offset}, {launch.count} launches of this width: "
             f"{row['ms']:.4f} ms, bound {b:.4f} ms by {by}, plain "
             f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms")
    return row


def kernel_phase(torch, tag, captured):
    """The three kernels of the unfused main path on edge cases and at
    their largest launch; ``segment_sum`` and ``segment_reduce`` also at
    the largest launch of their widest rows (the edge-chunk shape)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coo_spmm import coo_spmm
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.segment_sum import segment_sum

    dev = torch.device("cuda")
    seg_cases, spmm_cases = kernel_cases(torch, dev)
    results = {}

    # --- segment_sum and segment_reduce ---------------------------------
    for name in SEGMENT_KERNELS:
        errs = []
        for case in seg_cases:
            kinds = (None,) if name == "segment_sum" else ("min", "max")
            for kd in kinds:
                args = (case.data, case.ids, case.num_segments) + ((kd,) if kd else ())
                out = None if case.out_rows is None else out_view(
                    torch, case.num_segments + case.out_rows, case.data.shape[1], 0, dev
                )[case.out_rows:]
                kernel, plain = ((segment_sum, ref.segment_sum) if kd is None
                                 else (segment_reduce, ref.segment_reduce))
                errs.append(compare(torch, tag, name, f"edge {case.label} {kd or ''}",
                                    kernel, plain, args, out=out))
        launches = {key[1]: lc for key, lc in captured.items()
                    if isinstance(key, tuple) and key[0] == name}
        leaf = max(launches.values(), key=lambda lc: lc.size)
        chunk = launches[max(launches)]
        regimes = {"leaf": segment_regime(torch, tag, name, "largest launch", leaf),
                   "chunk": segment_regime(torch, tag, name, "widest rows", chunk)}
        row = dict(regimes["leaf"])
        row.update(
            max_abs_err=max(errs + [r["max_abs_err"] for r in regimes.values()]),
            regimes=regimes,
            launches_by_width={str(d): lc.count for d, lc in sorted(launches.items())},
        )
        results[name] = row

    # --- coo_spmm ------------------------------------------------------
    args = captured["coo_spmm"].args
    rows, cols, vals, dense, s = args
    errs = [compare(torch, tag, "coo_spmm", "main path", coo_spmm, ref.coo_spmm, args)]
    for a, k in spmm_cases:
        errs.append(compare(torch, tag, "coo_spmm", "edge", coo_spmm, ref.coo_spmm,
                            a, k))
    nnz = rows.shape[0]
    kdense, w = dense.shape
    used = int(torch.unique(cols).numel())
    b, by = bound(nnz * 20 + used * w * 4 + s * w * 4, 2 * nnz * w)
    results["coo_spmm"] = dict(
        shapes={"rows": [nnz], "dense": [kdense, w], "num_rows": s,
                "dense_rows_used": used},
        walk=repr(ops.gather_plan(nnz, s, w)),
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: coo_spmm(rows, cols, vals, dense, s)),
        plain_ms=time_ms(torch, lambda: ref.coo_spmm(rows, cols, vals, dense, s), reps=3),
        library_ms=csr_spmm_ms(torch, rows, cols, vals, dense, s),
        bound_ms=b, bound_by=by,
    )
    r = results["coo_spmm"]
    say(tag, f"kernels: coo_spmm [main path] at {r['shapes']}: {r['ms']:.4f} ms, bound "
             f"{b:.4f} ms by {by}, plain {r['plain_ms']:.4f} ms, library torch.sparse.mm "
             f"{r['library_ms']:.4f} ms; {r['walk']}")
    return results


def csr_spmm_ms(torch, rows, cols, vals, dense, num_rows) -> float:
    """Time of ``torch.sparse.mm`` with the (rows, cols, vals) matrix in
    CSR form, built outside the timed calls."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mat = torch.sparse_coo_tensor(
            torch.stack([rows, cols]), vals, (num_rows, dense.shape[0])
        ).coalesce().to_sparse_csr()
        return time_ms(torch, lambda: torch.sparse.mm(mat, dense))


def fused_hop_cases(torch, dev):
    """Edge cases of ``fused_hop`` as (label, args): zero edges, one
    segment, leaf hops, two, three, five and 64 children, ±inf child rows
    for min/max, an output row wider than one 4096-float tile, a key run
    of 5000 edges, keys and child indices out of range.  Integer-valued
    float32 whose products and sums stay below 2**24."""
    g = torch.Generator(device="cpu").manual_seed(11)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)

    def hop(n, s, k, kind, widths, rows=9, lo=-3, hi=4, inf_rows=0, key_lo=0,
            key_hi=None, idx_hi=None):
        keys = torch.sort(ints(key_lo, s if key_hi is None else key_hi, (n,))).values
        w = ints(0, 4 if kind == "sum" else 50, (n, k)).float()
        msgs, idxs = [], []
        for wc in widths:
            msg = ints(lo, hi, (rows, wc * k)).float()
            if inf_rows:
                msg[ints(0, rows, (inf_rows,))] = float("inf" if kind == "min" else "-inf")
            msgs.append(msg.contiguous())
            idxs.append(ints(0, rows if idx_hi is None else idx_hi, (n,)))
        return (keys.contiguous(), w, msgs, idxs, s, k, kind)

    cases = []
    for kind, k in (("sum", 2), ("min", 1), ("max", 1)):
        cases += [
            (f"{kind} zero edges", hop(0, 5, k, kind, (2, 3))),
            (f"{kind} one segment", hop(400, 1, k, kind, (4,))),
            (f"{kind} leaf", hop(1000, 37, k, kind, ())),
            (f"{kind} two children", hop(1000, 37, k, kind, (3, 5))),
            (f"{kind} three children", hop(1000, 37, k, kind, (2, 3, 4))),
            (f"{kind} five children", hop(500, 13, k, kind, (2, 1, 3, 2, 2), lo=-1, hi=2)),
            (f"{kind} 64 children", hop(300, 7, k, kind, (1,) * 64, lo=-1, hi=2)),
            (f"{kind} row of 5600 floats", hop(600, 5, k, kind, (70, 80 // k))),
            (f"{kind} one run of 5000 edges", hop(5000, 1, k, kind, (33,), lo=-1, hi=2)),
            (f"{kind} keys and indices out of range",
             hop(800, 19, k, kind, (3, 2), key_lo=-3, key_hi=23, idx_hi=11)),
        ]
    for kind in ("min", "max"):
        cases.append((f"{kind} ±inf child rows", hop(1000, 37, 1, kind, (3, 4), inf_rows=4)))
    return cases


def fused_library(torch, args, uniform: bool):
    """The one PyTorch call that computes a ``fused_hop`` launch, by hop
    class, and its time: ``index_add_`` for a leaf sum, ``scatter_reduce_``
    for a leaf min/max, a CSR ``torch.sparse.mm`` for a single-child
    channel-uniform sum; ``(None, None)`` where no one call does."""
    keys, w, msgs, idxs, s, k, kind = args
    dev = keys.device
    if not msgs and kind == "sum":
        return "index_add_", time_ms(
            torch, lambda: torch.zeros((s, k), device=dev).index_add_(0, keys, w))
    if not msgs:
        ident = float("inf") if kind == "min" else float("-inf")
        return f"scatter_reduce_ a{kind}", time_ms(
            torch, lambda: torch.full((s, 1), ident, device=dev).scatter_reduce_(
                0, keys[:, None], w, f"a{kind}", include_self=True))
    if len(msgs) == 1 and kind == "sum" and uniform:
        return "torch.sparse.mm, CSR", csr_spmm_ms(
            torch, keys, idxs[0], w[:, 0].contiguous(), msgs[0], s)
    return None, None


def fused_phase(torch, tag, captured):
    """``fused_hop`` against its plain version at the largest launch of
    each hop class of the fused path and on edge cases; each class timed
    beside its three-dispatch counterpart.  The JSON row is the
    single-child channel-uniform sum hop, the hop ``coo_spmm`` runs on
    the unfused path, where ``torch.sparse.mm`` computes the same."""
    from repro_torch.core import torch_engine
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_hop import fused_hop, gathers_one_child

    dev = torch.device("cuda")
    errs = []
    for label, args in fused_hop_cases(torch, dev):
        errs.append(compare(torch, tag, "fused_hop", label, fused_hop, ref.fused_hop, args))
    hops = []
    for (kind, nchild, uniform), launch in sorted(captured.items()):
        args = launch.args
        keys, w, msgs, idxs, s, k, _ = args
        label = f"main path {kind}, {nchild} children, uniform={uniform}"
        errs.append(compare(torch, tag, "fused_hop", label, fused_hop, ref.fused_hop, args))
        n = keys.shape[0]
        width = 1
        nbytes = n * 8 + n * k * 4
        for msg, idx in zip(msgs, idxs):
            width *= msg.shape[1] // k
            used = int(torch.unique(idx).numel())
            nbytes += n * 8 + used * msg.shape[1] * 4
        nbytes += s * width * k * 4
        b, by = bound(nbytes, n * width * k * (nchild + 1))
        keys_host = keys.cpu().numpy()
        gathers = [(m.view(m.shape[0], -1, k), i) for m, i in zip(msgs, idxs)]
        library, library_ms = fused_library(torch, args, uniform)
        hop = dict(
            kind=kind, children=nchild, uniform=uniform,
            shapes={"edges": n, "k": k, "num_segments": s,
                    "messages": [list(m.shape) for m in msgs]},
            walk=repr(ops.gather_plan(n, s, width * k) if gathers_one_child(nchild, width * k)
                      else ops.walk_plan(n, s, width * k)),
            ms=time_ms(torch, lambda: fused_hop(*args)),
            three_dispatch_ms=time_ms(
                torch,
                lambda: torch_engine.contract_hop(
                    keys, keys_host, w, gathers, s, kind, False, uniform
                ),
                reps=3,
            ),
            plain_ms=time_ms(torch, lambda: ref.fused_hop(*args), reps=3),
            library=library, library_ms=library_ms, bound_ms=b, bound_by=by,
        )
        hops.append(hop)
        say(tag, f"kernels: fused_hop [{label}] at {hop['shapes']}: {hop['ms']:.4f} ms, "
                 f"three-dispatch {hop['three_dispatch_ms']:.4f} ms, bound "
                 f"{b:.4f} ms by {by}, plain {hop['plain_ms']:.4f} ms, library "
                 f"{library} {library_ms if library_ms is None else f'{library_ms:.4f}'} ms; "
                 f"{hop['walk']}")
    check(hops, "no fused_hop launch captured")
    for kind in ("sum", "min", "max"):
        check(any(h["kind"] == kind for h in hops), f"fused path ran no {kind} hop")
    check(any(h["kind"] == "sum" and h["shapes"]["k"] > 1 for h in hops),
          "fused path ran no sum hop with k > 1")
    row = max(
        (h for h in hops if h["kind"] == "sum"),
        key=lambda h: (h["children"] == 1 and h["uniform"], h["ms"]),
    )
    return dict(row, max_abs_err=max(errs), hops=hops)


def semiring_floor(semiring: str, m: int, kd: int, n: int) -> float:
    """ms of the instructions the tile loop must issue for one launch:
    ``add_mul`` one FMA per step, the tropical semirings an add and a
    max/min per step, ``or_and`` one logic operation per packed word."""
    if semiring == "or_and":
        return -(-kd // 32) * m * n / LOGIC_OPS_PER_S * 1e3
    steps = m * kd * n * (1 if semiring == "add_mul" else 2)
    return steps / FP32_INSTR_PER_S * 1e3


def semiring_bound(semiring: str, m: int, kd: int, n: int) -> tuple[float, str]:
    """Bytes (A and B read once, C written once) against the operations:
    2 m kd n float32 operations, or for ``or_and`` one 32-bit logic
    operation per word of 32 packed values of k."""
    nbytes = (m * kd + kd * n + m * n) * 4
    if semiring != "or_and":
        return bound(nbytes, 2 * m * kd * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = semiring_floor(semiring, m, kd, n)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def semiring_phase(torch, tag, size: int = 2048):
    """``semiring_matmul`` against its plain version for every semiring,
    tolerance 0: at (size, size) x (size, size) on small integers and on
    fractional values, at (3000, 1000) x (1000, 2500) fractional, on ragged
    shapes with ±inf entries, with ±inf only in the last values of k, and
    with operands 4 and 8 bytes off 16-byte alignment; timed beside
    ``torch.matmul`` in full float32 (TF32 off) for ``add_mul``, with each
    semiring's bound and instruction floor."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.semiring_matmul import SEMIRINGS, semiring_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(13)

    def ints(shape, infs=0.0):
        x = torch.randint(-3, 4, shape, generator=g).float()
        if infs:
            pick = torch.rand(shape, generator=g)
            x[pick < infs / 2] = float("inf")
            x[(pick >= infs / 2) & (pick < infs)] = float("-inf")
        return x.to(dev)

    def fractions(shape, offset=0):
        """Normal floats; ``offset`` floats into a larger buffer."""
        buf = torch.randn(offset + shape[0] * shape[1], generator=g).to(dev)
        return buf[offset:].view(shape)

    def tail_infs(m, kd, n, last=5):
        a, b = fractions((m, kd)), fractions((kd, n))
        for x in (a[:, -last:], b[-last:]):
            pick = torch.rand(x.shape, generator=g).to(dev)
            x[pick < 0.25] = float("inf")
            x[(pick >= 0.25) & (pick < 0.5)] = float("-inf")
        return a, b

    errs = []

    def hold(semiring, label, a, b):
        plan = ops.matmul_plan(a.shape[0], b.shape[1], a.shape[1], semiring,
                               align=ops.alignment(a, b))
        errs.append(compare(torch, tag, "semiring_matmul", f"{semiring} {label}, vec "
                            f"{plan.vec}", semiring_matmul, ref.semiring_matmul,
                            (a, b, semiring)))

    a, b = ints((size, size)), ints((size, size))
    fa, fb = fractions((size, size)), fractions((size, size))
    ra, rb = fractions((3000, 1000)), fractions((1000, 2500))
    for semiring in SEMIRINGS:
        hold(semiring, "main shape", a, b)
        hold(semiring, "main shape, fractional", fa, fb)
        hold(semiring, "rectangular, fractional", ra, rb)
        for m, kd, n, infs in [(65, 33, 129, 0.0), (1, 1, 1, 0.0), (100, 0, 7, 0.0),
                               (3, 1000, 5, 0.0), (130, 70, 66, 0.1)]:
            hold(semiring, f"ragged, inf share {infs}", ints((m, kd), infs),
                 ints((kd, n), infs))
        hold(semiring, "ragged, ±inf in the last 5 values of k", *tail_infs(257, 77, 263))
        for offset in (1, 2):
            hold(semiring, f"operands {4 * offset} bytes off 16-byte alignment",
                 fractions((256, 512), offset), fractions((512, 384), offset))
    times = {}
    for semiring in SEMIRINGS:
        b_ms, by = semiring_bound(semiring, size, size, size)
        times[semiring] = dict(
            ms=time_ms(torch, lambda: semiring_matmul(a, b, semiring)),
            plain_ms=time_ms(torch, lambda: ref.semiring_matmul(a, b, semiring), reps=2),
            bound_ms=b_ms, bound_by=by, floor_ms=semiring_floor(semiring, size, size, size),
            library_ms=time_ms(torch, lambda: torch.matmul(a, b)) if semiring == "add_mul" else None,
            plan=repr(ops.matmul_plan(size, size, size, semiring, align=ops.alignment(a, b))),
        )
    for semiring, t in times.items():
        say(tag, f"kernels: semiring_matmul {semiring} at ({size}, {size}) x ({size}, "
                 f"{size}): {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                 f"{t['bound_ms']:.4f} ms by {t['bound_by']}, instruction floor "
                 f"{t['floor_ms']:.4f} ms, {t['plan']}")
    say(tag, f"kernels: semiring_matmul library torch.matmul (float32, TF32 off) "
             f"{times['add_mul']['library_ms']:.4f} ms")
    main = times["add_mul"]
    return dict(
        shapes={"a": [size, size], "b": [size, size], "semiring": "add_mul"},
        max_abs_err=max(errs), ms=main["ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        semirings=times,
    )


# ----------------------------------------------------------------------
# the two paths
# ----------------------------------------------------------------------


def drive(torch, tag, label, make_plan):
    """Plan, then execute cold and warm with the launch counts set to 0
    just before the cold execute and read just after; print the times,
    peak device memory, warm split, host profile and device idle share."""
    from repro_torch.api import plan as plan_mod
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    plan = make_plan()
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    stream = plan.resolved_stream()
    say(tag, f"{label}: {plan}; fused={plan.fused}; statistics {plan.stats_enabled}; "
             f"prepare {prepare_s:.3f} s; est peak message {plan.message_peak} B, "
             f"est peak {plan.est_peak} B; stream tile {stream}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = plan.execute()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    say(tag, f"{label}: cold execute {cold_s:.3f} s, launches {launches}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = plan.execute()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    say(tag, f"{label}: warm execute {warm_s:.3f} s, result rows "
             f"{res.num_rows}, peak device memory {peak} B ({peak - resident} B "
             f"above the {resident} B allocated before planning)")

    t0 = time.perf_counter()
    outputs = plan.outputs()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_mod._assemble(plan, outputs)
    assemble_s = time.perf_counter() - t0
    say(tag, f"{label}: warm split: engine.run {run_s:.3f} s, assemble "
             f"{assemble_s:.3f} s")

    host = cProfile.Profile()
    host.enable()
    plan.execute()
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host)
    say(tag, f"host profile: {label}, warm execute, {stats.total_tt:.3f} s of Python "
             "profile time; top functions by own time:")
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    for (file, line, fn), (_, calls, tottime, cumtime, _) in rows:
        say(tag, f"host profile: {tottime * 1e3:9.1f} ms own {cumtime * 1e3:9.1f} ms "
                 f"cum x{calls:<6d} {fn} ({Path(file).name}:{line})")

    wall, busy, top = idle_share(torch, plan.execute)
    say(tag, f"profile: {label}, warm execute {wall:.3f} s wall, device busy "
             f"{busy:.3f} s, idle share {1 - busy / wall:.3f}")
    for name, ms, cnt in top:
        say(tag, f"profile: {ms:10.3f} ms x{cnt:<6d} {name[:140]}")
    summary = {
        "prepare_s": prepare_s, "cold_execute_s": cold_s, "warm_execute_s": warm_s,
        "engine_run_s": run_s, "assemble_s": assemble_s, "rows": res.num_rows,
        "peak_bytes": peak, "peak_above_resident_bytes": peak - resident,
        "est_peak_bytes": plan.est_peak, "stream": stream, "device_busy_s": busy,
        "idle_share": 1 - busy / wall, "launches": launches,
    }
    return plan, res, summary


def same_result(a, b) -> bool:
    import numpy as np

    return list(a.relation.columns) == list(b.relation.columns) and all(
        a.column(c).dtype == b.column(c).dtype and np.array_equal(a.column(c), b.column(c))
        for c in a.relation.columns
    )


HOP_KERNELS = ("segment_sum", "coo_spmm", "fused_hop")


def verified(tag, label, plan) -> None:
    """Fail if ``plan.verify()`` finds any broken invariant.  V-OVERFLOW
    is printed and let pass: it compares a sketch estimate of a subtree's
    join rows with 2**24, and every leg checks its counts against an
    exact count itself (exact below 2**24, ``count_rtol`` above)."""
    diags = plan.verify(strict=False)
    say(tag, f"check: {label}: verify() on {plan}: {len(diags)} finding(s) "
             f"{[str(d) for d in diags]}")
    check(all(d.code == "V-OVERFLOW" for d in diags),
          f"{label}: the plan breaks its invariants")


def run_paths(plan) -> list[tuple[str, object]]:
    """``(label, choose_path's choice)`` for every ``engine.run`` of
    ``plan.execute()``: one, or one per key range of a split plan (no
    budget there, as the JAX package's ``execute_split`` runs them)."""
    from repro_torch.core.torch_engine import choose_path

    cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in plan.channels)
    k = len(plan.channels)
    if plan.split is None:
        runs = [("plan", plan.prep, plan.resolved_stream(), plan.memory_budget)]
    else:
        attr = plan.split.attr
        parts = plan.split_parts()
        runs = [(f"key range {i} of {len(parts)} ({part.dicts[attr].size} keys of {attr})",
                 part, None, None) for i, part in enumerate(parts)]
    return [(label, choose_path(prep, k=k, memory_budget=budget, stream=stream, measured=cm))
            for label, prep, stream, budget in runs]


def check_paths(tag, label, plan, launches) -> list[str]:
    """Print each run's ``torch path:`` line and check, through the
    launches, that the run took ``choose_path``'s path, or the one that
    ``mode=`` or ``.fused(True)`` pins: no hop kernel when every run is
    dense, some when any is sparse.  Returns the paths."""
    mode = plan.engine.mode
    pin = mode if mode != "auto" else ("sparse" if plan.fused is True else None)
    paths = []
    for run, choice in run_paths(plan):
        path = pin or choice.path
        say(tag, f"{label}: {run}: torch path: {choice.path} — {choice.reason}; runs "
                 f"{path}{' (pinned)' if pin else ''}")
        paths.append(path)
    hops = sum(launches[name] for name in HOP_KERNELS)
    if "sparse" in paths:
        check(hops > 0, f"{label}: a sparse run launched no hop kernel")
    else:
        check(hops == 0, f"{label}: a dense run launched hop kernels: {launches}")
    return paths


def hop_shape_of(args, kwargs=None):
    """``(autotune.HopShape, dims)`` of a ``fused_hop`` call with the
    engine's positional arguments, as the engine's ``_fused_contract``
    makes them."""
    import math

    from repro_torch.kernels import autotune

    keys, w, msgs, idxs, s, k, kind = args
    widths = tuple(m.shape[1] // k for m in msgs)
    shape = autotune.hop_shape(keys.shape[0], tuple(m.shape[0] for m in msgs), k=k, kind=kind,
                               child_widths=widths, num_segments=s)
    return shape, (keys.shape[0], s, math.prod(widths) * k)


def check_launch_shapes(torch, tag, label, plan) -> None:
    """Execute a fused plan once to tune any shape not tuned yet, then once
    more with a spy on the engine's ``fused_hop`` calls, and hold what
    they launched against ``explain`` and V-KERN (``plan.fused_runs()`` x
    ``hop_launch_shapes``), pass by pass (per key range, per stream tile,
    MIN/MAX passes): the same route, edges, segments and width, and as
    launch shape the card's tuned plan from ``kernels/autotune.py``'s
    cache (explain shows the model's pick; it prints where they differ)."""
    from repro_torch.core import torch_engine
    from repro_torch.core.torch_engine import hop_launch_shapes
    from repro_torch.kernels import autotune
    from repro_torch.kernels.fused_hop import gathers_one_child

    plan.execute()
    torch.cuda.synchronize()
    made = []
    real = torch_engine.fused_hop

    def spy(*args, plan=None, **kw):
        shape, dims = hop_shape_of(args)
        if dims[1] and dims[2]:
            walk = "gather" if gathers_one_child(len(args[2]), dims[2]) else "tile"
            tuned = autotune.cached_plan_for(shape, args[0].device, dims)
            want = None if tuned is None else bytes(tuned.make(*dims))
            made.append(((walk, *dims), bytes(plan) if plan is not None else None, want))
        return real(*args, plan=plan, **kw)

    torch_engine.fused_hop = spy
    try:
        plan.execute()
        torch.cuda.synchronize()
    finally:
        torch_engine.fused_hop = real
    passes, models = [], []
    for r in plan.fused_runs():
        entries = hop_launch_shapes(r["prep"], r["k"], r["encoded"], r["domains"])
        one = sorted((e["walk"], e["edges"], e["num_segments"], e["width"]) for e in entries)
        passes.extend([one] * r["repeat"])
        models.extend([bytes(e["plan"]) for e in entries] * r["repeat"])
    got, at = [], 0
    for one in passes:
        got.append(sorted(route for route, _, _ in made[at:at + len(one)]))
        at += len(one)
    same = at == len(made) and got == passes
    tuned = all(launched is not None and launched == want for _, launched, want in made)
    off_model = sum(launched not in models for _, launched, _ in made)
    say(tag, f"check: {label}: {len(made)} fused_hop launches in {len(passes)} passes: routes "
             f"and shapes equal fused_runs() x hop_launch_shapes: {same}; each took the card's "
             f"tuned plan: {tuned} ({off_model} of them not the model's pick that explain shows)")
    check(same and made, f"{label}: the launches are not the hops explain prints")
    check(tuned, f"{label}: a launch did not take its tuned plan")


# ----------------------------------------------------------------------
# the split leg and the cyclic leg
# ----------------------------------------------------------------------

CYCLIC_SIZES = {"TRIANGLE": 40_000, "FOURCYCLE": 20_000, "FOFGROUP": 40_000}
CYCLIC_CHECK_N = 4000
F32_UNIT = 2.0 ** -24  # float32 unit roundoff


def skew_total(db) -> int:
    """Σ COUNT of SKEWCHAIN's R1 ⋈ R2 in int64, without the port:
    Σ over p0 of c1[p0] · c2[p0]."""
    import numpy as np

    c1 = np.bincount(db["R1"].columns["p0"]).astype(np.int64)
    c2 = np.bincount(db["R2"].columns["p0"]).astype(np.int64)
    m = min(len(c1), len(c2))
    return int((c1[:m] * c2[:m]).sum())


def cyclic_counts(name: str, db) -> dict:
    """Per-group COUNT of a cyclic catalog query in int64 with
    ``scipy.sparse``, without the port: {group value: count} for every
    group with a nonzero count."""
    import numpy as np
    from scipy import sparse

    def mat(rel, a, b, rows=None, cols=None):
        x, y = db[rel].columns[a], db[rel].columns[b]
        shape = (rows or int(x.max()) + 1, cols or int(y.max()) + 1)
        return sparse.csr_matrix((np.ones(len(x), np.int64), (x, y)), shape=shape)

    if name in ("TRIANGLE", "FOURCYCLE"):
        v = len(db["L"].columns["a"])  # vertex ids are 0 .. v-1
        a1 = mat("E1", "a", "b", v, v)
        a2 = mat("E2", "b", "c", v, v)
        if name == "TRIANGLE":
            per_a = (a1 @ a2).multiply(mat("E3", "c", "a", v, v).T)
            label = "vlabel"
        else:
            back = mat("E3", "c", "d", v, v) @ mat("E4", "d", "a", v, v)
            per_a = (a1 @ a2).multiply(back.T)
            label = "lab"
        per_a = np.asarray(per_a.sum(axis=1)).ravel()
        node, labels = db["L"].columns["a"], db["L"].columns[label]
        out: dict = {}
        for lab, cnt in zip(labels.tolist(), per_a[node].tolist()):
            out[lab] = out.get(lab, 0) + int(cnt)
    else:  # FOFGROUP: diag(G1ᵀ (F1 @ F2) G2)
        people = 1 + max(int(db[r].columns[a].max()) for r, a in (
            ("F1", "u"), ("F1", "v"), ("F2", "v"), ("F2", "w"), ("G1", "u"), ("G2", "w")))
        groups = 1 + max(int(db[r].columns["grp"].max()) for r in ("G1", "G2"))
        f = mat("F1", "u", "v", people, people) @ mat("F2", "v", "w", people, people)
        m = f @ mat("G2", "w", "grp", people, groups)
        per_grp = np.asarray(mat("G1", "u", "grp", people, groups).multiply(m).sum(axis=0)).ravel()
        grp_values = np.arange(groups)
        out = dict(zip(grp_values.tolist(), (int(c) for c in per_grp)))
    return {k: c for k, c in out.items() if c}


def count_rtol(plan) -> float:
    """Relative tolerance of a float32 COUNT against the exact count.  Every
    weight is positive.  A hop rounds each edge weight once, multiplies by
    one gathered value per child (one rounding each) and adds at most the
    relation's edges into a key (one rounding per addition), each rounding
    at most 2**-24 relative; the errors of the hops compound, so their
    counts add to first order: Σ over the decomposition's relations of
    (edges + children + 1) × 2**-24."""
    deco = plan.prep.decomposition
    steps = sum(plan.prep.encoded[r].num_rows + len(deco.nodes[r].children) + 1
                for r in deco.order)
    return steps * F32_UNIT


def split_leg(torch, tag, args) -> dict:
    """SKEWCHAIN at ``--n``: the default plan (statistics on, split on p0)
    and the ``.stats(False)`` plan, driven and compared."""
    import numpy as np

    from repro_torch.api import Q, TorchChannelEngine
    from repro_torch.data.queries import skewed_chain_like
    from repro_torch.kernels import ops

    db, q = skewed_chain_like(args.n, seed=args.seed)
    dom = len(np.unique(np.concatenate([db["R1"].columns["p0"], db["R2"].columns["p0"]])))
    hot = float((db["R1"].columns["p0"] == 0).mean())
    say(tag, f"data: SKEWCHAIN n={args.n} seed={args.seed}: {dom} distinct p0 values, "
             f"{len(np.unique(db['R1'].columns['g1']))} group values, R1 share on p0=0 "
             f"{hot:.4f}")
    splan, sres, split = drive(torch, tag, "split leg", lambda: Q.from_query(q).plan(db))
    d = splan.split
    check(d is not None, "statistics chose no split plan on SKEWCHAIN")
    say(tag, f"split leg: {d.describe()}; roots {list(d.roots)}; ranges {list(d.ranges)}")
    split["paths"] = check_paths(tag, "split leg", splan, split["launches"])
    uplan, ures, unsplit = drive(
        torch, tag, "split leg, stats(False)", lambda: Q.from_query(q).stats(False).plan(db)
    )
    check(uplan.split is None, "the stats(False) plan split")
    unsplit["paths"] = check_paths(tag, "split leg, stats(False)", uplan, unsplit["launches"])
    same = same_result(sres, ures)
    say(tag, f"check: split leg: split = unsplit bit for bit: {same}; peak device memory "
             f"above resident {split['peak_above_resident_bytes']} B split vs "
             f"{unsplit['peak_above_resident_bytes']} B unsplit")
    check(same, "split result differs from the unsplit result")
    pplan, pres, sparse = drive(
        torch, tag, "split leg, mode=sparse",
        lambda: Q.from_query(q).engine(TorchChannelEngine(mode="sparse")).plan(db),
    )
    sparse["paths"] = check_paths(tag, "split leg, mode=sparse", pplan, sparse["launches"])
    ranges = len(pplan.split_parts())
    same = same_result(sres, pres) and pplan.split == splan.split
    plaunches = sparse["launches"]
    say(tag, f"check: split leg, mode=sparse: {ranges} key ranges, launches {plaunches}; "
             f"bit-identical to the default split plan: {same}")
    check(same, "split leg: the sparse-pinned split result differs from the default one")
    check(plaunches["segment_sum"] >= ranges and plaunches["coo_spmm"] >= ranges,
          "split leg, mode=sparse: segment_sum or coo_spmm missed a key range")
    want = skew_total(db)
    got = sres.column("count").sum()
    say(tag, f"check: split leg: Σ count {got:.0f} vs numpy {want}")
    check(got == want and sres.num_rows > 0, "split leg: Σ count disagrees with numpy")

    fplan = Q.from_query(q).fused(True).plan(db)
    ops.reset_launch_counts()
    fres = fplan.execute()
    flaunches = ops.launch_counts()
    check_paths(tag, "split leg, fused", fplan, flaunches)
    say(tag, f"check: split leg, fused: launches {flaunches}; bit-identical to unfused: "
             f"{same_result(sres, fres)}")
    check(same_result(sres, fres), "fused split result differs from the unfused one")
    check(flaunches["fused_hop"] > 0 and all(flaunches[k] == 0 for k in UNFUSED_KERNELS),
          "the fused split plan did not run on fused_hop alone")
    check_launch_shapes(torch, tag, "split leg, fused", fplan)

    small, sq = skewed_chain_like(args.check_n, seed=args.seed)
    gplan = Q.from_query(sq).plan(small)
    cplan = Q.from_query(sq).engine(TorchChannelEngine(device="cpu")).plan(small)
    gpu, cpu = gplan.execute(), cplan.execute()
    same = same_result(gpu, cpu) and gplan.split is not None and cplan.split == gplan.split
    say(tag, f"check: split leg: SKEWCHAIN n={args.check_n}: split {gplan.split.describe()}; "
             f"{cpu.num_rows} rows bit-identical to device='cpu': {same}")
    check(same, "split leg: cuda result differs from cpu result")
    for p in (splan, uplan, pplan, fplan, gplan):
        verified(tag, "split leg", p)
    return {"split": split, "split, stats(False)": unsplit, "split, mode=sparse": sparse,
            "launches": {"split": split["launches"], "split, stats(False)": unsplit["launches"],
                         "split, mode=sparse": plaunches, "split, fused": flaunches}}


def cyclic_leg(torch, tag, args) -> dict:
    """TRIANGLE, FOURCYCLE and FOFGROUP through the GHD compiler: host
    bag build against warm execute on the card, each count against
    ``scipy.sparse``, each card result against the CPU's."""
    from repro_torch.api import Q, TorchChannelEngine
    from repro_torch.data.queries import CYCLIC
    from repro_torch.kernels import ops

    out = {"launches": {}}
    for name, n in CYCLIC_SIZES.items():
        db, q = CYCLIC[name](n, seed=args.seed)
        label = f"cyclic {name}"
        plan, res, summary = drive(torch, tag, label, lambda: Q.from_query(q).plan(db))
        g = plan.ghd_plan
        check(plan.cyclic and g is not None, f"{name} was not compiled through the GHD")
        secs = g.seconds
        bags = {b: bt.num_rows for b, bt in g.bag_tables.items()}
        say(tag, f"{label}: n={n}; prepare {summary['prepare_s']:.3f} s of which encode "
                 f"{secs['encode']:.3f} s, build_ghd {secs['build_ghd']:.3f} s, bags "
                 f"{secs['bags']:.3f} s, finish_prepare {secs['finish_prepare']:.3f} s; "
                 f"bag rows {bags}; bag_peak_bytes {g.bag_peak_bytes}; max bag weight "
                 f"{max(int(bt.count.max(initial=0)) for bt in g.bag_tables.values())}; "
                 f"nodes after the fold {list(plan.prep.decomposition.nodes)} (rows "
                 f"{ {r: e.num_rows for r, e in plan.prep.encoded.items()} }, folded "
                 f"{plan.prep.folded})")
        summary.update(ghd_seconds=secs, bag_rows=bags, bag_peak_bytes=g.bag_peak_bytes,
                       nodes=list(plan.prep.decomposition.nodes))
        summary["paths"] = check_paths(tag, label, plan, summary["launches"])
        want = cyclic_counts(name, db)
        group = plan.group_display[0]
        got = dict(zip(res.column(group).tolist(), res.column("count").tolist()))
        rtol = count_rtol(plan)
        worst = 0.0
        ok = set(got) == set(want)
        for key, exact in want.items():
            err = abs(got.get(key, 0.0) - exact)
            if exact < 2 ** 24:
                ok = ok and err == 0
            else:
                worst = max(worst, err / exact)
        ok = ok and worst <= rtol
        say(tag, f"check: {label}: {len(got)} groups, Σ count {sum(got.values()):.0f} vs "
                 f"scipy {sum(want.values())}; largest count {max(want.values())}; exact "
                 f"below 2**24, above it worst relative error {worst:.3e} within "
                 f"{rtol:.3e}: {ok}")
        check(ok, f"{label}: counts disagree with scipy.sparse")
        small, sq = CYCLIC[name](CYCLIC_CHECK_N, seed=args.seed)
        gpu = Q.from_query(sq).plan(small).execute()
        cpu = Q.from_query(sq).engine(TorchChannelEngine(device="cpu")).plan(small).execute()
        same = same_result(gpu, cpu)
        say(tag, f"check: {label}: n={CYCLIC_CHECK_N}: {cpu.num_rows} rows bit-identical to "
                 f"device='cpu': {same}")
        check(same and gpu.num_rows > 0, f"{label}: cuda result differs from cpu result")
        splan = Q.from_query(q).engine(TorchChannelEngine(mode="sparse")).plan(db)
        ops.reset_launch_counts()
        sres = splan.execute()
        torch.cuda.synchronize()
        slaunches = ops.launch_counts()
        check_paths(tag, f"{label}, mode=sparse", splan, slaunches)
        same = same_result(res, sres)
        say(tag, f"check: {label}, mode=sparse: launches {slaunches}; bit-identical to the "
                 f"default plan: {same}")
        check(same, f"{label}: the sparse-pinned result differs from the default plan's")
        check(slaunches["segment_sum"] > 0, f"{label}, mode=sparse: no segment_sum launch")
        for p in (plan, splan):
            verified(tag, label, p)
        out[label] = summary
        out["launches"][label] = summary["launches"]
        out["launches"][f"{label}, mode=sparse"] = slaunches
        del plan, res, splan, sres
    return out


DENSE_START_N = 600  # the catalog's golden scale
DENSE_CHECK_N = 4800
SWEEP_REPS = 5


def tpch_db(n: int, seed: int):
    """The catalog's TPCH at ``n`` lineitem rows plus an integer measure
    ``lineitem.quantity`` in [1, 50], TPC-H's ``l_quantity``."""
    import numpy as np

    from repro_torch.data.queries import tpch_like
    from repro_torch.relational.relation import Database

    db, q = tpch_like(n, seed=seed)
    cols = {r: dict(db[r].columns) for r in q.relations}
    cols["lineitem"]["quantity"] = np.random.default_rng(seed + 1).integers(1, 51, n)
    return Database.from_mapping(cols), cols, q


def tpch_query(q, engine):
    from repro_torch.api import Avg, Count, Max, Min, Q, Sum

    m = "lineitem.quantity"
    return (Q.over(*q.relations).group_by(*(f"{r}.{a}" for r, a in q.group_by))
            .agg(n=Count(), s=Sum(m), a=Avg(m), lo=Min(m), hi=Max(m)).engine(engine))


def tpch_totals(cols) -> tuple[int, int]:
    """Σ COUNT and Σ SUM(quantity) of TPCH's chain join in numpy, without
    the port: supplier and customer matches per key by bincount, carried
    through orders to every lineitem row."""
    import numpy as np

    dom = 1 + max(int(c.max()) for rel in cols.values() for c in rel.values())
    sup = np.bincount(cols["supplier"]["suppkey"], minlength=dom)
    cust = np.bincount(cols["customer"]["custkey"], minlength=dom)
    orders = np.bincount(cols["orders"]["orderkey"], minlength=dom,
                         weights=cust[cols["orders"]["custkey"]]).astype(np.int64)
    li = cols["lineitem"]
    per_row = sup[li["suppkey"]] * orders[li["orderkey"]]
    return int(per_row.sum()), int((per_row * li["quantity"]).sum())


def dense_leg(torch, tag, args) -> dict:
    """TPCH with its quantity bundle at the largest doubling of 600 rows
    that ``choose_path`` still runs dense: the default plan against a
    ``mode="sparse"`` plan on the same data."""
    import math

    import numpy as np

    from repro_torch.api import TorchChannelEngine
    from repro_torch.core.torch_engine import choose_path

    series, n = [], DENSE_START_N
    while True:
        db, _, q = tpch_db(n, args.seed)
        plan = tpch_query(q, "torch").plan(db)
        (_, choice), = run_paths(plan)
        series.append((n, choice.path, choice.reason))
        if choice.path != "dense":
            break
        n *= 2
    say(tag, f"dense leg: doubling series {series}")
    check(len(series) > 1, "dense leg: TPCH is not dense even at 600 rows")
    n = series[-2][0]
    db, cols, q = tpch_db(n, args.seed)
    say(tag, f"data: TPCH n={n} seed={args.seed}, lineitem.quantity in [1, 50]")
    dplan, dres, dense = drive(torch, tag, "dense leg", lambda: tpch_query(q, "torch").plan(db))
    elems = {r: math.prod(dplan.prep.dicts[a].size for a in e.attrs)
             for r, e in dplan.prep.encoded.items()}
    choice = choose_path(dplan.prep, k=len(dplan.channels), measured=tuple(
        ch.measure[0] if ch.kind == "sum" else None for ch in dplan.channels))
    say(tag, f"dense leg: relation tensors' elements {elems} (rows "
             f"{ {r: e.num_rows for r, e in dplan.prep.encoded.items()} }); est dense peak "
             f"{choice.dense_peak} B vs sparse peak {choice.sparse_peak} B")
    dense.update(n=n, tensor_elems=elems, paths=check_paths(tag, "dense leg", dplan,
                                                             dense["launches"]))
    check(dense["paths"] == ["dense"], "dense leg: the default plan did not run dense")
    check(dense["launches"]["segment_reduce"] > 0, "dense leg: MIN/MAX launched no segment_reduce")
    splan, sres, sparse = drive(
        torch, tag, "dense leg, mode=sparse",
        lambda: tpch_query(q, TorchChannelEngine(mode="sparse")).plan(db),
    )
    sparse.update(n=n, paths=check_paths(tag, "dense leg, mode=sparse", splan,
                                         sparse["launches"]))
    same = same_result(dres, sres)
    say(tag, f"check: dense leg: dense = sparse bit for bit: {same}; dense vs sparse: "
             f"warm execute {dense['warm_execute_s'] * 1e3:.3f} vs "
             f"{sparse['warm_execute_s'] * 1e3:.3f} ms, device busy "
             f"{dense['device_busy_s'] * 1e3:.4f} vs {sparse['device_busy_s'] * 1e3:.4f} ms, "
             f"idle share {dense['idle_share']:.4f} vs {sparse['idle_share']:.4f}, peak "
             f"above resident {dense['peak_above_resident_bytes']} vs "
             f"{sparse['peak_above_resident_bytes']} B")
    check(same, "dense leg: the dense result differs from the sparse-pinned one")
    want_n, want_s = tpch_totals(cols)
    got_n, got_s = dres.column("n").sum(), dres.column("s").sum()
    say(tag, f"check: dense leg: Σ count {got_n:.0f} vs numpy {want_n}; Σ sum {got_s:.0f} "
             f"vs numpy {want_s}")
    check(got_n == want_n and got_s == want_s and dres.num_rows > 0,
          "dense leg: Σ count / Σ sum disagree with numpy")
    for name in dres.agg_names:
        check(bool(np.isfinite(dres.column(name)).all()), f"dense leg: non-finite {name}")

    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        tres = tpch_query(q, "torch").plan(db).execute()
        still = matmul.allow_tf32
    finally:
        matmul.allow_tf32 = before
    same = same_result(dres, tres)
    say(tag, f"check: dense leg: with allow_tf32 = True set globally: bit-identical "
             f"{same}; allow_tf32 still True after the run: {still}")
    check(same and still, "dense leg: a global TF32 setting changed the result or was lost")
    tf32_terms(torch, tag, dplan, args.seed)

    small, _, sq = tpch_db(DENSE_CHECK_N, args.seed)
    gplan = tpch_query(sq, "torch").plan(small)
    cplan = tpch_query(sq, TorchChannelEngine(device="cpu")).plan(small)
    gpu, cpu = gplan.execute(), cplan.execute()
    same = same_result(gpu, cpu)
    say(tag, f"check: dense leg: TPCH n={DENSE_CHECK_N}: {cpu.num_rows} rows bit-identical "
             f"to device='cpu': {same}")
    check(same and gpu.num_rows > 0, "dense leg: cuda result differs from cpu result")
    for p in (dplan, splan, gplan):
        verified(tag, "dense leg", p)
    dense["sweep"] = path_sweep(torch, tag, args.seed, [n for n, *_ in series] + [2 * series[-1][0]])
    return {"dense": dense, "dense, mode=sparse": sparse, "tpch": (db, q, dres),
            "launches": {"dense": dense["launches"],
                         "dense, mode=sparse": sparse["launches"]}}


TF32_GEMM = 2048  # a square term that cuBLAS runs on TF32 tensor cores when let


def tf32_terms(torch, tag, dplan, seed: int) -> None:
    """A TF32 check that can fail: the dense leg's integer data multiply
    exactly even in TF32 (11-bit significands), so each einsum term of
    its program, and a (2048 × 2048) · (2048 × 2048) term, is contracted
    on fractional operands of its shapes, with ``allow_tf32 = True`` set
    globally.  Inside ``full_fp32_matmul`` ``contract_term`` must equal
    its FP32 result (``allow_tf32 = False``) bit for bit; a bare
    ``torch.einsum`` of the square term must differ from it, which shows
    that TF32 was in force and the pin is what kept the bits."""
    from repro_torch.core.torch_engine import (
        build_dense_program,
        contract_term,
        dense_tensor,
        full_fp32_matmul,
    )

    prep = dplan.prep
    cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in dplan.channels)
    prog = build_dense_program(prep, "cuda")
    shapes, results = [], {}
    with full_fp32_matmul():
        for rel, expr, children in prog.terms(cm):
            operands = [dense_tensor(prep, rel, "cuda", cm)] + [results[c] for c in children]
            results[rel] = contract_term(expr, operands)
            shapes.append((rel, expr, [tuple(o.shape) for o in operands]))
    shapes.append(("square", "ab,bc->ac", [(TF32_GEMM, TF32_GEMM)] * 2))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    pinned_ok, square_differs = True, False
    try:
        for rel, expr, dims in shapes:
            operands = [torch.rand(d, generator=gen, device="cuda") + 0.5 for d in dims]
            matmul.allow_tf32 = False
            fp32 = contract_term(expr, operands)
            matmul.allow_tf32 = True
            bare = torch.einsum(expr, *operands)
            with full_fp32_matmul():
                pinned = contract_term(expr, operands)
            still = matmul.allow_tf32
            torch.cuda.synchronize()
            same = torch.equal(pinned, fp32) and still
            bare_err = float((bare - fp32).abs().max())
            say(tag, f"check: dense leg: TF32 term {rel} {expr} {dims}: pinned contract_term "
                     f"= FP32 bit for bit: {same}; bare torch.einsum under allow_tf32 = True "
                     f"max |diff| {bare_err:.3e}")
            pinned_ok = pinned_ok and same
            square_differs = square_differs or (rel == "square" and bare_err > 0)
    finally:
        matmul.allow_tf32 = before
    check(pinned_ok, "dense leg: a term under full_fp32_matmul differs from FP32 with TF32 on")
    check(square_differs, "dense leg: TF32 changed no bit of the bare square term; the TF32 "
                          "check cannot tell the pin from no pin")


def path_sweep(torch, tag, seed: int, sizes: list[int]) -> list[dict]:
    """Warm execute of each path, pinned, at each size of the dense leg's
    doubling series and one doubling past the first sparse choice: the
    median of ``SWEEP_REPS`` host-clock runs ending in a synchronise,
    against what ``choose_path`` picks there."""
    import statistics

    from repro_torch.api import TorchChannelEngine

    rows = []
    for n in sizes:
        db, _, q = tpch_db(n, seed)
        (_, choice), = run_paths(tpch_query(q, "torch").plan(db))
        row = {"n": n, "choice": choice.path}
        for mode in ("dense", "sparse"):
            plan = tpch_query(q, TorchChannelEngine(mode=mode)).plan(db)
            plan.execute()  # cold: builds the relation tensors or the views
            times = []
            for _ in range(SWEEP_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan.execute()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            row[f"{mode}_ms"] = statistics.median(times) * 1e3
        row["faster"] = "dense" if row["dense_ms"] < row["sparse_ms"] else "sparse"
        say(tag, f"dense leg: path sweep: TPCH n={n}: choose_path {choice.path}; warm "
                 f"execute, median of {SWEEP_REPS}: dense {row['dense_ms']:.3f} ms, sparse "
                 f"{row['sparse_ms']:.3f} ms; faster {row['faster']}")
        rows.append(row)
    return rows


def explain_phase(torch, tag, seed: int) -> None:
    """``explain(actuals=True)`` of a small plan on the card, its actual
    per-node cardinalities from the card's COUNT pass."""
    db, _, q = tpch_db(DENSE_START_N, seed)
    plan = tpch_query(q, "torch").fused(True).plan(db)
    for line in plan.explain(actuals=True).splitlines():
        say(tag, f"explain: {line}")
    verified(tag, "explain", plan)


# ----------------------------------------------------------------------
# the maintain leg
# ----------------------------------------------------------------------

# Table VIII's inserts into R2 (1, 10, 100, 1,000, 10,000) cut to three: each
# size costs two full recomputes (~6 s each) and a whole run with leg 22 took
# 1,264.2 s of its 1,200 on a slow host
MAINTAIN_SIZES = (1, 100, 10000)
MAINTAIN_DELETE = 1000  # present R2 tuples deleted after them
MAINTAIN_SIDE = 100  # rows of the R3 (leaf, growing) and R1 (root) inserts


def b2_cols(n: int, seed: int):
    """Table VIII's B2 star (``data/synth.py``) at ``n`` rows per relation
    with an integer measure ``m`` in [1, 40] on R2; its columns and query."""
    import numpy as np

    from repro_torch.data import synth

    db, q = synth.make("B2", n, seed=seed)
    cols = {r: dict(db[r].columns) for r in q.relations}
    cols["R2"]["m"] = np.random.default_rng(seed + 3).integers(1, 41, n)
    return cols, q


def b2_total(cols) -> int:
    """Σ COUNT of the B2 join R1(g1,j) ⋈ R2(j,b) ⋈ R3(b,g2) ⋈ R4(b,g3),
    counted in numpy without the port: R3 and R4 rows per b, R2 weighted
    per j, summed over R1 (integers below 2**53, exact in float64)."""
    import numpy as np

    bdom = 1 + max(int(cols[r]["b"].max()) for r in ("R2", "R3", "R4"))
    jdom = 1 + max(int(cols[r]["j"].max()) for r in ("R1", "R2"))
    per_b = (np.bincount(cols["R3"]["b"], minlength=bdom)
             * np.bincount(cols["R4"]["b"], minlength=bdom))
    w2 = np.bincount(cols["R2"]["j"], weights=per_b[cols["R2"]["b"]], minlength=jdom)
    return int(w2[cols["R1"]["j"]].sum())


def b2_bundle(engine):
    """COUNT, SUM and AVG of R2.m over B2, grouped as Table VIII groups."""
    from repro_torch.api import Avg, Count, Q, Sum

    return (Q.over("R1", "R2", "R3", "R4").group_by("R1.g1", "R3.g2", "R4.g3")
            .agg(n=Count(), s=Sum("R2.m"), a=Avg("R2.m")).engine(engine))


def b2_batches(cols, seed: int) -> list:
    """The leg's batches ``(label, op, rel, columns)``: Table VIII's five
    insert sizes into R2 (its value ranges), a delete of the first
    ``MAINTAIN_DELETE`` R2 tuples, an insert into the leaf R3 with 10 new
    b values and only new g2 values (both domains grow), and an insert
    into the root R1."""
    import numpy as np

    rng = np.random.default_rng(seed + 17)
    jdom = 1 + int(cols["R2"]["j"].max())
    bdom = 1 + max(int(cols[r]["b"].max()) for r in ("R2", "R3", "R4"))
    gdom = 1 + int(cols["R3"]["g2"].max())
    out = [(f"insert {k} into R2", "insert", "R2",
            {"j": rng.integers(0, jdom, k), "b": rng.integers(0, bdom, k),
             "m": rng.integers(1, 41, k)}) for k in MAINTAIN_SIZES]
    out.append((f"delete {MAINTAIN_DELETE} from R2", "delete", "R2",
                {a: c[:MAINTAIN_DELETE].copy() for a, c in cols["R2"].items()}))
    k = MAINTAIN_SIDE
    out.append((f"insert {k} into R3, new b and g2", "insert", "R3",
                {"b": np.concatenate([rng.integers(0, bdom, k - 10), bdom + np.arange(10)]),
                 "g2": gdom + rng.integers(0, 2, k)}))
    out.append((f"insert {k} into R1 (root)", "insert", "R1",
                {"g1": rng.integers(0, gdom, k), "j": rng.integers(0, jdom, k)}))
    return out


def mirrored(cols, op: str, rel: str, batch):
    """The host's copy of the columns after a batch.  Deletes here are a
    contiguous block of rows: the first ones, or the block that the
    ``MAINTAIN_SIZES[-1]`` insert appended (found by its rows)."""
    import numpy as np

    out = {r: dict(c) for r, c in cols.items()}
    cur = cols[rel]
    if op == "insert":
        out[rel] = {a: np.concatenate([c, np.asarray(batch[a])]) for a, c in cur.items()}
        return out
    k = len(next(iter(batch.values())))
    starts = np.flatnonzero(np.logical_and.reduce([c == batch[a][0] for a, c in cur.items()]))
    lo = next(int(i) for i in starts
              if all(np.array_equal(c[i:i + k], batch[a]) for a, c in cur.items()))
    out[rel] = {a: np.concatenate([c[:lo], c[lo + k:]]) for a, c in cur.items()}
    return out


def handle_stats(handle) -> dict:
    """A handle's refresh counters; a bundle's summed over its handles
    (``peak_delta_bytes`` their largest)."""
    stats = getattr(handle, "handles", {"": handle})
    keys = ("delta_rows", "rows_rescanned", "fallback_recomputes", "host_syncs")
    out = {k: sum(getattr(h.stats, k) for h in stats.values()) for k in keys}
    out["peak_delta_bytes"] = max(h.stats.peak_delta_bytes for h in stats.values())
    return out


def timed_refresh(torch, handle, op: str, rel: str, batch) -> dict:
    """One refresh with the launch counts set to 0 just before it and read
    just after: host ms ending in a synchronise, launches, the handle's
    counters for this refresh and the device peak above what was
    allocated before it."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = handle_stats(handle)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    getattr(handle, op)(rel, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    after = handle_stats(handle)
    row = {k: after[k] - before[k] for k in after if k != "peak_delta_bytes"}
    row.update(ms=ms, launches=launches, peak_delta_bytes=after["peak_delta_bytes"],
               peak_above_resident_bytes=torch.cuda.max_memory_allocated() - resident)
    return row


def from_scratch(torch, q, cols):
    """The port's answer on ``cols`` with nothing kept: plan and execute
    on the card, timed (host clock ending in a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = q.plan(cols)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = plan.execute()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return res, (t2 - t0) * 1e3, (t2 - t1) * 1e3


def maintain_leg(torch, tag, args) -> dict:
    """B2 at ``--maintain-n`` (Table VIII) maintained on the card: a COUNT handle
    through ``Q.maintain(db)`` and a COUNT/SUM/AVG bundle through
    ``Plan.maintain()`` take the batches of :func:`b2_batches`; after
    each, both equal a from-scratch execute on the card bit for bit and
    Σ COUNT equals numpy's.  Then the largest batch is deleted (its
    launches captured and held against the plain versions) and inserted
    again under the profiler, a MIN handle takes a delete (the
    non-invertible fallback), and at ``--check-n`` the same sequence runs
    on the card and on the CPU, bit for bit."""
    import numpy as np

    from repro_torch.api import Min, Q
    from repro_torch.incremental import MaintainedJoinAgg

    cols, q = b2_cols(args.maintain_n, args.seed)
    say(tag, f"data: B2 n={args.maintain_n} seed={args.seed}, R2.m in [1, 40]")
    count_q = Q.from_query(q)
    t0 = time.perf_counter()
    counter = count_q.maintain(cols)
    torch.cuda.synchronize()
    count_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = b2_bundle("torch").plan(cols).maintain()
    torch.cuda.synchronize()
    bundle_build = time.perf_counter() - t0
    check(isinstance(counter, MaintainedJoinAgg), "Q.maintain did not return a raw handle")
    caches = counter.caches["count"].msgs
    say(tag, f"maintain leg: COUNT handle (Q.maintain) built in {count_build:.3f} s, bundle "
             f"(Plan.maintain, {len(bundle.handles)} handles) in {bundle_build:.3f} s; root "
             f"{counter.prep.decomposition.root}; domains "
             f"{ {a: d.size for a, d in counter.dicts.items()} }; cached messages "
             f"{ {r: tuple(m.array.shape) for r, m in caches.items()} }; device memory "
             f"allocated {torch.cuda.memory_allocated()} B")

    def checked(label, cols):
        fresh_c, c_full, c_exec = from_scratch(torch, count_q, cols)
        fresh_b, b_full, b_exec = from_scratch(torch, b2_bundle("torch"), cols)
        want = b2_total(cols)
        ok_c = counter.result() == fresh_c.to_dict()
        ok_b = same_result(bundle.result(), fresh_b)
        total = fresh_b.column("n").sum()
        say(tag, f"check: maintain leg, {label}: COUNT handle = fresh execute bit for bit: "
                 f"{ok_c}; bundle = fresh execute bit for bit: {ok_b} ({fresh_b.num_rows} "
                 f"groups); Σ count {total:.0f} vs numpy {want}")
        check(ok_c and ok_b, f"maintain leg, {label}: a handle differs from a fresh execute")
        check(total == want and sum(counter.result().values()) == want,
              f"maintain leg, {label}: Σ count disagrees with numpy")
        for name in fresh_b.agg_names:
            check(bool(np.isfinite(fresh_b.column(name)).all()), f"maintain leg: non-finite {name}")
        return {"count": (c_full, c_exec), "bundle": (b_full, b_exec)}

    checked("as built", cols)
    totals: dict[str, int] = {}
    rows = []
    batches = b2_batches(cols, args.seed)
    for label, op, rel, batch in batches:
        row = {"batch": label}
        for name, handle in (("count", counter), ("bundle", bundle)):
            r = timed_refresh(torch, handle, op, rel, batch)
            row[name] = r
            for kernel, c in r["launches"].items():
                totals[kernel] = totals.get(kernel, 0) + c
        cols = mirrored(cols, op, rel, batch)
        full = checked(label, cols)
        for name in ("count", "bundle"):
            r = row[name]
            r.update(full_ms=full[name][0], full_execute_ms=full[name][1],
                     full_over_refresh=full[name][0] / r["ms"])
            say(tag, f"maintain leg, {label}, {name}: refresh {r['ms']:.3f} ms vs full "
                     f"recompute {r['full_ms']:.3f} ms (of it execute "
                     f"{r['full_execute_ms']:.3f} ms), ratio {r['full_over_refresh']:.2f}; "
                     f"delta_rows {r['delta_rows']}, rows_rescanned {r['rows_rescanned']}, "
                     f"fallback_recomputes {r['fallback_recomputes']}, peak_delta_bytes "
                     f"{r['peak_delta_bytes']}; device peak above resident "
                     f"{r['peak_above_resident_bytes']} B; launches {r['launches']}; "
                     f"device->host syncs {r['host_syncs']}")
            check(r["fallback_recomputes"] == 0, f"maintain leg, {label}: a fallback ran")
            check(r["launches"]["fused_hop"] == 0 and r["launches"]["segment_reduce"] == 0
                  and r["launches"]["semiring_matmul"] == 0,
                  f"maintain leg, {label}: a refresh launched a kernel off its path")
        rows.append(row)
    say(tag, f"maintain leg: launches of every refresh together: {totals}")
    check(totals["segment_sum"] > 0 and totals["coo_spmm"] > 0,
          "maintain leg: the refreshes never launched segment_sum or coo_spmm")

    # the largest batch once more: deleted (launches captured), inserted
    # again under the profiler
    big = batches[len(MAINTAIN_SIZES) - 1][3]
    captured = capture_launches(lambda: bundle.delete("R2", big), main_path_key)
    counter.delete("R2", big)
    cols = mirrored(cols, "delete", "R2", big)
    checked(f"delete the {MAINTAIN_SIZES[-1]} rows again", cols)
    profiles = {}
    for name, handle in (("count", counter), ("bundle", bundle)):
        wall, busy, top = idle_share(torch, lambda h=handle: h.insert("R2", big))
        profiles[name] = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall}
        say(tag, f"profile: maintain leg, {name}, insert {MAINTAIN_SIZES[-1]} into R2 again: "
                 f"{wall:.3f} s wall, device busy {busy:.4f} s, idle share "
                 f"{1 - busy / wall:.3f}")
        for op_name, ms, cnt in top[:8]:
            say(tag, f"profile: {ms:10.3f} ms x{cnt:<6d} {op_name[:140]}")
    cols = mirrored(cols, "insert", "R2", big)
    checked(f"insert the {MAINTAIN_SIZES[-1]} rows again", cols)

    # MIN through a delete: the non-invertible fallback
    min_q = (Q.over("R1", "R2", "R3", "R4").group_by("R1.g1", "R3.g2", "R4.g3")
             .agg(lo=Min("R2.m")))
    t0 = time.perf_counter()
    low = min_q.maintain(cols)
    torch.cuda.synchronize()
    min_build = time.perf_counter() - t0
    gone = {a: c[:MAINTAIN_DELETE].copy() for a, c in cols["R2"].items()}
    r = timed_refresh(torch, low, "delete", "R2", gone)
    cols = mirrored(cols, "delete", "R2", gone)
    fresh, full_ms, _ = from_scratch(torch, min_q, cols)
    same = low.result() == fresh.to_dict()
    say(tag, f"maintain leg, MIN handle: built in {min_build:.3f} s; delete "
             f"{MAINTAIN_DELETE} from R2: refresh {r['ms']:.3f} ms (fallback recomputes "
             f"{r['fallback_recomputes']}) vs full recompute {full_ms:.3f} ms; launches "
             f"{r['launches']}; = fresh execute bit for bit: {same}")
    check(same and r["fallback_recomputes"] == 1, "maintain leg: the MIN fallback is wrong")
    check(r["launches"]["segment_reduce"] > 0, "maintain leg: the MIN recompute ran no segment_reduce")
    del counter, bundle, low
    torch.cuda.empty_cache()
    maintain_cpu_check(torch, tag, args)
    return {"maintain": {"count_build_s": count_build, "bundle_build_s": bundle_build,
                         "min_build_s": min_build, "batches": rows, "profiles": profiles,
                         "min_delete": r},
            "captured": captured,
            "launches": {"maintain": totals, "maintain, MIN fallback": r["launches"]}}


def maintain_cpu_check(torch, tag, args) -> None:
    """The leg's batch sequence at ``--check-n`` on a card handle and a
    ``device="cpu"`` handle, COUNT and the bundle: equal bit for bit
    after every batch."""
    from repro_torch.api import Q, TorchChannelEngine

    cpu = TorchChannelEngine(device="cpu")
    cols, q = b2_cols(args.check_n, args.seed)
    pairs = {
        "count": (Q.from_query(q).maintain(cols), Q.from_query(q).engine(cpu).maintain(cols)),
        "bundle": (b2_bundle("torch").maintain(cols), b2_bundle(cpu).maintain(cols)),
    }
    for label, op, rel, batch in [("as built", None, None, None)] + b2_batches(cols, args.seed):
        same = True
        for gpu, host in pairs.values():
            if op is not None:
                getattr(gpu, op)(rel, batch)
                getattr(host, op)(rel, batch)
            a, b = gpu.result(), host.result()
            same = same and (a == b if isinstance(a, dict) else same_result(a, b))
        say(tag, f"check: maintain leg: B2 n={args.check_n}, {label}: card handles = "
                 f"device='cpu' handles bit for bit: {same}")
        check(same, f"maintain leg, n={args.check_n}, {label}: cuda differs from cpu")


def maintain_kernels(torch, tag, captured) -> dict:
    """The largest refresh's ``segment_sum`` and ``coo_spmm`` launches (the
    leg's own shapes) against their plain versions, tolerance 0, and
    timed beside the plain version, the library call and the bound."""
    seg = [lc for key, lc in captured.items() if isinstance(key, tuple) and key[0] == "segment_sum"]
    check(seg and "coo_spmm" in captured, "maintain leg: no segment_sum or coo_spmm captured")
    out = {"segment_sum": segment_regime(
        torch, tag, "segment_sum", "largest refresh launch",
        max(seg, key=lambda lc: lc.size), path="maintain leg")}
    out["coo_spmm"] = coo_spmm_row(
        torch, tag, "maintain leg", "largest refresh launch", captured["coo_spmm"], tol=None)
    return out


def spmm_tolerance(torch, rows, cols, vals, dense, s):
    """None (tolerance 0) when every product and partial sum of the
    float32 ``coo_spmm`` is an integer below 2**24, which both the kernel
    and its plain version then compute exactly; else the elementwise
    bound on their difference.  Summing a row's run of at most m edges in
    any order rounds each product and each addition once, at most 2**-24
    relative, so each result lies within (2m) · 2**-24 · Σ|w · x| of the
    exact sum (to first order), and the two within twice that."""
    mag = torch.zeros((s, dense.shape[1]), dtype=torch.float64, device=dense.device)
    mag.index_add_(0, rows, vals.abs().double()[:, None] * dense.abs().double()[cols])
    integral = bool((vals == vals.round()).all()) and bool((dense == dense.round()).all())
    if integral and (float(mag.max()) if mag.numel() else 0.0) < 2 ** 24:
        return None
    m = int(torch.bincount(rows, minlength=s).max())
    return (4 * m * F32_UNIT * mag).float()


def spmm_exact_check(torch, tag, path: str, lc) -> float:
    """A captured ``coo_spmm`` launch's rows and columns with exact
    operands, held against the plain version at tolerance 0: weights 1
    and a dense of integers in [1, hi], hi chosen so that no output sum
    passes 2**24.  Every edge adds at least 1 to its row, so a lost,
    repeated or misplaced edge shows, however long the row's run."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.coo_spmm import coo_spmm

    rows, cols, vals, dense, s = lc.args
    m = int(torch.bincount(rows, minlength=s).max()) if rows.numel() else 1
    hi = min(100, (2 ** 24 - 1) // m)
    check(hi >= 1, f"coo_spmm [{path}]: a row of {m} edges leaves no exact operands")
    gen = torch.Generator(device=dense.device).manual_seed(0)
    exact = torch.randint(1, hi + 1, tuple(dense.shape), generator=gen, device=dense.device)
    args = (rows, cols, torch.ones_like(vals), exact.to(dense.dtype), s)
    return compare(torch, tag, "coo_spmm", f"{path}, exact operands (weights 1, dense in "
                   f"[1, {hi}], longest run {m})", coo_spmm, ref.coo_spmm, args)


def coo_spmm_row(torch, tag, path: str, label: str, lc, tol) -> dict:
    """One captured ``coo_spmm`` launch held against its plain version
    within ``tol`` (None: exactly; else :func:`spmm_tolerance`'s bound),
    and timed beside the plain version, ``torch.sparse.mm`` and the
    bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coo_spmm import coo_spmm

    rows, cols, vals, dense, s = lc.args
    err = compare(torch, tag, "coo_spmm", f"{path}, {label}", coo_spmm, ref.coo_spmm, lc.args,
                  tol=tol)
    nnz, (kdense, w) = rows.shape[0], dense.shape
    used = int(torch.unique(cols).numel())
    b, by = bound(nnz * 20 + used * w * 4 + s * w * 4, 2 * nnz * w)
    row = dict(
        shapes={"rows": [nnz], "dense": [kdense, w], "num_rows": s, "dense_rows_used": used},
        launches=lc.count, walk=repr(ops.gather_plan(nnz, s, w)), max_abs_err=err,
        ms=time_ms(torch, lambda: coo_spmm(rows, cols, vals, dense, s)),
        plain_ms=time_ms(torch, lambda: ref.coo_spmm(rows, cols, vals, dense, s), reps=3),
        library_ms=csr_spmm_ms(torch, rows, cols, vals, dense, s),
        bound_ms=b, bound_by=by,
    )
    say(tag, f"kernels: coo_spmm [{path}] at {row['shapes']}: {row['ms']:.4f} ms, "
             f"bound {b:.4f} ms by {by}, plain {row['plain_ms']:.4f} ms, library "
             f"torch.sparse.mm {row['library_ms']:.4f} ms; {row['walk']}")
    return row


# ----------------------------------------------------------------------
# storage leg (Table XIV on the card)
# ----------------------------------------------------------------------


def measured_chain_cols(n: int, seed: int) -> dict:
    """The fold-free measured chain of the repo's Table XIV
    (``benchmarks/tables.py:276``): R1(g1, p0), R2(p0, p1, m), R3(p1,
    g2) at ``n`` rows each, join domains ``n // 50``, group domains 32,
    an integer measure m in [1, 100)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    jdom, gdom = max(4, n // 50), 32
    return {
        "R1": {"g1": rng.integers(0, gdom, n), "p0": rng.integers(0, jdom, n)},
        "R2": {"p0": rng.integers(0, jdom, n), "p1": rng.integers(0, jdom, n),
               "m": rng.integers(1, 100, n)},
        "R3": {"p1": rng.integers(0, jdom, n), "g2": rng.integers(0, gdom, n)},
    }


def storage_totals(cols) -> tuple[int, int]:
    """Σ COUNT and Σ SUM(R2.m) of the chain join in int64, without the
    port: Σ over p0, p1 of c1[p0]·c2[p0, p1]·c3[p1], i.e. each R2 row
    weighed by the R1 rows on its p0 and the R3 rows on its p1."""
    import numpy as np

    dom = 1 + max(int(cols[r][a].max()) for r, a in (
        ("R1", "p0"), ("R2", "p0"), ("R2", "p1"), ("R3", "p1")))
    c1 = np.bincount(cols["R1"]["p0"], minlength=dom).astype(np.int64)
    c3 = np.bincount(cols["R3"]["p1"], minlength=dom).astype(np.int64)
    w = c1[cols["R2"]["p0"]] * c3[cols["R2"]["p1"]]
    return int(w.sum()), int((w * cols["R2"]["m"]).sum())


def storage_sum_query(engine):
    """The repo's Table XIV query: SUM(R2.m) by R1.g1, R3.g2."""
    from repro_torch.api import Q, Sum

    return Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(s=Sum("R2.m")).engine(engine)


def storage_bundle(engine):
    """The storage smoke bundle of ``src/repro/launch/storage.py:61``."""
    from repro_torch.api import Avg, Count, Max, Min, Q, Sum

    return (
        Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2")
        .agg(n=Count(), s=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m"), mean=Avg("R2.m"))
        .engine(engine)
    )


def chunk_env(rows: int):
    """``REPRO_CHUNK_ROWS`` set for a ``with`` block (the chunk a stored
    plan's prepare streams in), restored after."""
    import os
    from unittest import mock

    return mock.patch.dict(os.environ, {"REPRO_CHUNK_ROWS": str(rows)})


def host_peak(torch, fn):
    """``(result, seconds, tracemalloc peak bytes)`` of ``fn()``, the host
    clock ending in a synchronise.  tracemalloc counts numpy's and
    Python's allocations (each host range an upload gathers among them),
    not memmap pages."""
    import tracemalloc

    tracemalloc.start()
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return out, secs, peak


def storage_leg(torch, tag, args) -> dict:
    """The repo's Table XIV on the card: the measured chain at
    ``--storage-n`` rows per relation written with ``write_database`` to
    a temporary directory (removed after) and mounted with
    ``open_database``; prepare's host peak, mounted and in memory; the
    Table XIV SUM query on both, bit for bit; the storage smoke bundle
    on the mounted database, driven; Σ COUNT / Σ SUM against numpy."""
    import numpy as np

    from repro_torch.aggregates.semiring import Sum
    from repro_torch.core.prepare import prepare
    from repro_torch.core.query import JoinAggQuery
    from repro_torch.kernels import ops
    from repro_torch.relational.relation import Database
    from repro_torch.storage import open_database, write_database

    n = args.storage_n
    cols = measured_chain_cols(n, args.seed)
    db = Database.from_mapping(cols)
    col_bytes = max(c.nbytes for rc in cols.values() for c in rc.values())
    total_bytes = sum(c.nbytes for rc in cols.values() for c in rc.values())
    chunk = max(4096, n // 25)
    say(tag, f"data: storage leg: measured chain n={n} seed={args.seed}: join domains "
             f"{max(4, n // 50)}, group domains 32; {total_bytes} B of columns, largest "
             f"column {col_bytes} B; chunk_rows {chunk}")
    out: dict = {"launches": {}}
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-storage-"))
    try:
        t0 = time.perf_counter()
        write_database(db, tmp / "db")
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mdb = open_database(tmp / "db")
        open_s = time.perf_counter() - t0
        disk = sum(p.stat().st_size for p in (tmp / "db").rglob("*") if p.is_file())
        say(tag, f"storage leg: write_database {write_s:.3f} s ({disk} B on disk), "
                 f"open_database {open_s:.3f} s")

        # Table XIV's prepare: encode + the three grouped-CSR views
        q = JoinAggQuery(("R1", "R2", "R3"), (("R1", "g1"), ("R3", "g2")), Sum("R2", "m"))

        def prep_all(d, ch):
            prep = prepare(q, d, chunk_rows=ch)
            for rel, attr in (("R1", "p0"), ("R2", "p0"), ("R3", "p1")):
                prep.csr_view(rel, (attr,))
            return prep

        peaks = {}
        for label, d, ch in (("mmap", mdb, chunk), ("in-memory", db, None)):
            prep, secs, peak = host_peak(torch, lambda: prep_all(d, ch))
            peaks[label] = peak
            say(tag, f"storage leg: prepare {label}: {secs:.3f} s, host peak {peak} B "
                     f"(tracemalloc) = {peak / col_bytes:.2f}x the largest column")
            out[f"prepare {label}"] = {"seconds": secs, "host_peak_bytes": peak,
                                       "peak_over_column": peak / col_bytes}
            del prep
        check(peaks["mmap"] < 2 * col_bytes,
              f"storage leg: mmap prepare host peak {peaks['mmap']} B is not below 2x the "
              f"largest column ({col_bytes} B)")

        # the Table XIV query, mounted (first execute traced) and in memory
        path = str(tmp / "db")
        results = {}
        for label in ("mmap", "in-memory"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "mmap":
                with chunk_env(chunk):
                    plan = storage_sum_query("torch").plan(path)
            else:
                plan = storage_sum_query("torch").plan(db)
            plan_s = time.perf_counter() - t0
            ops.reset_launch_counts()
            res, cold_s, peak = host_peak(torch, plan.execute)
            launches = ops.launch_counts()
            t0 = time.perf_counter()
            plan.execute()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            say(tag, f"storage leg: Table XIV SUM, {label}: {plan}; chunk_rows "
                     f"{plan.chunk_rows}; plan {plan_s:.3f} s; first execute {cold_s:.3f} s "
                     f"(traced), host peak {peak} B (tracemalloc) = {peak / col_bytes:.2f}x "
                     f"the largest column; "
                     f"warm execute {warm_s:.3f} s; launches {launches}; {res.num_rows} rows")
            verified(tag, f"storage leg, Table XIV SUM, {label}", plan)
            check_paths(tag, f"storage leg, Table XIV SUM, {label}", plan, launches)
            results[label] = res
            out[f"Table XIV SUM, {label}"] = {
                "plan_s": plan_s, "first_execute_s": cold_s, "warm_execute_s": warm_s,
                "first_execute_host_peak_bytes": peak,
                "chunk_rows": plan.chunk_rows, "rows": res.num_rows,
            }
            out["launches"][f"storage, Table XIV SUM, {label}"] = launches
            del plan
        same = same_result(results["mmap"], results["in-memory"])
        say(tag, f"check: storage leg: Table XIV SUM mounted = in-memory bit for bit: {same}")
        check(same, "storage leg: the mounted result differs from the in-memory one")

        # the storage smoke bundle on the mounted database, driven; the
        # Table XIV plans' device views go first, so the bundle's peak
        # above resident counts its own
        gc.collect()
        torch.cuda.empty_cache()
        with chunk_env(chunk):
            bplan, bres, bundle = drive(
                torch, tag, "storage leg, mmap bundle", lambda: storage_bundle("torch").plan(path)
            )
        blaunches = bundle["launches"]
        bundle["paths"] = check_paths(tag, "storage leg, mmap bundle", bplan, blaunches)
        for name in UNFUSED_KERNELS:
            check(blaunches[name] > 0, f"storage leg: the stored path never launched {name}")
        check(blaunches["fused_hop"] == 0, "storage leg: the unfused bundle launched fused_hop")
        verified(tag, "storage leg, mmap bundle", bplan)
        out["mmap bundle"] = bundle
        out["launches"]["storage, mmap bundle"] = blaunches
        out["kernels"] = storage_kernels(
            torch, tag, capture_launches(bplan.execute, main_path_key))

        want_n, want_s = storage_totals(cols)
        rtol = count_rtol(bplan)
        ok = True
        for label, got, want, col in (
            ("Σ count", bres.column("n"), want_n, "n"),
            ("Σ sum", bres.column("s"), want_s, "s"),
            ("Σ sum (Table XIV)", results["mmap"].column("s"), want_s, "s"),
        ):
            total = float(got.sum())
            exact = float(got.max(initial=0)) < 2 ** 24
            err = abs(total - want) / max(want, 1)
            good = (total == want) if exact else err <= rtol
            ok = ok and good
            say(tag, f"check: storage leg: {label} {total:.0f} vs numpy {want}; largest "
                     f"group {float(got.max(initial=0)):.0f}; "
                     + ("exact below 2**24" if exact else
                        f"relative error {err:.3e} within {rtol:.3e}") + f": {good}")
        check(ok and bres.num_rows > 0, "storage leg: Σ count / Σ sum disagree with numpy")
        for name in bres.agg_names:
            check(bool(np.isfinite(bres.column(name)).all()),
                  f"storage leg: non-finite values in {name}")
        del bplan, bres, results
        torch.cuda.empty_cache()
        storage_checks(torch, tag, args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def storage_kernels(torch, tag, captured) -> dict:
    """The stored bundle's largest ``segment_sum`` and ``segment_reduce``
    launches and its ``coo_spmm`` launch (the leg's own shapes) against
    their plain versions, and timed beside the plain version, the library
    call and the bound.  The segment kernels are held at tolerance 0.
    ``coo_spmm``'s row sums pass 2**24 here, so kernel and plain version
    round in different orders: it is held within
    :func:`spmm_tolerance`'s bound on the captured operands, and at
    tolerance 0 on exact operands at the same rows and columns
    (:func:`spmm_exact_check`)."""
    out = {}
    for name in SEGMENT_KERNELS:
        launches = [lc for key, lc in captured.items()
                    if isinstance(key, tuple) and key[0] == name]
        check(launches, f"storage leg: no {name} launch captured")
        out[name] = segment_regime(torch, tag, name, "largest stored-bundle launch",
                                   max(launches, key=lambda lc: lc.size), path="storage leg")
    check("coo_spmm" in captured, "storage leg: no coo_spmm launch captured")
    lc = captured["coo_spmm"]
    out["coo_spmm"] = coo_spmm_row(torch, tag, "storage leg", "stored-bundle launch", lc,
                                   tol=spmm_tolerance(torch, *lc.args))
    out["coo_spmm"]["exact_operands_max_abs_err"] = spmm_exact_check(
        torch, tag, "storage leg", lc)
    return out


def storage_checks(torch, tag, args, tmp: Path) -> None:
    """At ``--check-n``: the mounted bundle against forced tiny chunks
    (the k-way merge), ``.fused(True)``, the CPU and the in-memory twin,
    bit for bit; a ``Q.maintain`` handle over the mounted database
    against one over the in-memory twin through three 100-row R2
    inserts."""
    import numpy as np

    from repro_torch.api import Q, Sum, TorchChannelEngine
    from repro_torch.relational.relation import Database
    from repro_torch.storage import open_database, write_database

    n = args.check_n
    cols = measured_chain_cols(n, args.seed)
    db = Database.from_mapping(cols)
    write_database(db, tmp / "small")
    path = str(tmp / "small")
    want = storage_bundle("torch").plan(db).execute()
    tiny = max(64, n // 64)
    runs = {"default chunk": storage_bundle("torch").plan(open_database(path))}
    with chunk_env(tiny):
        runs[f"tiny chunks ({tiny} rows)"] = storage_bundle("torch").plan(path)
    runs["fused"] = storage_bundle("torch").fused(True).plan(path)
    runs["device='cpu'"] = storage_bundle(TorchChannelEngine(device="cpu")).plan(path)
    for label, plan in runs.items():
        same = same_result(want, plan.execute())
        say(tag, f"check: storage leg: n={n} mounted, {label} (chunk_rows "
                 f"{plan.chunk_rows}) = in-memory bit for bit: {same}")
        check(same and plan.chunk_rows is not None,
              f"storage leg, n={n}: the mounted {label} result differs")
    check(runs[f"tiny chunks ({tiny} rows)"].chunk_rows == tiny < n,
          "storage leg: the tiny-chunk plan did not stream in chunks of its rows")

    mq = Q.over("R1", "R2", "R3").group_by("R1.g1").agg(s=Sum("R2.m"))
    hm, hd = mq.maintain(db), mq.maintain(open_database(path))
    rng = np.random.default_rng(args.seed + 1)
    jdom = max(4, n // 50)
    for step in range(3):
        delta = {"p0": rng.integers(0, jdom, 100), "p1": rng.integers(0, jdom, 100),
                 "m": rng.integers(1, 100, 100)}
        hm.insert("R2", delta)
        hd.insert("R2", delta)
        same = hm.result() == hd.result()
        say(tag, f"check: storage leg: n={n}: maintained over the mounted database = over "
                 f"the in-memory one after insert {step + 1} of 100 R2 rows: {same}")
        check(same, f"storage leg: maintain diverged at insert {step + 1}")


# ----------------------------------------------------------------------


# ----------------------------------------------------------------------
# serve leg (the query server on the card)
# ----------------------------------------------------------------------

SERVE_WORKERS = 8
SERVE_CLIENTS = 8
SERVE_QUERIES_PER_CLIENT = 6
SERVE_VIEW_BATCHES = 6
SERVE_PAIRS_GROUPS = 40  # the incremental view keeps g1 < 40 and g2 < 40
SERVE_BURST = 8
SERVE_TF32_CLIENTS = 4
SERVE_TF32_QUERIES = 3  # per TF32 client, one after another


def serve_shapes():
    """The reference demo's five shapes (``launch/serve.py``) and the
    ``count`` shape with ``.fused(True)``."""
    from repro_torch.launch.serve import demo_queries

    shapes = demo_queries()
    shapes["count_fused"] = shapes["count"].fused(True)
    return shapes


def percentile_ms(samples: list[float], p: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(samples) * 1e3, p))


def client_load(srv, shapes, clients: int, per_client: int, on_answer=None) -> dict:
    """``clients`` threads, each sending ``per_client`` queries that rotate
    through ``shapes`` (client ``i`` starts at shape ``i``), each waited
    for before the next; returns every answer by (client, query) with its
    latency (host clock, ending when the answer is on the host) and the
    wall time.  Raises if a thread failed or hung."""
    import threading

    names = list(shapes)
    answers, errors = {}, []
    lock = threading.Lock()

    def client(i: int) -> None:
        for j in range(per_client):
            name = names[(i + j) % len(names)]
            try:
                t0 = time.perf_counter()
                res = srv.query(shapes[name])
                dt = time.perf_counter() - t0
                if on_answer is not None:
                    on_answer(name, res)
            except Exception as e:
                with lock:
                    errors.append(f"client {i} query {j} ({name}): {e!r}")
                return
            with lock:
                answers[(i, j)] = (name, res, dt)

    threads = [threading.Thread(target=client, args=(i,), name=f"client-{i}")
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "serve leg: a client thread hung")
    check(not errors, f"serve leg: client errors: {errors[:4]}")
    return {"answers": answers, "wall_s": wall,
            "latencies": [dt for _, _, dt in answers.values()]}


def serve_leg(torch, tag, args, tpch) -> dict:
    """The query server on the card: ``JoinAggServer(db, device="cuda")``
    over C1 at ``--n`` / 2 (the shard leg serves C1 at ``--n``, meshed)
    with the reference demo's integer ``R2.w``,
    answering the five demo shapes and a fused ``count`` from concurrent
    clients, fusing bursts, merging channels, serving two maintained
    views under writes (``by_g1``, whose R1 batches recompute because the
    whole chain folds into R1, and ``pairs``, whose R2 batches propagate
    through the device message caches) and a TCP client; a second server
    answers the dense
    leg's TPCH bundle under a global TF32 setting; at ``--check-n`` a
    ``device="cpu"`` server gives the same answers.  Every answer is held
    against a solo ``plan(db).execute()`` of its spec on the card, bit
    for bit (every partial sum is an integer below 2**24 here)."""
    import threading

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import demo_database
    from repro_torch.relational.relation import Database, Relation
    from repro_torch.serve import JoinAggServer, connect, serve_tcp

    t_leg = time.perf_counter()
    n = args.n // 2
    db = demo_database(n, seed=args.seed)
    shapes = serve_shapes()
    say(tag, f"data: serve leg: C1 n={n} seed={args.seed}, R2.w in [1, 100); shapes "
             f"{list(shapes)}; {SERVE_WORKERS} workers, fusion window 0.002 s")

    # solo oracles on the card, and the view's prefix oracles from a
    # shadow handle: epoch e == R1 insert batches 1..e
    t0 = time.perf_counter()
    solo = {name: q.plan(db).execute() for name, q in shapes.items()}
    oracle_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 7)
    g1_dom = int(db["R1"].columns["g1"].max()) + 1
    p0_dom = int(db["R1"].columns["p0"].max()) + 1
    deltas = [{"g1": rng.integers(0, g1_dom, 1000), "p0": rng.integers(0, p0_dom, 1000)}
              for _ in range(SERVE_VIEW_BATCHES)]
    t0 = time.perf_counter()
    shadow = shapes["count"].plan(db).maintain()
    shadow_build_s = time.perf_counter() - t0
    prefix, shadow_ms = [shadow.result()], []
    for d in deltas:
        t0 = time.perf_counter()
        prefix.append(shadow.insert("R1", d))
        shadow_ms.append((time.perf_counter() - t0) * 1e3)
    say(tag, f"serve leg: solo oracles {oracle_s:.3f} s ({ {k: r.num_rows for k, r in solo.items()} } "
             f"rows); view prefix oracles from a shadow handle built in {shadow_build_s:.3f} s, "
             f"refresh ms alone {[round(x, 1) for x in shadow_ms]}; {handle_stats(shadow)}")
    del shadow

    # the incremental view: the two_group shape on at most 40 x 40 groups,
    # taking R2 batches; with a group relation at each end of the chain
    # nothing folds, so no batch recomputes.  Its last prefix is also held
    # against a fresh execute over the grown database
    pairs_q = (shapes["two_group"].where("R1", "g1", "<", SERVE_PAIRS_GROUPS)
               .where("R4", "g2", "<", SERVE_PAIRS_GROUPS))
    r2 = db["R2"].columns
    pair_deltas = [{"p0": rng.integers(0, int(r2["p0"].max()) + 1, 1000),
                    "p1": rng.integers(0, int(r2["p1"].max()) + 1, 1000),
                    "w": rng.integers(1, 100, 1000)} for _ in range(SERVE_VIEW_BATCHES)]
    t0 = time.perf_counter()
    shadow = pairs_q.plan(db).maintain()
    shadow_build_s = time.perf_counter() - t0
    pair_prefix, pair_shadow_ms = [shadow.result()], []
    for d in pair_deltas:
        t0 = time.perf_counter()
        pair_prefix.append(shadow.insert("R2", d))
        pair_shadow_ms.append((time.perf_counter() - t0) * 1e3)
    pair_stats = handle_stats(shadow)
    del shadow
    grown = Database(relations=dict(db.relations)).add(Relation("R2", {
        a: np.concatenate([r2[a]] + [d[a].astype(r2[a].dtype) for d in pair_deltas]) for a in r2}))
    fresh = same_result(pairs_q.plan(grown).execute(), pair_prefix[-1])
    del grown
    say(tag, f"check: serve leg: view pairs prefix oracles from a shadow handle built in "
             f"{shadow_build_s:.3f} s, {pair_prefix[-1].num_rows} groups, refresh ms alone "
             f"{[round(x, 1) for x in pair_shadow_ms]}; {pair_stats}; last prefix = a fresh "
             f"execute over R2 with every batch appended: {fresh}")
    check(pair_stats["fallback_recomputes"] == 0, "serve leg: a pairs batch recomputed")
    check(fresh, "serve leg: the pairs view's last prefix differs from a fresh execute")

    largest = max(float(np.abs(r.column(a)).max()) for r in solo.values() for a in r.agg_names)
    say(tag, f"serve leg: largest aggregate of any solo answer {largest:.0f} (2**24 = {2 ** 24}): "
             "every partial sum of every served hop is an exact float32 integer")
    check(largest < 2 ** 24, "serve leg: a group passes 2**24; merged = solo is not exact")

    def same_as_solo(name, res):
        check(same_result(solo[name], res),
              f"serve leg: a served {name} answer differs from its solo execute")

    out: dict = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    srv = JoinAggServer(db, device="cuda", workers=SERVE_WORKERS, fusion_window=0.002)
    try:
        # cold (compile, prepare, upload, execute) and warm, per shape
        cold, warm = {}, {}
        for name, q in shapes.items():
            t0 = time.perf_counter()
            res = srv.query(q)
            cold[name] = time.perf_counter() - t0
            same_as_solo(name, res)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                res = srv.query(q)
                times.append(time.perf_counter() - t0)
            warm[name] = float(np.median(times))
            same_as_solo(name, res)
            say(tag, f"serve leg: {name}: cold {cold[name] * 1e3:.1f} ms, warm median of 5 "
                     f"{warm[name] * 1e3:.1f} ms, {res.num_rows} rows")

        # the views: created on the server, their writers refreshing on the
        # card while the clients' queries run; 2 readers per view check
        # every read against the batch prefix of its epoch
        t0 = time.perf_counter()
        view = srv.create_view("by_g1", shapes["count"])
        view_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pairs = srv.create_view("pairs", pairs_q)
        pairs_build_s = time.perf_counter() - t0
        stop = threading.Event()
        reads, torn = {}, []

        def reader(v, oracle, equal, i):
            key = (v.name, i)
            reads[key] = 0
            while not stop.is_set():
                snap = v.read()
                if not equal(snap.result, oracle[snap.epoch]):
                    torn.append((v.name, snap.epoch))
                    return
                reads[key] += 1
                time.sleep(0.005)

        refresh_ms, pairs_ms = [], []

        def writer(v, rel, batches, ms):
            for d in batches:
                t0 = time.perf_counter()
                v.insert(rel, d).result(timeout=600)
                ms.append((time.perf_counter() - t0) * 1e3)

        readers = [threading.Thread(target=reader, args=(v, oracle, equal, i),
                                    name=f"reader-{v.name}-{i}")
                   for v, oracle, equal in ((view, prefix, lambda a, b: a == b),
                                            (pairs, pair_prefix, same_result))
                   for i in range(2)]
        writers = [threading.Thread(target=writer, args=args, name=f"writer-{args[0].name}")
                   for args in ((view, "R1", deltas, refresh_ms),
                                (pairs, "R2", pair_deltas, pairs_ms))]
        for t in readers + writers:
            t.start()
        round1 = client_load(srv, shapes, SERVE_CLIENTS, SERVE_QUERIES_PER_CLIENT)
        for t in writers:
            t.join(timeout=900)
        check(not any(t.is_alive() for t in writers), "serve leg: a view writer hung")
        epochs = {v.name: v.drain() for v in (view, pairs)}
        stop.set()
        for t in readers:
            t.join(timeout=60)
        check(not any(t.is_alive() for t in readers), "serve leg: a view reader hung")
        for name, res, _ in round1["answers"].values():
            same_as_solo(name, res)
        served_pairs = handle_stats(pairs.handle)
        n_reads = {name: sum(n for (v, _), n in reads.items() if v == name)
                   for name in epochs}
        say(tag, f"check: serve leg: view by_g1: built in {view_build_s:.3f} s; {len(deltas)} R1 "
                 f"insert batches of 1000 rows, refresh ms {[round(x, 1) for x in refresh_ms]} "
                 f"(under the client load); {handle_stats(view.handle)}")
        say(tag, f"check: serve leg: view pairs: built in {pairs_build_s:.3f} s; {len(pair_deltas)} "
                 f"R2 insert batches of 1000 rows, refresh ms {[round(x, 1) for x in pairs_ms]} "
                 f"(under the client load and by_g1's writes); {served_pairs}")
        say(tag, f"check: serve leg: views: reads {n_reads} by 2 readers each, torn {torn}; epochs "
                 f"after the drain {epochs}")
        check(all(n > 0 for n in n_reads.values()) and not torn,
              "serve leg: a view read matched no batch prefix")
        check(served_pairs["fallback_recomputes"] == 0,
              "serve leg: a served pairs batch recomputed")
        check(epochs == {"by_g1": len(deltas), "pairs": len(pair_deltas)}
              and view.read().result == prefix[-1]
              and same_result(pairs.read().result, pair_prefix[-1]),
              "serve leg: a view did not reach its last prefix")

        # the same load again, every plan warm: under the profiler, with the
        # peak above what the full cache holds
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        box = {}
        wall, busy, top = idle_share(torch, lambda: box.setdefault(
            "r", client_load(srv, shapes, SERVE_CLIENTS, SERVE_QUERIES_PER_CLIENT)), cpu=False)
        round2 = box["r"]
        peak = torch.cuda.max_memory_allocated()
        for name, res, _ in round2["answers"].values():
            same_as_solo(name, res)
        n_q = SERVE_CLIENTS * SERVE_QUERIES_PER_CLIENT
        for label, r in (("mixed load, first round (view writes, merged compiles)", round1),
                         ("mixed load, second round (warm, profiled)", round2)):
            say(tag, f"serve leg: {label}: {n_q} queries from {SERVE_CLIENTS} clients in "
                     f"{r['wall_s']:.3f} s = {n_q / r['wall_s']:.2f} queries/s; latency p50 "
                     f"{percentile_ms(r['latencies'], 50):.1f} ms, p99 "
                     f"{percentile_ms(r['latencies'], 99):.1f} ms, max "
                     f"{max(r['latencies']) * 1e3:.1f} ms")
        say(tag, f"profile: serve leg, second round: {wall:.3f} s wall, device busy {busy:.3f} s, "
                 f"idle share {1 - busy / wall:.3f}; device peak {peak} B, {peak - resident} B "
                 f"above the {resident} B resident with the cache full")
        for name, ms, cnt in top[:8]:
            say(tag, f"profile: {ms:10.3f} ms x{cnt:<6d} {name[:140]}")

        # 8 identical queries: one burst (one execute) vs one after another
        fusion0 = srv.stats()["fusion"]
        t0 = time.perf_counter()
        futs = [srv.submit(shapes["sum"]) for _ in range(SERVE_BURST)]
        burst = [f.result(timeout=600) for f in futs]
        burst_s = time.perf_counter() - t0
        fusion1 = srv.stats()["fusion"]
        t0 = time.perf_counter()
        serial = [srv.query(shapes["sum"]) for _ in range(SERVE_BURST)]
        serial_s = time.perf_counter() - t0
        for res in burst + serial:
            same_as_solo("sum", res)
        shared = fusion1["shared_identical"] - fusion0["shared_identical"]
        batches = fusion1["batches"] - fusion0["batches"]
        say(tag, f"check: serve leg: burst of {SERVE_BURST} identical sum queries: "
                 f"{burst_s * 1e3:.1f} ms fused vs {serial_s * 1e3:.1f} ms serial; shared_identical "
                 f"+{shared}, batches +{batches}")
        check(shared == SERVE_BURST and batches == 1,
              "serve leg: the identical burst did not run as one execute")

        # a count/sum/multi burst by R1.g1: one channel-merged pass
        f0 = srv.stats()["fusion"]
        futs = {name: srv.submit(shapes[name]) for name in ("count", "sum", "multi")}
        merged = {name: f.result(timeout=600) for name, f in futs.items()}
        f1 = srv.stats()["fusion"]
        for name, res in merged.items():
            same_as_solo(name, res)
        merged_n = f1["merged_channels"] - f0["merged_channels"]
        say(tag, f"check: serve leg: count/sum/multi burst: merged_channels +{merged_n}, each "
                 f"demuxed answer = its solo answer bit for bit")
        check(merged_n >= 2, "serve leg: the count/sum/multi burst merged no channels")

        # one TCP round trip
        tcp, _ = serve_tcp(srv)
        try:
            with connect(*tcp.server_address) as remote:
                t0 = time.perf_counter()
                rres = remote.query({"relations": ["R1", "R2", "R3", "R4"],
                                     "group_by": ["R1.g1"], "aggs": {"n": {"kind": "count"}}})
                tcp_ms = (time.perf_counter() - t0) * 1e3
                remote_epoch, _ = remote.view_read("by_g1")
                stats = remote.server_stats()
        finally:
            tcp.shutdown()
            tcp.server_close()
        same = rres.to_dict("n") == solo["count"].to_dict("n")
        say(tag, f"check: serve leg: TCP round trip {tcp_ms:.1f} ms = in-process answer: "
                 f"{same}; view epoch over TCP {remote_epoch}")
        check(same and remote_epoch == len(deltas), "serve leg: the TCP answer differs")
    finally:
        srv.close()
    launches = ops.launch_counts()

    pc, fusion = stats["plan_cache"], stats["fusion"]
    served = 2 * n_q + 6 * len(shapes) + 2 * SERVE_BURST + 3 + 1
    say(tag, f"serve leg: device {stats['device']}; plan cache {pc}; fusion {fusion}; "
             f"{served} queries served; launches {launches}")
    check(pc["compiles"] < served, "serve leg: the plan cache compiled once per query")
    for name in ("segment_sum", "coo_spmm", "segment_reduce", "fused_hop"):
        check(launches[name] > 0, f"serve leg: the served queries never launched {name}")

    tf32 = serve_tf32(torch, tag, tpch)
    launches = {k: launches[k] + tf32[k] for k in launches}
    serve_cpu_check(torch, tag, args)
    out.update(
        cold_ms={k: v * 1e3 for k, v in cold.items()}, warm_ms={k: v * 1e3 for k, v in warm.items()},
        round1={"wall_s": round1["wall_s"], "qps": n_q / round1["wall_s"],
                "p50_ms": percentile_ms(round1["latencies"], 50),
                "p99_ms": percentile_ms(round1["latencies"], 99)},
        round2={"wall_s": round2["wall_s"], "qps": n_q / round2["wall_s"],
                "p50_ms": percentile_ms(round2["latencies"], 50),
                "p99_ms": percentile_ms(round2["latencies"], 99),
                "device_busy_s": busy, "idle_share": 1 - busy / wall,
                "peak_above_resident_bytes": peak - resident, "resident_bytes": resident},
        burst_ms=burst_s * 1e3, serial_ms=serial_s * 1e3, view_build_s=view_build_s,
        view_refresh_ms=refresh_ms, view_refresh_alone_ms=shadow_ms, pairs_build_s=pairs_build_s,
        pairs_refresh_ms=pairs_ms, pairs_refresh_alone_ms=pair_shadow_ms, tcp_ms=tcp_ms,
        plan_cache=pc, fusion=fusion,
        queries_served=served, leg_s=time.perf_counter() - t_leg,
    )
    out["kernels"] = serve_kernels(torch, tag, srv, shapes)
    out["launches"] = {"serve": launches}
    say(tag, f"serve leg: {out['leg_s']:.1f} s")
    return out


def serve_tf32(torch, tag, tpch) -> dict:
    """The dense leg's TPCH bundle from 4 concurrent clients of a second
    server, 3 queries each, under a global ``allow_tf32 = True``: every
    einsum term must
    run with TF32 off (a spy on ``contract_term`` reads the switch before
    and after each term, with 1 ms between the read and the products to
    widen the window a lost restore would fall in; the data's integer
    products are exact even in TF32, so the bits alone cannot show it),
    every answer equals the dense leg's FP32 result bit for bit, and the
    setting is still on afterwards (``full_fp32_matmul`` is counted
    across threads)."""
    import threading

    from repro_torch.core import torch_engine
    from repro_torch.kernels import ops
    from repro_torch.serve import JoinAggServer

    db, q, dres = tpch
    spec = tpch_query(q, "torch")
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    answers, errors, seen = [], [], []
    real = torch_engine.contract_term

    def spy(expr, operands):
        first = matmul.allow_tf32
        time.sleep(0.001)
        out = real(expr, operands)
        seen.append((first, matmul.allow_tf32))
        return out

    ops.reset_launch_counts()
    matmul.allow_tf32 = True
    try:
        with JoinAggServer(db, device="cuda", workers=SERVE_TF32_CLIENTS, fuse=False) as srv:
            plan = srv.plan_cache.lookup(spec, db)
            path = plan.engine.path(plan.prep, plan.channels)
            start = threading.Barrier(SERVE_TF32_CLIENTS, timeout=300)

            def client():
                start.wait()
                try:
                    for _ in range(SERVE_TF32_QUERIES):
                        answers.append(srv.query(spec))
                except Exception as e:
                    errors.append(repr(e))

            threads = [threading.Thread(target=client) for _ in range(SERVE_TF32_CLIENTS)]
            torch_engine.contract_term = spy
            try:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
            finally:
                torch_engine.contract_term = real
        still = matmul.allow_tf32
    finally:
        matmul.allow_tf32 = before
    launches = ops.launch_counts()
    same = (len(answers) == SERVE_TF32_CLIENTS * SERVE_TF32_QUERIES
            and all(same_result(dres, a) for a in answers))
    tf32_terms_seen = sum(a or b for a, b in seen)
    say(tag, f"check: serve leg: TPCH bundle ({path} path) from {SERVE_TF32_CLIENTS} concurrent "
             f"clients x {SERVE_TF32_QUERIES} queries with allow_tf32 = True set globally: "
             f"{len(seen)} einsum terms, {tf32_terms_seen} "
             f"of them with TF32 on at their start or end; {len(answers)} answers bit-identical "
             f"to the dense leg's FP32 result: {same}; allow_tf32 still True after: {still}; "
             f"errors {errors}")
    check(path == "dense", "serve leg: the TPCH bundle did not take the dense path")
    check(seen and tf32_terms_seen == 0, "serve leg: a concurrent dense term ran with TF32 on")
    check(same and still and not errors,
          "serve leg: concurrent dense queries under TF32 changed a result or lost the setting")
    return launches


def serve_cpu_check(torch, tag, args) -> None:
    """At ``--check-n``: the same clients against a ``device="cpu"`` server
    and a ``device="cuda"`` server, answer by answer, bit for bit."""
    from repro_torch.launch.serve import demo_database
    from repro_torch.serve import JoinAggServer

    db = demo_database(args.check_n, seed=args.seed)
    shapes = serve_shapes()
    runs = {}
    for device in ("cpu", "cuda"):
        with JoinAggServer(db, device=device, workers=SERVE_WORKERS, fusion_window=0.002) as srv:
            runs[device] = client_load(srv, shapes, SERVE_CLIENTS, SERVE_QUERIES_PER_CLIENT)
    same = all(
        name == runs["cuda"]["answers"][key][0]
        and same_result(res, runs["cuda"]["answers"][key][1])
        for key, (name, res, _) in runs["cpu"]["answers"].items()
    ) and len(runs["cpu"]["answers"]) == len(runs["cuda"]["answers"])
    say(tag, f"check: serve leg: C1 n={args.check_n}: {len(runs['cpu']['answers'])} answers "
             f"from a device='cpu' server bit-identical to a device='cuda' server: {same}")
    check(same, "serve leg: the cuda server's answers differ from the cpu server's")


def serve_kernels(torch, tag, srv, shapes) -> dict:
    """The served plans' own launches against the plain versions at
    tolerance 0 (every partial sum is an integer below 2**24): the
    largest ``segment_sum``, ``coo_spmm`` and ``segment_reduce`` launch of
    the five unfused cached shapes and the largest ``fused_hop`` of
    ``count_fused``, each timed beside its plain version, the library
    call and the bound.  These executes are not counted."""

    def cached(name):
        return srv.plan_cache.lookup(shapes[name], srv.db, srv.generation, srv.stats_generation)

    out, captured = {}, {}
    for shape in ("count", "sum", "multi", "minmax", "two_group"):
        for key, lc in capture_launches(cached(shape).execute, main_path_key).items():
            if key not in captured or lc.size > captured[key].size:
                captured[key] = lc
    for name in SEGMENT_KERNELS:
        launches = [lc for key, lc in captured.items() if isinstance(key, tuple) and key[0] == name]
        check(launches, f"serve leg: no {name} launch captured")
        out[name] = segment_regime(torch, tag, name, "largest served launch",
                                   max(launches, key=lambda lc: lc.size), path="serve leg")
    check("coo_spmm" in captured, "serve leg: no coo_spmm launch captured")
    out["coo_spmm"] = coo_spmm_row(torch, tag, "serve leg", "largest served launch",
                                   captured["coo_spmm"], tol=None)
    fused = capture_launches(cached("count_fused").execute, hop_class)
    check(fused, "serve leg: no fused_hop launch captured")
    out["fused_hop"] = fused_hop_row(torch, tag, "serve leg", fused)
    return out


def fused_hop_row(torch, tag, path: str, captured) -> dict:
    """The largest captured ``fused_hop`` launch (``hop_class`` keys)
    against its plain version at tolerance 0, timed beside the plain
    version, the library call of its hop class and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import fused_hop

    _, lc = max(captured.items(), key=lambda kv: kv[1].size)
    err = compare(torch, tag, "fused_hop", f"{path}, largest launch", fused_hop,
                  ref.fused_hop, lc.args)
    keys, w, msgs, idxs, s, k, kind = lc.args
    row = dict(
        shapes={"edges": keys.shape[0], "k": k, "num_segments": s, "kind": kind,
                "messages": [list(m.shape) for m in msgs]},
        launches=lc.count, max_abs_err=err, ms=time_ms(torch, lambda: fused_hop(*lc.args)),
        **hop_yardsticks(torch, lc.args),
    )
    library_ms = row["library_ms"]
    say(tag, f"kernels: fused_hop [{path}] at {row['shapes']}: {row['ms']:.4f} ms, bound "
             f"{row['bound_ms']:.4f} ms by {row['bound_by']}, plain {row['plain_ms']:.4f} ms, "
             f"library {row['library']} "
             f"{library_ms if library_ms is None else f'{library_ms:.4f}'} ms")
    return row


def hop_yardsticks(torch, args) -> dict:
    """What one ``fused_hop`` launch (``args`` as the engine passes them)
    is held against: its bound from bytes and operations, its plain
    version's ms and the ms of the library call of its hop class
    (``fused_library``)."""
    from repro_torch.kernels import ref

    keys, w, msgs, idxs, s, k, kind = args
    n = keys.shape[0]
    width, nbytes = 1, n * 8 + n * k * 4
    for msg, idx in zip(msgs, idxs):
        width *= msg.shape[1] // k
        nbytes += n * 8 + int(torch.unique(idx).numel()) * msg.shape[1] * 4
    nbytes += s * width * k * 4
    b, by = bound(nbytes, n * width * k * (len(msgs) + 1))
    library, library_ms = fused_library(torch, args, bool((w == w[:, :1]).all()))
    return dict(bound_ms=b, bound_by=by, library=library, library_ms=library_ms,
                plain_ms=time_ms(torch, lambda: ref.fused_hop(*args), reps=3))


# ----------------------------------------------------------------------
# shard leg (the sharded path over torch.distributed)
# ----------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4)
SHARD_TIMEOUT_S = 480  # one group's ranks, spawn to exit
SERVED_WORLD = 2  # the group that also serves meshed
SERVED_WARM = 5


TABLE_ONE_N = 500_000  # the paper's scale (Table I)
REF_B2_N = 500_000
REF_MAINTAIN_N = 100_000


def table_one(torch, tag, args) -> list[dict]:
    """The paper's Table I on the card: the data graph of every
    synthetic dataset at ``TABLE_ONE_N`` rows per relation; at
    ``--check-n`` the card's graph equals the CPU's, tensor for tensor."""
    from repro_torch.core.datagraph import build_data_graph
    from repro_torch.core.prepare import prepare
    from repro_torch.data import synth

    rows = []
    for name in synth.ALL:
        db, q = synth.make(name, TABLE_ONE_N, seed=args.seed)
        prep = prepare(q, db)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = build_data_graph(prep)
        torch.cuda.synchronize()
        row = dict(dataset=name, rows=TABLE_ONE_N, nodes=g.num_nodes, edges=g.num_edges,
                   memory_bytes=g.memory_bytes(), device_bytes=g.device_bytes(),
                   seconds=time.perf_counter() - t0)
        del g, prep, db
        small_db, small_q = synth.make(name, args.check_n, seed=args.seed)
        small = prepare(small_q, small_db)
        card, cpu = build_data_graph(small), build_data_graph(small, device="cpu")
        same = (
            (card.num_nodes, card.num_edges, card.memory_bytes())
            == (cpu.num_nodes, cpu.num_edges, cpu.memory_bytes())
            and all(torch.equal(getattr(card, a).cpu(), getattr(cpu, a))
                    for a in ("offsets", "edge_dst", "edge_mult", "node_type"))
            and all(torch.equal(card.blocks[k].codes.cpu(), b.codes)
                    for k, b in cpu.blocks.items())
        )
        say(tag, f"ref leg: Table I: {name} n={TABLE_ONE_N}: {row['nodes']} nodes, "
                 f"{row['edges']} edges, memory_bytes() {row['memory_bytes']} B, device "
                 f"{row['device_bytes']} B, built in {row['seconds']:.3f} s; at "
                 f"n={args.check_n} card = device='cpu' ({cpu.num_nodes} nodes, "
                 f"{cpu.num_edges} edges): {same}")
        check(same, f"ref leg: {name}: the card's data graph differs from the CPU's")
        rows.append(row)
    return rows


def ref_execute(torch, plan):
    """``plan.execute()`` on the ref engine with the launch counts set to
    0 just before and read just after: the result, wall seconds (ending
    in a synchronise), launches, device peak above what was allocated
    before, and the engine's own ``RefRun`` (stage seconds, peak rows)."""
    from repro_torch.core import ref_engine
    from repro_torch.kernels import ops

    runs = []
    real = ref_engine.ref_run

    def spy(*a, **kw):
        runs.append(real(*a, **kw))
        return runs[-1]

    ref_engine.ref_run = spy
    try:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = plan.execute()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        ref_engine.ref_run = real
    check(len(runs) == 1, "ref leg: the plan did not run the ref engine once")
    return res, secs, launches, torch.cuda.max_memory_allocated() - resident, runs[0]


def ref_run_line(run) -> str:
    return (f"data graph {run.graph_s:.3f} s, Stage 2 {run.stage2_s:.3f} s, Stage 3 "
            f"{run.stage3_s:.3f} s, peak rows {run.peak_rows}, {run.tiles} tiles "
            f"({run.splits} splits)")


def ref_leg(torch, tag, args, db, cols, digest: str, main: dict) -> dict:
    """The paper's own engine on the card (see 16 in the module
    docstring)."""
    from repro_torch.api import Count, Q, RefChannelEngine, Sum
    from repro_torch.core import ref_engine

    t_leg = time.perf_counter()
    seconds = {}
    table = table_one(torch, tag, args)
    seconds["table I"] = time.perf_counter() - t_leg

    # the main path's C1 bundle through "ref", on leg 2's data
    t0 = time.perf_counter()
    plan = bundle_query("ref").plan(db)
    prepare_s = time.perf_counter() - t0
    res, secs, launches, peak, run = ref_execute(torch, plan)
    want_n, want_s = chain_totals(cols)
    got_n, got_s = res.column("n").sum(), res.column("s").sum()
    same = result_digest(res) == digest
    say(tag, f"ref leg: C1 n={args.n} bundle through .engine('ref'): prepare {prepare_s:.3f} "
             f"s, execute {secs:.3f} s ({ref_run_line(run)}), {res.num_rows} rows, "
             f"launches {launches}; device peak {peak} B above resident against the "
             f"torch engine's {main['peak_above_resident_bytes']} B (warm execute "
             f"{main['warm_execute_s']:.3f} s)")
    say(tag, f"check: ref leg: C1: Σ count {got_n:.0f} vs numpy {want_n}; Σ sum {got_s:.0f} "
             f"vs numpy {want_s}; result digest equal to the main path's: {same}")
    check(same, "ref leg: the C1 bundle through ref differs from the main path's result")
    check(got_n == want_n and got_s == want_s, "ref leg: C1 Σ count / Σ sum disagree with numpy")
    for name in SEGMENT_KERNELS:
        check(launches[name] > 0, f"ref leg: the C1 bundle never launched {name}")
    c1 = dict(prepare_s=prepare_s, execute_s=secs, rows=res.num_rows, graph_s=run.graph_s,
              stage2_s=run.stage2_s, stage3_s=run.stage3_s, peak_rows=run.peak_rows,
              tiles=run.tiles, splits=run.splits, peak_above_resident_bytes=peak,
              torch_peak_above_resident_bytes=main["peak_above_resident_bytes"])
    captured = capture_launches(plan.execute, main_path_key, modules=(ref_engine,))
    del plan, res, run
    seconds["C1"] = time.perf_counter() - t_leg - seconds["table I"]

    # B2: path-ids and cross products, against the torch engine
    t0 = time.perf_counter()
    b2c, bq = b2_cols(REF_B2_N, args.seed)

    def b2_spec(engine):
        return (Q.over(*bq.relations).group_by("R1.g1", "R3.g2", "R4.g3")
                .agg(n=Count(), s=Sum("R2.m")).engine(engine))

    torch_res = b2_spec("torch").execute(b2c)
    bres, bsecs, blaunches, bpeak, brun = ref_execute(torch, b2_spec("ref").plan(b2c))
    same = same_result(bres, torch_res)
    total = b2_total(b2c)
    say(tag, f"ref leg: B2 n={REF_B2_N} COUNT/SUM through .engine('ref'): execute "
             f"{bsecs:.3f} s ({ref_run_line(brun)}), {bres.num_rows} rows, launches "
             f"{blaunches}, device peak {bpeak} B above resident")
    say(tag, f"check: ref leg: B2: every column bit-identical to .engine('torch'): {same}; "
             f"Σ count {bres.column('n').sum():.0f} vs numpy {total}")
    check(same and bres.num_rows > 0, "ref leg: B2 through ref differs from the torch engine")
    check(bres.column("n").sum() == total, "ref leg: B2 Σ count disagrees with numpy")
    b2 = dict(execute_s=bsecs, rows=bres.num_rows, graph_s=brun.graph_s,
              stage2_s=brun.stage2_s, stage3_s=brun.stage3_s, peak_rows=brun.peak_rows,
              tiles=brun.tiles, splits=brun.splits, peak_above_resident_bytes=bpeak)
    del torch_res, bres, brun, b2c
    seconds["B2"] = time.perf_counter() - t0

    # the card against the CPU at --check-n
    t0 = time.perf_counter()
    small, _ = chain_db(args.check_n, args.seed)
    small_b2, _ = b2_cols(args.check_n, args.seed)
    cpu = RefChannelEngine(device="cpu")
    for label, card_q, cpu_q, data in (
        ("C1 bundle", bundle_query("ref"), bundle_query(cpu), small),
        ("B2 COUNT/SUM", b2_spec("ref"), b2_spec(cpu), small_b2),
    ):
        gpu, host = card_q.execute(data), cpu_q.execute(data)
        same = same_result(gpu, host)
        say(tag, f"check: ref leg: {label} n={args.check_n}: {host.num_rows} rows, every "
                 f"column bit-identical to device='cpu': {same}")
        check(same and host.num_rows > 0, f"ref leg: {label}: the card differs from the CPU")
    seconds["card = cpu"] = time.perf_counter() - t0

    # maintenance: a "ref" COUNT handle on B2
    t0 = time.perf_counter()
    mcols, mq = b2_cols(REF_MAINTAIN_N, args.seed)

    def count_spec():
        return (Q.over(*mq.relations).group_by("R1.g1", "R3.g2", "R4.g3")
                .agg(n=Count()).engine("ref"))

    handle = count_spec().maintain(mcols)
    check(handle.result() == count_spec().execute(mcols).to_dict("n"),
          "ref leg: the maintained handle starts off the fresh answer")
    batches = {b[0]: b for b in b2_batches(mcols, args.seed)}
    refreshes = []
    for label, op, rel, batch in (batches["insert 100 into R2"],
                                  batches[f"insert {MAINTAIN_SIDE} into R3, new b and g2"],
                                  batches[f"insert {MAINTAIN_SIDE} into R1 (root)"],
                                  batches[f"delete {MAINTAIN_DELETE} from R2"]):
        row = timed_refresh(torch, handle, op, rel, batch)
        mcols = mirrored(mcols, op, rel, batch)
        fresh, fresh_ms, _ = from_scratch(torch, count_spec(), mcols)
        same = handle.result() == fresh.to_dict("n")
        say(tag, f"ref leg: maintain B2 n={REF_MAINTAIN_N}: {label}: refresh {row['ms']:.1f} "
                 f"ms (rows rescanned {row['rows_rescanned']}, recomputes "
                 f"{row['fallback_recomputes']}, launches {row['launches']}) against a "
                 f"from-scratch ref run {fresh_ms:.1f} ms; equal to it: {same}")
        check(same, f"ref leg: maintain: {label}: the handle differs from a fresh run")
        refreshes.append(dict(batch=label, ms=row["ms"], scratch_ms=fresh_ms,
                              rows_rescanned=row["rows_rescanned"]))
    seconds["maintain"] = time.perf_counter() - t0

    # the C1 run's largest segment launches against their plain versions
    kernels = {}
    for name in SEGMENT_KERNELS:
        seg = [lc for key, lc in captured.items() if isinstance(key, tuple) and key[0] == name]
        check(bool(seg), f"ref leg: no {name} launch captured")
        kernels[name] = segment_regime(torch, tag, name, "largest C1 ref launch",
                                       max(seg, key=lambda lc: lc.size), path="ref leg")
    leg_s = time.perf_counter() - t_leg
    say(tag, f"ref leg: the leg took {leg_s:.1f} s ("
             + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    return {"seconds": leg_s, "part_seconds": seconds, "table_one": table, "c1": c1,
            "b2": b2, "maintain": refreshes, "kernels": kernels,
            "launches": {"ref": launches}}


# PERF.md §6's few-row hops as one-child sum hops: (label, edges, rows,
# d, operand rows): the storage root hop and the maintain root rescan
FEW_ROW_HOPS = (
    ("storage root hop", 2_530_424, 32, 64, 100_000),
    ("maintain root rescan", 81_675, 50, 2600, 50_000),
)


def tuned_candidates(torch, tag, label, entry, args, fixed_out) -> list[dict]:
    """Launch every candidate that a tuned key measured (``entry`` of
    ``autotune.measurement_log()``) on the hop ``args`` and fail unless
    each output equals the fixed plan's ``fixed_out`` bit for bit; the
    candidates' ms are the measurement's own."""
    from repro_torch.kernels.fused_hop import fused_hop

    dims = entry["dims"]
    rows = []
    for plan, ms in entry["measured"]:
        got = fused_hop(*args, plan=plan.make(*dims))
        same = bool(torch.equal(got, fixed_out))
        check(same, f"autotune leg: {label}: {plan.key()} differs from the fixed plan")
        rows.append({"plan": plan.key(), "ms": ms, "equal_to_fixed": same})
    say(tag, f"autotune leg: {label}: measured " + ", ".join(
        f"{r['plan']} {r['ms']:.4f} ms" for r in rows) + f"; model pick {entry['model'].key()}, "
        f"winner {entry['winner'].key()}, fixed {entry['fixed'].key()}; every candidate "
        f"bit-identical to the fixed plan: {all(r['equal_to_fixed'] for r in rows)}")
    return rows


def autotune_leg(torch, tag, args, db, digest: str, fused: dict) -> dict:
    """The fused hop's tuned launch shapes (see 17 in the module
    docstring)."""
    from repro_torch.core import torch_engine
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels.fused_hop import fused_hop

    t_leg = time.perf_counter()
    dev = torch.device("cuda")
    log = autotune.measurement_log()
    plan = bundle_query("torch").fused(True).plan(db)
    c1_keys = {}
    for r in plan.fused_runs():
        for e in torch_engine.hop_launch_shapes(r["prep"], r["k"], r["encoded"], r["domains"]):
            for kind in (("sum",) if r["pass"] != "min/max" else ("min", "max")):
                shape = autotune.hop_shape(e["edges"], e["child_rows"], k=r["k"], kind=kind,
                                           child_widths=e["child_widths"],
                                           num_segments=e["num_segments"])
                c1_keys[autotune.cache_key(shape, dev)] = shape
    tuned_c1 = {key: log[key] for key in c1_keys if key in log}
    check(tuned_c1, "autotune leg: leg 3 tuned none of the C1 bundle's hops")
    say(tag, f"autotune leg: the fused C1 bundle has {len(c1_keys)} hop shape keys, "
             f"{len(tuned_c1)} tuned in leg 3 ({fused['tuning']['measurements']} measurements, "
             f"{fused['tuning']['timing_launches']} timing launches)")

    # (a) every tuned key of the C1 bundle: its candidates on the hop's own
    # operands, each bit-identical to the fixed plan, the fixed plan timed
    rows, seen = [], set()
    real = torch_engine.fused_hop

    def spy(*a, plan=None, **kw):
        shape, dims = hop_shape_of(a)
        key = autotune.cache_key(shape, dev) if dims[1] and dims[2] else None
        if key in tuned_c1 and key not in seen:
            seen.add(key)
            entry = tuned_c1[key]
            fixed_out = fused_hop(*a).clone()
            cands = tuned_candidates(torch, tag, f"C1 {shape.key()}", entry, a, fixed_out)
            fixed_ms = time_ms(torch, lambda: fused_hop(*a), reps=5)
            won = entry["winner"].make(*dims)
            tuned_ms = time_ms(torch, lambda: fused_hop(*a, plan=won), reps=5)
            row = {"key": shape.key(), "dims": list(dims), "plan": entry["winner"].key(),
                   "model": entry["model"].key(), "ms": tuned_ms, "fixed_ms": fixed_ms,
                   "candidates": cands}
            if entry["winner"] != entry["fixed"]:  # a shape PERF.md §6 has no row for
                row.update(hop_yardsticks(torch, a))
            rows.append(row)
            say(tag, f"autotune leg: C1 {shape.key()} at {dims}: tuned {entry['winner'].key()} "
                     f"{tuned_ms:.4f} ms, fixed {entry['fixed'].key()} {fixed_ms:.4f} ms"
                     + ("" if "bound_ms" not in row else
                        f"; bound {row['bound_ms']:.4f} ms by {row['bound_by']}, plain "
                        f"{row['plain_ms']:.4f} ms, library {row['library']} "
                        f"{row['library_ms']} ms"))
        return real(*a, plan=plan, **kw)

    torch_engine.fused_hop = spy
    try:
        res = plan.execute()
        torch.cuda.synchronize()
    finally:
        torch_engine.fused_hop = real
    check(seen == set(tuned_c1), "autotune leg: a tuned C1 key was not launched again")
    check(result_digest(res) == digest, "autotune leg: the fused C1 bundle changed its bits")

    # (b) the few-row hops, tuned on their first launch through the engine
    g = torch.Generator(device="cpu").manual_seed(args.seed + 17)
    few = []
    for label, n, s, d, operand_rows in FEW_ROW_HOPS:
        keys = torch.sort(torch.randint(0, s, (n,), generator=g)).values.to(dev)
        idx = torch.randint(0, operand_rows, (n,), generator=g).to(dev)
        w = torch.randint(0, 4, (n, 1), generator=g).float().to(dev)
        m2 = torch.randint(-3, 4, (operand_rows, d), generator=g).float().to(dev)
        hop = (keys, w, [m2], [idx], s, 1, "sum")
        shape, dims = hop_shape_of(hop)
        key = autotune.cache_key(shape, dev)
        before = autotune.stats()
        t0 = time.perf_counter()
        out = torch_engine.contract_hop(keys, keys.cpu().numpy(), w, [(m2, idx)], s, "sum", True)
        torch.cuda.synchronize()
        miss_s = time.perf_counter() - t0
        check(autotune.stats()["measurements"] == before["measurements"] + 1,
              f"autotune leg: {label}: the first launch did not tune")
        fixed_out = fused_hop(*hop).clone()
        check(bool(torch.equal(out, fixed_out)), f"autotune leg: {label}: tuned != fixed")
        check(bool(torch.equal(fixed_out, ref.fused_hop(*hop))),
              f"autotune leg: {label}: the kernel differs from its plain version")
        entry = autotune.measurement_log()[key]
        cands = tuned_candidates(torch, tag, label, entry, hop, fixed_out)
        won = entry["winner"].make(*dims)
        tuned_ms = time_ms(torch, lambda: fused_hop(*hop, plan=won), reps=3)
        fixed_ms = time_ms(torch, lambda: fused_hop(*hop), reps=3)
        row = {"key": shape.key(), "label": label, "dims": list(dims),
               "operand": [operand_rows, d], "plan": entry["winner"].key(),
               "model": entry["model"].key(), "ms": tuned_ms, "fixed_ms": fixed_ms,
               "first_launch_s": miss_s, "candidates": cands, **hop_yardsticks(torch, hop)}
        few.append(row)
        say(tag, f"autotune leg: {label}, {n} edges into {s} rows of d = {d} from a "
                 f"({operand_rows}, {d}) operand: tuned {entry['winner'].key()} "
                 f"{tuned_ms:.4f} ms against fixed {fixed_ms:.4f} ms ({fixed_ms / tuned_ms:.2f}x); "
                 f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}; plain "
                 f"{row['plain_ms']:.4f} ms; {row['library']} {row['library_ms']:.4f} ms; the "
                 f"first, tuning launch took {miss_s:.3f} s; bit-identical to the fixed plan and "
                 "to the plain version")
        del keys, idx, w, m2, hop, out, fixed_out

    # (c) the memory cache dropped: the bundle again, every plan read back
    # from the file, nothing measured, the same bits
    plans_before = {key: autotune.cached_plan_for(shape, dev) for key, shape in c1_keys.items()}
    autotune.reset_cache()
    before = autotune.stats()
    t0 = time.perf_counter()
    res = plan.execute()
    torch.cuda.synchronize()
    reread_s = time.perf_counter() - t0
    after = autotune.stats()
    plans_after = {key: autotune.cached_plan_for(shape, dev) for key, shape in c1_keys.items()}
    same = result_digest(res) == digest
    say(tag, f"autotune leg: after reset_cache() the fused C1 bundle took "
             f"{after['measurements'] - before['measurements']} measurements, read "
             f"{sum(v is not None for v in plans_after.values())} plans back from "
             f"{autotune.cache_path()} equal to the tuned ones: {plans_after == plans_before}; "
             f"{reread_s:.3f} s; digest equal to leg 2's: {same}")
    check(after["measurements"] == before["measurements"], "autotune leg: a hit measured")
    check(plans_after == plans_before, "autotune leg: the file gave other plans back")
    check(same, "autotune leg: the bundle changed its bits after reset_cache()")

    # (d) what tuning cost leg 3's cold execute
    say(tag, f"autotune leg: leg 3's cold fused execute with tuning {fused['cold_execute_s']:.3f} s "
             f"({fused['tuning']['measurements']} measurements, "
             f"{fused['tuning']['timing_launches']} timing launches), its warm execute "
             f"{fused['warm_execute_s']:.3f} s, the execute after reset_cache() {reread_s:.3f} s")
    seconds = time.perf_counter() - t_leg
    say(tag, f"autotune leg: {seconds:.1f} s")
    check(seconds < 30, f"autotune leg: took {seconds:.1f} s, over its 30 s")
    return {"tuned": rows + few, "seconds": seconds, "reread_execute_s": reread_s,
            "measurements": autotune.stats()["measurements"]}


def result_digest(res) -> str:
    """sha256 over every column's name, dtype, shape and bytes: equal
    digests are results equal bit for bit."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for name, col in res.relation.columns.items():
        col = np.ascontiguousarray(col)
        if col.dtype == object:
            col = col.astype(str)
        h.update(f"{name}:{col.dtype.str}:{col.shape}:".encode())
        h.update(col.tobytes())
    return h.hexdigest()


def skew_chain_db(n: int, seed: int):
    """C1 at ``n`` rows with both group attributes folded onto 2 codes:
    over 4 shards of the root group attribute the last two own no rows.
    The measure is folded onto [0, 4), so that at 20,000 rows every
    group's COUNT and SUM stays below 2**24 (4 groups hold every path):
    float32 sums are then exact in any order, and bits can be compared."""
    from repro_torch.relational.relation import Database

    _, cols = chain_db(n, seed)
    cols["R1"]["g1"] = cols["R1"]["g1"] % 2
    cols["R4"]["g2"] = cols["R4"]["g2"] % 2
    cols["R3"]["m"] = cols["R3"]["m"] % 4
    return Database.from_mapping(cols)


def shard_rank(rank: int, world: int, out_dir: str, job: dict) -> None:
    """One rank of a shard-leg group (a process of its own): join the
    group through the ``file://`` store under ``out_dir`` and run
    :func:`shard_rank_run`; write its numbers to ``rank<r>.json``, or the
    traceback to ``rank<r>.err``, and exit non-zero on any failure."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            job["backend"], init_method=f"file://{out_dir}/store", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S),
        )
        try:
            out = shard_rank_run(torch, dist, rank, world, job)
        finally:
            dist.destroy_process_group()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def shard_rank_run(torch, dist, rank: int, world: int, job: dict) -> dict:
    """The rank's part of the leg: the C1 bundle through ``Q ...
    .mesh(world).plan(db).execute()``, unfused then fused, each cold and
    warm with its launches counted from 0 over the cold execute and the
    walk and the all_gather timed apart; its answer must equal the
    parent's single-device execute bit for bit and Σ COUNT / Σ SUM
    numpy's.  With ``job["kernels"]`` every rank captures a warm
    execute's launches and rank 0 holds the largest against the plain
    versions; with ``job["skew"]`` a C1 whose last shards own no rows
    runs meshed and alone on this rank's card, bit for bit.  With
    ``job["serve"]`` the ranks then serve meshed (:func:`served_mesh`)."""
    from repro_torch.core.distributed import DistributedSparseProgram
    from repro_torch.kernels import ops

    tag = job["tag"]
    # the group's ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    ops.build()  # the parent built every library: this finds and loads them
    db, _ = chain_db(job["n"], job["seed"])
    spent = {"walk": 0.0, "gather": 0.0}

    def timed(name, fn):
        def run(self, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(self, *a)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return r
        return run

    DistributedSparseProgram.walk = timed("walk", DistributedSparseProgram.walk)
    DistributedSparseProgram.gather = timed("gather", DistributedSparseProgram.gather)

    def execute(plan):
        spent.update(walk=0.0, gather=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan.execute()
        torch.cuda.synchronize()
        return res, {"ms": (time.perf_counter() - t0) * 1e3, "walk_ms": spent["walk"] * 1e3,
                     "gather_ms": spent["gather"] * 1e3}

    out = {"rank": rank, "device": torch.cuda.current_device(), "modes": {}, "kernels": {}}
    label = f"shard leg, S={world} rank {rank}"
    for fused in (False, True):
        mode = "fused" if fused else "unfused"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plan = bundle_query("torch").fused(fused).mesh(world).plan(db)
        prepare_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        res, cold = execute(plan)
        launches = ops.launch_counts()
        res, warm = execute(plan)
        if not fused:
            direct_digest = result_digest(res)
        peak = torch.cuda.max_memory_allocated() - resident
        (prog,) = plan.prep.shard_programs.values()
        check(prog.num_shards == world and prog.axis.rank == rank,
              f"{label}: the program is shard {prog.axis.rank} of {prog.num_shards}")
        check(result_digest(res) == job["digest"],
              f"{label} {mode}: the gathered answer differs from the single-device execute")
        got = (int(res.column("n").sum()), int(res.column("s").sum()))
        check(got == tuple(job["totals"]), f"{label} {mode}: Σ count / Σ sum {got} vs numpy "
                                           f"{job['totals']}")
        want = ("fused_hop",) if fused else SEGMENT_KERNELS
        others = UNFUSED_KERNELS if fused else ("fused_hop",)
        check(all(launches[k] > 0 for k in want) and not any(launches[k] for k in others),
              f"{label} {mode}: launches {launches}")
        lo, hi = prog.ranges[rank]
        lines = plan.explain().splitlines()
        at = next(i for i, line in enumerate(lines) if line.startswith("torch path:"))
        end = next((j for j in range(at + 1, len(lines)) if not lines[j].startswith("  ")),
                   len(lines))
        check(lines[at].startswith("torch path: distributed-sparse"),
              f"{label} {mode}: {lines[at]}")
        out["modes"][mode] = {
            "path": lines[at:end],
            "prepare_s": prepare_s, "cold": cold, "warm": warm, "launches": launches,
            "peak_above_resident_bytes": peak, "resident_bytes": resident,
            "per_device_bytes": prog.per_device_bytes(), "range": [lo, hi],
            "tile": prog.tile, "rows": res.num_rows,
            "edges": {rel: er.num_rows for rel, er in prog.encoded.items()},
        }
        if job["kernels"]:
            # every rank takes part in the captured execute (a collective
            # call); rank 0 then holds its launches while the others wait
            captured = capture_launches(plan.execute, hop_class if fused else main_path_key)
            if rank == 0:
                out["kernels"].update(shard_kernels(torch, tag, f"shard leg, S={world}",
                                                    captured, fused))
            dist.barrier()
        del plan, res, prog

    if job["serve"]:
        out["serve_mesh"] = served_mesh(torch, rank, world, job, db, direct_digest)

    if job["skew"]:
        sdb = skew_chain_db(job["check_n"], job["seed"])
        for fused in (False, True):
            q = bundle_query("torch").fused(fused)
            ops.reset_launch_counts()
            meshed = q.mesh(world).plan(sdb)
            res = meshed.execute()
            launches = ops.launch_counts()
            (prog,) = meshed.prep.shard_programs.values()
            alone = q.plan(sdb).execute()
            largest = max(float(abs(alone.column(c)).max()) for c in ("n", "s"))
            check(largest < 2**24, f"{label}: skewed C1 aggregate {largest} is past 2**24, "
                                   "where float32 sums depend on their order")
            same = same_result(res, alone)
            edges = {rel: er.num_rows for rel, er in prog.encoded.items()
                     if prog.attr in er.attrs}
            out.setdefault("skew", {})["fused" if fused else "unfused"] = {
                "ranges": prog.ranges, "edges": edges, "launches": launches,
                "same": same, "rows": res.num_rows,
            }
            check(same, f"{label}: skewed C1 meshed differs from the single-device execute")
            del meshed, res, alone, prog
    return out


def served_mesh(torch, rank: int, world: int, job: dict, db, direct_digest: str) -> dict:
    """The served mesh on a shard-leg group (every rank calls it, on the
    C1 it holds): ``serve_mesh``; rank 0's server answers the bundle
    ``.mesh(world)`` cold and ``SERVED_WARM`` times warm, then with
    ``.fused(True)`` cold and warm, a burst of 4
    concurrent meshed count/sum specs with one unmeshed sum sent in its
    middle, and one TCP request with ``"mesh": world``, then closes,
    which ends the other ranks' follower loops.  Each served bundle must
    equal this rank's direct meshed execute (``direct_digest``) and the
    single-device one (``job["digest"]``) bit for bit, with Σ COUNT / Σ
    SUM numpy's; the burst's columns and the TCP answer those of the
    served bundle; the burst must merge into one lane execute.  Rank 0
    returns its timings, the lane's records and every rank's compiles
    and launches (gathered at close); the others their launches."""
    import numpy as np

    from repro_torch.api import Count, Q, Sum
    from repro_torch.kernels import ops
    from repro_torch.serve.mesh import serve_mesh
    from repro_torch.serve.server import serve_tcp
    from repro_torch.serve.session import connect

    label = f"serve-mesh leg, S={world}"
    check(direct_digest == job["digest"], f"{label} rank {rank}: direct execute digest differs")
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    srv = serve_mesh(db, device="cuda", workers=4)
    if srv is None:
        return {"seconds": time.perf_counter() - t_start, "launches": ops.launch_counts()}
    lane = srv._lane
    out: dict = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    try:
        bundle = bundle_query("torch").mesh(world)
        runs = []
        for i in range(1 + SERVED_WARM):
            res, ms = timed(lambda: srv.query(bundle))
            check(result_digest(res) == direct_digest,
                  f"{label}: served bundle {i} differs from the direct .mesh({world}) execute")
            got = (int(res.column("n").sum()), int(res.column("s").sum()))
            check(got == tuple(job["totals"]), f"{label}: served Σ count / Σ sum {got} vs "
                                               f"numpy {job['totals']}")
            runs.append({"ms": ms, **lane.records[-1]})
        out["bundle"] = {"cold": runs[0], "warm": runs[1:], "rows": res.num_rows}
        cols = res.relation.columns

        fused = []
        for i in range(2):
            fres, ms = timed(lambda: srv.query(bundle.fused(True)))
            check(result_digest(fres) == direct_digest,
                  f"{label}: served fused bundle {i} differs from the direct execute")
            fused.append({"ms": ms, **lane.records[-1]})
        out["fused"] = {"cold": fused[0], "warm": fused[1]}
        del fres

        base = Q.over("R1", "R2", "R3", "R4").group_by("R1.g1", "R4.g2")
        count_q, sum_q = base.agg(n=Count()), base.agg(s=Sum("R3.m"))
        fusion, executes = srv.stats()["fusion"], lane.executes

        def burst():
            futs = [srv.submit(count_q.mesh(world)), srv.submit(sum_q.mesh(world))]
            plain = srv.submit(sum_q)
            futs += [srv.submit(count_q.mesh(world)), srv.submit(sum_q.mesh(world))]
            return ([f.result(timeout=SHARD_TIMEOUT_S) for f in futs],
                    plain.result(timeout=SHARD_TIMEOUT_S))

        (answers, plain), burst_ms = timed(burst)
        after = srv.stats()["fusion"]
        merged = after["merged_channels"] - fusion["merged_channels"]
        batches = after["batches"] - fusion["batches"]
        lane_runs = lane.executes - executes
        check(merged == 4 and batches == 1 and lane_runs == 1,
              f"{label}: the burst did not fuse into one lane execute: merged {merged}, "
              f"batches {batches}, lane executes {lane_runs}")
        for a, agg in zip(answers, ("n", "s", "n", "s")):
            same = all(np.array_equal(a.relation.columns[c], cols[c]) for c in ("g1", "g2", agg))
            check(same, f"{label}: a burst {agg} answer differs from the served bundle's column")
        check(same_result(answers[1], plain),
              f"{label}: the unmeshed sum differs from the meshed one")
        out["burst"] = {"ms": burst_ms, "lane": lane.records[-1], "fusion": after}

        tcp, _ = serve_tcp(srv)
        try:
            spec = {"relations": ["R1", "R2", "R3", "R4"], "group_by": ["R1.g1", "R4.g2"],
                    "where": [["R1", "g1", "<", 40], ["R4", "g2", "<", 40]],
                    "aggs": {"n": {"kind": "count"}}, "mesh": world}
            with connect(*tcp.server_address) as remote:
                remote_res, tcp_ms = timed(lambda: remote.query(spec))
        finally:
            tcp.shutdown()
            tcp.server_close()
        keep = (cols["g1"] < 40) & (cols["g2"] < 40)
        want = {(int(a), int(b)): float(v)
                for a, b, v in zip(cols["g1"][keep], cols["g2"][keep], cols["n"][keep])}
        got = remote_res.to_dict("n")
        check(len(got) > 0 and {(int(a), int(b)): v for (a, b), v in got.items()} == want,
              f"{label}: the TCP answer differs from the served bundle's g1 < 40, g2 < 40 rows")
        out["tcp"] = {"ms": tcp_ms, "lane": lane.records[-1], "rows": len(got)}
    finally:
        srv.close()
    out.update(seconds=time.perf_counter() - t_start, ranks=lane.final,
               plan_cache=srv.stats()["plan_cache"], executes=lane.executes)
    for r, f in enumerate(lane.final):
        check(f["error"] is None, f"{label}: rank {r} reports {f['error']}")
        check(all(f["launches"][k] > 0 for k in HOP_KERNELS + ("segment_reduce",)),
              f"{label}: rank {r} served without launching every hop kernel: {f['launches']}")
    return out


def shard_kernels(torch, tag, path: str, captured, fused: bool) -> dict:
    """A rank's largest captured launches against their plain versions
    (tolerance 0), timed beside the plain version, the library call and
    the bound: ``segment_sum``, ``segment_reduce`` and ``coo_spmm`` of an
    unfused execute, or ``fused_hop`` of a fused one."""
    if fused:
        check(captured, f"{path}: no fused_hop launch captured")
        return {"fused_hop": fused_hop_row(torch, tag, path, captured)}
    out = {}
    for name in SEGMENT_KERNELS:
        launches = [lc for key, lc in captured.items() if isinstance(key, tuple) and key[0] == name]
        check(launches, f"{path}: no {name} launch captured")
        out[name] = segment_regime(torch, tag, name, "largest launch",
                                   max(launches, key=lambda lc: lc.size), path=path)
    if "coo_spmm" in captured:
        out["coo_spmm"] = coo_spmm_row(torch, tag, path, "largest launch",
                                       captured["coo_spmm"], tol=None)
    return out


def shard_group(world: int, job: dict, tmp: Path, target=None,
                timeout: float = SHARD_TIMEOUT_S) -> tuple[list[dict], float]:
    """Spawn ``world`` ranks of ``target`` (:func:`shard_rank` by default)
    and join them within ``timeout`` seconds; every rank's numbers and the
    group's wall seconds.  A rank that fails, hangs or exits non-zero
    fails the leg (a hung rank is killed first)."""
    import multiprocessing

    out_dir = tmp / f"group{world}"
    out_dir.mkdir()
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target or shard_rank, args=(r, world, str(out_dir), job),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = t0 + timeout
    for p in procs:
        p.join(timeout=max(deadline - time.perf_counter(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    errors = [(r, (out_dir / f"rank{r}.err").read_text()) for r in range(world)
              if (out_dir / f"rank{r}.err").exists()]
    codes = [p.exitcode for p in procs]
    check(not hung and not errors and not any(codes),
          f"{job.get('leg', 'shard leg')}, S={world}: hung ranks {hung}, exit codes {codes}\n"
          + "\n".join(f"rank {r}:\n{e}" for r, e in errors))
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    return ranks, time.perf_counter() - t0


def shard_leg(torch, tag, args, digest: str, totals: tuple[int, int]) -> dict:
    """The sharded path on the card (DESIGN.md §8): C1 at ``--n`` rows,
    the main path's bundle through ``Q ... .mesh(S).plan(db).execute()``
    on groups of S = 1, 2 and 4 ranks, each a process that
    ``multiprocessing`` spawns on ``cuda:{rank % device_count}``; NCCL
    when there are at least S cards, gloo otherwise (which gathers on the
    host).  The parent built the kernels before, so no rank runs
    ``nvcc``.  Every rank's answer must equal the single-device execute
    (``digest``) bit for bit and Σ COUNT / Σ SUM numpy's (``totals``);
    every rank must launch ``segment_sum`` and ``segment_reduce``
    (unfused) or ``fused_hop`` (fused).  At S = 4 a C1 whose trailing
    shards own no rows runs too, and the ranks' largest launches are held
    against the plain versions.  Prints the backend, cold and warm
    execute ms split into the walk and the all_gather, each rank's peak
    above resident beside the S = 1 peak, and ``per_device_bytes()``."""
    import shutil
    import tempfile

    cards = torch.cuda.device_count()
    tmp = Path(tempfile.mkdtemp(prefix="repro-shard-leg-"))
    groups = {}
    try:
        for world in SHARD_COUNTS:
            backend = "nccl" if cards >= world else "gloo"
            job = {"n": args.n, "seed": args.seed, "check_n": args.check_n, "tag": tag,
                   "backend": backend, "digest": digest, "totals": list(totals),
                   "kernels": world == max(SHARD_COUNTS), "skew": world == max(SHARD_COUNTS),
                   "serve": world == SERVED_WORLD}
            ranks, seconds = shard_group(world, job, tmp)
            per_card = -(-world // cards)
            say(tag, f"shard leg: S={world}: backend {backend}, {world} rank(s) on "
                     f"{min(world, cards)} card(s), {per_card} per card; group {seconds:.1f} s "
                     "from spawn to exit")
            groups[world] = {"backend": backend, "seconds": seconds, "ranks": ranks}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    base = {mode: groups[1]["ranks"][0]["modes"][mode]["peak_above_resident_bytes"]
            for mode in ("unfused", "fused")}
    totals_by_kernel: dict[str, int] = {}
    summary = {}
    for world, g in groups.items():
        for line in g["ranks"][0]["modes"]["unfused"]["path"]:
            say(tag, f"shard leg: S={world}: {line}")
        for r in g["ranks"]:
            for mode, m in r["modes"].items():
                peak = m["peak_above_resident_bytes"]
                say(tag, f"shard leg: S={world} rank {r['rank']} {mode}: shard {m['range']} "
                         f"(tile {m['tile']}), edges {m['edges']}; cold {m['cold']['ms']:.1f} ms "
                         f"(walk {m['cold']['walk_ms']:.1f}, all_gather "
                         f"{m['cold']['gather_ms']:.1f}), warm {m['warm']['ms']:.1f} ms (walk "
                         f"{m['warm']['walk_ms']:.1f}, all_gather {m['warm']['gather_ms']:.1f}); "
                         f"prepare {m['prepare_s']:.2f} s; launches {m['launches']}")
                say(tag, f"shard leg: S={world} rank {r['rank']} {mode}: peak above resident "
                         f"{peak} B vs S=1 {base[mode]} B, ratio {peak / base[mode]:.3f}; "
                         f"per_device_bytes() {m['per_device_bytes']} B, "
                         f"{m['per_device_bytes'] / peak:.3f} of the measured peak")
                for k, v in m["launches"].items():
                    totals_by_kernel[k] = totals_by_kernel.get(k, 0) + v
            for mode, sk in r.get("skew", {}).items():
                empty = sum(1 for lo, hi in sk["ranges"] if hi == lo)
                say(tag, f"shard leg: S={world} rank {r['rank']} skewed C1 n={args.check_n} "
                         f"{mode}: shards {sk['ranges']} ({empty} own no rows), this rank's "
                         f"sharded edges {sk['edges']}, launches {sk['launches']}, "
                         f"{sk['rows']} rows bit-identical to the single-device execute: "
                         f"{sk['same']}")
        summary[f"S={world}"] = {
            "backend": g["backend"], "seconds": g["seconds"],
            "ranks": [{mode: {k: m[k] for k in ("cold", "warm", "peak_above_resident_bytes",
                                               "per_device_bytes", "launches")}
                       for mode, m in r["modes"].items()} for r in g["ranks"]],
        }
    kernels = groups[max(SHARD_COUNTS)]["ranks"][0]["kernels"]
    for name in ("segment_sum", "segment_reduce", "fused_hop"):
        check(name in kernels, f"shard leg: {name} was not held against its plain version")
    served = served_lines(tag, groups[SERVED_WORLD])
    summary["launches"] = {"shard": {k: totals_by_kernel.get(k, 0) for k in KERNEL_SOURCES},
                           "serve-mesh": served.pop("launches")}
    summary["kernels"] = kernels
    summary["serve_mesh"] = served
    return summary


def served_lines(tag, group: dict) -> dict:
    """Print the served mesh's ``serve-mesh leg:`` lines; its numbers and
    every rank's launches summed."""
    world = len(group["ranks"])
    sm = group["ranks"][0]["serve_mesh"]

    def lane_text(rec):
        return (f"lane {rec['lane_ms']:.2f} ms (control message and confirm), rank 0 lookup "
                f"{rec['lookup_ms']:.2f} ms, execute {rec['execute_ms']:.1f} ms")

    b = sm["bundle"]
    say(tag, f"serve-mesh leg: S={world}: bundle .mesh({world}), {b['rows']} rows: cold "
             f"{b['cold']['ms']:.1f} ms ({lane_text(b['cold'])})")
    for i, w in enumerate(b["warm"]):
        say(tag, f"serve-mesh leg: S={world}: bundle warm {i + 1}: {w['ms']:.1f} ms "
                 f"({lane_text(w)})")
    fz = sm["fused"]
    say(tag, f"serve-mesh leg: S={world}: bundle .fused(True).mesh({world}): cold "
             f"{fz['cold']['ms']:.1f} ms ({lane_text(fz['cold'])}), warm "
             f"{fz['warm']['ms']:.1f} ms ({lane_text(fz['warm'])})")
    say(tag, f"serve-mesh leg: S={world}: burst of 4 meshed count/sum specs and 1 unmeshed "
             f"sum, cold: {sm['burst']['ms']:.1f} ms; one merged lane execute: "
             f"{lane_text(sm['burst']['lane'])}; fusion counters {sm['burst']['fusion']}")
    say(tag, f"serve-mesh leg: S={world}: TCP request \"mesh\": {world}, g1 < 40 and g2 < 40, "
             f"cold: {sm['tcp']['ms']:.1f} ms, {sm['tcp']['rows']} rows "
             f"({lane_text(sm['tcp']['lane'])})")
    launches: dict[str, int] = {}
    for r, f in enumerate(sm["ranks"]):
        say(tag, f"serve-mesh leg: S={world} rank {r}: compiles {f['compiles']}, kernel "
                 f"launches {f['launches']}")
        for k, v in f["launches"].items():
            launches[k] = launches.get(k, 0) + v
    say(tag, f"serve-mesh leg: S={world}: {sm['executes']} lane executes; served from "
             f"serve_mesh to close in {sm['seconds']:.1f} s of the group's "
             f"{group['seconds']:.1f} s from spawn to exit; rank 0 plan cache "
             f"{sm['plan_cache']}")
    return {"seconds": sm["seconds"], "bundle": b, "fused": fz, "burst": sm["burst"],
            "tcp": sm["tcp"],
            "ranks": sm["ranks"], "launches": {k: launches.get(k, 0) for k in KERNEL_SOURCES}}


# ----------------------------------------------------------------------
# comparison leg (the paper's Tables II and III on the card)
# ----------------------------------------------------------------------

ORACLE_N = 100_000  # the C1 bundle's oracle check: a join of about 10**8 rows


def measured(torch, fn):
    """``fn()`` on the card: its result, the synchronised wall ms and the
    device peak above what was allocated before the call."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated() - resident


def comparison_leg(torch, tag, args) -> dict:
    """The paper's comparison on the card, through the port's own copies
    of the reference's baselines and oracle (``benchmarks/tables.py``
    imports the JAX package's).  Table III: S1, S2 and S3 at ``--n``,
    ``join_agg`` (cold: it prepares on every call), ``binary_join_agg`` and
    ``preagg_join_agg``, each with its synchronised wall ms, device peak
    above resident and largest intermediate; the three answers must be
    equal.  Table II: B2 at the reference's five sizes (``--n`` / 16 …
    ``--n``), ``join_agg`` against ``preagg_join_agg`` on peak and ms,
    equal answers.  The oracle on the card holds S3's ``join_agg`` answer
    and the main path's C1 bundle at ``ORACLE_N`` rows group by group;
    at ``--check-n`` every baseline and oracle call on the card equals
    the same call with ``device="cpu"``, answers and statistics."""
    import numpy as np

    from repro_torch.aggregates.semiring import Avg, Count, Max, Min, Sum
    from repro_torch.baselines import binary_join_agg, preagg_join_agg
    from repro_torch.core import join_agg
    from repro_torch.data import synth
    from repro_torch.kernels import ops
    from repro_torch.relational.oracle import oracle_joinagg, oracle_multiagg

    t_leg = time.perf_counter()
    launches = dict.fromkeys(ops.KERNELS, 0)

    def joinagg(q, db):
        ops.reset_launch_counts()
        res = join_agg(q, db)
        torch.cuda.synchronize()
        for name, count in ops.launch_counts().items():
            launches[name] += count
        return res

    def row(table, label, ms, peak, stats):
        interm = ("none materialised" if stats is None else
                  f"max_intermediate_rows {stats.max_intermediate_rows}, "
                  f"max_intermediate_bytes {stats.max_intermediate_bytes}")
        say(tag, f"comparison leg: {table}: {label}: {ms:.1f} ms, peak above resident "
                 f"{peak} B, {interm}")
        return {"ms": ms, "peak_above_resident_bytes": peak,
                "max_intermediate_rows": None if stats is None else stats.max_intermediate_rows,
                "max_intermediate_bytes": None if stats is None else stats.max_intermediate_bytes}

    summary: dict = {"table3": {}, "table2": {}, "part_seconds": {}}
    s3_answer = None
    t_part = time.perf_counter()

    def part_done(part: str) -> None:
        nonlocal t_part
        now = time.perf_counter()
        summary["part_seconds"][part] = now - t_part
        t_part = now

    for name in synth.SELF_JOIN:
        db, q = synth.make(name, args.n, seed=args.seed)
        label = f"Table III {name} n={args.n}"
        out = {}
        answers = {}
        # one join_agg call: the legacy entry prepares on every call, so a
        # second one repeated the first (13,155.6 and 13,356.8 ms on S1)
        for method, fn in (("joinagg cold", lambda: (joinagg(q, db), None)),
                           ("binary", lambda: binary_join_agg(q, db)),
                           ("preagg", lambda: preagg_join_agg(q, db))):
            torch.cuda.empty_cache()
            (answers[method], stats), ms, peak = measured(torch, fn)
            out[method] = row(label, method, ms, peak, stats)
        want = answers["joinagg cold"]
        same = all(a == want for a in answers.values())
        say(tag, f"check: comparison leg: {label}: {len(want)} groups, Σ count "
                 f"{sum(want.values()):.0f}; JOIN-AGG, binary and pre-aggregation give the "
                 f"same groups and equal counts: {same}; peak binary / JOIN-AGG "
                 f"{out['binary']['peak_above_resident_bytes'] / out['joinagg cold']['peak_above_resident_bytes']:.1f}, "
                 f"preagg / JOIN-AGG "
                 f"{out['preagg']['peak_above_resident_bytes'] / out['joinagg cold']['peak_above_resident_bytes']:.1f}")
        check(same and len(want) > 0, f"comparison leg: {label}: the three answers differ")
        summary["table3"][name] = out
        if name == "S3":
            s3_answer, s3 = want, (db, q)
        del answers, want
    part_done("table3")

    sizes = [max(500, args.n // 16), args.n // 8, args.n // 4, args.n // 2, args.n]
    for i, size in enumerate(sizes, start=1):
        db, q = synth.make("B2", size, seed=args.seed)
        label = f"Table II B2 P{i} n={size}"
        torch.cuda.empty_cache()
        ja, ms_j, peak_j = measured(torch, lambda: joinagg(q, db))
        torch.cuda.empty_cache()
        (pa, stats), ms_p, peak_p = measured(torch, lambda: preagg_join_agg(q, db))
        out = {"joinagg": row(label, "joinagg", ms_j, peak_j, None),
               "preagg": row(label, "preagg", ms_p, peak_p, stats)}
        same = ja == pa
        say(tag, f"check: comparison leg: {label}: {len(ja)} groups; JOIN-AGG = "
                 f"pre-aggregation: {same}; peak preagg / JOIN-AGG {peak_p / peak_j:.1f}, ms "
                 f"preagg / JOIN-AGG {ms_p / ms_j:.2f}")
        check(same and len(ja) > 0, f"comparison leg: {label}: the answers differ")
        summary["table2"][f"P{i}"] = {"rows": size, **out}
    part_done("table2")

    # the oracle on the card
    db, q = s3
    torch.cuda.empty_cache()
    want, ms, peak = measured(torch, lambda: oracle_joinagg(q, db))
    same = want == s3_answer
    say(tag, f"check: comparison leg: oracle_joinagg S3 n={args.n}: {ms:.1f} ms, peak above "
             f"resident {peak} B; {len(want)} groups, JOIN-AGG's answer equal group by "
             f"group: {same}")
    check(same, "comparison leg: S3: JOIN-AGG differs from the oracle")
    summary["oracle S3"] = {"ms": ms, "peak_above_resident_bytes": peak}
    del s3_answer, want

    oracle_n = min(ORACLE_N, args.n)
    bundle = {"n": Count(), "s": Sum("R3", "m"), "a": Avg("R3", "m"),
              "lo": Min("R3", "m"), "hi": Max("R3", "m")}
    rels, groups = ("R1", "R2", "R3", "R4"), (("R1", "g1"), ("R4", "g2"))
    db, cols = chain_db(oracle_n, args.seed)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = bundle_query("torch").plan(db).execute()
    torch.cuda.synchronize()
    for name, count in ops.launch_counts().items():
        launches[name] += count
    want, ms, peak = measured(torch, lambda: oracle_multiagg(rels, groups, bundle, db))
    got = {key: {name: float(res.column(name)[i]) for name in bundle}
           for i, key in enumerate(res.group_tuples())}
    exact = set(got) == set(want) and all(
        got[k][name] == w[name] for k, w in want.items() for name in ("n", "s", "lo", "hi")
    )
    avg_ulps = max(abs(got[k]["a"] - w["a"]) / np.spacing(w["a"]) for k, w in want.items())
    joined = int(sum(w["n"] for w in want.values()))
    say(tag, f"check: comparison leg: oracle_multiagg C1 bundle n={oracle_n}: {ms:.1f} ms, "
             f"peak above resident {peak} B, join of {joined} rows, {len(want)} groups; "
             f"COUNT, SUM, MIN and MAX equal group by group: {exact}; AVG within "
             f"{avg_ulps:.1f} ulp")
    check(exact and avg_ulps <= 1.0 and len(want) > 0,
          "comparison leg: the C1 bundle differs from the oracle")
    summary["oracle C1 bundle"] = {"n": oracle_n, "ms": ms, "peak_above_resident_bytes": peak,
                                   "join_rows": joined}
    del res, want, got
    part_done("oracle")

    # card = CPU at --check-n: every baseline and oracle call, answers and statistics
    calls = []
    for name in ("S2", "S3", "B2"):
        db, q = synth.make(name, args.check_n, seed=args.seed)
        if name != "B2":
            calls.append((f"binary_join_agg {name}", binary_join_agg, (q, db)))
            calls.append((f"oracle_joinagg {name}", oracle_joinagg, (q, db)))
        calls.append((f"preagg_join_agg {name}", preagg_join_agg, (q, db)))
    db, _ = chain_db(args.check_n, args.seed)
    calls.append(("oracle_multiagg C1 bundle", oracle_multiagg, (rels, groups, bundle, db)))
    for label, fn, fargs in calls:
        ops.reset_launch_counts()
        gpu = fn(*fargs)
        check(not any(ops.launch_counts().values()),
              f"comparison leg: {label} launched a kernel")
        cpu = fn(*fargs, device="cpu")
        if isinstance(gpu, tuple):
            same = gpu[0] == cpu[0] and vars(gpu[1]) == vars(cpu[1])
            detail = f"statistics {vars(gpu[1])['max_intermediate_rows']} rows, "
        else:
            same, detail = gpu == cpu, ""
        say(tag, f"check: comparison leg: {label} n={args.check_n}: {detail}answers"
                 f"{' and statistics' if detail else ''} equal to device='cpu': {same}")
        check(same, f"comparison leg: {label}: cuda differs from cpu")
    part_done("card = cpu")

    for name in ("segment_sum", "coo_spmm", "segment_reduce"):
        check(launches[name] > 0, f"comparison leg: JOIN-AGG never launched {name}")
    seconds = time.perf_counter() - t_leg
    say(tag, f"comparison leg: JOIN-AGG launches {launches}; the leg took {seconds:.1f} s "
             f"({', '.join(f'{k} {v:.1f} s' for k, v in summary['part_seconds'].items())})")
    summary["seconds"] = seconds
    summary["launches"] = {"comparison": launches}
    return summary


# ----------------------------------------------------------------------
# 15. launcher leg
# ----------------------------------------------------------------------

LAUNCHER_ROWS = 40_000  # the storage gate's own default
LAUNCHER_TIMEOUT_S = 300


class UserSparse:
    """A user's engine: ``run`` with the reference's 4-argument
    signature (no ``fused``, no ``memory_budget``) and no streaming, over
    the torch engine pinned to its sparse walk."""

    name = "user-sparse"
    supports_streaming = False

    def __init__(self, inner):
        self.inner = inner

    def run(self, prep, channels, minmax, stream=None):
        return self.inner.run(prep, channels, minmax, stream)


def run_cli(argv: list[str]) -> tuple[subprocess.CompletedProcess, float]:
    """``python -m argv...`` from the checkout's root with ``PYTHONPATH=src``;
    the finished process and its wall seconds."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", *argv], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=LAUNCHER_TIMEOUT_S,
    )
    return proc, time.perf_counter() - t0


def launcher_leg(torch, tag, args) -> dict:
    """The port's storage gate and catalog verifier as a user runs them,
    and a registered engine answering by its name on the card (see 15 in
    the module docstring)."""
    from repro_torch.api import TorchChannelEngine, register_engine
    from repro_torch.kernels import ops

    t_leg = time.perf_counter()
    clis = {
        "storage smoke": ["repro_torch.launch.storage", "--smoke", "--rows",
                          str(LAUNCHER_ROWS)],
        "verify-catalog cuda": ["repro_torch.analysis", "--verify-catalog"],
        "verify-catalog cpu": ["repro_torch.analysis", "--verify-catalog", "--device", "cpu"],
    }
    with concurrent.futures.ThreadPoolExecutor(len(clis)) as pool:
        running = {label: pool.submit(run_cli, argv) for label, argv in clis.items()}

        # (c) a registered engine, by name, while the launchers run
        t0 = time.perf_counter()
        register_engine(UserSparse(TorchChannelEngine(device="cuda", mode="sparse")))
        small, _ = chain_db(args.check_n, args.seed)
        uplan = bundle_query("user-sparse").plan(small)
        ops.reset_launch_counts()
        got = uplan.execute()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        want = bundle_query(TorchChannelEngine(mode="sparse")).plan(small).execute()
        same = same_result(got, want)
        user_s = time.perf_counter() - t0
        say(tag, f"check: launcher leg: Q.engine('user-sparse') C1 bundle n={args.check_n}: "
                 f"{got.num_rows} rows, launches {launches}, every column bit-identical to "
                 f".engine(TorchChannelEngine(mode='sparse')): {same}")
        check(same and got.num_rows > 0,
              "launcher leg: the registered engine's answer differs")
        for name in UNFUSED_KERNELS:
            check(launches[name] > 0, f"launcher leg: user-sparse never launched {name}")
        done = {label: f.result() for label, f in running.items()}

    seconds = {}
    for label, (proc, secs) in done.items():
        seconds[label] = secs
        for line in proc.stdout.splitlines():
            say(tag, f"launcher leg: {label}: {line}")
        say(tag, f"launcher leg: {label}: exit code {proc.returncode} in {secs:.1f} s")
        check(proc.returncode == 0,
              f"launcher leg: {label} exited {proc.returncode}: {proc.stderr[-2000:]}")
    smoke_out = done["storage smoke"][0].stdout
    check("storage-smoke: torch ok (" in smoke_out
          and "storage-smoke: maintain() deltas ok" in smoke_out,
          "launcher leg: the storage smoke printed no ok lines")
    cuda_lines, cpu_lines = (
        [ln for ln in done[k][0].stdout.splitlines() if ln.startswith("catalog[")]
        for k in ("verify-catalog cuda", "verify-catalog cpu")
    )
    same_catalog = cuda_lines == cpu_lines and len(cuda_lines) == 10
    say(tag, f"check: launcher leg: verify-catalog on the card and with --device cpu: "
             f"{len(cuda_lines)} catalog lines, equal line for line: {same_catalog}")
    check(same_catalog, "launcher leg: the catalog verifier's lines differ by device")

    seconds["user-sparse"] = user_s
    leg_s = time.perf_counter() - t_leg
    say(tag, f"launcher leg: the leg took {leg_s:.1f} s ("
             + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    return {"seconds": leg_s, "part_seconds": seconds, "launches": {"launcher": launches}}


# ----------------------------------------------------------------------
# train leg: the LM substrate's dense decoder
# ----------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"
TRAIN_BATCH, TRAIN_SEQ = 4, 4096  # SHAPES["train_4k"]'s sequence, 4 of its 256 rows
TRAIN_STEPS, TRAIN_CKPT_EVERY = 6, 3
# (a) and (b) train n_layers 28 -> 8 at full width: the checkpoint I/O
# (12 B a parameter, three saves and a restore) and the steps scale with
# the parameters, and the script must stay within its time
TRAIN_LAYERS = 8
DECODE_STEPS = 8
# the reference's bound for bf16 activations (tests/test_arch_smoke.py)
BF16_LOGIT_TOL = 0.15
# a resumed step runs the same code on the restored state; only the order
# of a reduction on the card can move its result
RESUME_RTOL = 1e-3
BF16_LOSS_RTOL = 2e-2  # about five bf16 roundings (2**-8 each) of the loss
F32_RTOL, UPD_RTOL = 1e-5, 1e-4
GRAD_FLOOR = 1e-4  # 10**4 x AdamW's eps: below it an update's size rides on g's last bits
CPU_CHECK_SEQ = 256


def train_leg(torch, tag, args) -> dict:
    """The trainer, resume, prefill and decode at full width, and card =
    CPU at reduced width (see 18 in the module docstring)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import Checkpointer

    t_leg = time.perf_counter()
    seconds = {}
    ops.reset_launch_counts()
    say(tag, f"train leg: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the "
             f"card by earlier legs")
    # the checkpoint's own seconds: save (to the host, and for a blocking
    # save the write too), wait (the writer thread) and restore
    io = {"save": [], "wait": [], "restore": []}
    originals = {name: getattr(Checkpointer, name) for name in io}

    def timed(name):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return originals[name](*a, **kw)
            finally:
                io[name].append(round(time.perf_counter() - t0, 3))
        return run

    for name in io:
        setattr(Checkpointer, name, timed(name))
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = ["--arch", TRAIN_ARCH, "--n-layers", str(TRAIN_LAYERS), "--global-batch",
            str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--log-every", "1", "--ckpt-dir", ck_dir]
    published = get_config(TRAIN_ARCH)
    cfg = published.scaled(n_layers=TRAIN_LAYERS)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    try:
        # (a) six steps at full width and cut depth, checkpoints at steps 3 and 6
        t0 = time.perf_counter()
        whole = train.main(argv)
        seconds["train"] = time.perf_counter() - t0
        check(whole["steps"] == list(range(TRAIN_STEPS)), "train leg: steps missing")
        for i, step in enumerate(whole["steps"]):
            loss, gnorm, ms = whole["losses"][i], whole["grad_norms"][i], whole["ms"][i]
            say(tag, f"train leg: {TRAIN_ARCH} ({TRAIN_LAYERS} of {published.n_layers} "
                     f"layers) step {step}: {ms:.1f} ms, "
                     f"{whole['tokens_per_s'][i]:.0f} tokens/s, loss {loss:.6f}, gnorm "
                     f"{gnorm:.6f}, peak {whole['peak_bytes'][i] / 2**30:.2f} GiB; 6ND "
                     f"{6 * cfg.param_count() * tokens / ms / 1e9:.1f} TFLOP/s")
            check(np.isfinite(loss) and np.isfinite(gnorm),
                  f"train leg: step {step}: loss {loss} or gnorm {gnorm} not finite")
        check(Checkpointer(ck_dir).steps() == [TRAIN_CKPT_EVERY, TRAIN_STEPS],
              "train leg: the checkpoints are not steps 3 and 6")

        # (b) resumed from step_3 (4 updates taken): steps 4 and 5 again
        shutil.rmtree(Path(ck_dir) / f"step_{TRAIN_STEPS}")
        t0 = time.perf_counter()
        resumed = train.main(argv)
        seconds["resume"] = time.perf_counter() - t0
        k = TRAIN_CKPT_EVERY + 1
        check(resumed["steps"] == list(range(k, TRAIN_STEPS)),
              f"train leg: the resumed run took steps {resumed['steps']}")
        for key in ("losses", "grad_norms"):
            got, want = np.array(resumed[key]), np.array(whole[key][k:])
            rel = np.abs(got - want) / np.abs(want)
            say(tag, f"check: train leg: resumed {key} {got.tolist()} vs uninterrupted "
                     f"{want.tolist()}: largest relative difference {rel.max():.3g} "
                     f"(tolerance {RESUME_RTOL}), bit-identical {bool((got == want).all())}")
            check(bool((rel <= RESUME_RTOL).all()),
                  f"train leg: the resumed {key} differ from the uninterrupted run")
    finally:
        for name, fn in originals.items():
            setattr(Checkpointer, name, fn)
        shutil.rmtree(ck_dir, ignore_errors=True)
    say(tag, f"train leg: checkpoint seconds (a then b): save {io['save']}, wait {io['wait']}, "
             f"restore {io['restore']}; {(cfg.param_count() * 12) / 2**30:.2f} GiB a step "
             f"(f32 parameters, m and v)")
    del whole, resumed
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    decode = prefill_decode(torch, tag, args, published)
    seconds["prefill_decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_cpu = train_cpu_check(torch, tag, args)
    seconds["cpu_check"] = time.perf_counter() - t0

    launches = ops.launch_counts()
    check(not any(launches.values()), f"train leg: a JOIN-AGG kernel launched: {launches}")
    leg_s = time.perf_counter() - t_leg
    say(tag, f"train leg: the leg took {leg_s:.1f} s ("
             + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    return {"seconds": leg_s, "part_seconds": seconds, "checkpoint_seconds": io,
            "decode": decode, "card_cpu": card_cpu, "launches": {"train": launches}}


def prefill_decode(torch, tag, args, cfg) -> dict:
    """(c): a prompt of 4 x 4,096 tokens prefilled, 8 tokens decoded on its
    cache, the last decode's logits against a prefill of all 4,104."""
    import numpy as np

    from repro_torch.models.model import get_model

    model = get_model(cfg, "cuda").init(torch.Generator("cuda").manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    total = TRAIN_SEQ + DECODE_STEPS
    toks = torch.tensor(rng.integers(0, cfg.vocab, (TRAIN_BATCH, total)), dtype=torch.int32,
                        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = model.prefill({"tokens": toks[:, :TRAIN_SEQ]})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    dec = model.init_cache(TRAIN_BATCH, total)
    for key in ("k", "v"):
        dec[key][:, :, :TRAIN_SEQ] = cache[key]
    del cache
    step_ms = []
    for pos in range(TRAIN_SEQ, total):
        t0 = time.perf_counter()
        logits, dec = model.decode_step(dec, toks[:, pos:pos + 1], pos)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    full, _ = model.prefill({"tokens": toks})
    err = float((logits - full).abs().max())
    ok = bool(torch.allclose(logits, full, rtol=BF16_LOGIT_TOL, atol=BF16_LOGIT_TOL))
    finite = bool(torch.isfinite(logits).all())
    say(tag, f"train leg: prefill of {TRAIN_BATCH} x {TRAIN_SEQ} tokens {prefill_ms:.1f} ms; "
             f"decode steps at {TRAIN_SEQ}..{total - 1}: "
             + ", ".join(f"{ms:.1f}" for ms in step_ms) + " ms")
    say(tag, f"check: train leg: the last decode's logits {tuple(logits.shape)} vs a prefill "
             f"of all {total} tokens: largest |difference| {err:.4g}, within rtol = atol = "
             f"{BF16_LOGIT_TOL}: {ok}; finite: {finite}")
    check(ok and finite, "train leg: decode disagrees with prefill")
    del model, dec, full, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_ms": step_ms, "max_abs_err": err}


def _off(torch, got, want):
    """The elements of ``got`` beyond ``UPD_RTOL`` of ``want`` (with an
    absolute floor of ``UPD_RTOL`` x the largest of ``want``)."""
    return ~torch.isclose(got, want, rtol=UPD_RTOL, atol=UPD_RTOL * float(want.abs().max()))


def check_batch(cfg, rows: int, seq: int, seed: int) -> dict:
    """A pipeline batch of ``rows`` x ``seq`` tokens as numpy, with normal
    vision patches (rows, P, d) for ``vlm`` and normal audio frames (rows,
    n_audio_ctx, d) for ``audio``, drawn from ``seed``."""
    import numpy as np

    from repro_torch.train.pipeline import DataPipeline, PipelineConfig

    batch = DataPipeline(PipelineConfig(cfg.vocab, seq, rows)).local_batch_at(0)
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(rows, cfg.vision_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(rows, cfg.n_audio_ctx, cfg.d_model)).astype(
            np.float32)
    return batch


def train_cpu_check(torch, tag, args, arch=TRAIN_ARCH, leg="train leg", rows=TRAIN_BATCH,
                    seq=CPU_CHECK_SEQ, seed=None) -> dict:
    """(d): one train step of the reduced ``arch`` on the card and on the
    CPU from the same parameters (``seed``, else ``--seed``) and batch, in
    f32 and in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as t_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, schedule

    cfg = get_config(arch, reduced=True)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    lr = float(schedule(acfg, 1))
    seed = args.seed if seed is None else seed
    batch = check_batch(cfg, rows, seq, seed)
    base = t_model.get_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    matmul = torch.backends.cuda.matmul
    before = (t_model.ACT_DTYPE, matmul.allow_tf32)
    out = {}
    try:
        matmul.allow_tf32 = False  # f32 means f32
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            t_model.ACT_DTYPE = dtype
            runs = {}
            for dev in ("cuda", "cpu"):
                model = t_model.get_model(cfg, dev)
                model.load_state_dict(base.state_dict())
                opt = adamw_init(model.params())
                loss, metrics = train.build_train_step(model, acfg)(
                    opt, {k: torch.tensor(v, device=dev) for k, v in batch.items()})
                runs[dev] = (float(loss), float(metrics["grad_norm"]), model.params(), opt)
            (gl, gg, gp, go), (cl, cg, cp, co) = runs["cuda"], runs["cpu"]
            loss_rel, gnorm_rel = abs(gl - cl) / abs(cl), abs(gg - cg) / abs(cg)
            row = {"loss": [gl, cl], "grad_norm": [gg, cg], "loss_rel": loss_rel,
                   "gnorm_rel": gnorm_rel}
            if name == "f32":
                # m and v are (1 - b) g and (1 - b) g**2: the gradients, leaf by
                # leaf.  One Adam step moves a parameter by lr g / (|g| + eps),
                # which the last bits of g move by lr eps / |g|: parameters are
                # held to UPD_RTOL where |g| > GRAD_FLOOR, to 2 lr elsewhere.
                moment_off = sum(int(_off(torch, go[k][n].cpu(), co[k][n]).sum())
                                 for k in ("m", "v") for n in cp)
                param_off, near_zero, largest = 0, 0, 0.0
                for n in cp:
                    got, want = gp[n].detach().cpu(), cp[n].detach()
                    above = co["m"][n].abs() / (1 - acfg.b1) > GRAD_FLOOR
                    param_off += int((_off(torch, got, want) & above).sum())
                    near_zero += int((~above).sum())
                    largest = max(largest, float((got - want).abs().max()))
                row.update(moment_off=moment_off, param_off=param_off,
                           near_zero_grads=near_zero, param_max_diff=largest)
                ok = (loss_rel <= F32_RTOL and gnorm_rel <= UPD_RTOL and moment_off == 0
                      and param_off == 0 and largest <= 2 * lr * (1 + 1e-3))
                bounds = (f"loss rtol {F32_RTOL}, gnorm rtol {UPD_RTOL}; m and v within rtol "
                          f"{UPD_RTOL}: {moment_off} elements off; parameters within rtol "
                          f"{UPD_RTOL} where |g| > {GRAD_FLOOR}: {param_off} off, and within "
                          f"2 x lr = {2 * lr:.3g} at the {near_zero} elements with smaller "
                          f"|g|: largest difference {largest:.3g}")
            else:
                ok = loss_rel <= BF16_LOSS_RTOL and gnorm_rel <= BF16_LOSS_RTOL
                bounds = f"loss and gnorm rtol {BF16_LOSS_RTOL}"
            say(tag, f"check: {leg}: reduced {arch}, {name} activations, one step "
                     f"on {rows} x {seq} tokens, card vs CPU: loss {gl:.7f} vs "
                     f"{cl:.7f} (relative {loss_rel:.3g}), gnorm {gg:.7f} vs {cg:.7f} "
                     f"(relative {gnorm_rel:.3g}); {bounds}: {ok}")
            check(ok, f"{leg}: the card's {name} train step of {arch} differs from the CPU's")
            out[name] = row
    finally:
        t_model.ACT_DTYPE, matmul.allow_tf32 = before
    return out


# ----------------------------------------------------------------------
# moe/vlm leg: the LM substrate's moe and vlm families
# ----------------------------------------------------------------------

# (arch, n_layers cut to, rows a step, trained): every width as published,
# only the depth cut (f32 weights, gradients, m and v take 16 B a
# parameter: 44.0 GiB for moonshot at 4 layers and qwen2-vl-7b at 8;
# scout's 2 layers hold 23.2 GiB of f32 weights and serve without
# gradients)
MOE_VLM_RUNS = (
    ("moonshot-v1-16b-a3b", 4, 4, True),
    ("qwen2-vl-7b", 8, 2, True),
    ("llama4-scout-17b-a16e", 2, 4, False),
)
MOE_VLM_STEPS = 3
# the f32 card = CPU checks of the reduced MoE configs hold routing equal
# only where every token's k-th and (k+1)-th router probabilities on the
# CPU lie more than ROUTE_MARGIN apart (f32 card and CPU probabilities
# differ by ~1e-7); the check asserts it.  At 2 x 128 tokens and seed 3
# both reduced MoE configs clear it (1.8e-4 and 5.8e-4 on the CPU); at
# 4 x 256 tokens or seed 0 reduced moonshot does not (5.4e-6, 5.6e-5)
ROUTE_MARGIN = 1e-4
MOE_CHECK_ROWS, MOE_CHECK_SEQ, MOE_CHECK_SEED = 2, 128, 3


class RouteLog:
    """Spies on ``models/layers.py:moe_route`` inside a ``with``: every
    call's ``Routing``, kept on its device, and the activations' dtype."""

    def __init__(self):
        self.calls, self.dtypes = [], []

    def __enter__(self):
        from repro_torch.models import layers

        self.layers = layers
        self.original = layers.moe_route

        def spy(p, x, cfg):
            r = self.original(p, x, cfg)
            self.calls.append(r)
            self.dtypes.append(x.dtype)
            return r

        layers.moe_route = spy
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.original

    def dropped(self) -> tuple[int, int]:
        """(dropped, all) (token, choice) pairs over the calls."""
        if not self.calls:
            return 0, 0
        kept = sum(r.valid.sum() for r in self.calls)
        total = sum(r.valid.numel() for r in self.calls)
        return total - int(kept), total

    def margin(self, torch, k: int) -> float:
        """The smallest gap between a token's k-th and (k+1)-th router
        probability over the calls with f32 activations on the CPU."""
        gaps = []
        for r, dtype in zip(self.calls, self.dtypes):
            if r.probs.device.type != "cpu" or dtype != torch.float32:
                continue
            top = r.probs.detach().topk(k + 1, dim=-1).values
            gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return min(gaps)


def moe_vlm_leg(torch, tag, args) -> dict:
    """The moe and vlm families at full width and cut depth, and card =
    CPU at reduced width (see 19 in the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    t_leg = time.perf_counter()
    ops.reset_launch_counts()
    say(tag, f"moe/vlm leg: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the "
             f"card by earlier legs")
    out, seconds = {}, {}
    for arch, n_layers, rows, trained in MOE_VLM_RUNS:
        published = get_config(arch)
        cfg = published.scaled(n_layers=n_layers)
        t0 = time.perf_counter()
        row = {"n_layers": [n_layers, published.n_layers], "params": cfg.param_count(),
               "active_params": cfg.active_param_count()}
        say(tag, f"moe/vlm leg: {arch} ({cfg.family}) at full width, n_layers "
                 f"{published.n_layers} -> {n_layers}: {cfg.param_count()} parameters "
                 f"({cfg.active_param_count()} active a token), "
                 f"{cfg.param_count() * 4 / 2**30:.2f} GiB of f32 weights")
        if trained:
            row["train"] = moe_vlm_train(torch, tag, arch, cfg, rows)
        row["serve"] = moe_vlm_serve(torch, tag, args, cfg, rows)
        gc.collect()
        torch.cuda.empty_cache()
        row["left_gib"] = torch.cuda.memory_allocated() / 2**30
        seconds[arch] = time.perf_counter() - t0
        say(tag, f"moe/vlm leg: {arch} freed: {row['left_gib']:.2f} GiB left allocated; "
                 f"{seconds[arch]:.1f} s")
        out[arch] = row

    t0 = time.perf_counter()
    out["card_cpu"] = {}
    for arch, *_ in MOE_VLM_RUNS:
        out["card_cpu"][arch] = reduced_cpu_check(torch, tag, args, arch)
    seconds["cpu_check"] = time.perf_counter() - t0

    launches = ops.launch_counts()
    check(not any(launches.values()), f"moe/vlm leg: a JOIN-AGG kernel launched: {launches}")
    leg_s = time.perf_counter() - t_leg
    say(tag, f"moe/vlm leg: the leg took {leg_s:.1f} s ("
             + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    out.update(seconds=leg_s, part_seconds=seconds, launches={"moe_vlm": launches})
    return out


def moe_vlm_train(torch, tag, arch: str, cfg, rows: int) -> dict:
    """(a), (b): ``launch/train.main`` for ``MOE_VLM_STEPS`` steps of
    ``rows`` x 4,096 tokens (``vlm``: each row behind its zero patches),
    no checkpoint directory."""
    import numpy as np

    from repro_torch.launch import train

    argv = ["--arch", arch, "--n-layers", str(cfg.n_layers), "--global-batch", str(rows),
            "--seq-len", str(TRAIN_SEQ), "--steps", str(MOE_VLM_STEPS), "--log-every", "1",
            "--device", "cuda"]
    run = train.main(argv)
    check(run["steps"] == list(range(MOE_VLM_STEPS)), f"moe/vlm leg: {arch}: steps missing")
    # tokens through the decoder a step: the text and, for vlm, the patches
    tokens = rows * (TRAIN_SEQ + cfg.vision_patches)
    for i, step in enumerate(run["steps"]):
        loss, gnorm, aux, ms = run["losses"][i], run["grad_norms"][i], run["aux"][i], run["ms"][i]
        peak = run["peak_bytes"][i] / 2**30 if run["peak_bytes"] else float("nan")
        say(tag, f"moe/vlm leg: {arch} step {step}: {ms:.1f} ms, "
                 f"{run['tokens_per_s'][i]:.0f} text tokens/s, loss {loss:.6f}, gnorm "
                 f"{gnorm:.6f}, summed aux {aux:.6f}, peak {peak:.2f} GiB; 6 N_active D "
                 f"{6 * cfg.active_param_count() * tokens / ms / 1e9:.1f} TFLOP/s "
                 f"(D = {tokens} tokens through the layers)")
        check(all(np.isfinite(v) for v in (loss, gnorm, aux)),
              f"moe/vlm leg: {arch} step {step}: loss {loss}, gnorm {gnorm} or aux {aux} "
              f"not finite")
    if cfg.moe:
        check(min(run["aux"]) > 0, f"moe/vlm leg: {arch}: the auxiliary loss is zero")
    return {k: run[k] for k in ("losses", "grad_norms", "aux", "ms", "tokens_per_s",
                                "peak_bytes")}


def moe_vlm_serve(torch, tag, args, cfg, rows: int) -> dict:
    """(a)-(c): a prompt of ``rows`` x 4,096 tokens (``vlm``: behind
    ``vision_patches`` normal patches) prefilled, then ``DECODE_STEPS``
    tokens decoded on its cache, without gradients.  Decode is not held
    to a longer prefill here: MoE capacity depends on the call's tokens
    and the reference decodes M-RoPE at the raw position, so the two
    differ by design."""
    import numpy as np

    from repro_torch.models.model import ACT_DTYPE, get_model

    gen = torch.Generator("cuda").manual_seed(args.seed)
    model = get_model(cfg, "cuda").init(gen)
    rng = np.random.default_rng(args.seed)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (rows, TRAIN_SEQ + DECODE_STEPS)),
                        dtype=torch.int32, device="cuda")
    batch = {"tokens": toks[:, :TRAIN_SEQ]}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((rows, cfg.vision_patches, cfg.d_model), generator=gen,
                                       device="cuda").to(ACT_DTYPE)
    prompt = TRAIN_SEQ + (cfg.vision_patches if "patches" in batch else 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with RouteLog() as routes:
        t0 = time.perf_counter()
        logits, cache = model.prefill(batch)
        finite = bool(torch.isfinite(logits).all())  # waits for the prefill
        prefill_ms = (time.perf_counter() - t0) * 1e3
    dropped, choices = routes.dropped()
    dec = model.init_cache(rows, prompt + DECODE_STEPS)
    for key in ("k", "v"):
        dec[key][:, :, :prompt] = cache[key]
    del cache
    step_ms = []
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        step_logits, dec = model.decode_step(dec, toks[:, TRAIN_SEQ + i:TRAIN_SEQ + i + 1],
                                             prompt + i)
        finite = finite and bool(torch.isfinite(step_logits).all())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    share = dropped / choices if choices else 0.0
    say(tag, f"moe/vlm leg: {cfg.name}: prefill of {rows} x {prompt} tokens {prefill_ms:.1f} ms"
             + (f" ({dropped} of {choices} (token, choice) pairs dropped at capacity, "
                f"{share:.4f})" if cfg.moe else "")
             + f"; decode steps at {prompt}..{prompt + DECODE_STEPS - 1}: "
             + ", ".join(f"{ms:.1f}" for ms in step_ms) + f" ms; peak {peak:.2f} GiB")
    check(tuple(logits.shape) == (rows, 1, cfg.vocab) and finite,
          f"moe/vlm leg: {cfg.name}: prefill or decode logits not finite or misshapen")
    check(not cfg.moe or choices == cfg.n_layers * rows * TRAIN_SEQ * cfg.moe.top_k,
          f"moe/vlm leg: {cfg.name}: the prefill routed {choices} choices")
    del model, dec, logits, step_logits
    return {"prefill_ms": prefill_ms, "decode_ms": step_ms, "peak_gib": peak,
            "dropped": dropped, "choices": choices}


def reduced_cpu_check(torch, tag, args, arch: str, leg: str = "moe/vlm leg") -> dict:
    """(d): for the reduced ``arch``, one f32 and one bf16 train step and
    one f32 prefill on the card and on the CPU from the same parameters
    and batch.  MoE: the CPU's f32 routing of that forward and prefill is
    held to the routing margin first, before any value is compared.
    ``leg`` names the calling leg in the lines it prints."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as t_model

    cfg = get_config(arch, reduced=True)
    if cfg.moe:
        rows, seq, seed = MOE_CHECK_ROWS, MOE_CHECK_SEQ, MOE_CHECK_SEED
    else:
        rows, seq, seed = TRAIN_BATCH, CPU_CHECK_SEQ, args.seed
    batch = check_batch(cfg, rows, seq, seed)
    base = t_model.get_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))

    def feed(dev, labels=False):
        return {k: torch.tensor(v, device=dev) for k, v in batch.items()
                if labels or k != "labels"}

    matmul = torch.backends.cuda.matmul
    before = (t_model.ACT_DTYPE, matmul.allow_tf32)
    out, guard = {}, ""
    try:
        t_model.ACT_DTYPE, matmul.allow_tf32 = torch.float32, False
        with RouteLog() as routes, torch.no_grad():
            base.loss(feed("cpu", labels=True))  # the train step's forward
            want = base.prefill(feed("cpu"))[0]
        if cfg.moe:
            margin = routes.margin(torch, cfg.moe.top_k)
            out["route_margin"] = margin
            guard = f"; routing margin on the CPU {margin:.3g} (> {ROUTE_MARGIN})"
            say(tag, f"check: {leg}: reduced {arch}, f32 on the CPU: the smallest gap "
                     f"between a token's k-th and (k+1)-th router probability is "
                     f"{margin:.3g} (> {ROUTE_MARGIN}): {margin > ROUTE_MARGIN}")
            check(margin > ROUTE_MARGIN, f"{leg}: reduced {arch}: a near-tie in the "
                                         f"CPU's routing (margin {margin:.3g}); the f32 card "
                                         f"= CPU checks cannot hold")
        out["train"] = train_cpu_check(torch, tag, args, arch, leg, rows, seq, seed)
        t_model.ACT_DTYPE, matmul.allow_tf32 = torch.float32, False
        model = t_model.get_model(cfg, "cuda")
        model.load_state_dict(base.state_dict())
        got = model.prefill(feed("cuda"))[0].cpu()
    finally:
        t_model.ACT_DTYPE, matmul.allow_tf32 = before
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL * float(want.abs().max())))
    say(tag, f"check: {leg}: reduced {arch}, f32 prefill of {rows} x {seq} tokens, card "
             f"vs CPU: largest |logit difference| {err:.3g}, within rtol {F32_RTOL} (atol "
             f"{F32_RTOL} x max |logit|): {ok}{guard}")
    check(ok and bool(torch.isfinite(got).all()),
          f"{leg}: reduced {arch}: the card's f32 prefill differs from the CPU's")
    out["prefill_max_abs_err"] = err
    return out


# ----------------------------------------------------------------------
# ssm/hybrid leg: the LM substrate's recurrent families
# ----------------------------------------------------------------------

# (arch, n_layers trained): every width as published, the depth cut for
# the trainer (f32 weights, gradients, m and v take 16 B a parameter:
# 10.13 GiB for rwkv6-3b at 4 of 32 layers, 11.13 GiB for zamba2-2.7b at
# 12 of 54, 2 groups of shared_period 6; at full depth 46.03 and 36.09
# GiB would fit, but the steps would not fit the script's time limit);
# both serve at the same cut depth: at full depth (32 and 54 layers; PR
# 32) serving took 31-35 s of the leg, and with leg 21 a whole run took
# 1,184.6 s of its 1,200 (tools/decode_drift.py serves at full depth)
SSM_HYBRID_RUNS = (("rwkv6-3b", 4), ("zamba2-2.7b", 12))
SSM_HYBRID_STEPS = 3
# decode from a prefill's state against a longer prefill, f32 activations
# and TF32 off: a chunk's terms are summed in another grouping than one
# position at a time, and the two differ by under 1e-4 after 32 or 54
# layers on the H100.  With bf16 activations the two drift apart with
# depth (rounding at other GEMM shapes; the reference drifts as much at
# reduced width), past the reference's 0.15 at full depth:
# tools/decode_drift.py measures it
F32_DECODE_TOL = 1e-3


def counted_params(cfg) -> int:
    """The parameters the model holds, counted leaf by leaf (the analytic
    ``ModelConfig.param_count`` is not that count for these families)."""
    import math

    from repro_torch.models.convert import param_shapes

    return sum(math.prod(shape) for shape in param_shapes(cfg).values())


def ssm_hybrid_leg(torch, tag, args) -> dict:
    """The ssm and hybrid families: trained and served at full width and
    cut depth, and card = CPU at reduced width (see 20 in the module
    docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    t_leg = time.perf_counter()
    ops.reset_launch_counts()
    say(tag, f"ssm/hybrid leg: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on "
             f"the card by earlier legs")
    out, seconds = {}, {}
    for arch, n_layers in SSM_HYBRID_RUNS:
        published = get_config(arch)
        cfg = published.scaled(n_layers=n_layers)
        n_cut, n_full = counted_params(cfg), counted_params(published)
        say(tag, f"ssm/hybrid leg: {arch} ({cfg.family}) at full width, n_layers "
                 f"{published.n_layers} -> {n_layers} trained and served: {n_cut} counted "
                 f"parameters ({n_cut * 16 / 2**30:.2f} GiB of f32 weights, gradients, m and "
                 f"v; {n_full} at full depth)")
        t0 = time.perf_counter()
        row = {"n_layers": [n_layers, published.n_layers], "params": [n_cut, n_full],
               "train": launcher_train(torch, tag, arch, cfg, n_cut)}
        gc.collect()
        torch.cuda.empty_cache()
        seconds[f"{arch} train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        row["serve"] = ssm_hybrid_serve(torch, tag, args, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        row["left_gib"] = torch.cuda.memory_allocated() / 2**30
        seconds[f"{arch} serve"] = time.perf_counter() - t0
        say(tag, f"ssm/hybrid leg: {arch} freed: {row['left_gib']:.2f} GiB left allocated")
        out[arch] = row

    t0 = time.perf_counter()
    out["card_cpu"] = {arch: reduced_cpu_check(torch, tag, args, arch, "ssm/hybrid leg")
                       for arch, _ in SSM_HYBRID_RUNS}
    seconds["cpu_check"] = time.perf_counter() - t0

    launches = ops.launch_counts()
    check(not any(launches.values()), f"ssm/hybrid leg: a JOIN-AGG kernel launched: {launches}")
    leg_s = time.perf_counter() - t_leg
    say(tag, f"ssm/hybrid leg: the leg took {leg_s:.1f} s ("
             + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    out.update(seconds=leg_s, part_seconds=seconds, launches={"ssm_hybrid": launches})
    return out


def launcher_train(torch, tag, arch: str, cfg, n_counted: int, leg: str = "ssm/hybrid leg",
                     flops: tuple[int, str] | None = None) -> dict:
    """(a), (b): ``launch/train.main`` for ``SSM_HYBRID_STEPS`` steps of
    4 x 4,096 tokens, no checkpoint directory.  ``flops``: a step's
    counted operations and how they were counted (6ND with N =
    ``n_counted`` when None); ``leg`` names the calling leg."""
    import numpy as np

    from repro_torch.launch import train

    argv = ["--arch", arch, "--n-layers", str(cfg.n_layers), "--global-batch",
            str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--steps", str(SSM_HYBRID_STEPS),
            "--log-every", "1", "--device", "cuda"]
    run = train.main(argv)
    check(run["steps"] == list(range(SSM_HYBRID_STEPS)), f"{leg}: {arch}: steps missing")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flop, counted = flops or (6 * n_counted * tokens, f"6ND (N = {n_counted} counted "
                                                     f"parameters, D = {tokens} tokens)")
    for i, step in enumerate(run["steps"]):
        loss, gnorm, ms = run["losses"][i], run["grad_norms"][i], run["ms"][i]
        peak = run["peak_bytes"][i] / 2**30 if run["peak_bytes"] else float("nan")
        say(tag, f"{leg}: {arch} ({cfg.n_layers} layers) step {step}: {ms:.1f} ms, "
                 f"{run['tokens_per_s'][i]:.0f} tokens/s, loss {loss:.6f}, gnorm {gnorm:.6f}, "
                 f"peak {peak:.2f} GiB; {flop / ms / 1e9:.1f} TFLOP/s in {counted}")
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"{leg}: {arch} step {step}: loss {loss} or gnorm {gnorm} not finite")
    return {k: run[k] for k in ("losses", "grad_norms", "ms", "tokens_per_s", "peak_bytes")}


def serve_batch(torch, cfg, gen, seed: int) -> dict:
    """``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens on the card drawn from
    ``seed``; for ``audio`` behind normal bf16 frames (rows,
    n_audio_ctx, d) drawn from ``gen``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)),
                                    dtype=torch.int32, device="cuda")}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((TRAIN_BATCH, cfg.n_audio_ctx, cfg.d_model),
                                      generator=gen, device="cuda").to(torch.bfloat16)
    return batch


def prefill_and_decode(torch, model, batch: dict, prompt: int, steps: int):
    """Prefills ``batch["tokens"][:, :prompt]`` (behind the batch's other
    entries, whisper's ``frames``) and decodes the next ``steps`` tokens
    from its cache (keys and values copied into a ``prompt + steps`` slot
    cache; the recurrent state, or the memory's keys and values, as they
    are).  Returns (prefill ms, ms of each decode step, the last logits)."""
    toks = batch["tokens"]
    rows = toks.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = model.prefill({**batch, "tokens": toks[:, :prompt]})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    dec = model.init_cache(rows, prompt + steps)
    for key, t in cache.items():
        if key in ("k", "v"):
            dec[key][:, :, :prompt] = t
        else:
            dec[key].copy_(t)
    del cache
    step_ms = []
    for pos in range(prompt, prompt + steps):
        t0 = time.perf_counter()
        logits, dec = model.decode_step(dec, toks[:, pos:pos + 1], pos)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return prefill_ms, step_ms, logits


def ssm_hybrid_serve(torch, tag, args, cfg) -> dict:
    """(c): at the trained depth, without gradients.  As shipped (bf16
    activations): a prompt of 4 x (4,096 - D) tokens prefilled and
    ``DECODE_STEPS`` tokens decoded from its state, timed.  Then with f32
    activations and TF32 off: the same prompt, D = the config's chunk
    tokens decoded, and the last decode's logits of every row held to a
    prefill of all 4,096 within ``F32_DECODE_TOL``."""
    from repro_torch.models import model as t_model

    model = t_model.get_model(cfg, "cuda").init(torch.Generator("cuda").manual_seed(args.seed))
    D = cfg.ssm.chunk
    prompt = TRAIN_SEQ - D
    batch = serve_batch(torch, cfg, None, args.seed)
    toks = batch["tokens"]
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, step_ms, logits = prefill_and_decode(torch, model, batch, prompt, DECODE_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(logits).all())
    say(tag, f"ssm/hybrid leg: {cfg.name} ({cfg.n_layers} layers, bf16 activations): prefill "
             f"of {TRAIN_BATCH} x {prompt} tokens {prefill_ms:.1f} ms; decode steps at "
             f"{prompt}..{prompt + DECODE_STEPS - 1}: "
             + ", ".join(f"{ms:.1f}" for ms in step_ms) + f" ms; peak {peak:.2f} GiB")
    check(finite, f"ssm/hybrid leg: {cfg.name}: bf16 decode logits not finite")

    matmul = torch.backends.cuda.matmul
    before = (t_model.ACT_DTYPE, matmul.allow_tf32)
    try:
        t_model.ACT_DTYPE, matmul.allow_tf32 = torch.float32, False
        f32_prefill_ms, f32_ms, logits = prefill_and_decode(torch, model, batch, prompt, D)
        full, _ = model.prefill({"tokens": toks})
    finally:
        t_model.ACT_DTYPE, matmul.allow_tf32 = before
    err = float((logits - full).abs().max())
    ok = bool(torch.allclose(logits, full, rtol=F32_DECODE_TOL, atol=F32_DECODE_TOL))
    finite = bool(torch.isfinite(logits).all())
    ms = sorted(f32_ms)
    say(tag, f"ssm/hybrid leg: {cfg.name} ({cfg.n_layers} layers, f32 activations): prefill of "
             f"{len(toks)} x {prompt} tokens {f32_prefill_ms:.1f} ms; {D} decode steps: "
             f"median {ms[len(ms) // 2]:.1f}, min {ms[0]:.1f}, max {ms[-1]:.1f} ms a token")
    say(tag, f"check: ssm/hybrid leg: {cfg.name}: f32, the last of {D} decoded logits "
             f"{tuple(logits.shape)} vs a prefill of all {TRAIN_SEQ} tokens: largest |difference| "
             f"{err:.4g} (largest |logit| {float(full.abs().max()):.4g}), within rtol = atol = "
             f"{F32_DECODE_TOL}: {ok}; finite: {finite}")
    check(ok and finite, f"ssm/hybrid leg: {cfg.name}: decode disagrees with prefill")
    del model, logits, full
    return {"prefill_ms": prefill_ms, "decode_ms": step_ms, "peak_gib": peak,
            "f32_prefill_ms": f32_prefill_ms, "f32_decode_ms": f32_ms, "max_abs_err": err}


# ----------------------------------------------------------------------
# audio leg: the LM substrate's encoder-decoder
# ----------------------------------------------------------------------

AUDIO_ARCH = "whisper-medium"


def audio_leg(torch, tag, args) -> dict:
    """whisper-medium trained and served at full width and full depth, and
    card = CPU at reduced width (see 21 in the module docstring)."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.convert import param_shapes

    t_leg = time.perf_counter()
    ops.reset_launch_counts()
    cfg = get_config(AUDIO_ARCH)
    n = counted_params(cfg)
    n_enc = sum(math.prod(shape) for name, shape in param_shapes(cfg).items()
                if name.startswith("enc_"))
    frames, tokens = TRAIN_BATCH * cfg.n_audio_ctx, TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * (n_enc * frames + (n - n_enc) * tokens)
    say(tag, f"audio leg: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the "
             f"card by earlier legs; {AUDIO_ARCH} ({cfg.family}) at full width and depth, "
             f"{cfg.enc_layers} encoder and {cfg.n_layers} decoder layers: {n} counted "
             f"parameters ({n * 16 / 2**30:.2f} GiB of f32 weights, gradients, m and v; "
             f"the analytic param_count says {cfg.param_count()})")
    seconds = {}
    t0 = time.perf_counter()
    out = {"params": n, "encoder_params": n_enc,
           "train": launcher_train(
               torch, tag, AUDIO_ARCH, cfg, n, "audio leg",
               (flops, f"6 x ({n_enc} encoder parameters x {frames} frames + {n - n_enc} "
                       f"decoder and head parameters x {tokens} tokens) = {flops:.4g} FLOP"))}
    gc.collect()
    torch.cuda.empty_cache()
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"] = audio_serve(torch, tag, args, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    out["left_gib"] = torch.cuda.memory_allocated() / 2**30
    seconds["serve"] = time.perf_counter() - t0
    say(tag, f"audio leg: {AUDIO_ARCH} freed: {out['left_gib']:.2f} GiB left allocated")
    t0 = time.perf_counter()
    out["card_cpu"] = reduced_cpu_check(torch, tag, args, AUDIO_ARCH, "audio leg")
    seconds["cpu_check"] = time.perf_counter() - t0

    launches = ops.launch_counts()
    check(not any(launches.values()), f"audio leg: a JOIN-AGG kernel launched: {launches}")
    leg_s = time.perf_counter() - t_leg
    say(tag, f"audio leg: the leg took {leg_s:.1f} s ("
             + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    out.update(seconds=leg_s, part_seconds=seconds, launches={"audio": launches})
    return out


def audio_serve(torch, tag, args, cfg) -> dict:
    """(b): at full depth, without gradients, behind seeded normal bf16
    frames (4, 1,500, 1,024).  As shipped (bf16 activations): a prompt of
    4 x (4,096 - 8) tokens prefilled and ``DECODE_STEPS`` tokens decoded
    from its cache, timed.  Then with f32 activations and TF32 off: the
    same prompt and tokens, and the last decode's logits of every row
    held to a prefill of all 4,096 within ``F32_DECODE_TOL``."""
    from repro_torch.models import model as t_model

    gen = torch.Generator("cuda").manual_seed(args.seed)
    model = t_model.get_model(cfg, "cuda").init(gen)
    batch = serve_batch(torch, cfg, gen, args.seed)
    prompt = TRAIN_SEQ - DECODE_STEPS
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, step_ms, logits = prefill_and_decode(torch, model, batch, prompt, DECODE_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(logits).all())
    say(tag, f"audio leg: {cfg.name} ({cfg.enc_layers} + {cfg.n_layers} layers, bf16 "
             f"activations): prefill of {TRAIN_BATCH} x {prompt} tokens behind {cfg.n_audio_ctx} "
             f"frames {prefill_ms:.1f} ms; decode steps at {prompt}..{TRAIN_SEQ - 1}: "
             + ", ".join(f"{ms:.1f}" for ms in step_ms) + f" ms; peak {peak:.2f} GiB")
    check(finite and tuple(logits.shape) == (TRAIN_BATCH, 1, cfg.vocab),
          f"audio leg: {cfg.name}: bf16 decode logits not finite or misshapen")

    matmul = torch.backends.cuda.matmul
    before = (t_model.ACT_DTYPE, matmul.allow_tf32)
    try:
        t_model.ACT_DTYPE, matmul.allow_tf32 = torch.float32, False
        f32_prefill_ms, f32_ms, logits = prefill_and_decode(torch, model, batch, prompt,
                                                            DECODE_STEPS)
        t0 = time.perf_counter()
        full, _ = model.prefill(batch)
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t0) * 1e3
    finally:
        t_model.ACT_DTYPE, matmul.allow_tf32 = before
    err = float((logits - full).abs().max())
    ok = bool(torch.allclose(logits, full, rtol=F32_DECODE_TOL, atol=F32_DECODE_TOL))
    finite = bool(torch.isfinite(logits).all())
    say(tag, f"audio leg: {cfg.name} (f32 activations, TF32 off): prefill of {TRAIN_BATCH} x "
             f"{prompt} tokens {f32_prefill_ms:.1f} ms, of all {TRAIN_SEQ} {full_ms:.1f} ms; "
             f"decode steps " + ", ".join(f"{ms:.1f}" for ms in f32_ms) + " ms")
    say(tag, f"check: audio leg: {cfg.name}: f32, the last of {DECODE_STEPS} decoded logits "
             f"{tuple(logits.shape)} vs a prefill of all {TRAIN_SEQ} tokens: largest |difference| "
             f"{err:.4g} (largest |logit| {float(full.abs().max()):.4g}), within rtol = atol = "
             f"{F32_DECODE_TOL}: {ok}; finite: {finite}")
    check(ok and finite, f"audio leg: {cfg.name}: decode disagrees with prefill")
    del model, logits, full, batch
    return {"prefill_ms": prefill_ms, "decode_ms": step_ms, "peak_gib": peak,
            "f32_prefill_ms": f32_prefill_ms, "f32_full_prefill_ms": full_ms,
            "f32_decode_ms": f32_ms, "max_abs_err": err}


# ----------------------------------------------------------------------
# mesh leg: the LM substrate's mesh on torch.distributed
# ----------------------------------------------------------------------

MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
# (b): full width, depth cut: moonshot-v1-16b-a3b at 2 of its 48 layers
# (the attention's heads and the vocabulary cut over model, the experts
# expert-parallel), qwen2-1.5b at 2 of its 28 (the heads, the SwiGLU MLP
# and the tied 151,936-row head cut)
# and qwen2-1.5b at 2 of its 28 (the heads, the SwiGLU MLP and the tied
# head cut), rwkv6-3b at 2 of its 32 (the time mix's 40 heads and the
# channel mix's ffn columns cut) and zamba2-2.7b at one group of its 9 (6
# Mamba2 layers of 80 heads, cut, and the shared block)
MESH_ARCHS = {"moonshot-v1-16b-a3b": 2, "qwen2-1.5b": 2, "rwkv6-3b": 2, "zamba2-2.7b": 6}
MESH_ROWS, MESH_SEQ, MESH_STEPS = 4, 1024, 2  # 2 sequences a data rank
# (b) served on the mesh from the blocks the steps left: a prefill of
# MESH_ROWS x MESH_SEQ tokens laid out for a MESH_SLOTS-position cache
# (516 a rank), then MESH_DECODE tokens; qwen2-1.5b also one row (the
# positions over data x model, 258 a rank), MESH_ONE_ROW_DECODE tokens.
# Each held on rank 0 against the unsharded prefill and decode of the
# same parameters, bf16 as shipped, within BF16_LOGIT_TOL (the reference's
# bound for bf16 activations): the logits absolutely and relatively, each
# cache leaf relatively and of its largest element
MESH_SERVE = ("qwen2-1.5b", "rwkv6-3b")
# (b): rwkv6-3b's steps run with f32 activations (TF32 off), sharded and
# unsharded: with bf16 its gradient after one update rides on rounding
# (u's gradient at position 0 passes gn's Jacobian of 1 / sqrt(eps),
# ROADMAP.md §3), and at reduced width on the CPU the two steps' bf16
# norms after one update differ by 13.9 % against MESH_NORM_RTOL's 2 %;
# its serving runs bf16 as shipped
MESH_F32 = ("rwkv6-3b",)
MESH_DECODE, MESH_SLOTS, MESH_ONE_ROW_DECODE = 8, 1032, 4
MESH_SEED = 0
MESH_SAMPLE = 1024  # elements sampled from every gathered leaf
MESH_TIMEOUT_S = 300
# the dry prediction (launch/dryrun.py:run_cell, fake CUDA tensors on a
# fake world of 4): each (b) step's collective bytes by kind, and each
# served prefill's and decode step's, equal to the dry record's, on every
# rank; each argument count equal; the step's peak within MESH_PEAK_RTOL
# of the dry argument + temp bytes, plus MESH_PEAK_SLACK (the tracker does
# not see the allocator's rounding or the cuBLAS workspace; on gloo a
# gather's parts sit on the host, where the fake world puts them on the
# card); MESH_DRY_TIMEOUT_S bounds the subprocess
MESH_PEAK_RTOL, MESH_PEAK_SLACK = 0.10, 256 * 2**20
MESH_DRY_TIMEOUT_S = 300
MESH_DRY = r"""
import json, sys

import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models import model as t_model
from repro_torch.models.config import ShapeConfig

job = json.loads(sys.argv[1])
out = {}
for name, (arch, layers, kind, seq, rows, slots, f32) in job["cells"].items():
    t_model.ACT_DTYPE = torch.float32 if f32 else torch.bfloat16
    out[name] = dryrun.run_cell(
        arch, name, "single", cfg=get_config(arch).scaled(n_layers=layers),
        shape=ShapeConfig(name, kind, seq, rows), mesh_shape=tuple(job["mesh"]), device="cuda",
        slots=slots)
if job["full"]:
    t_model.ACT_DTYPE = torch.bfloat16
    out["full"] = dryrun.run_cell("qwen2-1.5b", "decode_32k", "single", device="cuda")
    out["table"] = roofline.markdown_table([out["full"]])
print(json.dumps(out))
"""
# the dry cells of each subprocess, run at once (the full-size cell with
# moonshot's)
MESH_DRY_SPLIT = (("train/moonshot-v1-16b-a3b",),
                  ("train/qwen2-1.5b", "prefill/qwen2-1.5b", "decode/qwen2-1.5b",
                   "train/zamba2-2.7b"),
                  ("train/rwkv6-3b", "prefill/rwkv6-3b", "decode/rwkv6-3b"))
# (a): the reduced configs' seeds and batch, tests/test_torch_lm_mesh.py's
# cases (a case "<arch>@vocab<V>" is the reduced config scaled to a
# vocabulary of V: 511 leaves qwen2-1.5b's head whole); seed 8 keeps
# reduced moonshot's routing margin at 3.8e-4 over both steps of 4 x 32
# tokens on the CPU.  The tests' rwkv6-3b at 3 heads (a whole time mix) is
# not run here: after two f32 steps one of its u's 384 elements lies
# beyond UPD_RTOL between the card and the CPU (u's gradient at position 0
# passes gn's Jacobian of 1 / sqrt(eps), ROADMAP.md §3), over FLIP_SHARE
# of a leaf that small
MESH_CHECK = {"qwen2-1.5b": 2, "moonshot-v1-16b-a3b": 8, "qwen2-vl-7b": 2, "rwkv6-3b": 2,
              "zamba2-2.7b": 2, "whisper-medium": 2, "minitron-4b": 2, "qwen2-1.5b@vocab511": 2}
MESH_CHECK_ROWS, MESH_CHECK_SEQ = 4, 32
# (a) served after the steps, card and CPU from the CPU's blocks: the
# pipeline's batch at step MESH_CHECK_SERVE_STEP as the prompt, then its
# last MESH_CHECK_DECODE labels decoded one at a time, f32 (TF32 off),
# logits and every cache block within F32_RTOL of the CPU's (relative and
# of the largest)
MESH_CHECK_DECODE, MESH_CHECK_SERVE_STEP = 3, 7
MESH_LR = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 4}
FLIP_SHARE = 1e-3
# (a) for MoE: the expert-parallel path sums the experts' partial outputs
# in bf16, as the reference does, and the gate's cotangent passes bf16
# sums that the card and the CPU accumulate in other orders, so the
# gradients agree to bf16, not f32 (tests/test_torch_lm_mesh.py holds the
# port to the reference with these bounds): step 0's loss and norm within
# EP_LOSS0_RTOL and EP_NORM0_RTOL; after the first update, which turns the
# gradients' bf16 differences into Adam sign flips where |g| is small, the
# loss and norm within EP_LOSS_RTOL and EP_NORM_RTOL, every element within
# 2 x (Σ lr), and beyond EP_PARAM_RTOL (with |g| > GRAD_FLOOR) on at most
# EP_FLIP_SHARE of a block
EP_LOSS0_RTOL, EP_NORM0_RTOL, EP_LOSS_RTOL, EP_NORM_RTOL = 1e-4, 1e-3, 2e-3, 1e-2
EP_PARAM_RTOL, EP_FLIP_SHARE = 1e-3, 0.05
# (b): the sharded step against the unsharded step with accum = 2, both
# with bf16 activations as shipped.  The experts' down-projection is summed
# over ``model`` from two bf16 partials on the mesh and computed whole on
# one card: one more bf16 rounding (2**-9) of each expert output.  Step 0's
# loss moves by that (MESH_LOSS0_RTOL); after an update, which turns the
# noise into Adam sign flips of near-zero gradients (about lr an element),
# the loss and norm by more; a sampled parameter stays within 2 x (Σ lr)
# and beyond MESH_PARAM_RTOL on at most MESH_FLIP_SHARE of the samples
MESH_LOSS0_RTOL, MESH_LOSS_RTOL, MESH_NORM_RTOL = 1e-3, 5e-3, 2e-2
MESH_PARAM_RTOL, MESH_FLIP_SHARE = 1e-2, 0.05


def mesh_rank(rank: int, world: int, out_dir: str, job: dict) -> None:
    """One rank of the mesh leg (a process of its own): join the group
    through the ``file://`` store under ``out_dir`` and run
    :func:`mesh_rank_run`; its numbers to ``rank<r>.json``, or the
    traceback to ``rank<r>.err``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        # the ranks share the host's cores with gloo's threads and the parent
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
        dist.init_process_group(
            job["backend"], init_method=f"file://{out_dir}/store", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S),
        )
        try:
            out = mesh_rank_run(torch, rank, job)
        finally:
            dist.destroy_process_group()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def mesh_check_cfg(case: str):
    """The reduced config of a ``MESH_CHECK`` case."""
    from repro_torch.configs import get_config

    arch, _, scale = case.partition("@")
    cfg = get_config(arch, reduced=True)
    if scale.startswith("vocab"):
        return cfg.scaled(vocab=int(scale.removeprefix("vocab")))
    return cfg.scaled(n_heads=int(scale.removeprefix("heads"))) if scale else cfg


def mesh_slots(cfg, seq: int, new: int) -> int:
    """A cache's positions for a prompt of ``seq`` tokens (behind the
    vlm's patches) and ``new`` decoded ones, rounded up to a multiple of 4
    (the positions cut over model, or over data x model)."""
    total = seq + (cfg.vision_patches if cfg.family == "vlm" else 0) + new
    return -(-total // 4) * 4


def blocks_close(torch, got: dict, want: dict, rtol: float, atol_abs: float = 0.0) -> dict:
    """Leaf by leaf: the largest difference, and whether every element is
    within ``rtol`` relative and ``rtol`` of the leaf's largest |value|
    (plus ``atol_abs``)."""
    largest, ok = {}, True
    for name, w in want.items():
        g, w = got[name].detach().float().cpu(), w.detach().float().cpu()
        largest[name] = float((g - w).abs().max()) if w.numel() else 0.0
        ok &= g.shape == w.shape and bool(torch.allclose(
            g, w, rtol=rtol, atol=rtol * float(w.abs().max()) + atol_abs))
    return {"largest": largest, "ok": ok}


def mesh_batch(torch, cfg, rows: int, seq: int, step: int, dev) -> dict:
    """The pipeline's batch at ``step``, and for the vlm and audio families
    step ``step``'s seeded normal f32 patches or frames (the CPU tests'
    stubs), on ``dev``."""
    import numpy as np

    from repro_torch.train.pipeline import DataPipeline, PipelineConfig

    b = DataPipeline(PipelineConfig(cfg.vocab, seq, rows)).local_batch_at(step)
    rng = np.random.default_rng([31, step])
    if cfg.family == "vlm":
        b["patches"] = rng.normal(size=(rows, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(rows, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return {k: torch.tensor(v, device=dev) for k, v in b.items()}


def mesh_sample_index(numel: int, seed: int, i: int):
    """``MESH_SAMPLE`` seeded flat positions in leaf ``i`` (name order)."""
    import numpy as np

    return np.random.default_rng([seed, i]).integers(0, numel, MESH_SAMPLE)


def mesh_sample(torch, whole, seed: int, i: int) -> list[float]:
    """The sampled elements of a whole leaf."""
    idx = mesh_sample_index(whole.numel(), seed, i)
    return whole.reshape(-1)[torch.as_tensor(idx, device=whole.device)].float().cpu().tolist()


def mesh_local_sample(torch, block, spec: tuple, shape: tuple, mesh, seed: int,
                      i: int) -> dict[int, float]:
    """The sampled elements of a leaf of ``shape`` that this rank's block
    holds, by sample position: no leaf is gathered whole."""
    import math

    import numpy as np

    from repro_torch.launch.sharding import entry_axes

    idx = mesh_sample_index(math.prod(shape), seed, i)
    at = np.unravel_index(idx, shape)
    held = np.ones(len(idx), bool)
    local = []
    for dim in range(len(shape)):
        axes = entry_axes(spec[dim]) if dim < len(spec) else ()
        count, index = 1, 0
        for a in axes:
            count, index = count * mesh.shape[a], index * mesh.shape[a] + mesh.coords[a]
        size = shape[dim] // count
        held &= at[dim] // size == index
        local.append(at[dim] - index * size)
    flat = np.ravel_multi_index(tuple(x[held] for x in local), tuple(block.shape))
    values = block.reshape(-1)[torch.as_tensor(flat, device=block.device)].float().cpu()
    return {int(k): float(v) for k, v in zip(np.nonzero(held)[0], values)}


# the modules whose collectives the (b) lines print apart (the recorder's
# ``caller``): the expert exchanges, the step's own gathers and gradient
# reductions, the model axis's sums
EXPERT_CALLERS = ("repro_torch.models.moe_ep",)
FSDP_CALLERS = ("repro_torch.launch.train",)
SUM_CALLERS = ("repro_torch.models.shard_ctx", "repro_torch.models.layers")
COMM_NAMES = {"all-gather": "all_gather", "all-reduce": "all_reduce", "all-to-all": "all_to_all"}


def comm_totals(log: list, callers: tuple | None = None, skip: tuple = ()) -> dict:
    """The entries of a ``launch/mesh.py:recording`` log made from the
    modules ``callers`` (None: any) but ``skip``, summed by collective:
    ``totals[name] = [seconds (each call to its return, the host copies
    included), input bytes, calls, output bytes]``."""
    totals: dict = {}
    for e in log:
        if (callers is not None and e["caller"] not in callers) or e["caller"] in skip:
            continue
        row = totals.setdefault(COMM_NAMES[e["kind"]], [0.0, 0, 0, 0])
        row[0] += e["seconds"]
        row[1] += e["in_bytes"]
        row[2] += 1
        row[3] += e["bytes"]
    return totals


def kind_bytes(log: list) -> dict:
    """A log's result bytes by kind, as ``launch/hlo_analysis.py`` counts them."""
    out: dict = {}
    for e in log:
        out[e["kind"]] = out.get(e["kind"], 0) + e["bytes"]
    return out


def mesh_blocks_close(torch, got: dict, want: dict, m: dict, lr_sum: float, rtol: float,
                      share: float) -> dict:
    """Leaf by leaf, this rank's blocks of two runs: every element within
    2 x (Σ lr); where the first moment says the gradient is not near zero
    (|m| / (1 - b1) > GRAD_FLOOR), within ``rtol`` on all but ``share``
    of the leaf (leg 18's rule over two steps)."""
    off_share, largest = 0.0, 0.0
    for name, w in want.items():
        g = got[name].detach().cpu()
        w = w.detach().cpu()
        above = m[name].cpu().abs() / 0.1 > GRAD_FLOOR
        off = ~torch.isclose(g, w, rtol=rtol, atol=rtol * float(w.abs().max())) & above
        off_share = max(off_share, float(off.float().mean()))
        largest = max(largest, float((g - w).abs().max()))
    return {"off_share": off_share, "largest": largest, "rtol": rtol, "share": share,
            "ok": off_share <= share and largest <= 2 * lr_sum * (1 + 1e-3)}


def mesh_check_serve(torch, cfg, cpu_model, meshes: dict, batch_of) -> dict:
    """(a)'s serving on this rank: the meshed prefill of the step
    ``MESH_CHECK_SERVE_STEP`` batch and ``MESH_CHECK_DECODE`` decode steps
    (``launch/dryrun.py:MeshServe``), f32, on the card and on the CPU from
    the CPU's blocks after the steps: every step's logits and the cache
    blocks after the last, card against CPU within ``F32_RTOL``; for MoE
    the CPU's routing margin over the calls."""
    import copy

    from repro_torch.launch import dryrun

    slots = mesh_slots(cfg, MESH_CHECK_SEQ, MESH_CHECK_DECODE)
    first = MESH_CHECK_SEQ + (cfg.vision_patches if cfg.family == "vlm" else 0)
    got, margin = {}, None
    for dev in ("cuda", "cpu"):
        model = cpu_model if dev == "cpu" else copy.deepcopy(cpu_model).to(dev)
        serve = dryrun.MeshServe(model, meshes[dev], MESH_CHECK_ROWS, slots)
        batch = batch_of(cfg, MESH_CHECK_ROWS, MESH_CHECK_SEQ, MESH_CHECK_SERVE_STEP, dev)
        labels = batch.pop("labels")[:, -MESH_CHECK_DECODE:]
        with RouteLog() as routes:
            logits, cache = serve.prefill({k: serve.rows_of(v) for k, v in batch.items()})
            steps = {0: logits}
            for t in range(MESH_CHECK_DECODE):
                steps[t + 1], cache = serve.decode(cache, serve.rows_of(labels[:, t:t + 1]),
                                                   first + t)
        if cfg.moe and dev == "cpu":
            margin = routes.margin(torch, cfg.moe.top_k)
        got[dev] = (steps, cache)
    return {"logits": blocks_close(torch, got["cuda"][0], got["cpu"][0], F32_RTOL),
            "cache": blocks_close(torch, got["cuda"][1], got["cpu"][1], F32_RTOL),
            "route_margin": margin, "slots": slots}


def mesh_serve(torch, rank: int, cfg, model, mesh) -> dict:
    """(b)'s serving on this rank from ``model``'s blocks (see
    ``MESH_SERVE``): prefill and decode timed, their collectives counted
    by kind (``launch/mesh.py``'s recorder) and their argument blocks'
    bytes (``dryrun.cell_arguments``), the cache blocks gathered whole
    after the prefill and after the last
    decode; then rank 0 runs the unsharded prefill and decode of the same
    parameters (gathered whole: in bf16 the leaves of 2**20 elements or
    more, which the model reads only through bf16 products and row
    lookups, the rest in f32) and holds the logits and caches to them."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.mesh import recording
    from repro_torch.models import model as t_model
    from repro_torch.train.pipeline import DataPipeline, PipelineConfig

    tokens = torch.tensor(DataPipeline(PipelineConfig(
        cfg.vocab, MESH_SEQ + MESH_DECODE, MESH_ROWS)).local_batch_at(MESH_STEPS)["tokens"],
        device="cuda")
    runs = [("rows", MESH_ROWS, MESH_DECODE)]
    if cfg.name == "qwen2-1.5b":
        runs.append(("one_row", 1, MESH_ONE_ROW_DECODE))
    out, meshed, weights = {}, {}, None
    for label, rows, new in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve = dryrun.MeshServe(model, mesh, rows, MESH_SLOTS, weights=weights)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weights = serve.model
        toks = tokens[:rows]
        prompt = {"tokens": serve.rows_of(toks[:, :MESH_SEQ])}
        arguments = {"prefill": sum(dryrun.cell_arguments(
            "prefill", None, serve.prefill, (prompt,), mesh).values())}
        t0 = time.perf_counter()
        with recording() as prefill_log:
            logits, cache = serve.prefill(prompt)
            torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        filled = {k: v.clone() for k, v in cache.items()}
        steps, step_ms, decode_logs = [logits], [], []
        for t in range(new):
            row = serve.rows_of(toks[:, MESH_SEQ + t:MESH_SEQ + t + 1])
            if t == 0:
                arguments["decode"] = sum(dryrun.cell_arguments(
                    "decode", None, serve.decode, (cache, row, MESH_SEQ), mesh).values())
            t0 = time.perf_counter()
            with recording() as log:
                lg, cache = serve.decode(cache, row, MESH_SEQ + t)
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(lg)
            decode_logs.append(log)
        prefill_comm = comm_totals(prefill_log)
        per_token = {k: [x / new for x in v]
                     for k, v in comm_totals(sum(decode_logs, [])).items()}
        specs = serve.layout(MESH_SLOTS)[1]
        whole = {stage: {k: shd.gather(t, specs[k], mesh) for k, t in c.items()}
                 for stage, c in (("prefill", filled), ("decode", cache))}
        meshed[label] = (steps, whole, toks, new)
        out[label] = {"rows": rows, "tokens": new, "build_s": build_s, "prefill_ms": prefill_ms,
                      "decode_ms": step_ms, "prefill_comm": prefill_comm,
                      "per_token": per_token, "specs": {k: str(v) for k, v in specs.items()},
                      "kind_bytes": {"prefill": kind_bytes(prefill_log),
                                     "decode": [kind_bytes(log) for log in decode_logs]},
                      "argument_bytes": arguments}
    # the unsharded prefill and decode on rank 0
    t0 = time.perf_counter()
    specs = train.param_specs(cfg, mesh)
    params = {}
    for name, p in sorted(model.params().items()):
        t = p.detach()
        w = shd.gather(t.to(torch.bfloat16) if t.numel() >= 2**20 else t, specs[name], mesh)
        if rank == 0:
            params[name] = w.float()
        del w
    if rank != 0:
        return out
    ref = t_model.get_model(cfg, "cuda")
    ref.load_state_dict(params)
    del params
    for label, (steps, whole, toks, new) in meshed.items():
        logits, pre = ref.prefill({"tokens": toks[:, :MESH_SEQ]})
        cache = ref.init_cache(toks.shape[0], MESH_SLOTS)
        for k, t in pre.items():
            if k in ("k", "v"):
                cache[k][:, :, :t.shape[2]] = t
            else:
                cache[k].copy_(t)
        filled = {k: v.clone() for k, v in cache.items()}
        want = [logits]
        for t in range(new):
            logits, cache = ref.decode_step(cache, toks[:, MESH_SEQ + t:MESH_SEQ + t + 1],
                                            MESH_SEQ + t)
            want.append(logits)
        close = [bool(torch.allclose(g, w, rtol=BF16_LOGIT_TOL, atol=BF16_LOGIT_TOL))
                 and bool(torch.isfinite(g).all()) for g, w in zip(steps, want)]
        out[label]["check"] = {
            "logits_ok": all(close),
            "logits_largest": [float((g - w).abs().max()) for g, w in zip(steps, want)],
            "prefill_cache": blocks_close(torch, whole["prefill"], filled, BF16_LOGIT_TOL),
            "decode_cache": blocks_close(torch, whole["decode"], cache, BF16_LOGIT_TOL)}
    del ref
    out["unsharded_s"] = time.perf_counter() - t0
    return out


def mesh_rank_run(torch, rank: int, job: dict) -> dict:
    """(a) card = CPU, (b) full width, (c) compression and the checkpoint,
    on this rank (see 22 in the module docstring)."""
    import hashlib

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import all_gather, all_reduce, make_mesh, recording
    from repro_torch.models import convert, moe_ep
    from repro_torch.models import model as t_model
    from repro_torch.train import compression
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, schedule

    ops.reset_launch_counts()
    out: dict = {"rank": rank}
    seconds: dict = {}
    t_rank = time.perf_counter()
    calls = {"n": 0}
    ep_fn = moe_ep.moe_block_ep

    def counted(*a, **kw):
        calls["n"] += 1
        return ep_fn(*a, **kw)

    moe_ep.moe_block_ep = counted
    acfg = AdamWConfig(**MESH_LR)
    lr_sum = sum(float(schedule(acfg, s)) for s in range(1, MESH_STEPS + 1))
    meshes = {dev: make_mesh(MESH_SHAPE, MESH_AXES, device=dev) for dev in ("cuda", "cpu")}
    coords = meshes["cuda"].coords

    def batch_of(cfg, rows, seq, step, dev):
        return mesh_batch(torch, cfg, rows, seq, step, dev)

    seconds["meshes"] = time.perf_counter() - t_rank

    # (a) card = CPU: the reduced configs, f32, TF32 off -------------------
    t0 = time.perf_counter()
    matmul = torch.backends.cuda.matmul
    before = (t_model.ACT_DTYPE, matmul.allow_tf32)
    t_model.ACT_DTYPE, matmul.allow_tf32 = torch.float32, False
    runs = {}
    try:
        for arch, seed in MESH_CHECK.items():
            cfg = mesh_check_cfg(arch)
            row = {}
            for dev, mesh in meshes.items():
                calls["n"] = 0
                # drawn on the host for both, as the CPU's and the card's
                # generators draw different values
                model = train.shard_model(cfg, mesh, torch.Generator().manual_seed(seed)).to(dev)
                opt = adamw_init(model.params())
                step = train.build_train_step(model, acfg, mesh=mesh)
                losses, norms = [], []
                t1 = time.perf_counter()
                with recording() as log, RouteLog() as routes:
                    for s in range(MESH_STEPS):
                        loss, m = step(opt, batch_of(cfg, MESH_CHECK_ROWS, MESH_CHECK_SEQ, s,
                                                     dev))
                        losses.append(float(loss))
                        norms.append(float(m["grad_norm"]))
                row[dev] = {"losses": losses, "norms": norms, "ep_calls": calls["n"],
                            "steps_s": time.perf_counter() - t1, "comm": comm_totals(log)}
                if cfg.moe and dev == "cpu":
                    row["route_margin"] = routes.margin(torch, cfg.moe.top_k)
                runs[(arch, dev)] = (model, opt)
            (gm, go), (cm, co) = runs[(arch, "cuda")], runs[(arch, "cpu")]
            rtol, share = (EP_PARAM_RTOL, EP_FLIP_SHARE) if cfg.moe else (UPD_RTOL, FLIP_SHARE)
            row["params"] = mesh_blocks_close(torch, gm.params(), cm.params(), co["m"], lr_sum,
                                              rtol, share)
            row["moments"] = {k: sum(int(_off(torch, go[k][n].cpu(), co[k][n]).sum())
                                     for n in co[k]) for k in ("m", "v")}
            row["serve"] = mesh_check_serve(torch, cfg, cm, meshes, batch_of)
            out[f"a/{arch}"] = row
        seconds["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # (c) compression: this rank's local gradients of reduced qwen2-1.5b
        # (the card's model after (a), its rows), over the data group
        cfg = get_config("qwen2-1.5b", reduced=True)
        mesh = meshes["cuda"]
        model, opt = runs[("qwen2-1.5b", "cuda")]
        specs = train.param_specs(cfg, mesh)
        local = t_model.get_model(cfg, "cuda")
        local.load_state_dict(train.whole_params(model, mesh))
        batch = batch_of(cfg, MESH_CHECK_ROWS, MESH_CHECK_SEQ, 9, "cuda")
        rows = shd.batch_shardings(batch, mesh)
        batch = {k: shd.shard_of(v, rows[k].spec, mesh) for k, v in batch.items()}
        local.loss(batch).backward()
        grads = {n: shd.shard_of(p.grad, specs[n], mesh) for n, p in local.params().items()}
        data = mesh.axis_group("data")
        errs = compression.init_error_buffers(grads)
        t0 = time.perf_counter()
        reduced, _ = compression.compressed_psum_tree(grads, errs, data)
        torch.cuda.synchronize()
        comp_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain = {n: all_reduce(g, data) / 2 for n, g in grads.items()}
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        worst = 0.0
        for n, g in grads.items():
            # rank i's q_i is within half a step of its scale s_i and is
            # dequantised with the largest: |Σ q_i s_max - Σ g_i| / 2 is at
            # most Σ (127 (s_max - s_i) + s_i / 2) / 2
            s_i = torch.clamp(g.float().abs().max(), min=1e-12) / 127.0
            scales = all_gather(s_i.reshape(1), data, 0)
            bound = float((127 * (scales.max() - scales) + scales / 2).sum() / 2)
            worst = max(worst, float((reduced[n] - plain[n]).abs().max()) / bound)
        out["c/compression"] = {"worst_over_bound": worst, "leaves": len(grads),
                                "ms": comp_ms, "plain_ms": plain_ms,
                                "int8_bytes": sum(g.numel() for g in grads.values()),
                                "f32_bytes": 4 * sum(g.numel() for g in grads.values())}
        del local, grads, reduced, plain
        # (c) the 4-rank checkpoint, then this run's next step
        p_sh = shd.param_shardings(convert.param_shapes(cfg), cfg, mesh)
        shardings = (convert.nest(p_sh), {"m": convert.nest(p_sh),
                                          "step": shd.NamedSharding(mesh, ()),
                                          "v": convert.nest(p_sh)})
        Checkpointer(job["ckpt"]).save(MESH_STEPS, train.state_tree(model.params(), opt),
                                       shardings=shardings)
        whole = train.whole_params(model, mesh)
        digest = hashlib.sha256()
        for n in sorted(whole):
            digest.update(whole[n].cpu().numpy().tobytes())
        step = train.build_train_step(model, acfg, mesh=mesh)
        loss, m = step(opt, batch_of(cfg, MESH_CHECK_ROWS, MESH_CHECK_SEQ, MESH_STEPS, "cuda"))
        out["c/ckpt"] = {"digest": digest.hexdigest(), "next": [float(loss),
                                                                 float(m["grad_norm"])]}
        del runs, model, opt, whole
        seconds["c"] = time.perf_counter() - t0
    finally:
        t_model.ACT_DTYPE, matmul.allow_tf32 = before

    # (b) full width, bf16 activations as shipped ---------------------------
    import gc

    mesh = meshes["cuda"]
    out["b"] = {}
    for arch, layers in MESH_ARCHS.items():
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch).scaled(n_layers=layers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train.shard_model(cfg, mesh, torch.Generator("cuda").manual_seed(MESH_SEED))
        opt = adamw_init(model.params())
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        held = sum(p.numel() for p in model.params().values())
        step = train.build_train_step(model, acfg, mesh=mesh)
        losses, norms, ms, peaks, per_step, gathered, kinds = [], [], [], [], [], [], []
        entries: list = []  # every step's collectives (launch/mesh.py's recorder)
        dtypes = (t_model.ACT_DTYPE, torch.backends.cuda.matmul.allow_tf32)
        if arch in MESH_F32:
            t_model.ACT_DTYPE, torch.backends.cuda.matmul.allow_tf32 = torch.float32, False
        try:
            for s in range(MESH_STEPS):
                batch = batch_of(cfg, MESH_ROWS, MESH_SEQ, s, "cuda")
                if s == 0:
                    arguments = sum(dryrun.cell_arguments("train", model, step, (opt, batch),
                                                          mesh).values())
                torch.cuda.reset_peak_memory_stats()
                calls["n"] = 0
                t0 = time.perf_counter()
                with recording() as log:
                    loss, m = step(opt, batch)
                    losses.append(float(loss))
                ms.append((time.perf_counter() - t0) * 1e3)
                norms.append(float(m["grad_norm"]))
                peaks.append(torch.cuda.max_memory_allocated())
                per_step.append(comm_totals(log, EXPERT_CALLERS).get("all_to_all",
                                                                     [0, 0, 0, 0])[1])
                gathered.append(comm_totals(log, FSDP_CALLERS)["all_gather"][3])
                kinds.append(kind_bytes(log))
                entries += log
        finally:
            t_model.ACT_DTYPE, torch.backends.cuda.matmul.allow_tf32 = dtypes
        exchanged = comm_totals(entries, EXPERT_CALLERS)
        fsdp = comm_totals(entries, FSDP_CALLERS)
        summed = comm_totals(entries, SUM_CALLERS)
        comm = comm_totals(entries, skip=EXPERT_CALLERS + FSDP_CALLERS + SUM_CALLERS)
        seconds[f"b_steps/{arch}"] = sum(ms) / 1e3
        t0 = time.perf_counter()
        # a seeded sample of every leaf, each rank the elements its blocks hold
        specs = train.param_specs(cfg, mesh)
        shapes = convert.param_shapes(cfg)
        sample = {name: mesh_local_sample(torch, p.detach(), specs[name], shapes[name], mesh,
                                          MESH_SEED, i)
                  for i, (name, p) in enumerate(sorted(model.params().items()))}
        seconds[f"b_sample/{arch}"] = time.perf_counter() - t0
        served, dense = None, step.held
        if arch in MESH_SERVE:
            del opt, step
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            served = mesh_serve(torch, rank, cfg, model, mesh)
            seconds[f"b_serve/{arch}"] = time.perf_counter() - t0
            opt = step = None
        out["b"][arch] = {"losses": losses, "norms": norms, "ms": ms, "peak_bytes": peaks,
                          "served": served,
                          "init_s": init_s, "held_params": held, "ep_calls": calls["n"],
                          "dense_held": dense, "gathered_bytes_per_step": gathered,
                          "exchange_bytes_per_step": per_step,
                          "exchange": exchanged.get("all_to_all"), "expert": exchanged,
                          "fsdp": fsdp, "model_sums": summed, "comm": comm, "coords": coords,
                          "sample": sample, "kind_bytes": kinds, "argument_bytes": arguments}
        del model, opt, step
    moe_ep.moe_block_ep = ep_fn
    seconds["rank"] = time.perf_counter() - t_rank
    out["seconds"] = seconds
    out["launches"] = ops.launch_counts()
    return out


def mesh_dry(tag) -> tuple[dict, float]:
    """The dry prediction of (b)'s cells (``MESH_DRY`` in subprocesses
    run at once, ``MESH_DRY_SPLIT``: ``launch/dryrun.py:run_cell`` on a
    fake world of ``MESH_SHAPE``, fake
    CUDA tensors): each ``MESH_ARCHS`` config's train cell at its cut depth
    on ``MESH_ROWS`` x ``MESH_SEQ`` tokens (f32 activations for
    ``MESH_F32``), each ``MESH_SERVE`` config's prefill laid out for
    ``MESH_SLOTS`` positions and its decode against them, and qwen2-1.5b x
    decode_32k x single at full size; (the records by cell, seconds)."""
    cells = {f"train/{arch}": (arch, layers, "train", MESH_SEQ, MESH_ROWS, None,
                               arch in MESH_F32) for arch, layers in MESH_ARCHS.items()}
    for arch in MESH_SERVE:
        layers = MESH_ARCHS[arch]
        cells[f"prefill/{arch}"] = (arch, layers, "prefill", MESH_SEQ, MESH_ROWS, MESH_SLOTS,
                                    False)
        cells[f"decode/{arch}"] = (arch, layers, "decode", MESH_SLOTS, MESH_ROWS, None, False)
    check(sorted(sum(MESH_DRY_SPLIT, ())) == sorted(cells),
          "mesh leg: MESH_DRY_SPLIT does not hold every dry cell once")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_DRY, json.dumps({
            "cells": {n: cells[n] for n in part}, "mesh": MESH_SHAPE, "full": i == 0})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT)
        for i, part in enumerate(MESH_DRY_SPLIT)]
    out = {}
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=MESH_DRY_TIMEOUT_S)
            check(proc.returncode == 0, f"mesh leg: the dry run failed: {stderr[-3000:]}")
            out.update(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    for name, rec in out.items():
        if name == "table":
            continue
        check(rec["status"] == "ok", f"mesh leg: dry cell {name}: {rec.get('error')}\n"
                                     f"{rec.get('traceback', '')}")
        mem = rec["memory"]
        say(tag, f"mesh leg: dry {name} on {rec['mesh_shape']} (rank 0, fake {rec['device']} "
                 f"tensors): built {rec['build_s']} s, run {rec['run_s']} s; dot_flops "
                 f"{rec['dot_flops']:.6g}, hbm_bytes {rec['hbm_bytes']:.6g}; collective bytes by "
                 f"kind " + json.dumps({k: v["bytes"] for k, v in
                                        rec["collectives_by_kind"].items()})
                 + f"; argument {mem['argument_size_in_bytes']} B, temp "
                   f"{mem['temp_size_in_bytes']} B, output {mem['output_size_in_bytes']} B")
    say(tag, "mesh leg: dry qwen2-1.5b x decode_32k x single, roofline row (roofline.py's H100 "
             "SXM constants, NVIDIA H100 80GB HBM3, 700 W; modelled): "
             + out["table"].splitlines()[-1])
    say(tag, f"mesh leg: the dry run took {seconds:.1f} s")
    return out, seconds


def mesh_hold_dry(tag, ranks: list, dry: dict) -> dict:
    """Each rank's real (b) steps and served calls against the dry records:
    collective bytes by kind equal, argument bytes equal, the step's peak
    within ``MESH_PEAK_RTOL`` and ``MESH_PEAK_SLACK``; what was compared."""
    held = {}
    for arch in MESH_ARCHS:
        rec = dry[f"train/{arch}"]
        want = {k: v["bytes"] for k, v in rec["collectives_by_kind"].items()}
        mem = rec["memory"]
        need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        for r in ranks:
            b = r["b"][arch]
            peaks = b["peak_bytes"]
            off = [abs(p - need) for p in peaks]
            ok_peak = all(x <= MESH_PEAK_RTOL * need + MESH_PEAK_SLACK for x in off)
            say(tag, f"check: mesh leg: (b) {arch}, rank {r['rank']}, dry vs real step: "
                     f"collective bytes by kind dry {json.dumps(want)}, real "
                     + ", ".join(json.dumps(k) for k in b["kind_bytes"])
                     + f"; argument bytes dry {mem['argument_size_in_bytes']}, real "
                       f"{b['argument_bytes']}; dry argument + temp {need} B against the real "
                       f"peaks {peaks} B (off by " + ", ".join(f"{x / need:.2%}" for x in off)
                     + f"; within {MESH_PEAK_RTOL:.0%} + {MESH_PEAK_SLACK} B: {ok_peak})")
            check(all(k == want for k in b["kind_bytes"]),
                  f"mesh leg: (b) {arch}, rank {r['rank']}: a step's collective bytes by kind "
                  "differ from the dry run's")
            check(b["argument_bytes"] == mem["argument_size_in_bytes"],
                  f"mesh leg: (b) {arch}, rank {r['rank']}: the blocks' bytes differ from the "
                  "dry run's")
            check(ok_peak, f"mesh leg: (b) {arch}, rank {r['rank']}: the step's peak is not "
                           "within the margin of the dry argument + temp bytes")
        held[f"train/{arch}"] = {"dry": want, "argument": mem["argument_size_in_bytes"],
                                 "temp": mem["temp_size_in_bytes"],
                                 "peaks": {r["rank"]: r["b"][arch]["peak_bytes"] for r in ranks}}
    for arch in MESH_SERVE:
        for kind in ("prefill", "decode"):
            rec = dry[f"{kind}/{arch}"]
            want = {k: v["bytes"] for k, v in rec["collectives_by_kind"].items()}
            for r in ranks:
                sv = r["b"][arch]["served"]["rows"]
                got = sv["kind_bytes"][kind]
                got = got if isinstance(got, list) else [got]
                say(tag, f"check: mesh leg: (b) {arch} served, rank {r['rank']}, dry vs real "
                         f"{kind}: collective bytes by kind dry {json.dumps(want)}, real "
                         + ", ".join(json.dumps(k) for k in got)
                         + f"; argument bytes dry {rec['memory']['argument_size_in_bytes']}, "
                           f"real {sv['argument_bytes'][kind]}")
                check(all(k == want for k in got) and sv["argument_bytes"][kind]
                      == rec["memory"]["argument_size_in_bytes"],
                      f"mesh leg: (b) {arch} served, rank {r['rank']}: the {kind}'s collective "
                      "or argument bytes differ from the dry run's")
            held[f"{kind}/{arch}"] = {"dry": want,
                                      "argument": rec["memory"]["argument_size_in_bytes"]}
    return held


def mesh_leg(torch, tag, args) -> dict:
    """The LM substrate's mesh on torch.distributed: one group of 4 ranks,
    mesh (data 2, model 2) (see 22 in the module docstring)."""
    import hashlib
    import math

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import model as t_model
    from repro_torch.models.convert import param_shapes
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, schedule
    from repro_torch.train.pipeline import DataPipeline, PipelineConfig

    from repro_torch.launch.mesh import abstract_mesh

    t_leg = time.perf_counter()
    ops.reset_launch_counts()
    world = math.prod(MESH_SHAPE)
    cards = torch.cuda.device_count()
    backend = "cpu:gloo,cuda:nccl" if cards >= world else "gloo"
    predicted = {}
    for arch, layers in MESH_ARCHS.items():
        cfg = get_config(arch).scaled(n_layers=layers)
        n_params = sum(math.prod(s) for s in param_shapes(cfg).values())
        n_expert = sum(math.prod(s) for n, s in param_shapes(cfg).items() if train.is_expert(n))
        held = train.dense_held(cfg, abstract_mesh(MESH_SHAPE, MESH_AXES))
        line = (f"{arch} at full width, {layers} of {get_config(arch).n_layers} layers: "
                f"{n_params} parameters ({n_expert} in experts); a rank computes with "
                f"{held['dense']} of the {held['whole']} non-expert elements "
                f"({4 * held['dense']} of {4 * held['whole']} B in f32)")
        if cfg.moe:
            E, k = cfg.moe.n_experts, cfg.moe.top_k
            t_loc = MESH_ROWS // MESH_SHAPE[0] * MESH_SEQ
            C = max(1, int(cfg.moe.capacity_factor * k * t_loc / E))
            predicted[arch] = 2 * E * C * cfg.d_model * 2
            line += (f"; capacity C = {C} a rank; predicted all_to_all bytes a rank a layer "
                     f"(the forward's two exchanges of (E, C, d) bf16): {predicted[arch]}")
        say(tag, f"mesh leg: {line}")
    say(tag, f"mesh leg: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the card "
             f"by earlier legs; {world} ranks, mesh {dict(zip(MESH_AXES, MESH_SHAPE))}, "
             f"backend {backend}, {min(world, cards)} card(s)")
    seconds = {}
    dry, seconds["dry"] = mesh_dry(tag)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    job = {"backend": backend, "ckpt": str(tmp / "ck"), "leg": "mesh leg"}
    try:
        ranks, seconds["group"] = shard_group(world, job, tmp, target=mesh_rank,
                                              timeout=MESH_TIMEOUT_S)
        held_dry = mesh_hold_dry(tag, ranks, dry)
        rank_launches = {name: sum(r["launches"][name] for r in ranks) for name in KERNEL_SOURCES}
        for r in ranks:
            say(tag, f"mesh leg: rank {r['rank']} seconds: "
                     + ", ".join(f"{k} {v:.1f}" for k, v in r["seconds"].items())
                     + f" (the group {seconds['group']:.1f} s from spawn to exit)")
        check(not any(rank_launches.values()),
              f"mesh leg: a JOIN-AGG kernel launched in a rank: {rank_launches}")
        acfg = AdamWConfig(**MESH_LR)
        lr_sum = sum(float(schedule(acfg, s)) for s in range(1, MESH_STEPS + 1))

        # (a) card = CPU
        for arch in MESH_CHECK:
            moe = bool(mesh_check_cfg(arch).moe)
            if moe:
                bounds = (EP_LOSS0_RTOL, EP_NORM0_RTOL, EP_LOSS_RTOL, EP_NORM_RTOL)
            else:
                bounds = (F32_RTOL, UPD_RTOL, F32_RTOL, UPD_RTOL)
            for r in ranks:
                row = r[f"a/{arch}"]
                g, c = row["cuda"], row["cpu"]
                loss_rel = [abs(a - b) / abs(b) for a, b in zip(g["losses"], c["losses"])]
                norm_rel = [abs(a - b) / abs(b) for a, b in zip(g["norms"], c["norms"])]
                margin, blocks = row.get("route_margin"), row["params"]
                say(tag, f"check: mesh leg: (a) rank {r['rank']} reduced {arch}, f32, "
                         f"{MESH_STEPS} sharded steps on {MESH_CHECK_ROWS} x {MESH_CHECK_SEQ} "
                         f"tokens, card vs CPU: losses {g['losses']} vs {c['losses']} (relative "
                         f"{[f'{x:.3g}' for x in loss_rel]}; step 0 within {bounds[0]}, later "
                         f"{bounds[2]}), norms {g['norms']} vs {c['norms']} "
                         f"({[f'{x:.3g}' for x in norm_rel]}; {bounds[1]}, {bounds[3]}); blocks "
                         f"beyond {blocks['rtol']} where |g| > {GRAD_FLOOR}: share "
                         f"{blocks['off_share']:.3g} (<= {blocks['share']}), largest difference "
                         f"{blocks['largest']:.3g} (<= 2 x Σ lr = {2 * lr_sum:.3g}); m and v "
                         f"elements beyond {UPD_RTOL} {row['moments']}; moe_block_ep calls "
                         f"{g['ep_calls']} and {c['ep_calls']}"
                         + (f"; CPU routing margin {margin:.3g} (> {ROUTE_MARGIN})"
                            if margin is not None else "")
                         + "; steps " + ", ".join(
                             f"{dev} {row[dev]['steps_s']:.2f} s, collectives "
                             + " ".join(f"{k} {v[0]:.2f} s x{v[2]}"
                                        for k, v in row[dev]["comm"].items())
                             for dev in ("cuda", "cpu")))
                if margin is not None:
                    check(margin > ROUTE_MARGIN, f"mesh leg: (a) rank {r['rank']}: a near-tie in "
                                                 f"the CPU's routing (margin {margin:.3g})")
                check(loss_rel[0] <= bounds[0] and norm_rel[0] <= bounds[1]
                      and max(loss_rel) <= bounds[2] and max(norm_rel) <= bounds[3]
                      and blocks["ok"],
                      f"mesh leg: (a) rank {r['rank']}: the card's sharded {arch} steps differ "
                      "from the CPU's")
                check((g["ep_calls"] > 0 and c["ep_calls"] > 0) == moe,
                      f"mesh leg: (a) {arch}: moe_block_ep calls {g['ep_calls']}, "
                      f"{c['ep_calls']}")
                sv = row["serve"]
                margin = sv["route_margin"]
                say(tag, f"check: mesh leg: (a) rank {r['rank']} reduced {arch}, f32, served "
                         f"after the steps from the CPU's blocks: a prefill of {MESH_CHECK_ROWS} x "
                         f"{MESH_CHECK_SEQ} tokens and {MESH_CHECK_DECODE} decode steps against "
                         f"a {sv['slots']}-position cache, card vs CPU: largest |logit "
                         f"difference| a step "
                         f"{[f'{x:.3g}' for x in sv['logits']['largest'].values()]}, largest "
                         f"cache difference " + ", ".join(
                             f"{k} {v:.3g}" for k, v in sv["cache"]["largest"].items())
                         + f", within {F32_RTOL} (relative and of the largest): "
                         f"{sv['logits']['ok'] and sv['cache']['ok']}"
                         + (f"; CPU routing margin {margin:.3g} (> {ROUTE_MARGIN})"
                            if margin is not None else ""))
                if margin is not None:
                    check(margin > ROUTE_MARGIN, f"mesh leg: (a) rank {r['rank']}: a near-tie in "
                                                 f"the served {arch}'s routing ({margin:.3g})")
                check(sv["logits"]["ok"] and sv["cache"]["ok"],
                      f"mesh leg: (a) rank {r['rank']}: the card's meshed prefill or decode of "
                      f"{arch} differs from the CPU's")

        # (b) every rank's loss finite and equal, then the unsharded step
        unsharded = {}
        for arch, layers in MESH_ARCHS.items():
            cfg = get_config(arch).scaled(n_layers=layers)
            b0 = ranks[0]["b"][arch]
            for r in ranks:
                b = r["b"][arch]
                dense = b["dense_held"]
                say(tag, f"mesh leg: (b) {arch}, rank {r['rank']} {b['coords']}: "
                         f"{b['held_params']} parameters held ({b['held_params'] * 12 / 2**30:.2f} "
                         f"GiB with m and v), init {b['init_s']:.2f} s; steps "
                         + ", ".join(f"{ms:.1f} ms" for ms in b["ms"])
                         + "; peaks " + ", ".join(f"{p / 2**30:.2f} GiB" for p in b["peak_bytes"])
                         + f"; losses {b['losses']}, norms {b['norms']}; dense elements computed "
                         f"with {dense['dense']} of {dense['whole']} whole ({4 * dense['dense']} "
                         f"of {4 * dense['whole']} B in f32), bytes the step's all_gather "
                         f"returned a step {b['gathered_bytes_per_step']}"
                         + (f"; all_to_all bytes a step {b['exchange_bytes_per_step']} "
                            f"({b['exchange_bytes_per_step'][-1] / layers:.0f} a layer, forward, "
                            f"recompute and backward; {b['exchange'][2]} calls over the steps, "
                            f"{b['exchange'][0]:.2f} s); moe_block_ep calls in the last step "
                            f"{b['ep_calls']}" if cfg.moe else "")
                         + "; the steps' collectives (s, input bytes, calls, output bytes; host "
                         "copies included): expert path "
                         + ", ".join(f"{k} {v[0]:.2f} s {v[1]} B {v[2]} {v[3]} B"
                                     for k, v in b["expert"].items())
                         + "; the model axis's sums "
                         + ", ".join(f"{k} {v[0]:.2f} s {v[1]} B {v[2]} {v[3]} B"
                                     for k, v in b["model_sums"].items())
                         + "; gathers and gradient reductions "
                         + ", ".join(f"{k} {v[0]:.2f} s {v[1]} B {v[2]} {v[3]} B"
                                     for k, v in b["fsdp"].items())
                         + "; the rest " + ", ".join(f"{k} {v[0]:.2f} s {v[1]} B {v[2]} {v[3]} B"
                                                     for k, v in b["comm"].items()))
                check(all(np.isfinite(b["losses"])) and all(np.isfinite(b["norms"])),
                      f"mesh leg: (b) {arch}, rank {r['rank']}: a loss or norm is not finite")
                check(b["losses"] == b0["losses"] and b["norms"] == b0["norms"],
                      f"mesh leg: (b) {arch}, rank {r['rank']}'s losses or norms differ from "
                      "rank 0's")
                check((b["ep_calls"] > 0) == bool(cfg.moe),
                      f"mesh leg: (b) {arch}, rank {r['rank']}: moe_block_ep calls "
                      f"{b['ep_calls']}")
                check(dense["dense"] < dense["whole"],
                      f"mesh leg: (b) {arch}, rank {r['rank']} computes with whole dense leaves")
                for label, sv in (b["served"] or {}).items():
                    if not isinstance(sv, dict):
                        continue
                    tok = sv["decode_ms"]
                    say(tag, f"mesh leg: (b) {arch}, rank {r['rank']}, served on the mesh "
                             f"({sv['rows']} row(s)): weights gathered to the blocks computed "
                             f"with in {sv['build_s']:.2f} s; prefill of {sv['rows']} x {MESH_SEQ} "
                             f"tokens {sv['prefill_ms']:.1f} ms (its collectives "
                             + ", ".join(f"{k} {v[0]:.3f} s x{v[2]}"
                                         for k, v in sv["prefill_comm"].items())
                             + f"); {sv['tokens']} decode steps against {MESH_SLOTS} positions "
                             + ", ".join(f"{x:.1f}" for x in tok)
                             + f" ms (mean {sum(tok) / len(tok):.1f} ms a token); collectives a "
                             "token (s, input bytes, calls, output bytes) "
                             + ", ".join(f"{k} {v[0]:.4f} s {v[1]:.0f} B {v[2]:.1f} {v[3]:.0f} B"
                                         for k, v in sv["per_token"].items())
                             + f"; cache layout {sv['specs']}")
                    if "check" not in sv:
                        continue
                    c = sv["check"]
                    ok = c["logits_ok"] and c["prefill_cache"]["ok"] and c["decode_cache"]["ok"]
                    say(tag, f"check: mesh leg: (b) {arch} served on the mesh ({sv['rows']} "
                             f"row(s)) vs the unsharded prefill and decode of the same parameters "
                             f"on rank 0, bf16: largest |logit difference| a step "
                             f"{[f'{x:.3g}' for x in c['logits_largest']]}; largest cache "
                             f"difference after the prefill " + ", ".join(
                                 f"{k} {v:.3g}" for k, v in c["prefill_cache"]["largest"].items())
                             + ", after the decode " + ", ".join(
                                 f"{k} {v:.3g}" for k, v in c["decode_cache"]["largest"].items())
                             + f"; within {BF16_LOGIT_TOL}: {ok}")
                    check(ok, f"mesh leg: (b) {arch}: the meshed prefill or decode "
                              f"({sv['rows']} row(s)) differs from the unsharded one")
                if arch in MESH_SERVE and r["rank"] == 0:
                    check(all("check" in sv for sv in b["served"].values()
                              if isinstance(sv, dict)),
                          f"mesh leg: (b) {arch}: rank 0 held no serving check")
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            model = t_model.get_model(cfg, "cuda").init(
                torch.Generator("cuda").manual_seed(MESH_SEED))
            opt = adamw_init(model.params())
            step = train.build_train_step(model, acfg, accum=MESH_SHAPE[0])
            pipe = DataPipeline(PipelineConfig(cfg.vocab, MESH_SEQ, MESH_ROWS))
            want_l, want_n = [], []
            dtypes = (t_model.ACT_DTYPE, torch.backends.cuda.matmul.allow_tf32)
            if arch in MESH_F32:
                t_model.ACT_DTYPE, torch.backends.cuda.matmul.allow_tf32 = torch.float32, False
            try:
                for s in range(MESH_STEPS):
                    loss, m = step(opt, {k_: torch.tensor(v, device="cuda")
                                         for k_, v in pipe.local_batch_at(s).items()})
                    want_l.append(float(loss))
                    want_n.append(float(m["grad_norm"]))
            finally:
                t_model.ACT_DTYPE, torch.backends.cuda.matmul.allow_tf32 = dtypes
            params = model.params()
            off, largest, total = 0, 0.0, 0
            for i, name in enumerate(sorted(params)):
                want = torch.tensor(mesh_sample(torch, params[name].detach(), MESH_SEED, i))
                held = {}
                for r in ranks:
                    held.update({int(k): v for k, v in r["b"][arch]["sample"][name].items()})
                check(sorted(held) == list(range(MESH_SAMPLE)),
                      f"mesh leg: (b) the ranks' blocks do not hold every sample of {arch}'s "
                      f"{name}")
                got = torch.tensor([held[k] for k in range(MESH_SAMPLE)])
                close = torch.isclose(got, want, rtol=MESH_PARAM_RTOL,
                                      atol=MESH_PARAM_RTOL * float(want.abs().max()))
                off += int((~close).sum())
                total += got.numel()
                largest = max(largest, float((got - want).abs().max()))
            del model, opt, params, step
            gc.collect()
            torch.cuda.empty_cache()
            seconds[f"unsharded/{arch}"] = time.perf_counter() - t0
            rel_l = [abs(a - b) / abs(b) for a, b in zip(b0["losses"], want_l)]
            rel_n = [abs(a - b) / abs(b) for a, b in zip(b0["norms"], want_n)]
            ok = (rel_l[0] <= MESH_LOSS0_RTOL and max(rel_l) <= MESH_LOSS_RTOL
                  and max(rel_n) <= MESH_NORM_RTOL and off <= MESH_FLIP_SHARE * total
                  and largest <= 2 * lr_sum * (1 + 1e-3))
            say(tag, f"check: mesh leg: (b) {arch}: sharded steps vs the unsharded step with "
                     f"accum = {MESH_SHAPE[0]} on the same batches and seed"
                     + (", f32 activations (MESH_F32)" if arch in MESH_F32 else "") + ": losses "
                     f"{b0['losses']} vs {want_l} (relative {[f'{x:.3g}' for x in rel_l]}; step 0 "
                     f"within {MESH_LOSS0_RTOL}, later {MESH_LOSS_RTOL}), norms {b0['norms']} vs "
                     f"{want_n} ({[f'{x:.3g}' for x in rel_n]}; {MESH_NORM_RTOL}); {total} sampled "
                     f"parameters: {off} beyond rtol {MESH_PARAM_RTOL} (<= "
                     f"{MESH_FLIP_SHARE:.0%}), largest difference {largest:.3g} (<= 2 x Σ lr = "
                     f"{2 * lr_sum:.3g}): {ok}")
            check(ok, f"mesh leg: (b) {arch}: the sharded steps differ from the unsharded accum "
                      "step")
            unsharded[arch] = {"losses": want_l, "norms": want_n, "sample_off": off,
                               "sample_largest": largest}

        # (c) the 4-rank checkpoint, restored here as one rank
        t0 = time.perf_counter()
        rcfg = get_config("qwen2-1.5b", reduced=True)
        matmul = torch.backends.cuda.matmul
        before = (t_model.ACT_DTYPE, matmul.allow_tf32)
        try:
            t_model.ACT_DTYPE, matmul.allow_tf32 = torch.float32, False
            model = t_model.get_model(rcfg, "cuda")
            opt = adamw_init(model.params())
            tree, saved = Checkpointer(job["ckpt"]).restore(train.state_tree(model.params(), opt))
            train.load_state(model.params(), opt, tree)
            digest = hashlib.sha256()
            for n in sorted(model.params()):
                digest.update(model.params()[n].detach().cpu().numpy().tobytes())
            pipe = DataPipeline(PipelineConfig(rcfg.vocab, MESH_CHECK_SEQ, MESH_CHECK_ROWS))
            loss, m = train.build_train_step(model, acfg, accum=MESH_SHAPE[0])(
                opt, {k_: torch.tensor(v, device="cuda")
                      for k_, v in pipe.local_batch_at(MESH_STEPS).items()})
            got = (float(loss), float(m["grad_norm"]))
        finally:
            t_model.ACT_DTYPE, matmul.allow_tf32 = before
        del model, opt, tree
        seconds["restore"] = time.perf_counter() - t0
        c0 = ranks[0]["c/ckpt"]
        same = digest.hexdigest() == c0["digest"]
        nxt = c0["next"]
        ok = (same and saved == MESH_STEPS and abs(got[0] - nxt[0]) <= F32_RTOL * abs(nxt[0])
              and abs(got[1] - nxt[1]) <= UPD_RTOL * abs(nxt[1]))
        say(tag, f"check: mesh leg: (c) the 4-rank checkpoint of reduced qwen2-1.5b (step_{saved}) "
                 f"restored here as one rank: parameters bit-identical to the ranks' gathered "
                 f"ones: {same}; its next step (accum = {MESH_SHAPE[0]}) loss {got[0]:.7f} and "
                 f"norm {got[1]:.7f} vs the 4-rank run's {nxt[0]:.7f} and {nxt[1]:.7f} "
                 f"(rtol {F32_RTOL}, {UPD_RTOL}): {ok}")
        check(ok, "mesh leg: (c) the restored checkpoint's next step differs from the 4-rank run's")
        for r in ranks:
            c = r["c/compression"]
            say(tag, f"check: mesh leg: (c) rank {r['rank']}: compressed_psum_tree over the data "
                     f"group of {c['leaves']} gradient blocks ({c['f32_bytes']} B in f32, "
                     f"{c['int8_bytes']} B of int8 payload) in {c['ms']:.2f} ms (plain all-reduce "
                     f"{c['plain_ms']:.2f} ms): largest distance to the plain mean "
                     f"{c['worst_over_bound']:.3g} of the int8 bound (<= 1)")
            check(c["worst_over_bound"] <= 1 + 1e-5,
                  f"mesh leg: (c) rank {r['rank']}: the compressed sum leaves its int8 bound")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches = ops.launch_counts()
    check(not any(launches.values()), f"mesh leg: a JOIN-AGG kernel launched: {launches}")
    leg_s = time.perf_counter() - t_leg
    say(tag, f"mesh leg: the leg took {leg_s:.1f} s ("
             + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    return {"seconds": leg_s, "part_seconds": seconds, "backend": backend,
            "predicted_exchange_bytes_a_layer": predicted, "dry": held_dry,
            "dry_full": {k: v for k, v in dry["full"].items()
                         if k not in ("top_collectives", "argument_leaves")},
            "b": {arch: {r["rank"]: {k: v for k, v in r["b"][arch].items() if k != "sample"}
                         for r in ranks} for arch in MESH_ARCHS},
            "unsharded": unsharded,
            "a": {r["rank"]: {k: v for k, v in r.items() if k.startswith("a/")} for r in ranks},
            "c": {"restored_next": got, "ranks_next": nxt,
                  "compression": [r["c/compression"] for r in ranks]},
            "launches": {"mesh": {name: launches[name] + rank_launches[name]
                                  for name in KERNEL_SOURCES}}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=500_000, help="rows per relation")
    ap.add_argument("--check-n", type=int, default=20_000,
                    help="rows per relation of the CPU bit-identity check")
    ap.add_argument("--seed", type=int, default=0)
    # cut from 5,000,000 (Table XIV's scale): a whole run with leg 22 took
    # 1,264.2 s of its 1,200 on a slow host
    ap.add_argument("--storage-n", type=int, default=2_000_000,
                    help="rows per relation of the storage leg")
    # cut from --n (500,000, Table VIII's B2): a whole run with leg 22's
    # served cells took 1,113.2 s of its 1,200, the maintain leg 191.9 s of
    # it, most of that the host's prepare for the handles and the fresh
    # executes each batch is held to
    ap.add_argument("--maintain-n", type=int, default=250_000,
                    help="rows per relation of the maintain leg")
    args = ap.parse_args()
    t_script = time.perf_counter()
    # the fused hops tune their launch shapes from scratch, into a cache
    # file of this run's own, which goes with the run
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(Path(tune_dir) / "autotune.json")
    try:
        return smoke(args, t_script)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def smoke(args, t_script: float) -> int:
    if not (SRC / "repro_torch" / "kernels" / "ops.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a repository checkout", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.api import TorchChannelEngine
    from repro_torch.kernels import autotune, ops

    tag = card_line()
    dev_name = torch.cuda.get_device_name(0)
    say(tag, f"card: {dev_name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    def done(phase: str) -> None:
        say(tag, f"chip_smoke: {phase} done at {time.perf_counter() - t_script:.1f} s")

    # 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = ops.build()
    say(tag, f"build: {time.perf_counter() - t0:.2f} s wall for {list(built)} "
             f"(nvcc per source: "
             + ", ".join(f"{k} {v.seconds:.2f} s" for k, v in built.items()) + ")")
    for name, b in built.items():
        for line in b.log.splitlines():
            if ("registers" in line or "spill" in line or "stack frame" in line
                    or (name == "semiring_matmul" and "entry function" in line)):
                say(tag, f"build: {name}: {line.strip()}")
    done("1. build")

    # 2. main path (unfused) ---------------------------------------------
    db, cols = chain_db(args.n, args.seed)
    say(tag, f"data: C1 n={args.n} seed={args.seed}")
    plan, res, main = drive(torch, tag, "main path", lambda: bundle_query("torch").plan(db))
    say(tag, f"main path: root with statistics on (the default): "
             f"{plan.prep.decomposition.root}")
    launches = main["launches"]
    for name in UNFUSED_KERNELS:
        check(launches[name] > 0, f"main path never launched {name}")
    check(launches["fused_hop"] == 0, "the unfused main path launched fused_hop")
    check(launches["semiring_matmul"] == 0, "the main path launched semiring_matmul")
    main["paths"] = check_paths(tag, "main path", plan, launches)

    # 3. fused path -------------------------------------------------------
    tuned0 = autotune.stats()
    fplan, fres, fused = drive(
        torch, tag, "fused path", lambda: bundle_query("torch").fused(True).plan(db)
    )
    fused["tuning"] = {k: v - tuned0[k] for k, v in autotune.stats().items()}
    flaunches = fused["launches"]
    hops = len(fplan.prep.decomposition.nodes)
    passes = 1 + len(fplan.minmax)
    fstream = fplan.resolved_stream()
    tiles = 1 if fstream is None else -(-fplan.prep.dicts[fstream[0]].size // fstream[1])
    timing = fused["tuning"]["timing_launches"]
    say(tag, f"fused path: launches reckoned as {hops} hops x {passes} passes (1 "
             f"channel pass + {len(fplan.minmax)} MIN/MAX) x {tiles} stream tiles = "
             f"{hops * passes * tiles}, plus {timing} launches that timed candidate launch "
             f"shapes in {fused['tuning']['measurements']} measurements (kernels/autotune.py); "
             f"counted {flaunches['fused_hop']}")
    check(flaunches["fused_hop"] > 0, "fused path never launched fused_hop")
    check(fused["tuning"]["measurements"] > 0, "the cold fused execute tuned nothing")
    check(flaunches["fused_hop"] == hops * passes * tiles + timing,
          "fused_hop launches differ from hops x passes x stream tiles + timing launches")
    for name in UNFUSED_KERNELS + ("semiring_matmul",):
        check(flaunches[name] == 0, f"fused path launched {name}")
    fused["paths"] = check_paths(tag, "fused path", fplan, flaunches)
    check_launch_shapes(torch, tag, "fused path", fplan)
    for p in (plan, fplan):
        verified(tag, "main and fused paths", p)

    # 4. correctness -----------------------------------------------------
    want_n, want_s = chain_totals(cols)
    for label, r in (("main path", res), ("fused path", fres)):
        got_n, got_s = r.column("n").sum(), r.column("s").sum()
        say(tag, f"check: {label}: Σ count {got_n:.0f} vs numpy {want_n}; Σ sum "
                 f"{got_s:.0f} vs numpy {want_s}")
        check(got_n == want_n and got_s == want_s,
              f"{label}: Σ count / Σ sum disagree with numpy")
        check(r.num_rows > 0, f"{label}: empty result")
        for name in r.agg_names:
            check(bool(np.isfinite(r.column(name)).all()),
                  f"{label}: non-finite values in {name}")
    same = same_result(res, fres)
    say(tag, f"check: fused path: {fres.num_rows} rows, every column bit-identical "
             f"to the unfused main path: {same}")
    check(same, "fused result differs from the unfused result")

    small, _ = chain_db(args.check_n, args.seed)
    for label, fuse in (("main path", None), ("fused path", True)):
        gq = bundle_query("torch")
        cq = bundle_query(TorchChannelEngine(device="cpu"))
        if fuse:
            gq, cq = gq.fused(True), cq.fused(True)
        gpu, cpu = gq.plan(small).execute(), cq.plan(small).execute()
        same = same_result(gpu, cpu)
        say(tag, f"check: {label}: C1 n={args.check_n}: {cpu.num_rows} rows, "
                 f"{len(cpu.relation.columns)} columns bit-identical to device='cpu': "
                 f"{same}")
        check(same and gpu.num_rows == cpu.num_rows,
              f"{label}: cuda result differs from cpu result")
    done("2.-4. main and fused paths")

    # 5. kernels vs plain, at the paths' shapes --------------------------
    captured = capture_launches(plan.execute, main_path_key)
    check("coo_spmm" in captured, "no coo_spmm launch captured")
    for name in SEGMENT_KERNELS:
        check(any(key[0] == name for key in captured if isinstance(key, tuple)),
              f"no {name} launch captured")
    results = kernel_phase(torch, tag, captured)
    results["fused_hop"] = fused_phase(torch, tag, capture_launches(fplan.execute, hop_class))
    results["semiring_matmul"] = semiring_phase(torch, tag)
    for name, errs in gather_phase(torch, tag).items():
        results[name]["max_abs_err"] = max([results[name]["max_abs_err"]] + errs)
    done("5. kernels")

    # 6. split leg, 7. cyclic leg, 8. dense leg, 9. explain --------------
    main_digest = result_digest(res)
    del plan, fplan, res, fres, captured
    torch.cuda.empty_cache()
    split = split_leg(torch, tag, args)
    done("6. split leg")
    cyclic = cyclic_leg(torch, tag, args)
    done("7. cyclic leg")
    dense = dense_leg(torch, tag, args)
    tpch = dense.pop("tpch")
    done("8. dense leg")
    explain_phase(torch, tag, args.seed)
    done("9. explain")

    # 10. maintain leg -----------------------------------------------------
    torch.cuda.empty_cache()
    maintain = maintain_leg(torch, tag, args)
    for name, row in maintain_kernels(torch, tag, maintain.pop("captured")).items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], row["max_abs_err"])
        results[name]["maintain"] = row
    done("10. maintain leg")

    # 11. storage leg ------------------------------------------------------
    torch.cuda.empty_cache()
    stored = storage_leg(torch, tag, args)
    for name, row in stored.pop("kernels").items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], row["max_abs_err"])
        results[name]["storage"] = row
    done("11. storage leg")

    # 12. serve leg --------------------------------------------------------
    torch.cuda.empty_cache()
    served = serve_leg(torch, tag, args, tpch)
    del tpch
    for name, row in served.pop("kernels").items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], row["max_abs_err"])
        results[name]["serve"] = row
    done("12. serve leg")

    # 13. shard leg --------------------------------------------------------
    torch.cuda.empty_cache()
    sharded = shard_leg(torch, tag, args, main_digest, (want_n, want_s))
    for name, row in sharded.pop("kernels").items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], row["max_abs_err"])
        results[name]["shard"] = row
    done("13. shard leg")
    served_s = sharded["serve_mesh"]["seconds"]
    say(tag, f"chip_smoke: 13. shard leg without the served group done at "
             f"{time.perf_counter() - t_script - served_s:.1f} s (the served group took "
             f"{served_s:.1f} s)")

    # 14. comparison leg ---------------------------------------------------
    torch.cuda.empty_cache()
    compared = comparison_leg(torch, tag, args)
    done("14. comparison leg")

    # 15. launcher leg -----------------------------------------------------
    torch.cuda.empty_cache()
    launched = launcher_leg(torch, tag, args)
    done("15. launcher leg")

    # 16. ref leg ------------------------------------------------------------
    torch.cuda.empty_cache()
    reffed = ref_leg(torch, tag, args, db, cols, main_digest, main)
    for name, row in reffed.pop("kernels").items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], row["max_abs_err"])
        results[name]["ref"] = row
    done("16. ref leg")

    # 17. autotune leg -------------------------------------------------------
    torch.cuda.empty_cache()
    tuned = autotune_leg(torch, tag, args, db, main_digest, fused)
    results["fused_hop"]["tuned"] = tuned["tuned"]
    done("17. autotune leg")

    # 18. train leg --------------------------------------------------------
    del db, cols
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_leg(torch, tag, args)
    done("18. train leg")

    # 19. moe/vlm leg --------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    moe_vlm = moe_vlm_leg(torch, tag, args)
    done("19. moe/vlm leg")

    # 20. ssm/hybrid leg -----------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    recurrent = ssm_hybrid_leg(torch, tag, args)
    done("20. ssm/hybrid leg")

    # 21. audio leg ----------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    audio = audio_leg(torch, tag, args)
    done("21. audio leg")

    # 22. mesh leg -----------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    meshed = mesh_leg(torch, tag, args)
    done("22. mesh leg")

    legs = {"main": launches, "fused": flaunches}
    for leg in (split, cyclic, dense, maintain, stored, served, sharded, compared, launched,
                reffed, trained, moe_vlm, recurrent, audio, meshed):
        legs.update(leg.pop("launches"))
    for label, summary in (("main path", main), ("fused path", fused), *split.items(),
                           *cyclic.items(), *dense.items(), *maintain.items(),
                           *(("storage leg, " + k, v) for k, v in stored.items()),
                           ("serve leg", served), ("shard leg", sharded),
                           ("comparison leg", compared), ("launcher leg", launched),
                           ("ref leg", reffed), ("train leg", trained),
                           ("moe/vlm leg", moe_vlm), ("ssm/hybrid leg", recurrent),
                           ("audio leg", audio), ("mesh leg", meshed),
                           ("autotune leg", {k: v for k, v in tuned.items() if k != "tuned"})):
        say(tag, f"{label} summary: {json.dumps(summary)}")
    paths = {name: "main" for name in UNFUSED_KERNELS}
    paths.update(fused_hop="fused", semiring_matmul=None)
    counts = {name: launches[name] for name in UNFUSED_KERNELS}
    counts.update(fused_hop=flaunches["fused_hop"], semiring_matmul=0)
    kernels = []
    for name in ops.KERNELS:
        r = results[name]
        src, replaces = KERNEL_SOURCES[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shapes": r["shapes"], "path": paths[name],
            "leg_launches": {leg: counts_of[name] for leg, counts_of in legs.items()},
        }
        if name in SEGMENT_KERNELS:
            entry.update(regimes=r["regimes"], launches_by_width=r["launches_by_width"])
        if name == "coo_spmm":
            entry.update(walk=r["walk"])
        for leg in ("maintain", "storage", "serve", "shard", "ref"):
            if leg in r:
                entry[leg] = r[leg]
        if name == "fused_hop":
            entry.update(three_dispatch_ms=r["three_dispatch_ms"], library=r["library"],
                         hops=r["hops"], walk=r["walk"], tuned=r["tuned"],
                         tuning_launches=fused["tuning"]["timing_launches"])
        if name == "semiring_matmul":
            entry.update(note="no path launches it; held and timed on its own",
                         semirings=r["semirings"])
        kernels.append(entry)
    say(tag, f"chip_smoke: the whole script took {time.perf_counter() - t_script:.1f} s")
    print(tag, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
