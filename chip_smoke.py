#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, so the script
exits non-zero and prints no result line:

1. Build: compiles every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the seconds taken,
   each kernel's registers and spills, and the card's name and power limit.
2. Kernels vs plain versions: every kernel against its plain PyTorch
   version on the card, on edge cases (packed and int8 banks, int8 at
   D = 1000, ragged Q and R, num_valid < R, k > num_valid, k = R,
   duplicate rows; for the exact tensor-core scan also Q = 1, 4 and 33,
   R off its 64- and 256-row steps, splits ending inside and between
   warpgroups, ties across warpgroups, W = 1, 3 and 65 words with
   dim < 32 W and random padding bits, k = R over several splits, and
   ``encode_search``'s encode kernel alone; for the banded kernels also
   empty bands, bands narrower than k, bands crossing blocks and running
   past num_valid, two bands (also overlapping, nested or out of order,
   whose overflow slots canonicalize on the bands' union), no tile
   budget and the plan's tight one,
   bands far apart, Q = 1, 7, 33 and 70 (one to three query groups), every
   band empty, one band covering the whole bank, bands meeting a 32-row
   tile in one row, num_valid inside bands, int8 banks, and k = 1 and the
   largest k that fits; for ``hamming_pop`` Q = R = 1,
   ragged Q and R, Q or R under one 16 x 8 fragment, W = 1, 2, 3, 64, 65
   and 130,
   rows off a 16-byte boundary, all-zero and all-ones words, dim < 32 W
   with random padding bits, q = r, and the served buckets 4 / 8 / 16 / 32
   against 1,000 and 3,000 centroids; for ``hd_encode`` ragged B, F and D,
   all-absent rows, sign ties and levels past m - 1, at several launch
   shapes; for ``imc_mvm`` integer and float weights, exact .5 points of
   part / lsb, saturated codes, ragged Q, R and Dp, a 64-column array,
   every compiled output tile, a partial that a float64 sum would round
   twice, weight rows off a 16-byte boundary, one 43-column tile, and
   Q = 1 and 33; for ``decode_attention`` the reference's
   test shapes, G = 1 at hd = 256, G = 48, G = 5 at hd = 128, Whisper's
   G = 1 at hd = 64 and InternVL2's G = 8 at hd = 128, valid_len
   0 / 1 / 70 of 128 /
   S, S off every chunk multiple and the served shape, valid_len at a
   split boundary - 1 / + 0 / + 1, valid_len 1 with every later split
   empty, S under one split, and 1, 2, 7 and 17 forced splits, each also
   in the partial form ``decode_attention_partial`` with its log-sum-exp,
   where valid_len 0 must give 0 and -inf; plus rows past valid_len set
   to 127, which must leave the output bit-identical).
   Tolerance: exact (integer indices, scores, similarities and HVs;
   ``imc_mvm`` and its plain version round every float32 fused
   multiply-add alike), and
   rtol / atol 2e-4 for ``decode_attention`` (float32 softmax and dots in
   another order; the reference's own kernel-vs-oracle tolerance).
3. The autotuner: ``repro_torch.launch.tune.main`` in-process at the
   served shapes (``tune/sweep.py``), into a temporary file. The six swept
   kernels' launch counts are set to 0 just before and read just after; a
   kernel never launched fails the run, as does a candidate whose result
   differs from the default's, a worst tuned-vs-default ratio under 1.0,
   or a table left active. Prints the measured ceilings beside the
   published ones and each op's default and tuned microseconds. Then
   ``hd_encode`` (B = 32, F = 1,024, D = 8,192) and ``imc_mvm`` (Q = 32
   against 581,196 rows at Dp = 2,731, 6.35 GB of float32 weights) are
   held against their plain versions at those shapes and timed beside
   them (``hd_encode`` also by bucket 4 / 8 / 16 / 32 and launch block
   with the host's issue hidden, and with no present bin: its compaction
   and launch alone), and ``imc_mvm`` beside one float32 ``torch.matmul``
   (TF32 off)
   over the same tile dot products without the ADC; the weights are
   freed after.
3b. The end-to-end pipelines (``core.pipeline``) on the ``imc_mvm``
   kernel: ``run_db_search`` ideal and analog (MLC3, TiTe2, 3
   write-verify cycles, D = 8,193, so Dp = 2,731) with 4,096 OMS-style
   queries against the 581,196 targets of phase 4's bank and as many
   decoys, open window; ``run_clustering`` (MLC3, Sb2Te3, D = 2,049, Dp =
   683) on one paper-average bucket of 10,624 spectra; the ISA's
   ``compile_db_search`` stream over the packed targets with 32 staged
   queries. Each prints identifications at 1% FDR and recall (or the
   clustering ratios), the wall seconds of its stages (encode, noise,
   scores, FDR or linkage), the peak device memory, the modelled SpecPCM
   chip's latency and energy (``core/imc/energy.py``, not this card's),
   and the ``imc_mvm`` launches: counts set to 0 just before each run and
   read just after; the analog paths must launch the kernel and none may
   call its plain version. The scores of the first 32 queries of the
   first chunk on the first 65,536 rows of each side, and of the last 32
   queries of the last chunk on the last 65,536 rows, must equal the
   plain version bit for bit from the same noisy weights; so must the
   clustering bucket's first and last 32 rows of scores (all 10,624
   columns) and the ISA's MVM on the first 65,536 rows of its state
   (which must also equal ``core.imc.array.imc_mvm`` of that state);
   every score must be finite;
   the analog route must identify at least 90% of the ideal route's
   count (Fig. 10). ``imc_mvm`` is timed at both pipeline shapes beside
   one float32 ``torch.matmul`` over the same operands (TF32 off), its
   bound and its design's bound (``csrc/imc_mvm.cu``'s header).
4. Serving at iPRG2012 scale (no tuning table active): ``repro_torch.launch.serve_db.main`` four
   times, ``--fused`` (the ``topk_hamming`` kernel), ``--fused-e2e``
   (``encode_search``), ``--oms --fused`` (``topk_hamming_banded``) and
   ``--oms --fused-e2e`` (``encode_search_banded``; the OMS runs at the
   launcher's default window, ``query - ref`` in (-20, +200)), each on a
   bank of 1,162,392 rows (581,196 targets = 145,299 identities x 4, and
   as many m/z-reversed decoys) at D = 8192, 1024 bins, 16 levels,
   k = 4. Kernel launch counts are set to 0 just before each run and read
   just after; a kernel of the run's path that was never launched fails
   the run. Each run prints how its serving span splits into the traffic
   generator's sleeps, the device's searches (CUDA events around each
   batch's search) and host work; the OMS runs also their candidate and
   scanned fractions. A served batch of 32, recorded by a
   ``SearchExecutor`` subclass handed to the launcher, is held against
   the plain route on the card (for OMS, the unfused masked route); then
   each kernel is timed with CUDA events on that batch and bank (and, at
   each smaller served bucket, on evenly spaced rows of it) beside its
   plain version and its bound, beside an estimate printed for its design
   (the exact kernels at Q = 32: the tensor-core scan's +-1 expansion on
   the integer lanes alone; the banded kernels: the POPC pipe's floor);
   the encode kernel that ``encode_search`` and ``encode_search_banded``
   run first is also timed alone, by bucket. The OMS runs print the rows
   the banded design reads (each 32-row tile a band meets, once per query
   group; checked against the distinct band rows) and time the banded
   kernel at each value of its ``waves`` knob at every bucket.
   Then continuous serving with streaming ingestion, on the same bank
   (5% of it, 29,059 refs and as many decoys, held out and appended as
   58,118 unpacked int8 rows halfway through each run), each kernel count
   set to 0 just before a run and read just after:
   ``--fused --continuous --num-slots 2 --append 0.05`` (``topk_hamming``
   on the base and, merged, on the int8 delta) and ``--oms --fused
   --fused-e2e --continuous --num-slots 2 --append 0.05``
   (``encode_search_banded`` before the append; after it the staged
   encode, then ``topk_hamming_banded`` on the packed base and on the
   delta). Each prints q/s, p50 / p95, the device's busy seconds and idle
   share and how many admissions found another batch still in flight
   (counted by a recording executor) beside the flush-sync run of its
   route in the same call. A pre-append batch of 32 is held against the
   plain route on its bank; tenant0 is then compacted through the
   server's registry (timed, with the peak device memory), and the first
   merged batch of 32 must equal the plain route (exact) or the unfused
   masked route (OMS) on the compacted bank, and the kernel on it. The
   delta scan alone is timed beside its plain version and bound, the
   host's merged OMS plan beside the base plan. One dispatch of each route
   (merged exact, encoded with query-HV cache misses, fused-e2e, merged
   OMS, OMS fused-e2e, OMS encoded) runs under the sync debug mode
   "error" with fresh queries: it must make no host synchronization and
   launch the route's kernels (the merged routes once on the base and
   once on the delta).
5. Clustering serving: ``repro_torch.launch.serve_cluster.main`` with two
   tenants, each streaming one paper-average precursor bucket (10,624
   spectra = 1,328 identities x 8) at D = 2048, 1024 bins, 16 levels,
   threshold 0.36 D, max batch 32, consolidation every 2,048 spectra.
   The ``hamming_pop`` count is set to 0 just before the run and read
   just after. The run's batches, recorded by a ``SearchExecutor``
   subclass, are replayed through clusterers whose distance step is the
   plain version, on the card: every assignment (cluster id, spawn flag,
   distance) and each tenant's summary must be equal. Then
   ``hamming_pop`` is timed at the served shape (each bucket against the
   largest final centroid bank) beside its plain version, one served
   distance step and ``torch._int_mm`` on the unpacked operands. Then
   the same streams through ``serve_cluster --continuous --num-slots 2``
   (a batch scores the centroids of its dispatch, as the reference's
   continuous mode does): the run's dispatches and finalizes are logged
   in order and replayed in that interleaving through clusterers on the
   plain distance function; every dispatch's snapshot (clusters,
   structure version) and every assignment must be equal, and one
   clustering dispatch must make no host synchronization.
6. One bucket batch-wise: the kernel's pairwise distances over 10,624
   encoded spectra and complete linkage at 0.36 D must give the labels,
   merges and cluster count of the same pipeline over the plain distance
   function, and the pairwise distances must equal the plain version's;
   prints the pairwise kernel's time, bound, plain and ``torch._int_mm``
   times and the linkage's seconds.
7. LM decode serving: ``repro_torch.launch.serve.main`` on Qwen2-7B at full
   width and depth (bfloat16, the port's seeded parameters) with the int8
   KV store (``--kv-quant``), batch 32, a 1,024-token prompt from the
   token pipeline, 64 greedy tokens. The ``decode_attention`` count is set
   to 0 just before and must read 28 layers x 63 steps after, with the
   plain version called 0 times; one decode step must run under the
   sync debug mode "error" (no host synchronization). A teacher-forced replay of the same
   decode with the plain attention on the card must agree: per step,
   max |logits difference| at most 2**-4 of the largest |logit|, and every
   differing greedy token a near tie. Prints prefill seconds, decode
   ms/step p50/p95, tokens/s, the device's share of a step (kernel time
   from ``torch.profiler`` over three steps against the served p50) and
   its largest kernels, the device operations of one step (one
   ``decode_attention`` kernel a layer, checked) and the kernel's split
   count, peak memory,
   the kernel at valid_len 1,025 and 1,088 beside its bound, its plain
   version and one ``scaled_dot_product_attention`` call over the
   dequantized cache, the kernel at other split counts, and the per-step
   weight-read bound.
7b. LM decode serving of the other decoder-only configs:
   ``repro_torch.launch.serve.main`` on ``gemma_7b``, ``granite_20b``,
   ``granite_34b`` and ``deepseek_moe_16b`` at full width and depth and on
   ``llama4_scout_17b_a16e`` at full width with 14 of its 48 layers (its
   bfloat16 weights would not fit the card: a ``reduced:`` line says so),
   bfloat16, the int8 KV store, batch 32, a 512-token prompt, 16 greedy
   tokens; one model at a time, freed before the next. Each must launch
   ``decode_attention`` layers x 15 times (the plain version 0 times),
   give tokens in range and finite logits, agree with a teacher-forced
   replay on the plain attention as phase 7 does, and run one decode step
   under the sync debug mode "error". For the MoE configs the routing
   (experts and kept mask, per layer and token) is recorded in the
   served run and in the replay: at most 1% of the (step, layer, token)
   decisions may differ, and the logits are held only on steps whose
   routing is identical in every layer. Prints prefill seconds, decode
   ms/step p50 / p95, tokens/s, peak memory and the routing counts.
8. LM training: Qwen2-7B at full width with its depth cut to 2 of 28
   layers (4 until PR 27, whose phase 9 needed the time; float32 master
   weights, gradients and AdamW moments), through
   ``build_model`` -> ``init_train_state`` -> ``make_train_step`` ->
   ``TokenPipeline.get_for``: batch 8 x 512 tokens, remat "full", three
   exact steps, then three with ``imc_linear`` (every FFN
   down-projection through ``_imc_linear`` on the ``imc_mvm`` kernel).
   After the timed steps of each, one more step runs under
   ``torch.profiler`` (the device's milliseconds by kernel: the
   ``imc_mvm`` kernels, matmuls, the rest). Every loss and grad_norm must
   be finite; the ``imc_mvm`` count is set to 0 just before the IMC steps
   and must read 2 layers x 4 steps after (remat recomputes each block in
   backward, but stops after the exact product, before the kernel), with
   the plain version called 0 times. One layer's kernel operands at the
   training shape (Q 4,096, R 3,584, Dp 18,944), kept by a recorder in an
   evaluation forward, must give the plain version's output bit for bit
   (computed 256 queries at a time). A ``CheckpointManager`` save of the
   trained state into a temporary directory, restored into a state of
   another draw, must equal it leaf for leaf and bit for bit. Prints the
   step ms (CUDA events) and tokens/s of both, the peak memory, the
   kernel's launches a step, its ms at the training shape beside its
   bound and a float32 ``torch.matmul`` of the same operands, the
   IMC-over-exact loss gap on one batch, and the checkpoint's size and
   seconds.
8b. Training the other families: ``deepseek_moe_16b`` at full width
   with 4 of its 28 layers (~2.77 G float32 parameters, ~44 GB of state),
   batch 8 x 512, remat "full", three timed exact steps and one profiled
   (device milliseconds in matmuls, the index kernels of the MoE's
   routing, dispatch and combine, and the rest); then ``granite_20b`` at full width with
   4 of its 52 layers and ``imc_linear``, one timed and one profiled step:
   ``imc_mvm`` must launch 4 times a step (the plain version never), and
   one launch at the training shape (Q 4,096, R 6,144, Dp 24,576), kept
   by a recorder in an evaluation forward, must equal the plain version
   bit for bit on its first and last 256 query rows; it is timed beside
   a float32 ``torch.matmul`` and its bound. Losses and grad norms must
   be finite. Prints the step ms, tokens/s and peak memory of each.
7c. The recurrent families: ``repro_torch.launch.serve.main`` on
   ``hymba_1_5b`` (attention and Mamba heads side by side, the int8 KV
   store) and ``xlstm_125m`` (mLSTM blocks, an sLSTM every fourth) at
   published width and full depth, bfloat16, batch 32, a 512-token
   prompt, 16 greedy tokens. Hymba must launch ``decode_attention`` 32
   layers x 15 times, xLSTM (no attention; ``--kv-quant`` changes
   nothing) 0 times, the plain version 0 times. A teacher-forced replay
   must reproduce each served run's logits exactly; in Hymba's, every
   attention call also runs the plain version on the same inputs, within
   rtol / atol 2e-4 (a free-running replay on the plain attention is
   printed, not held: bfloat16 rounding, amplified through the
   random-weight layers, moves it past 2^-4); one decode step runs under
   the sync debug mode "error".
   The state carry: a float32 copy of each model (8 of the rows) decodes
   the same way, and each step's logits are held against
   ``forward_train`` of the prompt and the generated tokens at that
   position within 2^-4 (the served bfloat16 run's share is printed, not
   held, for the same reason; CARRY_BATCH's comment). Then Hymba's ring
   run, 8 of its 32 layers (cut for the time limit since phase 10b
   joined it), batch 4 x (2,048 + 64): the decode wraps the 2,048-slot window at position 2,048, a
   replay runs the kernel and its plain version on the same inputs at
   every layer of every wrapped step (``valid_len`` 2,048), within rtol /
   atol 2e-4, and a float32 copy of the run is held against
   ``forward_train`` as above. Prints prefill
   seconds, decode ms/step p50 / p95, tokens/s, peak memory, the weights'
   and states' bytes and the weight-read bound.
8c. Training the recurrent families at published width, batch 8 x 512,
   remat "full", AdamW, three timed steps and one profiled:
   ``xlstm_125m`` exact at full depth, then ``hymba_1_5b`` (4 of its 32
   layers since phase 10b joined the time limit, 8 before) exact and, on the same state, with ``imc_linear``:
   ``imc_mvm`` must launch once a layer a step, never for xLSTM, the
   plain version never, and
   one launch at Hymba's training shape (Q 4,096, R 1,600, Dp 5,504)
   must equal the plain version bit for bit on its first and last 256
   query rows. Prints step ms, tokens/s, the device's milliseconds by
   group and peak memory.

7d. The encoder-decoder and VLM families: ``repro_torch.launch.serve.main``
   on ``whisper_medium`` at published width and full depth (24 encoder
   and 24 decoder layers; 256 frame embeddings from the stub frontend and
   256 tokens) and ``internvl2_76b`` at published width with 32 of its 80
   layers (64 patch embeddings and 448 tokens; a ``reduced:`` line says
   why), bfloat16, the int8 KV store, batch 32, 16 greedy tokens. Each
   must launch ``decode_attention`` decoder layers x 15 times (360 and
   480), the plain version 0 times. A teacher-forced replay on the kernel
   must reproduce the served logits exactly, each of its attention calls
   within rtol / atol 2e-4 of the plain version on the same inputs; a
   free-running plain replay's share of the max logit is printed; one
   decode step runs under the sync debug mode "error". Whisper's cross
   K/V must be kept at the memory's 256 rows, and a float32 copy of it
   (8 of the rows) must match ``forward_train`` over its encoded frames
   and the prompt and generated tokens at every decode position within
   2^-4 of the max logit (ROADMAP F4). Prints prefill seconds, decode
   ms/step p50 / p95, tokens/s, the weights' and a decode step's bytes
   and read bounds, the cross K/V's bytes, peak memory, and the kernel
   at the last step's valid_len on a served cache beside its plain
   version and bound.
8d. Training them: batch 8 x 512, remat "full", three timed steps and
   one profiled: ``whisper_medium`` at full depth exact, then on the same
   state with ``imc_linear``: ``imc_mvm`` must launch 48 times a step
   (its 24 encoder and 24 decoder FFN down-projections), the plain
   version never, and one launch at the training shape (Q 2,048, R
   1,024, Dp 4,096) must equal the plain version bit for bit on its first
   and last 256 query rows; it is timed beside a float32 ``torch.matmul``
   and its bound. Then ``internvl2_76b`` at published width with 1 of
   its 80 layers, exact (a ``reduced:`` line says why). Losses and grad
   norms must be finite. Prints step ms, tokens/s, the device's
   milliseconds by group and peak memory.
8e. The hierarchical DCN gradient reduction: Qwen2-7B at published width
   (2 of its 28 layers, for the time limit; a ``reduced:`` line says
   why), batch 8 x 512 in 2 pod
   slices on the emulated route, remat "full", ``imc_linear``, with
   ``dcn_compression`` none, int8, topk and topk_ef at a top-k fraction
   of 0.01, three timed steps and one profiled each. ``imc_mvm`` must
   launch once a layer a pod a step, the plain version never; losses and
   grad norms must be finite; ``none`` runs beside one step of
   ``microbatches=2`` from the same draw (the largest parameter
   difference is printed: bit identity is held on the CPU). On pod 0's
   gradients (the reference's leaves: a stacked layer leaf whole) one
   ``dcn_send`` of the whole tree is timed; int8's codes must lie in
   [-127, 127] within one scale step of every leaf; ``topk_ef``'s
   ``sent + new residual == grads + old residual`` bit for bit on every
   leaf, the embedding's top-k mask (545 M elements) must equal the
   CPU's on a host copy, and ``dcn_allreduce_tree`` (every method) and
   ``cross_pod_allreduce`` on a 1-rank NCCL group (a ``file://`` store)
   must equal the emulated route leaf by leaf. One ``imc_mvm`` launch at
   the per-pod shape (Q 2,048, R 3,584, Dp 18,944) must equal the plain
   version bit for bit on its first and last 256 query rows. Prints step
   ms, tokens/s, peak memory, the DCN bytes over the raw bytes, the
   device's milliseconds by group and ``imc_mvm`` launches a step.
9. DB search over a device mesh: ``serve_db`` on a 1-rank NCCL group
   (``make_debug_mesh`` gives the (1, 1) mesh and the local route; 4,096
   x 4 references), then 2 and then 4 processes sharing the one card in a
   gloo group (NCCL refuses two ranks on one card; gloo stages each
   collective through the host), each rank serving phase 4's four routes
   at the iPRG2012 scale over the (1, n) debug mesh with its own block of
   the bank on the card (the kernels were built in this process first).
   Every served request must equal phase 4's one-process run of the same
   stream (indices, scores, has_candidate), every rank's results rank
   0's, and the FDR accept masks and matches a replay of the mesh run's
   batches on the one-process scores; each rank must launch the route's
   kernel. Prints q/s and p50 / p95, the kernel a shard alone on the card
   (the ranks take turns), the gather + merge of its candidates and the
   whole route (all ranks together, host clock), each rank's block and
   peak memory, and the kernels' launches; then ``ring_matmul_reduce``
   and ``ag_matmul_pipelined`` at 2,048 x 4,096 x 4,096 float32 on the
   ranks, bit for bit against their ring-order replays and within 1e-5 of
   one ``x @ w`` (relative to its largest entry). Inside the same rank
   processes, ``--fused`` and ``--oms --fused --fused-e2e`` again with
   ``--continuous --num-slots 2 --append 0.05`` (rank 0 plans each step:
   ``serve.scheduler.CoordinatedScheduler``): every rank's batches and
   results rank 0's; every request equal, bit for bit, to rank 0's replay
   of the recorded batches (the append before the same batch) through a
   one-process continuous server on the card; the requests of the merged
   batches equal to phase 4's one-process run (indices, scores,
   has_candidate) and their FDR masks and matches to a replay of those
   batches on the one-process scores; each rank must launch the route's
   kernel. Prints q/s, p50 / p95, the batches, the plan exchanges and the
   admissions that found another batch in flight (counted by this
   script's recorder). These are processes sharing one card, not a
   multi-card deployment.
10. The dense LM over a device mesh: Qwen2-7B served (full width, 4 of
   its 28 layers since phase 10b joined the time limit, the int8 KV
   store, 32 x (512 + 16)) and trained (full width, 2
   layers, 8 x 512, remat "full", ``imc_linear``, 2 steps) in this
   process, then by 2 and 4 processes sharing the card in a gloo group:
   serving on (1, 2) and (1, 4) with the one-process tokens forced into
   the decode steps, every step's whole logits within 2^-4 of its largest
   against the one-process run's, ``decode_attention`` launched 4 x 15
   times on every rank and held against its plain version at the rank's
   cache shape; training on (2, 1), (1, 2) and (2, 2), each loss within
   rtol 1e-3 of the one-process run's, ``imc_mvm`` launched once a layer
   a step on every rank and held bit for bit against its plain version on
   the rank's ff shard; the (2, 2) state saved and restored on (1, 4),
   every rank's blocks as the files hold them. Prints prefill s, decode
   p50 / p95 ms, tokens/s, step ms, each rank's peak memory and the gloo
   collectives' count and host ms a step. In the same rank processes,
   ``granite_20b`` (full width, 1 kv head, 4 of its 52 layers, the int8
   KV store, 8 x (2,048 + 16)) served with its caches' slots striped over
   ``model`` (``kv_seq``) on (1, 2) and (1, 4) (1,032 and 516 slots a
   rank): the prefill's and every decode step's whole logits within 2^-4
   of its largest against this process's whole-cache run, whose tokens
   are forced, ``decode_attention_partial`` launched 4 x 15 times on every
   rank and held against its plain version on the rank's block (output
   and log-sum-exp, a mid-block count and an empty block), each rank's
   cache bytes a 1 / ranks share of the whole cache's. Then
   ``launch.train`` and ``launch.serve`` on a 1-rank NCCL group ((1, 1)
   ``DeviceMesh``, the parameters DTensors, both kernels launched).
10b. The MoE (expert-parallel), encoder-decoder and VLM families over the
   same rank processes, each beside the same run in this process:
   ``deepseek_moe_16b`` served at full width with 8 of its 28 layers
   (full depth until phase 10c joined the time limit) on (1, 2) (32
   experts and 8 kv heads a rank; this process's routes forced, so the
   logits answer for the kernel and the sharding, and the decisions the
   mesh made itself are counted), decoded one step with 2 layers on (2, 1)
   (a step's 32 tokens are one MoE group, routed whole by every rank) and
   trained with 1 layer on (2, 2); ``whisper_medium`` served at full
   width with 12 of its 24 decoder layers (and all 24 encoder layers) and
   trained with 2 encoder and 2 decoder layers (``imc_linear`` on whole
   128-column ``ff`` tiles a rank) on (1, 2); ``internvl2_76b`` served
   at full width with 2 of its 80 layers on (1, 4) (these cuts since
   phase 10c joined the time limit). Serving: every decode step's whole logits within 2^-4 of its
   largest, ``decode_attention`` launched layers x steps times on every
   rank and held against its plain version at the rank's cache block;
   training: each loss within rtol 2e-3 of this process's, ``imc_mvm``
   launched once an FFN a step on every rank and bit for bit against its
   plain version on the rank's shard. Prints the same quantities as
   phase 10 and the share of MoE routing decisions that differ.
10c. The recurrent (xLSTM) and hybrid (Hymba) families over the same rank
   processes (or, with ``--only 10c``, spawns of its own), each beside the
   same run in this process: ``xlstm_125m`` served at full width and
   depth on (1, 2), (2, 1) and (1, 4) (its 4 mLSTM heads split over
   ``model``), ``hymba_1_5b`` served at full width and depth on (1, 2)
   (25 heads over 5 kv heads: replicated over ``model``), both as float32
   copies at 32 x (512 + 16): every decode step's whole logits within
   2^-4 of its largest, and every ``decode_attention`` launch of Hymba on
   every rank held against its plain version (rtol / atol 2e-4);
   ``hymba_1_5b`` trained at full width with 4 of its 32 layers and
   ``imc_linear`` on (2, 2) (each loss within rtol 2e-3, ``imc_mvm``
   launched once a layer a step on every rank, on ``ff`` gathered, and bit
   for bit against its plain version on the first and last 256 rows of a
   launch); then the DCN process-group route over a model sharded within
   each pod: ``xlstm_125m`` (float32) on a (pod 2, data 1, model 2) mesh
   of 4 processes, two steps with ``dcn_compression`` ``none`` and two
   with ``topk_ef``, beside the emulated route in this process (the
   first loss within rtol 1e-5, the DCN bytes equal; for ``none`` the
   later losses within DCN_MESH_LOSS_RTOL and the parameters within 2
   applied learning rates a step and a mean of DCN_MESH_MEAN_LR of them,
   limits that a control, the same run with one pod's sends dropped,
   must exceed) and, for ``none``, beside the emulated route run by each
   pod's own (data, model) ranks (losses and every parameter equal);
   ``topk_ef``'s ``sent + new residual == grads + old residual`` on every
   leaf of every rank and step, the second with a non-zero old residual,
   and its residual rows (1, ...). Prints prefill s, decode p50 / p95,
   tokens/s, step ms, each rank's peak memory and the gloo collectives,
   and the phase's seconds.

It then prints one ``{"kernels": [...]}`` line and, last, one
``{"ok": true, "device": {...}}`` line. It exits non-zero where
``torch.cuda.is_available()`` is False, and where ``src/repro_torch`` is
missing beside it.

    python3 chip_smoke.py --only 7c,8c

runs the build and the named phases alone (7c, 8c, 7d, 8d, 8e, 9, 10
with 10b, 10c;
9 alone first serves phase 4's four routes in one process), printing
their lines and no kernels or ``ok`` line: a quick check of one slice on
the card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# iPRG2012 (core/imc/energy.py): 145,299 identities x 4 replicates; its
# 15,867 queries are cut to 4,096 per run for the time limit
IDENTITIES = 145_299
REPLICATES = 4
QUERIES = 4096
IPRG_QUERIES = 15_867
DIM, K, MAX_BATCH = 8192, 4, 32

# H100 SXM published peaks (dense, 700 W): 3.35 TB/s HBM3, 1,979 TOP/s
# int8 on the tensor cores and 67 TFLOP/s float32 outside them. POPC
# issues 16 per clock per SM (a quarter of the 64-wide integer pipe): the
# floor of the banded kernels' design (and of the exact kernels' 8-query
# blocks). The exact kernels' tensor-core scan also spends its +-1
# expansion on the 64 integer lanes per clock per SM (NVIDIA's sm_90
# throughput table for 32-bit integer multiply-add, AND and shift).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_OPS_PER_S = 67e12
POPC_PER_CLOCK_PER_SM = 16
INT_LANES_PER_CLOCK_PER_SM = 64

TPU_KERNELS = {
    "topk_hamming": "src/repro/kernels/topk_hamming/topk_hamming.py:85",
    "encode_search": "src/repro/kernels/encode_search/encode_search.py:78",
    "topk_hamming_banded":
        "src/repro/kernels/topk_hamming/topk_hamming.py:165",
    "encode_search_banded":
        "src/repro/kernels/encode_search/encode_search.py:176",
    "hamming_pop": "src/repro/kernels/hamming_pop/hamming_pop.py:20",
    "hd_encode": "src/repro/kernels/hd_encode/hd_encode.py:60",
    "imc_mvm": "src/repro/kernels/imc_mvm/imc_mvm.py:24",
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:23",
}
# iPRG2012's OMS candidate fraction (core/imc/energy.py DATASETS)
IPRG_CANDIDATE_FRACTION = 0.025


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def phase_build(build):
    t0 = time.perf_counter()
    paths = build.build()
    secs = time.perf_counter() - t0
    print(f"build: {len(paths)} kernels in {secs:.2f} s "
          f"({', '.join(p.name for p in paths.values())})")
    for name in paths:
        regs = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        spills = sum("0 bytes spill stores" not in ln for ln in regs
                     if "spill" in ln)
        print(f"build: {name}: {len(regs) // 2} entry points, "
              f"{spills} with spills; "
              f"{'; '.join(r for r in regs if 'registers' in r)[:400]}")
    print(nvidia_smi("name,power.limit"))


# phase 2 cases: (Q, R, D, packed, k, num_valid, duplicate rows, plan);
# plan None takes the wrappers' launch plan, (block_q, None) the wrappers'
# plan for that query block (a packed bank's 16- and 32-query blocks score
# on the tensor cores, its 8-query blocks on the POPC scan), else (queries
# a block, rows a split) is launched as given. Packed cases with
# D % 32 != 0 hold random words, padding bits included (topk_hamming
# only: an encoded packed bank holds whole 32-dim words)
EDGE_CASES = [
    (32, 3000, 8192, True, 4, None, False, None),
    (5, 1000, 256, True, 7, 600, False, None),  # ragged Q; num_valid in a
                                                # tile
    (5, 1000, 256, True, 7, 600, False, (16, None)),  # on the tensor cores:
                                                      # R off the 64- and
                                                      # 256-row steps,
                                                      # num_valid in a step
    (40, 517, 64, True, 20, 9, False, None),    # k > num_valid
    (3, 37, 32, True, 37, None, False, None),   # k = R
    (3, 37, 32, True, 37, None, False, (16, None)),   # k = R, tensor cores
    (17, 300, 96, True, 9, None, True, None),   # duplicate rows 100 apart:
                                                # ties across warpgroups
    (32, 2000, 1000, False, 4, None, False, None),  # int8 at D = 1000
    (9, 129, 1000, False, 129, 77, True, None),     # int8, k = R, ties, masked
    (1, 1000, 8192, True, 4, 999, False, None),     # Q = 1
    (1, 1000, 8192, True, 4, 999, False, (16, None)),  # Q = 1, tensor cores
    (4, 777, 256, True, 5, None, False, None),      # Q = 4: 8-query block
    (33, 700, 256, True, 6, 650, False, None),      # two query blocks
    (16, 3000, 256, True, 5, 2900, False, (16, 100)),  # splits end inside
                                                       # warpgroups' rows
    (32, 1500, 256, True, 4, 1234, True, (32, 320)),   # splits end between
                                                       # warpgroups; ties
    (7, 300, 20, True, 6, None, False, None),       # W = 1, dim 20
    (7, 300, 20, True, 6, None, False, (16, None)),  # the same, tensor cores
    (9, 500, 70, True, 5, None, True, None),        # W = 3, dim 70, ties
    (12, 400, 2070, True, 4, 333, False, None),     # W = 65, dim 2070
    (8, 300, 64, True, 300, None, False, (8, 64)),  # k = R over 5 splits
    (16, 300, 64, True, 300, None, False, (16, 64)),  # the same, tensor cores
]


# banded cases: (Q, R, D, packed, k, num_valid, duplicate rows, bands,
# tile budget); "plan" bands and budget come from plan_candidates over
# sorted precursors, as the OMS server makes them
BANDED_EDGE_CASES = [
    (32, 3000, 8192, True, 4, None, False, "wide", None),   # crosses blocks
    (5, 1000, 256, True, 7, 600, False, "random", None),    # ragged, past nv
    (40, 517, 64, True, 20, 9, False, "random", 1),         # k > num_valid
    (16, 400, 96, True, 9, None, True, "narrow", None),     # ties, < k, empty
    (16, 5000, 256, True, 4, None, False, "far_apart", 8),  # both bank ends
    (24, 2000, 256, True, 5, 1900, False, "two", None),     # two bands
    (32, 6000, 256, True, 4, None, False, "plan", "plan"),  # tight budget
    (32, 2000, 1000, False, 4, None, False, "wide", None),  # int8 at D = 1000
    (9, 129, 1000, False, 129, 77, True, "two", None),      # int8, k = R, ties
    (1, 3000, 256, True, 4, None, False, "wide", None),     # Q = 1
    (7, 2000, 256, True, 1, None, False, "random", None),   # Q = 7, k = 1
    (33, 3000, 256, True, 5, 2500, False, "wide", None),    # two query groups,
                                                            # num_valid in bands
    (70, 4000, 256, True, 4, None, False, "two", None),     # three groups
    (12, 300, 64, True, 4, None, False, "empty", None),     # every band empty
    (9, 1500, 256, True, 6, None, False, "whole", 2),       # one band = bank
    (16, 500, 1000, False, 8, None, False, "one_row", None),  # int8; bands
                                                              # meeting a tile
                                                              # in one row
    (3, 4000, 256, True, "max", None, False, "wide", None),   # the largest k
                                                              # that fits
    (24, 3000, 256, True, 6, None, False, "overlap", None),   # two bands
    (40, 2000, 1000, False, 5, 1800, False, "overlap", None),  # overlapping
                                                               # or nested,
                                                               # either order
]


def banded_k_max(wpr: int, bands: int, limit: int) -> int:
    """The largest k of a one-query banded block and of the split merge."""
    from repro_torch.kernels.topk_hamming.ops import MERGE_WARPS, banded_smem
    fixed = banded_smem(1, wpr, bands, 0)
    return min((limit - fixed) // 8, limit // (8 * MERGE_WARPS))


def banded_case(np, rng, Q, R, kind, num_tiles):
    """(starts, lens, tile budget) of one banded edge case: (Q,) arrays for
    one band, (2, Q) for two."""
    if kind == "random":        # empty, narrow and wide, some past R
        starts, lens = rng.integers(-3, R + 1, Q), rng.integers(0, R // 2, Q)
    elif kind == "narrow":      # narrower than k, some empty
        starts, lens = rng.integers(0, R - 3, Q), rng.integers(0, 3, Q)
    elif kind == "far_apart":   # inside each 8-query block, both bank ends
        starts = np.where(np.arange(Q) % 2 == 0, 5, R - 700)
        lens = np.full(Q, 600)
    elif kind == "wide":        # many tiles each
        starts, lens = rng.integers(0, 200, Q), rng.integers(R // 2, R, Q)
    elif kind == "empty":       # every band empty
        starts, lens = rng.integers(0, R, Q), np.zeros(Q, np.int64)
    elif kind == "whole":       # query 0's band is the whole bank
        starts, lens = rng.integers(0, R // 2, Q), rng.integers(0, R // 4, Q)
        starts[0], lens[0] = 0, R
    elif kind == "one_row":     # bands meeting a 32-row tile in one row
        t = rng.integers(1, R // 32 - 1, Q) * 32  # tiles start at row 0:
        starts = np.where(np.arange(Q) % 2 == 0, t - 1, t + 31)
        lens = np.where(np.arange(Q) % 3 == 0, 1, 2)
        starts[0], lens[0] = 0, 1                 # the window starts there
    elif kind == "overlap":     # overlapping, nested or out of order; a
        # later band starting at row 0 (ROADMAP.md Queue 3, F5)
        s0 = rng.integers(0, R // 2, Q)
        s1 = np.clip(s0 + rng.integers(-R // 8, R // 4, Q), 0, R - 1)
        starts = np.stack([s0, s1])
        lens = rng.integers(0, R // 3, (2, Q))
        swap = rng.random(Q) < 0.5
        starts[:, swap], lens[:, swap] = starts[::-1, swap], lens[::-1, swap]
        starts[1, rng.random(Q) < 0.2] = 0
    elif kind == "two":
        s0, s1 = rng.integers(0, R // 3, Q), rng.integers(R // 2, R - 10, Q)
        starts = np.stack([s0, s1])
        lens = np.stack([rng.integers(0, R // 4, Q),
                         np.minimum(rng.integers(0, R, Q), R - s1)])
    else:                       # "plan": decoy and target blocks
        from repro_torch.serve.oms import (
            OMSConfig,
            build_precursor_index,
            plan_candidates,
        )
        index = build_precursor_index(
            rng.uniform(400, 1600, R // 2), rng.uniform(400, 1600, R // 2))
        plan = plan_candidates(index, np.sort(rng.uniform(400, 1700, Q)),
                               OMSConfig(), num_rows_padded=R, block_q=8)
        starts, lens, num_tiles = plan.starts, plan.lens, plan.num_tiles
    return starts.astype(np.int32), lens.astype(np.int32), num_tiles


# hamming_pop cases: (Q, R, W, layout); ragged Q and R against the
# 128 x 128 block, Q or R under one 16 x 8 fragment, W = 1, 3, 65 and
# 130 (off every 8-word chunk), W % 4 != 0, rows off a 16-byte boundary,
# all-zero and all-ones words, dim < 32 W with random padding bits, q = r
# (the pairwise shape), and the served buckets against grown centroid banks
HAMMING_EDGE_CASES = [
    (1, 1, 1, "random"), (1, 1000, 64, "random"), (70, 130, 3, "random"),
    (65, 64, 64, "random"), (33, 200, 2, "random"), (40, 77, 64, "offset"),
    (5, 300, 64, "zeros_ones"), (500, 500, 64, "same"),
    (3, 5, 64, "random"), (50, 6, 65, "random"), (40, 300, 65, "random"),
    (129, 90, 130, "offset"), (33, 200, 64, "pad_bits"),
    (130, 129, 3, "pad_bits"), (2048, 2048, 64, "same"),
] + [(q, c, 64, "random") for q in (4, 8, 16, 32) for c in (1000, 3000)]


def hamming_dim(W: int, layout: str) -> int:
    """The case's dim: 32 W, or 13 fewer bits with the padding bits left
    random ("pad_bits")."""
    return 32 * W - (13 if layout == "pad_bits" else 0)


# hd_encode cases: (B, F, D, m, layout, block_b, block_d): ragged B, F and
# D, all-absent rows, sign ties (two present bins), levels past m - 1, and
# several launch shapes
HD_ENCODE_EDGE_CASES = [
    (32, 1024, 8192, 16, "sparse", None, None),
    (5, 37, 100, 8, "past_m", None, None),
    (13, 300, 1000, 16, "sparse", 4, 256),
    (9, 64, 96, 4, "absent", 2, 32),
    (7, 2, 64, 4, "ties", 1, 8192),
]

# imc_mvm cases: (Q, R, Dp, weights, full_scale, tile_cols, block_q,
# block_r, adc_levels): noisy packed levels, integer weights, exact .5
# points of part / lsb (lsb = 2), saturated codes, ragged Q, R and Dp, a
# 64-column array, every compiled tile size along each axis, the
# double-rounding case (a partial of -2**-60 from a cancellation, then
# 3 * (1 + 2**-23), with lsb = 2**-22 so each float32 ulp of a partial is
# its own code), float weights at Dp = 2,731 (rows off 16-byte
# boundaries) with R odd, one ragged 43-column tile, and Q = 1 and 33
IMC_EDGE_CASES = [
    (32, 4000, 2731, "noisy", 135.7645, 128, None, None, 31),
    (9, 70, 300, "integer", 135.76, 128, 8, 32, 31),
    (17, 300, 257, "integer", 62.0, 128, 16, 64, 31),
    (8, 129, 128, "saturate", 31.0, 128, 32, 128, 31),
    (40, 515, 1000, "normal", 128.0, 64, 64, 256, 31),
    (4, 300, 300, "fma_tie", 4.0, 128, None, None, 2 ** 24),
    (32, 1003, 2731, "noisy", 135.7645, 128, None, None, 31),
    (32, 700, 43, "noisy", 135.7645, 128, None, None, 31),
    (1, 500, 300, "noisy", 135.7645, 128, None, None, 31),
    (33, 300, 2731, "noisy", 135.7645, 128, None, None, 31),
]


# decode_attention cases: (B, S, KV, G, hd, valid lengths): the
# reference's test shapes (tests/test_kernels.py), G = 1 at hd = 256
# (gemma), granite's MQA G = 48, llama4's G = 5 at hd 128 (last case),
# valid_len 1 / 70 of 128 / S, S off every chunk
# multiple, valid_len 0 (uniform weights), and the served shape at the
# first and last decode steps. Then the split edges of the split rule
# (decode_splits): valid_len at a split boundary - 1 / + 0 / + 1 (8
# splits of 125 at B 2, KV 2, S 1,000; 3 of 363 at the served shape),
# valid_len 1 with every later split empty, and S under one split; hd
# 48 and 96 (rows of 3 and 6 16-byte segments). Whisper's G = 1 at hd
# 64 and InternVL2's G = 8 at hd 128 (phase 7d) at their served shape
# (S = 528, one split on 132 SMs) and with fewer rows (5 splits of 106):
# valid_len at the boundary - 1 / + 0 / + 1. Tolerance rtol / atol
# 2e-4 (float32; the reference's own kernel-vs-oracle tolerance).
DECODE_EDGE_CASES = [
    (1, 128, 1, 4, 32, (128,)), (2, 256, 2, 8, 64, (256, 77)),
    (2, 96, 4, 7, 16, (96,)), (2, 300, 2, 1, 256, (300, 129)),
    (1, 200, 1, 48, 128, (200, 64)), (1, 128, 2, 4, 32, (1, 70, 128)),
    (3, 333, 2, 3, 64, (333, 65, 0)), (32, 1088, 4, 7, 128, (1025, 1088)),
    (2, 1000, 2, 7, 128, (124, 125, 126, 1, 0, 1000)),
    (32, 1088, 4, 7, 128, (362, 363, 364, 1)),
    (4, 100, 2, 7, 128, (1, 99, 100, 0)),
    (2, 150, 2, 5, 48, (150, 77)), (1, 100, 1, 12, 96, (100, 33)),
    (4, 600, 8, 5, 128, (600, 513, 1)),
    (32, 528, 16, 1, 64, (257, 271, 528)),
    (2, 528, 16, 1, 64, (105, 106, 107, 1)),
    (32, 528, 8, 8, 128, (513, 527, 528)),
    (4, 528, 8, 8, 128, (105, 106, 107, 1)),
]
DECODE_RTOL = DECODE_ATOL = 2e-4
# split counts forced on one shape (S = 300 takes each count asked)
DECODE_SPLITS = (1, 2, 7, 17)
DECODE_SPLIT_SHAPE = (2, 300, 2, 7, 128)


def decode_case(torch, np, B, S, KV, G, hd, seed=0):
    """(q, k8, v8, k_scale, v_scale) on the card for one decode case."""
    rng = np.random.default_rng(seed + B * S + G * hd)
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32) * hd ** -0.5
    k8 = rng.integers(-127, 128, (B, S, KV, hd), dtype=np.int8)
    v8 = rng.integers(-127, 128, (B, S, KV, hd), dtype=np.int8)
    ks = rng.uniform(0.005, 0.5, (B, S, KV)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, S, KV)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (q, k8, v8, ks, vs)]


def close_count(torch, got, want, rtol, atol) -> int:
    """Elements of ``got`` outside ``atol + rtol * |want|``, or not finite."""
    bad = (got - want).abs() > atol + rtol * want.abs()
    return int((bad | ~torch.isfinite(got)).sum())


def hd_encode_case(torch, np, B, F, D, m, layout):
    """(levels, id_hvs, level_hvs) on the card for one hd_encode case."""
    rng = np.random.default_rng(B * 1000 + F + D)
    idh = rng.choice([-1, 1], size=(F, D)).astype(np.int8)
    lvh = rng.choice([-1, 1], size=(m, D)).astype(np.int8)
    lev = rng.integers(0, m, size=(B, F))
    if layout == "sparse":
        lev[:, rng.random(F) < 0.9] = 0
    elif layout == "past_m":
        lev[:, :5] = m + 2
    elif layout == "absent":
        lev[::2] = 0
    elif layout == "ties":
        lev = rng.integers(1, m, size=(B, F))
    return (torch.from_numpy(lev.astype(np.int32)).cuda(),
            torch.from_numpy(idh).cuda(), torch.from_numpy(lvh).cuda())


def imc_case(torch, np, Q, R, Dp, kind):
    """(queries, weights) float32 on the card for one imc_mvm case."""
    rng = np.random.default_rng(Q * 1000 + R + Dp)
    if kind in ("integer", "saturate"):
        q = rng.integers(-4, 5, size=(Q, Dp)).astype(np.float32)
        w = rng.integers(-3, 4, size=(R, Dp)).astype(np.float32)
        if kind == "saturate":
            w = np.sign(q[:1]) * 3 + 0 * w
    elif kind in ("noisy", "fma_tie"):
        q = (2 * rng.binomial(3, 0.5, size=(Q, Dp)) - 3).astype(np.float32)
        w = (2 * rng.binomial(3, 0.5, size=(R, Dp)) - 3) * (
            1 + 0.1716 * rng.standard_normal((R, Dp)))
        if kind == "fma_tie":   # columns 0-2 of each tile, even rows
            w[::2] = 0
            for c0 in range(0, Dp - 2, 128):
                q[:, c0:c0 + 3] = [1, -1, 3]
                w[::2, c0:c0 + 3] = [2.0 ** -37, 2.0 ** -37 * (1 + 2.0 ** -23),
                                     1 + 2.0 ** -23]
            # scaled by powers of two, which keep the rounding structure
            w[::2] *= 2.0 ** -(np.arange(0, R, 2) % 4)[:, None]
    else:
        q = rng.standard_normal((Q, Dp)) * 2
        w = rng.standard_normal((R, Dp))
    return (torch.from_numpy(np.ascontiguousarray(q, np.float32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(w, np.float32)).cuda())


def hamming_case(torch, Q, R, W, layout):
    """(q, r) int32 word operands on the card for one hamming_pop case."""
    g = torch.Generator().manual_seed(Q * 1000 + R + W)

    def words(rows):
        flat = torch.randint(-2**31, 2**31, (rows * W + 1,), generator=g,
                             dtype=torch.int64).to(torch.int32).cuda()
        # "offset": rows start one word past a 16-byte boundary
        return (flat[1:] if layout == "offset" else flat[:-1]).view(rows, W)

    q, r = words(Q), words(R)
    if layout == "zeros_ones":
        q, r = torch.zeros_like(q), torch.full_like(r, -1)
    elif layout == "same":
        r = q
    return q, r


def phase_kernels_vs_plain(torch, np):
    from repro_torch.core.hd.similarity import INT32_MIN, bitpack_bipolar
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_partial_plain,
        decode_attention_plain,
    )
    from repro_torch.kernels.decode_attention.ops import _launch as launch_split
    from repro_torch.kernels.decode_attention.ops import split_plan
    from repro_torch.kernels.encode_search import (
        encode_search,
        encode_search_banded,
        encode_search_banded_plain,
        encode_search_plain,
    )
    from repro_torch.kernels.encode_search.ops import (
        encode_queries,
        encode_queries_plain,
        _launch_encode_search,
    )
    from repro_torch.kernels.hamming_pop import hamming_pop, hamming_pop_plain
    from repro_torch.kernels.hd_encode import hd_encode, hd_encode_plain
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.kernels.topk_hamming import (
        topk_hamming,
        topk_hamming_banded,
        topk_hamming_banded_plain,
        topk_hamming_plain,
    )
    from repro_torch.kernels.topk_hamming.ops import (
        _launch_exact,
        smem_limit,
        words_per_row,
    )
    dev = torch.device("cuda")

    def bank(rng, rows, d, packed, dup=False):
        if packed and d % 32:  # random words, padding bits included
            t = torch.from_numpy(rng.integers(
                0, 2**32, (rows, -(-d // 32)), dtype=np.uint32).view(
                    np.int32)).to(dev)
            return torch.cat([t, t, t]) if dup else t
        hv = rng.choice([-1, 1], size=(rows, d)).astype(np.int8)
        if dup:
            hv = np.concatenate([hv, hv, hv])
        t = torch.from_numpy(hv).to(dev)
        return bitpack_bipolar(t) if packed else t

    def codebooks(rng, Q, D):
        F, m = 300, 16
        idh = torch.from_numpy(rng.choice([-1, 1], size=(F, D)).astype(
            np.int8)).to(dev)
        lvh = torch.from_numpy(rng.choice([-1, 1], size=(m, D)).astype(
            np.int8)).to(dev)
        lev = rng.integers(0, m, size=(Q, F))
        lev[:, rng.random(F) < 0.7] = 0
        lev[0] = 0
        lev[-1, :3] = m + 2   # past the codebook: LV[m - 1]
        return torch.from_numpy(lev.astype(np.int32)).to(dev), idh, lvh

    def diff(got, want):
        return int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())

    mismatches = dict.fromkeys(TPU_KERNELS, 0)
    for Q, R, D, packed, k, nv, dup, plan in EDGE_CASES:
        rng = np.random.default_rng(Q * 1000 + R + D)
        r = bank(rng, R // 3 if dup else R, D, packed, dup)
        q = bank(rng, Q, D, packed)
        bq, rows = plan or (None, None)
        got = (topk_hamming(q, r, dim=D, k=k, num_valid=nv, block_q=bq)
               if rows is None else _launch_exact(
                   q, r, dim=D, k=k, num_valid=nv, bq=bq,
                   rows_per_split=rows))
        mismatches["topk_hamming"] += diff(
            got, topk_hamming_plain(q, r, dim=D, k=k, num_valid=nv))
        if packed and D % 32:
            continue
        lev, idh, lvh = codebooks(rng, Q, D)
        got = (encode_search(lev, idh, lvh, r, dim=D, k=k, num_valid=nv,
                             block_q=bq)
               if rows is None else _launch_encode_search(
                   lev, idh, lvh, r, dim=D, k=k, num_valid=nv,
                   codebook_words=None, bq=bq, rows_per_split=rows))
        mismatches["encode_search"] += diff(got, encode_search_plain(
            lev, idh, lvh, r, dim=D, k=k, num_valid=nv))
        # the encode kernel alone
        mismatches["encode_search"] += int(
            (encode_queries(lev, idh, lvh, r)
             != encode_queries_plain(lev, idh, lvh, packed=packed)).sum())
    limit = smem_limit(dev)
    for Q, R, D, packed, k, nv, dup, kind, nt in BANDED_EDGE_CASES:
        rng = np.random.default_rng(Q * 1000 + R + D + 1)
        r = bank(rng, R // 3 if dup else R, D, packed, dup)
        q = bank(rng, Q, D, packed)
        starts, lens, nt = banded_case(np, rng, Q, r.shape[0], kind, nt)
        if k == "max":
            k = min(r.shape[0], banded_k_max(
                words_per_row(r.shape[1] * r.element_size())[0],
                1 if starts.ndim == 1 else starts.shape[0], limit))
        starts = torch.from_numpy(starts).to(dev)
        lens = torch.from_numpy(lens).to(dev)
        want = topk_hamming_banded_plain(q, r, starts, lens, dim=D, k=k,
                                         num_valid=nv)
        mismatches["topk_hamming_banded"] += diff(
            topk_hamming_banded(q, r, starts, lens, dim=D, k=k, num_valid=nv,
                                num_tiles=nt), want)
        # without canonicalization only the fillers of INT32_MIN slots differ
        raw_i, raw_v = topk_hamming_banded(q, r, starts, lens, dim=D, k=k,
                                           num_valid=nv, num_tiles=nt,
                                           canonicalize=False)
        real = want[1] != INT32_MIN
        mismatches["topk_hamming_banded"] += int(
            (raw_v != want[1]).sum() + (raw_i[real] != want[0][real]).sum())
        lev, idh, lvh = codebooks(rng, Q, D)
        mismatches["encode_search_banded"] += diff(
            encode_search_banded(lev, idh, lvh, r, starts, lens, dim=D, k=k,
                                 num_valid=nv, num_tiles=nt),
            encode_search_banded_plain(lev, idh, lvh, r, starts, lens, dim=D,
                                       k=k, num_valid=nv))
    for Q, R, W, layout in HAMMING_EDGE_CASES:
        q, r = hamming_case(torch, Q, R, W, layout)
        dim = hamming_dim(W, layout)
        mismatches["hamming_pop"] += int(
            (hamming_pop(q, r, dim=dim)
             != hamming_pop_plain(q, r, dim=dim)).sum())
    for B, F, D, m, layout, bb, bd in HD_ENCODE_EDGE_CASES:
        lev, idh, lvh = hd_encode_case(torch, np, B, F, D, m, layout)
        mismatches["hd_encode"] += int(
            (hd_encode(lev, idh, lvh, block_b=bb, block_d=bd)
             != hd_encode_plain(lev, idh, lvh)).sum())
    for Q, R, Dp, kind, fs, tc, bq, br, adc in IMC_EDGE_CASES:
        q, w = imc_case(torch, np, Q, R, Dp, kind)
        mismatches["imc_mvm"] += int(
            (imc_mvm(q, w, full_scale=fs, tile_cols=tc, block_q=bq,
                     block_r=br, adc_levels=adc)
             != imc_mvm_plain(q, w, full_scale=fs, tile_cols=tc,
                              adc_levels=adc)).sum())
    decode_err = 0.0
    decode_cases = [(case, vl, None) for case in DECODE_EDGE_CASES
                    for vl in case[-1]]
    # forced split counts, valid_len around the first split boundary
    for n in DECODE_SPLITS:
        per = split_plan(DECODE_SPLIT_SHAPE[1], n)[1]
        decode_cases += [((*DECODE_SPLIT_SHAPE, ()), vl, n) for vl in (
            0, 1, per - 1, per, per + 1, DECODE_SPLIT_SHAPE[1])]
    for (B, S, KV, G, hd, _), vl, n in decode_cases:
        ops = decode_case(torch, np, B, S, KV, G, hd)
        got = launch_split(*ops, vl, n)
        want = decode_attention_plain(*ops, vl)
        mismatches["decode_attention"] += close_count(
            torch, got, want, DECODE_RTOL, DECODE_ATOL)
        decode_err = max(decode_err, float((got - want).abs().max()))
        # the partial form (a kv_seq block): the output and its
        # log-sum-exp; valid_len 0 is an empty block, 0 and -inf
        out, lse = launch_split(*ops, vl, n, partial=True)
        want_out, want_lse = decode_attention_partial_plain(*ops, vl)
        if vl <= 0:
            mismatches["decode_attention"] += int(
                (out != 0).sum() + (lse != float("-inf")).sum())
            continue
        mismatches["decode_attention"] += close_count(
            torch, out, want_out, DECODE_RTOL, DECODE_ATOL) + close_count(
            torch, lse, want_lse, DECODE_RTOL, DECODE_ATOL)
        decode_err = max(decode_err, float((out - want_out).abs().max()),
                         float((lse - want_lse).abs().max()))
    # rows at or past valid_len set to 127 must leave the output
    # bit-identical (their weight is exactly 0)
    q, k8, v8, ks, vs = decode_case(torch, np, 2, 200, 2, 7, 128, seed=5)
    out = decode_attention(q, k8, v8, ks, vs, 70)
    k8[:, 70:] = 127
    v8[:, 70:] = 127
    tail_diff = int((decode_attention(q, k8, v8, ks, vs, 70) != out).sum())
    torch.cuda.synchronize()
    print(f"kernels vs plain: {len(EDGE_CASES)} exact, "
          f"{len(BANDED_EDGE_CASES)} banded, {len(HAMMING_EDGE_CASES)} "
          f"hamming_pop, {len(HD_ENCODE_EDGE_CASES)} hd_encode, "
          f"{len(IMC_EDGE_CASES)} imc_mvm and {len(decode_cases)} "
          f"decode_attention cases (each also in the partial form), "
          f"mismatches {json.dumps(mismatches)} "
          f"(decode_attention: elements outside rtol/atol "
          f"{DECODE_RTOL}/{DECODE_ATOL}, max |err| {decode_err:.3g}; "
          f"masked-tail perturbation: {tail_diff} differing elements)")
    check(tail_diff == 0, "decode_attention output moved with rows past "
                          "valid_len")
    check(not any(mismatches.values()), "kernel disagrees with its plain "
                                         "version")


def phase_tune(torch, np):
    """The autotuner at the served shapes, then ``hd_encode`` and
    ``imc_mvm`` timed at the sweep's shapes; returns their kernel entries."""
    import gc
    import os
    import tempfile

    import torch.nn.functional as nnf

    from repro_torch.kernels.encode_search import (
        encode_search,
        encode_search_banded,
    )
    from repro_torch.kernels.hd_encode import hd_encode, hd_encode_plain
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.kernels.topk_hamming import (
        topk_hamming,
        topk_hamming_banded,
    )
    from repro_torch.launch import roofline, tune
    from repro_torch.tune import sweep
    from repro_torch.tune import table as tune_table
    from repro_torch.tune.microbench import burst_seconds

    swept = {"topk_hamming": topk_hamming,
             "topk_hamming_banded": topk_hamming_banded,
             "encode_search": encode_search,
             "encode_search_banded": encode_search_banded,
             "hd_encode": hd_encode, "imc_mvm": imc_mvm}
    check(tuple(swept) == sweep.OPS, "chip_smoke's swept kernels are not "
                                      "the sweep's ops")
    tune_table.reset()
    for fn in swept.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "table.json")
        t0 = time.perf_counter()
        table = tune.main(["--out", out, "--iters", "3"])
        wall = time.perf_counter() - t0
        launches = {op: fn.launches for op, fn in swept.items()}
        loaded = tune_table.load_table(out)
    ratio = sweep.tuned_vs_default_ratio(table)
    ops = {}
    rejected = 0
    for op, buckets in table.ops.items():
        for bucket, e in buckets.items():
            rejected += sum("rejected" in c for c in e["candidates"])
            ops[op] = {"bucket": bucket, "default_us": e["default_us"],
                       "default_spread": e["default_spread"],
                       "tuned_us": e["us"], "blocks": e["blocks"],
                       "candidates": len(e["candidates"])}
    ceil = table.ceilings
    print(json.dumps({
        "path": "tune", "wall_s": wall, "device_kind": table.device_kind,
        "ceilings": {"peak_flops_fp32": ceil["peak_flops_fp32"],
                     "hbm_bw": ceil["hbm_bw"], "matmul": ceil["matmul"]},
        "published": {"peak_flops_bf16": roofline.PEAK_FLOPS,
                      "peak_flops_fp32": roofline.PEAK_FLOPS_FP32,
                      "hbm_bw": roofline.HBM_BW},
        "ops": ops, "launches": launches, "rejected_candidates": rejected,
        "worst_tuned_vs_default": ratio}))
    check(all(launches[op] > 0 for op in swept),
          f"a swept kernel was never launched on the tune path: {launches}")
    check(loaded is not None and set(loaded.ops) == set(swept)
          and loaded.device_kind == torch.cuda.get_device_name(0),
          "the written table does not load back whole")
    check(rejected == 0, "a sweep candidate differs from the default's "
                         "result")
    check(ratio >= 1.0, f"worst tuned-vs-default ratio {ratio} < 1.0")
    # the serving phases run on the fixed rules
    check(tune_table.active_table() is None
          and not os.environ.get(tune_table.ENV_VAR),
          "a tuning table is active after the sweep")

    entries = []
    lev, idh, lvh, words = sweep.encoder_operands(False, "cuda")
    B, F = lev.shape
    D = idh.shape[1]
    got = hd_encode(lev, idh, lvh, codebook_words=words)
    want = hd_encode_plain(lev, idh, lvh)
    mism = int((got != want).sum())
    check(mism == 0, "hd_encode differs from its plain version at the "
                     "sweep's shape")
    ms = time_ms(torch, lambda: hd_encode(lev, idh, lvh,
                                          codebook_words=words),
                 iters=200, warmup=5)
    # the kernel alone: the same 200 launches queued behind a device wait
    dev_ms = 1e3 * sorted(burst_seconds(
        lambda: hd_encode(lev, idh, lvh, codebook_words=words),
        torch.device("cuda"), calls=200, iters=3))[1]
    plain_ms = time_ms(torch, lambda: hd_encode_plain(lev, idh, lvh),
                       iters=2, warmup=1)
    n_present = int((lev > 0).sum())
    b_ms, b_by = bound_ms(2 * n_present * D,
                          lev.numel() * 4 + sum(w.numel() * 4 for w in words)
                          + B * D)

    def device_ms(lv, **knobs):
        return 1e3 * sorted(burst_seconds(
            lambda: hd_encode(lv, idh, lvh, codebook_words=words, **knobs),
            torch.device("cuda"), calls=200, iters=3))[1]

    # with the host's issue hidden: by bucket (the first n rows), by
    # block_d at each bucket, and with no present bin (the compaction and
    # the launch alone, no codebook loads)
    bucket_ms = {n: device_ms(lev[:n]) for n in HD_ENCODE_BUCKETS}
    block_d_ms = {bd: {n: device_ms(lev[:n], block_d=bd)
                       for n in HD_ENCODE_BUCKETS}
                  for bd in HD_ENCODE_BLOCK_D}
    absent_ms = device_ms(torch.zeros_like(lev))
    print(f"tune: hd_encode with the host's issue hidden by bucket (B: ms) "
          f"{json.dumps(bucket_ms)}; by block_d, then bucket "
          f"{json.dumps(block_d_ms)}; at B={B} with no present bin "
          f"{absent_ms:.4f} ms")
    print(f"tune: hd_encode at B={B}, F={F}, D={D} ({n_present} present "
          f"bins): {ms:.4f} ms per launch (200 back to back; "
          f"{dev_ms:.4f} ms with the host's issue hidden), plain "
          f"{plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}); kernel vs "
          f"plain: {mism} mismatches; no single PyTorch call computes Eq. 1 "
          f"with its sign; sm clock, power, limit: "
          f"{nvidia_smi('clocks.sm,power.draw,power.limit')}")
    entries.append({
        "name": "hd_encode", "route": "cuda",
        "source": "src/repro_torch/csrc/hd_encode.cu",
        "replaces": TPU_KERNELS["hd_encode"],
        "launches": launches["hd_encode"], "mismatches": mism,
        "max_abs_err": int((got.to(torch.int32) - want.to(torch.int32))
                           .abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "device_ms": dev_ms,
        "bucket_device_ms": {str(n): t for n, t in bucket_ms.items()},
        "absent_device_ms": absent_ms,
        "shape": f"B={B}, F={F}, D={D} (tune sweep)"})
    del lev, idh, lvh, words, got, want

    qf, wf, fs = sweep.imc_operands(False, "cuda")
    Q, Dp = qf.shape
    R = wf.shape[0]
    got = imc_mvm(qf, wf, full_scale=fs)
    t0 = time.perf_counter()
    want = imc_mvm_plain(qf, wf, full_scale=fs)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    mism = int((got != want).sum())
    max_abs_err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "imc_mvm gave non-finite scores")
    check(mism == 0, "imc_mvm differs from its plain version at the sweep's "
                     "shape")
    del want
    ms = time_ms(torch, lambda: imc_mvm(qf, wf, full_scale=fs), iters=10,
                 warmup=2)
    # the yardstick: the same tile dot products as one float32 batched
    # matmul (TF32 off), no DAC or ADC; its layouts made beforehand
    T = -(-Dp // 128)
    pad = T * 128 - Dp
    q3 = nnf.pad(qf.round().clamp(-3, 3), (0, pad)).view(Q, T, 128)
    q3 = q3.transpose(0, 1).contiguous()
    w3 = nnf.pad(wf, (0, pad)).view(R, T, 128).permute(1, 2, 0).contiguous()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_ms = time_ms(torch, lambda: torch.matmul(q3, w3), iters=10,
                         warmup=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del q3, w3
    b_ms, b_by = bound_ms(2 * Q * R * Dp, (Q + R) * Dp * 4 + Q * R * 4,
                          FP32_OPS_PER_S)
    print(f"tune: imc_mvm at Q={Q}, R={R}, Dp={Dp} ({wf.numel() * 4 / 1e9:.3f}"
          f" GB of weights): {ms:.4f} ms, plain {plain_ms:.1f} ms (one "
          f"call), float32 torch.matmul over the same tile dot products "
          f"(TF32 off, no ADC) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{2 * Q * R * Dp:.4g} float32 ops at {FP32_OPS_PER_S:.3g}/s, "
          f"{(Q + R) * Dp * 4 + Q * R * 4:.4g} B); kernel vs plain: {mism} "
          f"mismatches; sm clock, power, limit: "
          f"{nvidia_smi('clocks.sm,power.draw,power.limit')}")
    entries.append({
        "name": "imc_mvm", "route": "cuda",
        "source": "src/repro_torch/csrc/imc_mvm.cu",
        "replaces": TPU_KERNELS["imc_mvm"], "launches": launches["imc_mvm"],
        "mismatches": mism, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        "library": f"float32 torch.matmul ({T}, {Q}, 128) x ({T}, 128, "
                   f"{R}), TF32 off, no ADC",
        "shape": f"Q={Q}, R={R}, Dp={Dp} (tune sweep)"})
    del qf, wf, got
    gc.collect()
    torch.cuda.empty_cache()
    return entries


# the pipelines phase: run_db_search at iPRG2012 scale (DB_CFG: Dp 2,731,
# the tuner's imc_mvm shape and db_search_cost's defaults) and
# run_clustering on one paper-average bucket (Dp 683)
PIPE_DB_CFG = dict(hd_dim=8193, mlc_bits=3, num_levels=16, material="tite2",
                   write_verify=3)
PIPE_CLUSTER_CFG = dict(hd_dim=2049, mlc_bits=3, num_levels=16,
                        material="sb2te3", write_verify=0)
# the scores checked against the plain version: the first
# PIPE_CHECK_QUERIES queries of the first chunk on the first
# PIPE_CHECK_ROWS rows of each bank, and the last queries of the last
# chunk on the last rows (the plain version's whole DB-search bank takes
# seconds a side; a clustering bucket has fewer rows, so all of them)
PIPE_CHECK_QUERIES, PIPE_CHECK_ROWS = 32, 65_536
# the analog route must identify at least this share of the ideal route's
# count (Fig. 10: MLC3 with write-verify keeps the quality)
PIPE_MIN_ANALOG_SHARE = 0.9


def pipeline_recorder(torch, pipeline):
    """Stand-ins for the pipelines' stages that call the real ones and
    keep, per run: each stage's wall seconds (a device synchronization on
    both sides: the instrumented run's seconds), the noisy weights the
    noise stage made (alive for the whole run anyway), and per noisy bank
    the first query chunk with its first scores and the last chunk's last
    queries with their last scores (a few MB). Non-finite scores are
    counted on the device, with no host synchronization; read
    ``rec["nonfinite"]`` after the run."""
    rec = {"secs": {}, "banks": [], "first": {}, "last": {},
           "nonfinite": None}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec["secs"][name] = rec["secs"].get(name, 0.0) + (
                time.perf_counter() - t0)
            return out
        return run

    real_noise, real_scores = pipeline.apply_write_noise, pipeline._scores

    def noise(generator, weights, cfg):
        out = real_noise(generator, weights, cfg)
        rec["banks"].append(out)
        return out

    def scores(q, bank, cfg):
        out = real_scores(q, bank, cfg)
        bad = (~torch.isfinite(out)).sum()
        rec["nonfinite"] = bad if rec["nonfinite"] is None else (
            rec["nonfinite"] + bad)
        if not cfg.ideal:
            key = bank.data_ptr()
            if key not in rec["first"]:
                rec["first"][key] = (
                    q.clone(),
                    out[:PIPE_CHECK_QUERIES, :PIPE_CHECK_ROWS].clone())
            rec["last"][key] = (
                q[-PIPE_CHECK_QUERIES:].clone(),
                out[-PIPE_CHECK_QUERIES:, -PIPE_CHECK_ROWS:].clone())
        return out

    patch = mock.patch.multiple(
        pipeline, encode_and_pack=timed("encode", pipeline.encode_and_pack),
        apply_write_noise=timed("noise", noise),
        _scores=timed("scores", scores),
        fdr_filter=timed("fdr", pipeline.fdr_filter))
    return rec, patch


def imc_shape_times(torch, q, w, acfg, iters):
    """``imc_mvm`` through the array model at one pipeline shape, beside
    one float32 ``torch.matmul`` over the same operands (TF32 off, no DAC
    or ADC), the bound (inputs once, output once; FMAs at the float32
    peak) and the design's bound of ``csrc/imc_mvm.cu``'s header (the
    weights read once per 32-query tile, FMAs at 33.5 T/s)."""
    from repro_torch.core.imc.array import imc_mvm_reference

    Q, Dp = q.shape
    R = w.shape[0]
    ms = time_ms(torch, lambda: imc_mvm_reference(q, w, acfg), iters=iters,
                 warmup=1)
    qf = q.to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_ms = time_ms(torch, lambda: torch.matmul(qf, w.t()), iters=iters,
                         warmup=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    fmas = Q * R * Dp
    b_ms, b_by = bound_ms(2 * fmas, (Q + R) * Dp * 4 + Q * R * 4,
                          FP32_OPS_PER_S)
    design_ms = 1e3 * max(R * Dp * 4 * -(-Q // 32) / HBM_BYTES_PER_S,
                          fmas / (FP32_OPS_PER_S / 2))
    return {"shape": f"Q={Q}, R={R}, Dp={Dp}", "ms": ms, "matmul_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "design_bound_ms": design_ms}


def plain_mismatches(torch, acfg, got, q, w) -> tuple[int, float]:
    """The elements of ``got`` that differ from the plain ``imc_mvm`` of
    ``q`` x ``w`` under ``acfg``, and the plain version's seconds."""
    from repro_torch.core.imc.array import default_full_scale
    from repro_torch.kernels.imc_mvm import imc_mvm_plain

    t0 = time.perf_counter()
    want = imc_mvm_plain(q.to(torch.float32), w,
                         full_scale=default_full_scale(acfg),
                         tile_cols=acfg.cols, dac_limit=acfg.dac_levels,
                         adc_levels=acfg.adc_levels)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(want.shape == got.shape, f"checked scores of shape "
                                   f"{tuple(got.shape)}, plain "
                                   f"{tuple(want.shape)}")
    return int((got != want).sum()), secs


def phase_pipelines(torch, np):
    """``run_db_search`` (ideal and analog) at iPRG2012 scale,
    ``run_clustering`` on one paper-average bucket and the ISA's
    DB-search stream, all on the card; returns the numbers row 7 of the
    kernels line gains."""
    import dataclasses
    import gc

    from repro_torch.core import (
        SpecPCMConfig,
        pipeline,
        run_clustering,
        run_db_search,
    )
    from repro_torch.core.imc.array import imc_mvm as array_imc_mvm
    from repro_torch.core.imc.isa import ISAExecutor, compile_db_search
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.spectra import (
        SyntheticMSConfig,
        generate_dataset,
        generate_query_set,
    )

    out = {}
    t_phase = time.perf_counter()
    # the serving phases' bank (145,299 identities x 4); OMS-style queries
    # whose modifications add 60-150 Da to the precursor, as serve_db --oms
    ms = SyntheticMSConfig(num_identities=IDENTITIES,
                           spectra_per_identity=REPLICATES, num_bins=1024,
                           seed=0, modification_mass_range=(60.0, 150.0))
    t0 = time.perf_counter()
    ds = generate_dataset(ms, device="cuda")
    pool = generate_query_set(ds, ms, QUERIES, seed=1, modification_rate=0.3)
    pick = torch.linspace(0, pool.num_spectra - 1, QUERIES,
                          device="cuda").round().long()
    q_spec, q_prec, q_id = (pool.spectra[pick], pool.precursor[pick],
                            pool.identity[pick])
    del pool
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    reports, runs = {}, {}
    for ideal in (True, False):
        cfg = SpecPCMConfig(ideal=ideal, **PIPE_DB_CFG)
        rec, patch = pipeline_recorder(torch, pipeline)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        imc_mvm.launches = 0
        imc_mvm_plain.calls = 0
        t0 = time.perf_counter()
        with patch:
            rep = run_db_search(q_spec, q_prec, ds.spectra, ds.precursor, cfg,
                                query_identity=q_id, ref_identity=ds.identity,
                                open_search=True, device="cuda")
        wall = time.perf_counter() - t0
        launches, plain = imc_mvm.launches, imc_mvm_plain.calls
        nonfinite = int(rec["nonfinite"])
        name = "ideal" if ideal else "analog"
        reports[name], runs[name] = rep, rec
        line = {
            "path": f"run_db_search ({name})", "queries": QUERIES,
            "refs": ds.num_spectra, "decoys": ds.num_spectra,
            "identified_at_1pct_fdr": rep.num_identified,
            "recall": rep.recall, "no_candidate": rep.num_no_candidate,
            "wall_s": wall, "stage_s": rec["secs"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "imc_mvm_launches": launches, "imc_mvm_plain_calls": plain,
            "query_chunk": pipeline.query_chunk(ds.num_spectra),
            "modelled_specpcm_chip": {
                "latency_s": rep.cost.latency_s,
                "energy_j": rep.cost.energy_j,
                "note": "core/imc/energy.py's model of the paper's PCM "
                        "chip, not a measurement of this card"}}
        print(json.dumps(line))
        check(plain == 0, f"the plain imc_mvm ran {plain} times on the "
                          f"{name} DB-search path")
        check(nonfinite == 0, f"{nonfinite} non-finite scores on the {name} "
                              f"path")
        check(ideal or launches > 0, "imc_mvm never launched on the analog "
                                     "DB-search path")
        check(not ideal or launches == 0, "the ideal DB search launched "
                                          "imc_mvm")
        out[f"db_{name}"] = line
    ideal_n = reports["ideal"].num_identified
    analog_n = reports["analog"].num_identified
    share = analog_n / max(ideal_n, 1)
    print(f"pipelines: analog identifies {analog_n} of the ideal route's "
          f"{ideal_n} at 1% FDR ({share:.4f}; at least "
          f"{PIPE_MIN_ANALOG_SHARE} required); data made in {data_s:.2f} s")
    check(share >= PIPE_MIN_ANALOG_SHARE, f"the analog route identifies "
                                          f"{share:.4f} of the ideal's")
    out["analog_over_ideal"] = share
    out["db_launches"] = out["db_analog"]["imc_mvm_launches"]

    # the first chunk's first scores and the last chunk's last scores
    # against the plain version, from the same noisy weights
    rec = runs["analog"]
    cfg = SpecPCMConfig(**PIPE_DB_CFG)
    acfg = cfg.array_cfg()
    check(len(rec["banks"]) == 2 and len(rec["first"]) == 2,
          "the analog run did not program and score two sides")
    mism, plain_s = {}, []
    for side, noisy in zip(("targets", "decoys"), rec["banks"]):
        for end in ("first", "last"):
            q, got = rec[end][noisy.data_ptr()]
            w = (noisy[:PIPE_CHECK_ROWS] if end == "first"
                 else noisy[-PIPE_CHECK_ROWS:])
            n, secs = plain_mismatches(torch, acfg, got,
                                       q[:PIPE_CHECK_QUERIES], w)
            mism[f"{side}, {end}"] = n
            plain_s.append(secs)
    # w is a view: it would keep the decoys' 6.35 GB bank alive
    del q, got, w
    print(f"pipelines: DB-search scores of {PIPE_CHECK_QUERIES} queries x "
          f"{PIPE_CHECK_ROWS} rows vs the plain version (the first chunk's "
          f"first queries on the first rows, the last chunk's last queries "
          f"on the last rows): {mism} mismatches; plain "
          f"{min(plain_s):.2f}-{max(plain_s):.2f} s each")
    check(not any(mism.values()), "the DB-search scores differ from the "
                                  "plain imc_mvm")
    out["check_mismatches"] = {"run_db_search": sum(mism.values())}
    out["db_check_plain_ms"] = 1e3 * plain_s[0]

    # imc_mvm at the DB-search chunk's shape, on the target side
    noisy = rec["banks"][0]
    q_chunk, _ = rec["first"][noisy.data_ptr()]
    out["db_shape"] = imc_shape_times(torch, q_chunk, noisy, acfg, iters=3)

    # the ISA's DB-search stream over the packed target bank (encoded
    # again here, after the run's noisy weights are freed, so the run
    # keeps none of it alive) with 32 staged queries
    del rec, runs, noisy
    gc.collect()
    torch.cuda.empty_cache()
    packed = pipeline.encode_and_pack(ds.spectra.to(torch.float32), cfg)
    stream = compile_db_search(packed.shape[0], packed.shape[1], acfg,
                               cfg.write_verify, cfg.adc_bits, cfg.mlc_bits)
    ex = ISAExecutor(acfg, cfg.device_cfg(), seed=cfg.seed, device="cuda")
    imc_mvm.launches = 0
    imc_mvm_plain.calls = 0
    t0 = time.perf_counter()
    ex.load_stage(packed)
    ex.execute_one(stream[0])
    del packed
    ex.load_stage(q_chunk[:PIPE_CHECK_QUERIES])
    ex.execute_one(stream[1])
    torch.cuda.synchronize()
    isa_s = time.perf_counter() - t0
    isa_launches, isa_plain = imc_mvm.launches, imc_mvm_plain.calls
    mvm = stream[1]
    isa_cfg = dataclasses.replace(acfg, adc_bits=max(mvm.aux, 1),
                                  bits_per_cell=mvm.mlc_bits)
    isa_mism, _ = plain_mismatches(
        torch, isa_cfg, ex.result[:, :PIPE_CHECK_ROWS], ex.stage,
        ex.state.weights[:PIPE_CHECK_ROWS])
    same = torch.equal(ex.result, array_imc_mvm(ex.stage, ex.state))
    print(f"pipelines: ISA stream {[i.opcode.name for i in stream]} over "
          f"{ex.state.weights.shape[0]} x {ex.state.weights.shape[1]} "
          f"packed rows, {PIPE_CHECK_QUERIES} staged queries: {isa_s:.2f} s, "
          f"{isa_launches} imc_mvm launch(es), plain {isa_plain}; "
          f"{isa_mism} mismatches against the plain version on the first "
          f"{PIPE_CHECK_ROWS} rows; equal to core.imc.array.imc_mvm of the "
          f"same state: {same}; trace {ex.trace.cycles} cycles, "
          f"{ex.trace.energy_j:.6g} J (the modelled SpecPCM chip)")
    check(isa_launches == 1 and isa_plain == 0,
          "MVM_COMPUTE did not launch imc_mvm once")
    check(isa_mism == 0, "the ISA's MVM differs from the plain imc_mvm")
    check(same, "the ISA's MVM differs from core.imc.array.imc_mvm")
    out["check_mismatches"]["isa_mvm_compute"] = isa_mism
    out["isa_launches"] = isa_launches
    del ex, q_chunk, ds, q_spec, q_prec, q_id
    gc.collect()
    torch.cuda.empty_cache()

    # clustering: one paper-average bucket (10,624 spectra); the bucket
    # width takes every precursor of the synthetic set into one bucket
    cds = generate_dataset(SyntheticMSConfig(
        num_identities=CLUSTER_IDENTITIES,
        spectra_per_identity=CLUSTER_REPLICATES, num_bins=1024, seed=0),
        device="cuda")
    ccfg = SpecPCMConfig(**PIPE_CLUSTER_CFG)
    rec, patch = pipeline_recorder(torch, pipeline)
    secs = {}
    real_linkage = pipeline.complete_linkage

    def linkage(dist, threshold):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_linkage(dist, threshold)
        secs["linkage"] = time.perf_counter() - t0
        return res

    torch.cuda.reset_peak_memory_stats()
    imc_mvm.launches = 0
    imc_mvm_plain.calls = 0
    t0 = time.perf_counter()
    with patch, mock.patch.object(pipeline, "complete_linkage", linkage):
        crep = run_clustering(cds.spectra, cds.precursor, cds.identity, ccfg,
                              bucket_width=2000.0, device="cuda")
    wall = time.perf_counter() - t0
    launches, plain = imc_mvm.launches, imc_mvm_plain.calls
    nonfinite = int(rec["nonfinite"])
    line = {
        "path": "run_clustering (analog)", "spectra": cds.num_spectra,
        "clustered_ratio": crep.clustered_ratio,
        "incorrect_ratio": crep.incorrect_ratio,
        "clusters": crep.num_clusters, "wall_s": wall,
        "stage_s": dict(rec["secs"], **secs),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "imc_mvm_launches": launches, "imc_mvm_plain_calls": plain,
        "modelled_specpcm_chip": {"latency_s": crep.cost.latency_s,
                                  "energy_j": crep.cost.energy_j}}
    print(json.dumps(line))
    check(launches == 1 and plain == 0, "the clustering path did not launch "
                                        "imc_mvm once, or ran its plain "
                                        "version")
    check(nonfinite == 0, f"{nonfinite} non-finite clustering scores")
    out["cluster"] = line
    out["cluster_launches"] = launches

    # the bucket's first and last rows of scores, every column (the
    # ragged 43-column tile included), against the plain version
    check(len(rec["banks"]) == 1 and len(rec["first"]) == 1,
          "the clustering run did not program and score one bucket")
    (noisy,) = rec["banks"]
    cacfg = ccfg.array_cfg()
    q_all, got = rec["first"][noisy.data_ptr()]
    cmism = {"first": plain_mismatches(torch, cacfg, got,
                                       q_all[:PIPE_CHECK_QUERIES],
                                       noisy[:PIPE_CHECK_ROWS])[0]}
    q, got = rec["last"][noisy.data_ptr()]
    cmism["last"] = plain_mismatches(torch, cacfg, got, q,
                                     noisy[-PIPE_CHECK_ROWS:])[0]
    print(f"pipelines: clustering scores of the first and last "
          f"{PIPE_CHECK_QUERIES} rows x {noisy.shape[0]} columns vs the "
          f"plain version: {cmism} mismatches")
    check(not any(cmism.values()), "the clustering scores differ from the "
                                   "plain imc_mvm")
    out["check_mismatches"]["run_clustering"] = sum(cmism.values())
    out["cluster_shape"] = imc_shape_times(torch, q_all, noisy, cacfg,
                                           iters=10)
    for key in ("db_shape", "cluster_shape"):
        s = out[key]
        print(f"pipelines: imc_mvm at {s['shape']}: {s['ms']:.4f} ms, float32 "
              f"torch.matmul over the same operands (TF32 off, no ADC) "
              f"{s['matmul_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
              f"({s['bound_by']}), the design's bound "
              f"{s['design_bound_ms']:.4f} ms; sm clock, power, limit: "
              f"{nvidia_smi('clocks.sm,power.draw,power.limit')}")
    del rec, q_all, q, got, noisy, cds
    gc.collect()
    torch.cuda.empty_cache()
    print(f"pipelines: phase {time.perf_counter() - t_phase:.1f} s")
    return out


def recording_executor(rows: int):
    """A ``SearchExecutor`` subclass that keeps the device batch, bank,
    encoder, results and OMS plan of the first served batch of ``rows``
    queries, and every served request's result (``results``: request id
    -> (indices, scores, accept, match, has_candidate)) and the request
    ids of every batch (``batches``)."""
    from repro_torch.serve import SearchExecutor

    class Recording(SearchExecutor):
        got = None
        results: dict = {}
        batches: list = []

        def dispatch(self, reqs):
            h = super().dispatch(reqs)
            if Recording.got is None and h.n == rows:
                Recording.got = (h.db, self.server.encoder, h.batch.clone(),
                                 h.idx.clone(), h.vals.clone(), h.plan)
            return h

        def finalize(self, handle):
            live = super().finalize(handle)
            Recording.batches.append([r.rid for r in handle.reqs])
            for r in live:
                res = r.result
                Recording.results[r.rid] = (
                    res.indices.copy(), res.scores.copy(), bool(res.accept),
                    int(res.match), bool(res.has_candidate))
            return live

    return Recording


def time_ms(torch, fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops: float, nbytes: float, ops_per_s: float = INT8_OPS_PER_S
             ) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of ``ops``
    at ``ops_per_s`` (by default the int8 tensor-core peak: the search
    score and Eq. 1 are +-1 products, which int8 tensor cores compute
    exactly) and ``nbytes`` at HBM bandwidth."""
    t_ops = ops / ops_per_s
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def popc_pipe_ms(popc: float, sms: int) -> float:
    """The banded design's own ceiling: ``popc`` POPCs at 16 per clock per
    SM and the card's maximum SM clock, in ms."""
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return 1e3 * popc / (POPC_PER_CLOCK_PER_SM * sms * clock_hz)


def expansion_ops(Q: int, R: int, W: int, bq: int) -> int:
    """Integer operations of the exact scan's +-1 expansion
    (csrc/hd_exact_scan.cuh), per query block: a multiply and an AND per
    4 bank bits, and 23 per query word (8 expansions of 3) at each
    256-row step."""
    blocks = -(-Q // bq)
    return blocks * (16 * R * W + -(-R // 256) * bq * W * 23)


def int_pipe_ms(ops: float, sms: int) -> float:
    """The time of ``ops`` integer operations at 64 lanes per clock per SM
    and the card's maximum SM clock, in ms: the tensor-core scan's +-1
    expansion alone, an estimate that leaves out its wgmmas, staging and
    barriers."""
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return 1e3 * ops / (INT_LANES_PER_CLOCK_PER_SM * sms * clock_hz)


def band_rows(starts, lens):
    """Distinct rows inside any band of a (B, Q) plan."""
    iv = sorted((int(a), int(a + n)) for a, n in zip(starts.ravel(),
                                                      lens.ravel()) if n > 0)
    total, hi = 0, -1
    for a, b in iv:
        if b > hi:
            total += b - max(a, hi)
            hi = b
    return total


def design_rows(starts, lens, R: int, plan) -> tuple[int, int]:
    """(rows the banded kernels read from device memory, runs of band rows):
    per query group, each 32-row tile of its window that a band meets,
    once (csrc/hd_banded_scan.cuh; ``banded_tiles`` walks them as the
    blocks do). A run of consecutive band rows of a group adds at most 31
    rows at each end."""
    from repro_torch.kernels.topk_hamming.ops import (
        BANDED_TILE_ROWS,
        banded_tiles,
    )
    ends = starts + lens
    rows = runs = 0
    for g in range(plan.groups):
        for x in range(plan.blocks):
            rows += sum(min(a + BANDED_TILE_ROWS, R) - a
                        for a, _ in banded_tiles(starts, ends, plan, g, x))
        s = starts[:, g * plan.group:(g + 1) * plan.group].ravel()
        e = ends[:, g * plan.group:(g + 1) * plan.group].ravel()
        hi = -1
        for a, b in sorted(zip(s[e > s], e[e > s])):
            runs += a > hi
            hi = max(hi, b)
    return rows, runs


def serve_route(fused_e2e: bool, oms: bool) -> tuple[str, str, list]:
    """(path, kernel, ``serve_db`` argv) of one served route at the
    iPRG2012 scale."""
    route = "fused-e2e" if fused_e2e else "fused"
    kernel = ("encode_search" if fused_e2e else "topk_hamming") + (
        "_banded" if oms else "")
    argv = ["--hd-dim", str(DIM), "--identities", str(IDENTITIES),
            "--refs-per-identity", str(REPLICATES), "--queries",
            str(QUERIES), "--k", str(K), "--max-batch", str(MAX_BATCH),
            "--device", "cuda", f"--{route}"] + (["--oms"] if oms else [])
    return (f"oms {route}" if oms else route), kernel, argv


def phase_serve(torch, np, fused_e2e: bool, oms: bool):
    import dataclasses
    import gc

    from repro_torch.kernels.encode_search import (
        encode_search,
        encode_search_banded,
        encode_search_banded_plain,
        encode_search_plain,
    )
    from repro_torch.kernels.encode_search.ops import encode_queries
    from repro_torch.kernels.topk_hamming import (
        topk_hamming,
        topk_hamming_banded,
        topk_hamming_banded_plain,
        topk_hamming_plain,
    )
    from repro_torch.kernels.block_utils import DEFAULTS
    from repro_torch.kernels.topk_hamming.ops import (
        pick_block_q,
        plan_banded,
        smem_limit,
    )
    from repro_torch.launch import serve_db
    from repro_torch.serve import (
        oms_search_encoded,
        oms_search_levels,
        search_database_encoded,
        search_database_levels,
    )

    path, kernel, argv = serve_route(fused_e2e, oms)
    recorder = recording_executor(MAX_BATCH)
    gc.collect()  # an earlier run's server and banks sit in reference cycles
    torch.cuda.reset_peak_memory_stats()
    for fn in serve_db.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    s = serve_db.main(argv, executor_cls=recorder)
    launches = {n: fn.launches for n, fn in serve_db.KERNELS.items()}
    wall = time.perf_counter() - t0
    line = {
        "path": path, "queries": s["count"], "qps": s["qps"],
        "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"],
        "identified_at_fdr": s["identified"], "correct": s["correct"],
        "library_s": s["library_s"], "bank_build_s": s["bank_build_s"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "batches": s["batches"],
        "buckets": s["buckets"], "span_s": s["span_s"],
        "sleep_s": s["sleep_s"], "device_busy_s": s["device_busy_s"],
        "host_s": s["span_s"] - s["sleep_s"] - s["device_busy_s"],
        "device_idle_share": s["device_idle_share"],
        "run_s": wall}
    if oms:
        line.update({key: s["oms"][key] for key in (
            "candidate_fraction", "scanned_fraction", "no_candidate")},
            iprg2012_candidate_fraction=IPRG_CANDIDATE_FRACTION)
    print(json.dumps(line))
    SERVED[path] = line
    ONE_PROCESS[path] = (recorder.results, s["identified"])
    check(launches[kernel] > 0, f"{kernel} never launched on the {path} path")
    check(s["count"] == QUERIES, f"{path}: served {s['count']} of {QUERIES}")
    check(recorder.got is not None, f"{path}: no served batch of {MAX_BATCH}")

    db, enc, batch, idx, vals, plan = recorder.got
    R, W = db.data.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    unfused = dataclasses.replace(db, fused=False)
    # each smaller served bucket: its first rows, and on OMS evenly spaced
    # rows of the sorted batch (a batch of n sorted queries spans the mass
    # range as the 32 do)
    sel = {n: torch.arange(0, MAX_BATCH, MAX_BATCH // n, device=batch.device)
           for n in [*sorted(s["buckets"]), MAX_BATCH] if n <= MAX_BATCH}
    n_present = int((batch > 0).sum()) if fused_e2e else 0
    cb_bytes = (sum(w.numel() * 4 for w in enc.codebook_words)
                if fused_e2e else 0)
    if oms:
        starts = torch.from_numpy(plan.starts).to(batch.device)
        lens = torch.from_numpy(plan.lens).to(batch.device)
        args = {n: (batch[i].contiguous(), starts[:, i].contiguous(),
                    lens[:, i].contiguous()) for n, i in sel.items()}
        if fused_e2e:
            def run(n=MAX_BATCH, canonicalize=False, waves=None):
                b, st, ln = args[n]
                return encode_search_banded(
                    b, enc.id_hvs, enc.level_hvs, db.data, st, ln, dim=db.dim,
                    k=K, num_valid=db.num_rows, num_tiles=plan.num_tiles,
                    canonicalize=canonicalize,
                    codebook_words=enc.codebook_words, waves=waves)

            def plain():
                return encode_search_banded_plain(
                    batch, enc.id_hvs, enc.level_hvs, db.data, starts, lens,
                    dim=db.dim, k=K, num_valid=db.num_rows)

            served = oms_search_levels(unfused, enc, batch, plan, K)

            def route():
                return oms_search_levels(db, enc, batch, plan, K,
                                         fused_e2e=True)
        else:
            def run(n=MAX_BATCH, canonicalize=False, waves=None):
                b, st, ln = args[n]
                return topk_hamming_banded(
                    b, db.data, st, ln, dim=db.dim, k=K,
                    num_valid=db.num_rows, num_tiles=plan.num_tiles,
                    canonicalize=canonicalize, waves=waves)

            def plain():
                return topk_hamming_banded_plain(batch, db.data, starts, lens,
                                                 dim=db.dim, k=K,
                                                 num_valid=db.num_rows)

            served = oms_search_encoded(unfused, batch, plan, K)

            def route():
                return oms_search_encoded(db, batch, plan, K)
        cand = int(plan.lens.sum())
        union = band_rows(plan.starts, plan.lens)
        ops = 2 * (cand + n_present) * db.dim
        pipe_ops = (cand + n_present) * W
        nbytes = (batch.numel() * batch.element_size() + cb_bytes
                  + union * W * 4 + 2 * plan.starts.nbytes
                  + 2 * MAX_BATCH * K * 4)
        bplan = plan_banded(MAX_BATCH, R, W, K, plan.starts.shape[0],
                            plan.num_tiles, sms, DEFAULTS[kernel]["waves"],
                            smem_limit(batch.device))
        read_rows, runs = design_rows(plan.starts.astype(np.int64),
                                      plan.lens.astype(np.int64), R, bplan)
        check(union <= read_rows <= union + 2 * 31 * runs,
              f"{path}: the design reads {read_rows} rows for {union} "
              f"distinct band rows in {runs} runs")
        fetched = read_rows * W * 4
        priced = (-(-MAX_BATCH // 8) * plan.starts.shape[0] * plan.num_tiles
                  * 128 * W * 4)
        extra = (f"; {cand} candidate rows over {plan.starts.shape[0]} bands "
                 f"(candidate fraction {plan.candidate_fraction:.4f}, plan "
                 f"num_tiles {plan.num_tiles}, scanned fraction "
                 f"{plan.scanned_fraction:.4f}), {union} distinct band rows "
                 f"({union * W * 4 / 1e9:.4g} GB); this design reads "
                 f"{read_rows} rows, {fetched / 1e9:.4g} GB "
                 f"({read_rows / max(union, 1):.4f}x the union; "
                 f"{bplan.groups} query group of {bplan.group}, "
                 f"{bplan.blocks} blocks; the plan's budget prices "
                 f"{priced / 1e9:.4g} GB)")
    else:
        if fused_e2e:
            def run(n=MAX_BATCH, canonicalize=None):
                return encode_search(batch[:n], enc.id_hvs,
                                     enc.level_hvs, db.data, dim=db.dim, k=K,
                                     num_valid=db.num_rows,
                                     codebook_words=enc.codebook_words)

            def plain():
                return encode_search_plain(batch, enc.id_hvs, enc.level_hvs,
                                           db.data, dim=db.dim, k=K,
                                           num_valid=db.num_rows)

            def route():
                return search_database_levels(db, enc, batch, K,
                                              fused_e2e=True)

        else:
            def run(n=MAX_BATCH, canonicalize=None):
                return topk_hamming(batch[:n], db.data, dim=db.dim, k=K,
                                    num_valid=db.num_rows)

            def plain():
                return topk_hamming_plain(batch, db.data, dim=db.dim, k=K,
                                          num_valid=db.num_rows)

            def route():
                return search_database_encoded(db, batch, K)

        served = None  # the plain version is the plain route here
        ops = 2 * (MAX_BATCH * R + n_present) * db.dim
        bq = pick_block_q(MAX_BATCH, W, K, smem_limit(batch.device))
        pipe_ops = expansion_ops(MAX_BATCH, R, W, bq)
        nbytes = (batch.numel() * 4 + cb_bytes + db.data.numel() * 4
                  + 2 * MAX_BATCH * K * 4)
        extra = ""
    p_idx, p_vals = plain()
    if served is None:
        served = p_idx, p_vals
    served_diff = int((served[0] != idx).sum() + (served[1] != vals).sum())
    k_idx, k_vals = run(canonicalize=True)
    max_abs_err = int((k_vals.to(torch.int64) - p_vals.to(torch.int64))
                      .abs().max())
    mismatches = int((k_idx != p_idx).sum() + (k_vals != p_vals).sum())
    print(f"{path}: served batch of {MAX_BATCH} vs the "
          f"{'unfused masked' if oms else 'plain'} route on the card: "
          f"{served_diff} differing entries; kernel vs plain: {mismatches}")
    check(served_diff == 0, f"{path}: served batch differs from the route")
    check(mismatches == 0, f"{path}: {kernel} differs from its plain version")

    ms = time_ms(torch, run, iters=20, warmup=2)
    bucket_ms = {n: time_ms(torch, lambda n=n: run(n), iters=20, warmup=2)
                 for n in sel if n < MAX_BATCH}
    if oms:
        # every served bucket at each value of the knob, for choosing the
        # default (the tuner sweeps Q = 32 alone)
        alt = {w: {n: time_ms(torch, lambda n=n, w=w: run(n, waves=w),
                              iters=20, warmup=2) for n in sel}
               for w in BANDED_WAVES}
        print(f"{path}: {kernel} by waves, then served bucket (Q: ms) "
              f"{json.dumps(alt)}")
    # the served route on the same batch: the kernel plus the route's own
    # tensor work around it (bands, merge, overflow slots, permutation)
    route_ms = time_ms(torch, route, iters=20, warmup=2)
    plain_ms = time_ms(torch, plain, iters=2, warmup=0)
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit")
    b_ms, b_by = bound_ms(ops, nbytes)
    if oms:
        ceiling = (f"this design's POPC-pipe floor "
                   f"{popc_pipe_ms(pipe_ops, sms):.4f} ms ({pipe_ops:.4g} "
                   f"POPC)")
    else:
        ceiling = (f"an estimate of the tensor-core scan's +-1 expansion "
                   f"alone (not the design's ceiling: its wgmmas, staging "
                   f"and barriers add to it) {int_pipe_ms(pipe_ops, sms):.4f}"
                   f" ms ({pipe_ops:.4g} integer ops at 64 a clock per SM)")
    encode_ms = None
    if fused_e2e:
        # the encode kernel alone, on the served batch and each bucket
        rows = {n: batch[i].contiguous() for n, i in sel.items()}
        encode_ms = {n: time_ms(torch, lambda b=b: encode_queries(
            b, enc.id_hvs, enc.level_hvs, db.data,
            codebook_words=enc.codebook_words), iters=20, warmup=2)
            for n, b in rows.items()}
        extra += (f"; the encode kernel alone by served bucket (Q: ms) "
                  f"{json.dumps(encode_ms)}")
    print(f"{path}: {kernel} {ms:.4f} ms (the served route around it "
          f"{route_ms:.4f} ms), plain {plain_ms:.2f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {ops:.4g} int8 ops, {nbytes:.4g} B), "
          f"{ceiling} at Q={MAX_BATCH}, R={R}"
          + (f", {n_present} present bins in the batch" if fused_e2e else "")
          + extra + f"; by served bucket (Q: ms) {json.dumps(bucket_ms)}; "
          f"sm clock, power, limit: {clocks}")
    return {
        "name": kernel, "route": "cuda",
        "source": f"src/repro_torch/csrc/{kernel.removesuffix('_banded')}.cu",
        "replaces": TPU_KERNELS[kernel], "launches": launches[kernel],
        "mismatches": mismatches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a streaming top-k by Hamming
        # distance (with or without the encode, banded or not)
        "library_ms": None,
        "route_ms": route_ms,
        "bucket_ms": {str(n): t for n, t in bucket_ms.items()},
        **({} if encode_ms is None else {
            "encode_ms": encode_ms[MAX_BATCH],
            "encode_bucket_ms": {str(n): t for n, t in encode_ms.items()}}),
    }


# the clustering configuration: two tenants, each streaming one
# paper-average precursor bucket (core/imc/energy.py: 10,624 spectra,
# here 1,328 identities x 8 replicates) at D = 2048, 1024 bins, 16 levels,
# threshold 0.36 D, max batch 32 (4 buckets), 5 ms flush
CLUSTER_IDENTITIES, CLUSTER_REPLICATES, CLUSTER_DIM = 1328, 8, 2048
CLUSTER_ARGV = ["--identities", str(CLUSTER_IDENTITIES),
                "--spectra-per-identity", str(CLUSTER_REPLICATES),
                "--tenants", "2", "--consolidate-every", "2048",
                "--device", "cuda"]


def cluster_recorder():
    """A ``SearchExecutor`` subclass that keeps the server and, per
    finalized clustering batch, (tenant, HVs, assignments)."""
    from repro_torch.serve import SearchExecutor

    class Recording(SearchExecutor):
        server = None
        batches = []

        def _dispatch_cluster(self, reqs, tenant):
            Recording.server = self.server
            return super()._dispatch_cluster(reqs, tenant)

        def _finalize_cluster(self, handle):
            live = super()._finalize_cluster(handle)
            Recording.batches.append((handle.tenant,
                                      handle.hvs[:handle.n].copy(),
                                      [r.result for r in handle.reqs]))
            return live

    return Recording


def unpacked_int_mm_ms(torch, a, b):
    """``torch._int_mm`` of two unpacked int8 operands (the same function
    up to (D + dot) / 2), with its rows padded to a multiple of 8 (and
    above 16) as the call requires; returns (ms, padded shape)."""
    def pad(t, mult, least=0):
        rows = max(least, -(-t.shape[0] // mult) * mult)
        return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[0]))

    a8, b8 = pad(a, 8, 17), pad(b, 8)
    return (time_ms(torch, lambda: torch._int_mm(a8, b8.t()), iters=20,
                    warmup=2), (a8.shape[0], b8.shape[0]))


def phase_serve_cluster(torch, np):
    import gc

    from repro_torch.core.hd.clustering import cross_distances
    from repro_torch.core.hd.similarity import bitpack_bipolar
    from repro_torch.kernels.hamming_pop import hamming_pop, hamming_pop_plain
    from repro_torch.launch import serve_cluster
    from repro_torch.serve import StreamingClusterer
    from repro_torch.tune.microbench import burst_seconds

    recorder = cluster_recorder()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    hamming_pop.launches = 0
    t0 = time.perf_counter()
    s = serve_cluster.main(CLUSTER_ARGV, executor_cls=recorder)
    launches = hamming_pop.launches
    wall = time.perf_counter() - t0
    total = 2 * CLUSTER_IDENTITIES * CLUSTER_REPLICATES
    server = recorder.server
    line = {
        "path": "serve_cluster", "spectra": s["count"], "spectra_per_s":
        s["qps"], "qps": s["qps"], "p50_ms": s["p50_ms"],
        "p95_ms": s["p95_ms"],
        "batches": s["batches"], "buckets": s["buckets"],
        "launches": {"hamming_pop": launches},
        "tenants": {t: {k: q[k] for k in (
            "clusters", "spawned", "merges", "consolidations",
            "clustered_ratio", "incorrect_ratio")}
            for t, q in s["cluster_quality"].items()},
        "span_s": s["span_s"], "sleep_s": s["sleep_s"],
        "device_busy_s": s["device_busy_s"], "decide_s": s["decide_s"],
        "consolidate_s": s["consolidate_s"],
        "other_host_s": (s["span_s"] - s["sleep_s"] - s["device_busy_s"]
                         - s["decide_s"] - s["consolidate_s"]),
        "library_s": s["library_s"],
        "device_idle_share": s["device_idle_share"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "run_s": wall}
    print(json.dumps(line))
    SERVED["serve_cluster"] = line
    check(launches > 0, "hamming_pop never launched on the serve_cluster path")
    check(s["count"] == total, f"serve_cluster: served {s['count']} of {total}")

    # the same batches, in the same order, through clusterers whose
    # distance step is the plain version, on the card
    t0 = time.perf_counter()
    replay = {}
    differing = 0
    for tenant, hvs, want in recorder.batches:
        cl = replay.get(tenant)
        if cl is None:
            cl = replay[tenant] = StreamingClusterer(
                server.clustering, "cuda", hamming=hamming_pop_plain)
        c0, version = cl.num_clusters, cl.struct_version
        d = cl.snapshot_distances(hvs)
        got = cl.assign_batch(hvs, None if d is None else d.cpu().numpy(),
                              c0, version)
        differing += sum((a.cluster_id, a.spawned, a.distance)
                         != (b.cluster_id, b.spawned, b.distance)
                         for a, b in zip(got, want))
    same_state = all(replay[t].summary() == server.clusterers[t].summary()
                     for t in server.clusterers)
    print(f"serve_cluster: {len(recorder.batches)} recorded batches replayed "
          f"through the plain distance function on the card in "
          f"{time.perf_counter() - t0:.2f} s: {differing} differing "
          f"assignment entries, tenant summaries equal: {same_state}")
    check(differing == 0 and same_state,
          "serve_cluster differs from its plain-path replay")

    # the served shape: each bucket against the largest final centroid bank
    tenant = max(server.clusterers,
                 key=lambda t: server.clusterers[t].num_clusters)
    cl = server.clusterers[tenant]
    bank = cl.device_bank()
    C, W = bank.shape
    hv32 = next(h for t, h, _ in recorder.batches
                if t == tenant and len(h) == 32)
    q = bitpack_bipolar(torch.from_numpy(hv32).cuda())
    want = hamming_pop_plain(q, bank, dim=CLUSTER_DIM)
    got = hamming_pop(q, bank, dim=CLUSTER_DIM)
    max_abs_err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
    mismatches = int((got != want).sum())
    check(mismatches == 0, "hamming_pop differs from its plain version at "
                           "the served shape")
    ms = {n: time_ms(torch, lambda n=n: hamming_pop(q[:n], bank,
                                                     dim=CLUSTER_DIM),
                     iters=200, warmup=5) for n in (4, 8, 16, 32)}
    # the kernel alone: the same launches queued behind a device wait
    dev_ms = {n: 1e3 * sorted(burst_seconds(
        lambda n=n: hamming_pop(q[:n], bank, dim=CLUSTER_DIM),
        torch.device("cuda"), calls=200, iters=3))[1] for n in (4, 8, 16, 32)}
    plain_ms = time_ms(torch, lambda: hamming_pop_plain(q, bank,
                                                         dim=CLUSTER_DIM),
                       iters=5, warmup=1)
    # a served batch's distance step, whole and by piece: the events take
    # in the host's launch gaps between the small kernels
    pack_ms = time_ms(torch, lambda: bitpack_bipolar(
        torch.from_numpy(hv32).cuda()), iters=50, warmup=2)
    dist_ms = time_ms(torch, lambda: cross_distances(q, bank,
                                                     dim=CLUSTER_DIM),
                      iters=50, warmup=2)

    def served_step():
        cl._dirty.update(range(32))  # as after a batch that touched 32 rows
        return cl.snapshot_distances(hv32)

    step_ms = time_ms(torch, served_step, iters=50, warmup=2)
    print(f"serve_cluster: one served distance step (32 changed centroid "
          f"rows rewritten, the batch copied and packed, hamming_pop, the "
          f"float distances) {step_ms:.4f} ms; of it, copying and packing "
          f"32 HVs {pack_ms:.4f} ms and the distances from packed words "
          f"{dist_ms:.4f} ms")
    cent = torch.from_numpy(cl._cent.copy()).cuda()
    lib_ms, lib_shape = unpacked_int_mm_ms(
        torch, torch.from_numpy(hv32).cuda(), cent)
    ops = 2 * 32 * C * CLUSTER_DIM
    nbytes = (32 + C) * W * 4 + 32 * C * 4
    b_ms, b_by = bound_ms(ops, nbytes)
    print(f"serve_cluster: hamming_pop at the served shape against "
          f"{tenant}'s final {C} centroids ({W} words): by bucket (Q: ms) "
          f"{json.dumps(ms)} (with the host's issue hidden "
          f"{json.dumps(dev_ms)}), plain {plain_ms:.4f} ms, torch._int_mm on the "
          f"unpacked operands {lib_ms:.4f} ms (padded to {lib_shape}), "
          f"bound {b_ms:.6f} ms ({b_by}; {ops:.4g} int8 ops, {nbytes:.4g} "
          f"B) at Q=32; kernel vs plain: {mismatches} mismatches; sm "
          f"clock, power, limit: {nvidia_smi('clocks.sm,power.draw,power.limit')}")
    return {
        "name": "hamming_pop", "route": "cuda",
        "source": "src/repro_torch/csrc/hamming_pop.cu",
        "replaces": TPU_KERNELS["hamming_pop"], "launches": launches,
        "mismatches": mismatches, "max_abs_err": max_abs_err,
        "ms": ms[32], "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms,
        "shape": f"Q=32 x C={C}, W={W} (served)", "served_step_ms": step_ms,
        "device_ms": dev_ms[32],
    }


def phase_bucket(torch, np, entry):
    """One paper-average bucket batch-wise: the kernel's pairwise distances
    and complete linkage at 0.36 D, against the same pipeline over the
    plain distance function; adds the pairwise shape's numbers to the
    kernel's ``entry``."""
    from repro_torch.core import SpecPCMConfig, encode_and_pack
    from repro_torch.core.hd.clustering import (
        complete_linkage,
        pairwise_distances,
    )
    from repro_torch.core.hd.similarity import bitpack_bipolar
    from repro_torch.kernels.hamming_pop import hamming_pop, hamming_pop_plain
    from repro_torch.spectra import SyntheticMSConfig, generate_dataset

    n = CLUSTER_IDENTITIES * CLUSTER_REPLICATES
    ds = generate_dataset(SyntheticMSConfig(
        num_identities=CLUSTER_IDENTITIES,
        spectra_per_identity=CLUSTER_REPLICATES, num_bins=1024, seed=0),
        device="cuda")
    hv = encode_and_pack(ds.spectra, SpecPCMConfig(
        hd_dim=CLUSTER_DIM, mlc_bits=1, num_levels=16, ideal=True, seed=0))
    del ds
    words = bitpack_bipolar(hv)
    W = words.shape[1]
    thr = 0.36 * CLUSTER_DIM
    pair_mism = int((hamming_pop(words, words, dim=CLUSTER_DIM)
                     != hamming_pop_plain(words, words, dim=CLUSTER_DIM))
                    .sum())
    k_ms = time_ms(torch, lambda: hamming_pop(words, words, dim=CLUSTER_DIM),
                   iters=10, warmup=2)
    p_ms = time_ms(torch, lambda: hamming_pop_plain(words, words,
                                                     dim=CLUSTER_DIM),
                   iters=1, warmup=0)
    lib_ms, lib_shape = unpacked_int_mm_ms(torch, hv, hv)
    ops = 2 * n * n * CLUSTER_DIM
    nbytes = n * W * 4 + n * n * 4
    b_ms, b_by = bound_ms(ops, nbytes)
    results, linkage_s = {}, {}
    for name, fn in (("kernel", None), ("plain", hamming_pop_plain)):
        dist = pairwise_distances(words, dim=CLUSTER_DIM, hamming=fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = complete_linkage(dist, thr)
        torch.cuda.synchronize()
        linkage_s[name] = time.perf_counter() - t0
        results[name] = res
        del dist
    a, b = results["kernel"], results["plain"]
    same = (torch.equal(a.labels, b.labels) and a.num_merges == b.num_merges
            and a.num_clusters == b.num_clusters)
    print(f"bucket: N={n} (the paper's average precursor bucket), D="
          f"{CLUSTER_DIM}, threshold {thr:g}: hamming_pop pairwise "
          f"{k_ms:.4f} ms (Q=R={n}, W={W}; {pair_mism} mismatches against "
          f"its plain version), plain {p_ms:.2f} ms, "
          f"torch._int_mm on the unpacked operands {lib_ms:.4f} ms (padded "
          f"to {lib_shape}), bound {b_ms:.4f} ms ({b_by}; {ops:.4g} int8 "
          f"ops, {nbytes:.4g} B; {b_ms / k_ms:.1%} of it reached); "
          f"complete linkage {linkage_s['kernel']:.2f} s "
          f"(plain-distance run {linkage_s['plain']:.2f} s), "
          f"{a.num_merges} merges, {a.num_clusters} clusters; labels, "
          f"merges and clusters equal to the plain pipeline: {same}")
    check(pair_mism == 0, "hamming_pop differs from its plain version at "
                          "the pairwise shape")
    check(same, "linkage over kernel distances differs from the plain "
                "pipeline")
    entry.update(pairwise_ms=k_ms, pairwise_plain_ms=p_ms,
                 pairwise_mismatches=pair_mism,
                 pairwise_bound_ms=b_ms, pairwise_bound_by=b_by,
                 pairwise_library_ms=lib_ms,
                 pairwise_shape=f"Q=R={n}, W={W}",
                 linkage_s=linkage_s["kernel"], linkage_merges=a.num_merges)


# the flush-sync runs' summary lines, by path, for the continuous runs'
# side-by-side lines
SERVED: dict = {}
SERVED_PATHS = {"topk_hamming": "fused", "encode_search": "fused-e2e",
                "topk_hamming_banded": "oms fused",
                "encode_search_banded": "oms fused-e2e"}
# path -> (request id -> result, identifications) of phase 4's one-process
# runs, the yardstick of phase 9's mesh runs
ONE_PROCESS: dict = {}
# the continuous runs: two slots; 5% of each bank (a suffix of its targets
# and decoys) held out and appended halfway through the run
NUM_SLOTS, APPEND = 2, 0.05


def continuous_recorder(np, rows: int):
    """A ``SearchExecutor`` subclass for the continuous runs: keeps the
    server, counts the admissions that found another batch still in
    flight on the device (its ``ready`` event not yet fired), and keeps
    the first served batch of ``rows`` queries before the append and the
    first merged one (bank, delta, device batches, results, plan and the
    batch's padded precursors)."""
    from repro_torch.serve import SearchExecutor

    class Recording(SearchExecutor):
        server = None
        dispatches = overlapped = 0
        plain = merged = None

        def __init__(self, server):
            super().__init__(server)
            Recording.server = server
            self.outstanding = []

        def dispatch(self, reqs):
            busy = any(not h.ready.query() for h in self.outstanding
                       if h.ready is not None)
            h = super().dispatch(reqs)
            Recording.dispatches += 1
            Recording.overlapped += busy
            self.outstanding.append(h)
            if getattr(h, "n", 0) == rows:
                key = "plain" if h.delta is None else "merged"
                if getattr(Recording, key) is None:
                    prec = None
                    if h.plan is not None:
                        p = sorted(r.precursor for r in h.reqs)
                        prec = np.asarray(p + [p[-1]] * (h.batch.shape[0]
                                                         - h.n), np.float32)
                    setattr(Recording, key, dict(
                        db=h.db, delta=h.delta, batch=h.batch.clone(),
                        raw=None if h.raw is None else h.raw.clone(),
                        idx=h.idx.clone(), vals=h.vals.clone(), plan=h.plan,
                        prec=prec))
            return h

        def finalize(self, handle):
            self.outstanding.remove(handle)
            return super().finalize(handle)

    return Recording


def dispatch_without_sync(torch, server, submit, n: int, what: str) -> dict:
    """Submits ``n`` requests through ``submit(i)``, dispatches them as one
    batch under the sync debug mode "error" (a host synchronization
    raises), then finalizes it; returns the launches the dispatch made."""
    from repro_torch.launch import serve_db
    from repro_torch.kernels.hamming_pop import hamming_pop
    kernels = {**serve_db.KERNELS, "hamming_pop": hamming_pop}
    for i in range(n):
        submit(i)
    reqs = server.queue.take_batch()
    check(len(reqs) == n, f"{what}: took {len(reqs)} of {n} requests")
    torch.cuda.synchronize()
    before = {k: fn.launches for k, fn in kernels.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = server.executor.dispatch(reqs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    made = {k: fn.launches - before[k] for k, fn in kernels.items()
            if fn.launches - before[k]}
    live = server.executor.finalize(h)
    check(len(live) == n and all(r.result is not None for r in live),
          f"{what}: the dispatched batch did not finish")
    print(f"sync-free dispatch: {what}: {n} queries dispatched with no host "
          f"synchronization (sync debug mode \"error\"), launches {made}")
    return made


def random_queries(np, seed: int, n: int, levels: bool):
    """Fresh queries (query-HV cache misses): bipolar (D,) int8 HVs, or
    sparse (1,024,) levels for an encoder server."""
    rng = np.random.default_rng(seed)
    if levels:
        lev = rng.integers(0, 16, size=(n, 1024)).astype(np.int32)
        lev[rng.random(lev.shape) < 0.9] = 0
        return lev
    return rng.choice([-1, 1], size=(n, DIM)).astype(np.int8)


def timeit(fn) -> float:
    """Seconds one host call of ``fn`` takes."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def compact_timed(torch, server, tenant: str) -> tuple[float, float]:
    """Compacts ``tenant`` through the server's registry; returns (seconds,
    peak device GiB during it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check(server.banks.compact(tenant), f"nothing to compact for {tenant}")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def continuous_line(torch, s, path, recorder, launches, wall):
    line = {
        "path": path, "queries": s["count"], "qps": s["qps"],
        "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"],
        "identified_at_fdr": s.get("identified"),
        "batches": s["batches"], "buckets": s["buckets"],
        "scheduler": s["scheduler"], "launches": launches,
        "span_s": s["span_s"], "sleep_s": s["sleep_s"],
        "device_busy_s": s["device_busy_s"],
        "device_idle_share": s["device_idle_share"],
        "dispatches": recorder.dispatches,
        "admissions_with_another_batch_in_flight": recorder.overlapped,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "run_s": wall}
    return line


def side_by_side(flush: dict, cont: dict, what: str) -> None:
    keys = ("qps", "p50_ms", "p95_ms", "span_s", "sleep_s", "device_busy_s",
            "device_idle_share")
    print(f"{what}: flush-sync vs continuous ({NUM_SLOTS} slots), this call: "
          + ", ".join(f"{k} {flush.get(k)} / {cont.get(k)}" for k in keys))


def phase_serve_continuous(torch, np):
    """``serve_db --fused --continuous --num-slots 2 --append 0.05`` at full
    width: the pre-append and merged batches against the plain route, the
    compaction, the merged batch on the compacted bank, the delta scan
    alone, and one dispatch of each exact route with no host sync."""
    import gc

    from repro_torch.kernels.topk_hamming import topk_hamming
    from repro_torch.kernels.topk_hamming import topk_hamming_plain
    from repro_torch.launch import serve_db
    from repro_torch.serve import (
        BankRegistry,
        DBSearchServer,
        QueryEncoder,
        merged_search_encoded,
        search_database_encoded,
    )

    path = f"fused continuous, append {APPEND}"
    recorder = continuous_recorder(np, MAX_BATCH)
    argv = ["--hd-dim", str(DIM), "--identities", str(IDENTITIES),
            "--refs-per-identity", str(REPLICATES), "--queries",
            str(QUERIES), "--k", str(K), "--max-batch", str(MAX_BATCH),
            "--device", "cuda", "--fused", "--continuous", "--num-slots",
            str(NUM_SLOTS), "--append", str(APPEND)]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for fn in serve_db.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    s = serve_db.main(argv, executor_cls=recorder)
    launches = {n: fn.launches for n, fn in serve_db.KERNELS.items()}
    wall = time.perf_counter() - t0
    line = continuous_line(torch, s, path, recorder, launches, wall)
    line.update(append_rows=s["append_rows"], append_s=s["append_s"],
                delta_rows=s["banks"]["delta_rows"])
    print(json.dumps(line))
    check(launches["topk_hamming"] > 0,
          f"topk_hamming never launched on the {path} path")
    check(s["count"] == QUERIES, f"{path}: served {s['count']} of {QUERIES}")
    check(s["mode"] == "continuous" and s["banks"]["appends"] == 1,
          f"{path}: not a continuous run with one append")
    check(recorder.plain is not None and recorder.merged is not None,
          f"{path}: no pre-append or merged batch of {MAX_BATCH}")
    side_by_side(SERVED["fused"], line, "fused")
    server = recorder.server

    # the pre-append batch against the plain route on its own bank
    p = recorder.plain
    want = topk_hamming_plain(p["batch"], p["db"].data, dim=DIM, k=K,
                              num_valid=p["db"].num_rows)
    pre_diff = int((want[0] != p["idx"]).sum() + (want[1] != p["vals"]).sum())

    # the merged route: one topk_hamming launch on the base and one on the
    # int8 delta, with no host sync; then the delta scan alone
    m = recorder.merged
    delta = m["delta"]
    made = dispatch_without_sync(
        torch, server, lambda i, q=random_queries(np, 11, MAX_BATCH, False):
        server.submit(q[i], tenant="tenant0"), MAX_BATCH,
        "merged exact (base + delta, query-HV cache misses)")
    check(made.get("topk_hamming") == 2,
          f"the merged exact route launched {made} (want topk_hamming on "
          f"the base and on the delta)")
    d_rows = delta.db.data
    d_ms = time_ms(torch, lambda: topk_hamming(m["raw"], d_rows, dim=DIM,
                                               k=K), iters=20, warmup=2)
    d_plain = time_ms(torch, lambda: topk_hamming_plain(
        m["raw"], d_rows, dim=DIM, k=K), iters=2, warmup=1)
    d_got = topk_hamming(m["raw"], d_rows, dim=DIM, k=K)
    d_want = topk_hamming_plain(m["raw"], d_rows, dim=DIM, k=K)
    d_mism = int((d_got[0] != d_want[0]).sum() + (d_got[1] != d_want[1]).sum())
    d_bound, d_by = bound_ms(2 * MAX_BATCH * d_rows.shape[0] * DIM,
                             d_rows.numel() + m["raw"].numel()
                             + 2 * MAX_BATCH * K * 4)
    # the merged route on the card (base scan, delta scan, row maps,
    # merge) beside the base route alone
    merged_ms = time_ms(torch, lambda: merged_search_encoded(
        m["db"], delta, m["batch"], m["raw"], K), iters=20, warmup=2)
    base_ms = time_ms(torch, lambda: search_database_encoded(
        m["db"], m["batch"], K), iters=20, warmup=2)

    # compaction through the server's registry, then the merged batch on
    # the compacted bank: the kernel and the plain route must both equal
    # the merged result
    comp_s, comp_peak = compact_timed(torch, server, "tenant0")
    rebuilt = server.banks.get("tenant0")
    plain = topk_hamming_plain(m["batch"], rebuilt.data, dim=DIM, k=K,
                               num_valid=rebuilt.num_rows)
    kern = search_database_encoded(rebuilt, m["batch"], K)
    merged_diff = int((plain[0] != m["idx"]).sum()
                      + (plain[1] != m["vals"]).sum())
    compacted_diff = int((kern[0] != m["idx"]).sum()
                         + (kern[1] != m["vals"]).sum())
    print(f"{path}: pre-append batch of {MAX_BATCH} vs the plain route: "
          f"{pre_diff} differing entries; merged batch of {MAX_BATCH} "
          f"(base {m['db'].num_rows} + delta {delta.num_rows} rows: "
          f"{delta.num_targets} refs + {delta.num_decoys} decoys, "
          f"{d_rows.numel() / 1e6:.1f} MB of int8 rows) vs the plain route "
          f"on the rebuilt bank: {merged_diff}; the compacted bank through "
          f"the kernel vs the merged result: {compacted_diff}; compaction "
          f"of tenant0 {comp_s:.3f} s, peak device memory during it "
          f"{comp_peak:.2f} GiB, run peak {line['peak_memory_gib']:.2f} GiB; "
          f"the delta scan alone (topk_hamming, int8, Q={MAX_BATCH}, R="
          f"{d_rows.shape[0]}) {d_ms:.4f} ms, plain {d_plain:.2f} ms, bound "
          f"{d_bound:.4f} ms ({d_by}), kernel vs plain {d_mism} mismatches; "
          f"the merged route {merged_ms:.4f} ms against the base route "
          f"alone {base_ms:.4f} ms; sm clock, power, limit: "
          f"{nvidia_smi('clocks.sm,power.draw,power.limit')}")
    check(pre_diff == 0, f"{path}: the pre-append batch differs")
    check(merged_diff == 0, f"{path}: the merged batch differs from the "
                            f"plain route on the rebuilt bank")
    check(compacted_diff == 0, f"{path}: the compacted bank differs from "
                               f"the merged result")
    check(d_mism == 0, "topk_hamming on the int8 delta differs from its "
                       "plain version")
    check(server.banks.delta("tenant0") is None, "the delta survived")

    # the exact routes with no delta: encoded with cache misses, and
    # fused-e2e (an encoder server on the compacted bank)
    dispatch_without_sync(
        torch, server, lambda i, q=random_queries(np, 12, MAX_BATCH, False):
        server.submit(q[i], tenant="tenant0"), MAX_BATCH,
        "encoded, query-HV cache misses (compacted bank)")
    reg = BankRegistry(fused=True)
    reg.adopt("tenant0", rebuilt)
    enc = QueryEncoder.from_config(dim=DIM, num_features=1024,
                                   num_levels=16, seed=0, device="cuda")
    e2e = DBSearchServer(reg, k=K, max_batch_size=MAX_BATCH, encoder=enc,
                         fused_e2e=True, continuous=True, buckets=4)
    warm = random_queries(np, 13, MAX_BATCH, True)
    for q in warm:
        e2e.submit(q, tenant="tenant0")
    e2e.run_until_drained()
    made = dispatch_without_sync(
        torch, e2e, lambda i, q=random_queries(np, 14, MAX_BATCH, True):
        e2e.submit(q[i], tenant="tenant0"), MAX_BATCH, "fused-e2e")
    check(made.get("encode_search") == 1, f"fused-e2e launched {made}")
    line.update(pre_append_diff=pre_diff, merged_diff=merged_diff,
                compacted_diff=compacted_diff, compaction_s=comp_s,
                compaction_peak_gib=comp_peak, delta_scan_ms=d_ms,
                merged_route_ms=merged_ms, base_route_ms=base_ms,
                delta_scan_plain_ms=d_plain, delta_scan_bound_ms=d_bound)
    return line


def phase_serve_continuous_oms(torch, np):
    """``serve_db --oms --fused --fused-e2e --continuous --num-slots 2
    --append 0.05`` (``--fused`` makes the merged batches search the
    packed base through the banded kernel too): the merged batch against
    the unfused masked route on the rebuilt bank, the merged plan's
    fractions, and one dispatch of each OMS route with no host sync."""
    import gc

    from repro_torch.launch import serve_db
    from repro_torch.serve import (
        DBSearchServer,
        merged_oms_plan,
        merged_oms_search_encoded,
        oms_plan,
        oms_search_encoded,
    )

    path = f"oms fused + fused-e2e continuous, append {APPEND}"
    recorder = continuous_recorder(np, MAX_BATCH)
    argv = ["--hd-dim", str(DIM), "--identities", str(IDENTITIES),
            "--refs-per-identity", str(REPLICATES), "--queries",
            str(QUERIES), "--k", str(K), "--max-batch", str(MAX_BATCH),
            "--device", "cuda", "--oms", "--fused", "--fused-e2e",
            "--continuous", "--num-slots", str(NUM_SLOTS), "--append",
            str(APPEND)]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for fn in serve_db.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    s = serve_db.main(argv, executor_cls=recorder)
    launches = {n: fn.launches for n, fn in serve_db.KERNELS.items()}
    wall = time.perf_counter() - t0
    line = continuous_line(torch, s, path, recorder, launches, wall)
    line.update({key: s["oms"][key] for key in (
        "candidate_fraction", "scanned_fraction", "no_candidate")})
    m = recorder.merged
    check(m is not None and recorder.plain is not None,
          f"{path}: no pre-append or merged batch of {MAX_BATCH}")
    line.update(merged_candidate_fraction=m["plan"].candidate_fraction,
                merged_scanned_fraction=m["plan"].scanned_fraction,
                delta_rows=m["delta"].num_rows)
    print(json.dumps(line))
    for kernel in ("encode_search_banded", "topk_hamming_banded"):
        check(launches[kernel] > 0, f"{kernel} never launched on the "
                                    f"{path} path")
    check(s["count"] == QUERIES, f"{path}: served {s['count']} of {QUERIES}")
    side_by_side(SERVED["oms fused-e2e"], line, "oms fused-e2e")
    server = recorder.server
    # the host's planning of one batch: the merged plan (base, delta and
    # merged ranges) against the base plan alone
    plan_ms = {name: 1e3 * min(timeit(fn) for _ in range(5)) for name, fn in (
        ("merged", lambda: merged_oms_plan(m["db"], m["delta"], m["prec"],
                                           server.oms)),
        ("base", lambda: oms_plan(m["db"], m["prec"], server.oms)))}
    # the merged route's device pieces: the staged encode (levels of about
    # the served sparsity), each side's banded search, the whole route
    from repro_torch.serve.db_search import _oms_search_inner, _plan_bands
    mp, delta = m["plan"], m["delta"]
    lev_host = random_queries(np, 27, MAX_BATCH, True)
    lev = torch.from_numpy(lev_host).cuda()
    base_bands = _plan_bands(m["db"], mp.base)
    delta_bands = _plan_bands(delta.db, mp.delta)
    pieces = {
        "staged encode": lambda: server._encode_levels(lev, lev_host),
        "base banded search": lambda: _oms_search_inner(
            m["db"], m["batch"], mp.base, K, base_bands),
        "delta banded search (int8)": lambda: _oms_search_inner(
            delta.db, m["raw"], mp.delta, K, delta_bands),
        "merged route": lambda: merged_oms_search_encoded(
            m["db"], delta, m["batch"], m["raw"], mp, K)}
    piece_ms = {name: time_ms(torch, fn, iters=20, warmup=2)
                for name, fn in pieces.items()}
    print(f"{path}: host planning of one batch of {MAX_BATCH}: merged plan "
          f"{plan_ms['merged']:.3f} ms, the base plan alone "
          f"{plan_ms['base']:.3f} ms; the merged batch on the card (ms): "
          f"{json.dumps(piece_ms)}")
    line.update(merged_plan_ms=plan_ms["merged"], base_plan_ms=plan_ms["base"],
                merged_piece_ms=piece_ms)

    made = dispatch_without_sync(
        torch, server, lambda i, q=random_queries(np, 21, MAX_BATCH, True),
        p=np.random.default_rng(22).uniform(400, 1600, MAX_BATCH):
        server.submit(q[i], tenant="tenant0", precursor=float(p[i])),
        MAX_BATCH, "merged OMS (staged encode, base + delta)")
    check(made.get("topk_hamming_banded") == 2,
          f"the merged OMS route launched {made} (want topk_hamming_banded "
          f"on the base and on the delta)")
    comp_s, comp_peak = compact_timed(torch, server, "tenant0")
    rebuilt = server.banks.get("tenant0")
    plan = oms_plan(rebuilt, m["prec"], server.oms)
    same_plan = bool((plan.starts == m["plan"].starts).all()
                     and (plan.lens == m["plan"].lens).all())
    import dataclasses
    want = oms_search_encoded(dataclasses.replace(rebuilt, fused=False),
                              m["batch"], plan, K)
    merged_diff = int((want[0] != m["idx"]).sum()
                      + (want[1] != m["vals"]).sum())
    print(f"{path}: merged batch of {MAX_BATCH} (base {m['db'].num_rows} + "
          f"delta {m['delta'].num_rows} rows; merged candidate fraction "
          f"{m['plan'].candidate_fraction:.4f}, scanned fraction "
          f"{m['plan'].scanned_fraction:.4f}) vs the unfused masked route on "
          f"the rebuilt bank: {merged_diff} differing entries, plans equal: "
          f"{same_plan}; compaction {comp_s:.3f} s, peak during it "
          f"{comp_peak:.2f} GiB, run peak {line['peak_memory_gib']:.2f} GiB")
    check(same_plan and merged_diff == 0,
          f"{path}: the merged batch differs from the rebuilt bank's route")
    dispatch_without_sync(
        torch, server, lambda i, q=random_queries(np, 23, MAX_BATCH, True),
        p=np.random.default_rng(24).uniform(400, 1600, MAX_BATCH):
        server.submit(q[i], tenant="tenant0", precursor=float(p[i])),
        MAX_BATCH, "OMS fused-e2e (compacted bank)")
    enc_server = DBSearchServer(server.banks, k=K, max_batch_size=MAX_BATCH,
                                oms=server.oms, continuous=True, buckets=4)
    dispatch_without_sync(
        torch, enc_server,
        lambda i, q=random_queries(np, 25, MAX_BATCH, False),
        p=np.random.default_rng(26).uniform(400, 1600, MAX_BATCH):
        enc_server.submit(q[i], tenant="tenant0", precursor=float(p[i])),
        MAX_BATCH, "OMS encoded, query-HV cache misses")
    line.update(merged_diff=merged_diff, compaction_s=comp_s,
                compaction_peak_gib=comp_peak)
    return line


def continuous_cluster_recorder():
    """A ``SearchExecutor`` subclass that logs the clustering run's
    dispatches (HVs, snapshot size, structure version) and finalizes
    (assignments) in the order they happened, and counts the admissions
    that found another batch still in flight."""
    from repro_torch.serve import SearchExecutor

    class Recording(SearchExecutor):
        server = None
        events = []
        dispatches = overlapped = 0

        def __init__(self, server):
            super().__init__(server)
            Recording.server = server
            self.outstanding = []

        def _dispatch_cluster(self, reqs, tenant):
            busy = any(not h.ready.query() for h in self.outstanding
                       if h.ready is not None)
            h = super()._dispatch_cluster(reqs, tenant)
            Recording.dispatches += 1
            Recording.overlapped += busy
            self.outstanding.append(h)
            Recording.events.append(("dispatch", id(h), tenant,
                                     h.hvs.copy(), h.n, h.c0,
                                     h.struct_version))
            return h

        def _finalize_cluster(self, handle):
            self.outstanding.remove(handle)
            live = super()._finalize_cluster(handle)
            Recording.events.append(("finalize", id(handle),
                                     [r.result for r in handle.reqs]))
            return live

    return Recording


def phase_serve_cluster_continuous(torch, np):
    """``serve_cluster --continuous --num-slots 2`` on phase 5's streams,
    replayed in its recorded interleaving of dispatches and finalizes
    through clusterers on the plain distance function."""
    import gc

    from repro_torch.kernels.hamming_pop import hamming_pop, hamming_pop_plain
    from repro_torch.launch import serve_cluster
    from repro_torch.serve import StreamingClusterer

    recorder = continuous_cluster_recorder()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    hamming_pop.launches = 0
    t0 = time.perf_counter()
    s = serve_cluster.main(CLUSTER_ARGV + ["--continuous", "--num-slots",
                                           str(NUM_SLOTS)],
                           executor_cls=recorder)
    launches = hamming_pop.launches
    wall = time.perf_counter() - t0
    total = 2 * CLUSTER_IDENTITIES * CLUSTER_REPLICATES
    line = continuous_line(torch, s, "serve_cluster continuous", recorder,
                           {"hamming_pop": launches}, wall)
    line.update(decide_s=s["decide_s"], consolidate_s=s["consolidate_s"],
                tenants={t: {k: q[k] for k in (
                    "clusters", "spawned", "merges", "consolidations",
                    "clustered_ratio", "incorrect_ratio")}
                    for t, q in s["cluster_quality"].items()})
    print(json.dumps(line))
    check(launches > 0, "hamming_pop never launched on the continuous "
                        "serve_cluster path")
    check(s["count"] == total, f"serve_cluster continuous: served "
                               f"{s['count']} of {total}")
    side_by_side(SERVED["serve_cluster"], line, "serve_cluster")
    server = recorder.server
    t0 = time.perf_counter()
    replay, pending = {}, {}
    differing = bad_snapshots = 0
    for ev in recorder.events:
        if ev[0] == "dispatch":
            _, hid, tenant, hvs, n, c0, version = ev
            cl = replay.get(tenant)
            if cl is None:
                cl = replay[tenant] = StreamingClusterer(
                    server.clustering, "cuda", hamming=hamming_pop_plain)
            bad_snapshots += (cl.num_clusters, cl.struct_version) != (
                c0, version)
            d = cl.snapshot_distances(hvs)
            pending[hid] = (tenant, hvs[:n], None if d is None
                            else d[:n].cpu().numpy(), c0, version)
        else:
            _, hid, want = ev
            tenant, hvs, d, c0, version = pending.pop(hid)
            got = replay[tenant].assign_batch(hvs, d, c0, version)
            differing += sum((a.cluster_id, a.spawned, a.distance)
                             != (b.cluster_id, b.spawned, b.distance)
                             for a, b in zip(got, want))
    same_state = all(replay[t].summary() == server.clusterers[t].summary()
                     for t in server.clusterers)
    n_batches = sum(ev[0] == "finalize" for ev in recorder.events)
    print(f"serve_cluster continuous: {n_batches} batches replayed in their "
          f"recorded interleaving of dispatches and finalizes through the "
          f"plain distance function on the card in "
          f"{time.perf_counter() - t0:.2f} s: {differing} differing "
          f"assignment entries, {bad_snapshots} dispatches whose snapshot "
          f"(clusters, structure version) differs, tenant summaries equal: "
          f"{same_state}")
    check(differing == 0 and bad_snapshots == 0 and same_state,
          "continuous serve_cluster differs from its interleaved replay")
    made = dispatch_without_sync(
        torch, server,
        lambda i, q=random_queries(np, 31, MAX_BATCH, False):
        server.submit_cluster(q[i][:CLUSTER_DIM], tenant="tenant0"),
        MAX_BATCH, "clustering")
    check(made.get("hamming_pop") == 1, f"clustering launched {made}")
    line.update(replay_differing=differing)
    return line


# the LM serving configuration: Qwen2-7B at full width and depth (28
# layers, d_model 3,584, 28 query heads over 4 KV heads, head_dim 128,
# d_ff 18,944, vocab 152,064), bfloat16, int8 KV store, the port's seeded
# parameters; the reference's decode_32k shape (batch 128 x 32,768) is
# cut to what one card holds
LM_BATCH, LM_PROMPT, LM_GEN = 32, 1024, 64
LM_ARGV = ["--arch", "qwen2_7b", "--kv-quant", "--batch", str(LM_BATCH),
           "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN),
           "--device", "cuda"]
# teacher-forced replay on the plain attention: per step, max |logits
# difference| at most this share of the step's largest |logit|. The
# kernel and the plain version agree to float32 rounding, but the
# attention output is rounded to bfloat16 and one changed rounding moves
# every later bfloat16 activation of the step through 28 residual layers.
LM_REPLAY_SHARE = 2.0 ** -4
# the banded knob's values (blocks per SM), each timed at every bucket
BANDED_WAVES = (1, 2, 4, 8, 16)
# hd_encode's buckets and block_d values, each timed at every bucket
HD_ENCODE_BUCKETS = (4, 8, 16, 32)
HD_ENCODE_BLOCK_D = (256, 512, 1024, 2048, 8192)
# split counts timed beside the split rule's at the served shape
SPLIT_SWEEP = (1, 2, 4, 6, 9)


def profile_device_ms(torch, fn, steps):
    """Device milliseconds per ``fn()`` (every kernel, copy and fill the
    profiler traced over ``steps`` calls), the eight largest by kernel
    name, and per call by name the device milliseconds and operations;
    ``(None, {}, {}, {})`` when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    per, count = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            # kernels whose names share their first 60 characters (the
            # templated elementwise kernels) add up under one key
            k = e.key[:60]
            per[k] = per.get(k, 0.0) + us / 1e3 / steps
            count[k] = count.get(k, 0.0) + e.count / steps
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:8])
    return (sum(per.values()) or None), top, per, count


def phase_serve_lm(torch, np):
    """Qwen2-7B decode serving with the int8 KV store through
    ``repro_torch.launch.serve.main``; returns the ``decode_attention``
    kernel entry."""
    import gc

    import torch.nn.functional as nnf

    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.kernels.decode_attention.ops import _launch as launch_split
    from repro_torch.kernels.decode_attention.ops import (
        decode_splits,
        split_plan,
    )
    from repro_torch.launch import serve
    from repro_torch.train.serve_step import make_decode_step
    from repro_torch.tune.microbench import burst_seconds

    gc.collect()
    torch.cuda.empty_cache()
    decode_attention.launches = 0
    decode_attention_plain.calls = 0
    t0 = time.perf_counter()
    run = serve.main(LM_ARGV, keep_logits=True)
    wall = time.perf_counter() - t0
    launches = decode_attention.launches
    plain_calls = decode_attention_plain.calls
    cfg, model, params = run.model.cfg, run.model, run.params
    steps = LM_GEN - 1
    B, S = run.batch["tokens"].shape
    check(launches == cfg.num_layers * steps,
          f"decode_attention launched {launches} times, not "
          f"{cfg.num_layers} layers x {steps} steps")
    check(run.launches == launches, "the launcher's launch count differs")
    check(plain_calls == 0, f"the plain decode attention ran {plain_calls} "
                            f"times on the card's main path")
    check(tuple(run.tokens.shape) == (B, LM_GEN)
          and int(run.tokens.min()) >= 0
          and int(run.tokens.max()) < cfg.padded_vocab,
          "generated tokens out of shape or range")
    check(all(bool(torch.isfinite(lg).all()) for lg in run.logits),
          "non-finite decode logits")

    # teacher-forced replay: the same prompt and the served tokens, with
    # the plain decode attention on the card
    decode = make_decode_step(model)
    rep = replay_decode(torch, run, LM_GEN, decode_attention_plain)
    cache, prefill_agree = rep["cache"], rep["prefill_agree"]
    max_diff, share = rep["max_diff"], rep["share"]
    disagree, unexplained = sum(rep["disagree"]), sum(rep["unexplained"])
    check(plain_calls == 0 and decode_attention_plain.calls
          == cfg.num_layers * steps, "the replay did not run the plain "
                                     "decode attention")
    print(json.dumps({
        "path": "lm replay", "steps": steps, "tokens": B * steps,
        "prefill_tokens_agreeing": prefill_agree,
        "greedy_tokens_disagreeing": disagree,
        "disagreements_not_near_ties": unexplained,
        "max_abs_dlogits_per_step": max_diff,
        "worst_share_of_max_logit": max(share),
        "tolerance_share": LM_REPLAY_SHARE}))
    check(max(share) <= LM_REPLAY_SHARE, "decode logits on the kernel differ "
                                         "from the plain replay past the "
                                         "stated tolerance")
    check(unexplained == 0, "a greedy token differs from the plain replay "
                            "where the logits are not near a tie")
    check(prefill_agree == B, "the prefill's greedy tokens are not "
                              "reproducible")

    # the decode loop reads nothing back: one step under the sync debug
    # mode "error" raises at any synchronizing call
    last = S + steps - 1
    tok = run.tokens[:, steps - 1:steps]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode(params, tok, cache, last)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the device's share of a decode step: the kernels' device time over
    # three steps (torch.profiler; a step's ~2,000 launches overflow the
    # launch queue, so it cannot be queued whole behind a device wait)
    # against the served step, host issue included
    device_step_ms, top, per_kernel, count = profile_device_ms(
        torch, lambda: decode(params, tok, cache, last), steps=3)
    # one decode_attention kernel a layer: the splits merge in the launch
    c = cache[0]
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    G = cfg.num_heads // KV
    size = c.k.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, per = split_plan(size, decode_splits(B, KV, size, sms))
    attention_kernels = sum(v for k, v in count.items()
                            if "decode_attention_kernel" in k)
    print(json.dumps({
        "path": "lm decode step", "decode_attention_splits": splits,
        "positions_per_split": per, "grid_blocks": splits * KV * B,
        "device_ops_per_step": sum(count.values()),
        "decode_attention_kernels_per_step": attention_kernels,
        "decode_attention_device_ms_per_step": sum(
            v for k, v in per_kernel.items()
            if "decode_attention_kernel" in k)}))
    check(device_step_ms is None or attention_kernels == cfg.num_layers,
          f"a decode step ran {attention_kernels} decode_attention kernels, "
          f"not one per layer ({cfg.num_layers})")
    p50, p95 = run.step_percentile_ms(0.5), run.step_percentile_ms(0.95)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    print(json.dumps({
        "path": "lm serve", "arch": cfg.name, "layers": cfg.num_layers,
        "batch": B, "prompt": S, "gen": LM_GEN, "kv_cache": "int8",
        "wall_s": wall, "prefill_s": run.prefill_s,
        "decode_s": run.decode_s, "decode_ms_p50": p50,
        "decode_ms_p95": p95, "decode_tokens_per_s": run.decode_tokens_per_s,
        "device_step_ms": device_step_ms,
        "device_share_of_decode_step": (None if device_step_ms is None
                                        else device_step_ms / p50),
        "device_ms_per_step_by_kernel": top,
        "peak_gb": run.peak_bytes / 1e9,
        "weight_gb": weight_bytes / 1e9,
        "weight_read_bound_ms": 1e3 * weight_bytes / HBM_BYTES_PER_S,
        "launches": launches, "sm clock, power, limit":
            nvidia_smi("clocks.sm,power.draw,power.limit")}))

    # the kernel at the served shape, on layer 0's filled cache
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, KV, G, hd), generator=g, device="cuda") * hd ** -0.5
    ops = (q, c.k, c.v, c.k_scale, c.v_scale)
    timed = {}
    for vl in (S + 1, size):
        got = decode_attention(*ops, vl)
        want = decode_attention_plain(*ops, vl)
        bad = close_count(torch, got, want, DECODE_RTOL, DECODE_ATOL)
        err = float((got - want).abs().max())
        check(bad == 0, f"decode_attention differs from its plain version "
                        f"on the served cache at valid_len {vl}")
        ms = time_ms(torch, lambda vl=vl: decode_attention(*ops, vl),
                     iters=200, warmup=10)
        dev_ms = 1e3 * sorted(burst_seconds(
            lambda vl=vl: decode_attention(*ops, vl), torch.device("cuda"),
            calls=200, iters=3))[1]
        plain_ms = time_ms(torch, lambda vl=vl: decode_attention_plain(
            *ops, vl), iters=5, warmup=1)
        # the yardstick: one SDPA call (GQA, boolean mask of the valid
        # positions) over the dequantized float32 K/V, dequant not timed
        kf = (c.k.float() * c.k_scale[..., None]).transpose(1, 2)
        vf = (c.v.float() * c.v_scale[..., None]).transpose(1, 2)
        qh = q.reshape(B, KV * G, 1, hd)
        mask = (torch.arange(size, device="cuda") < vl)[None, None, None]

        def sdpa():
            return nnf.scaled_dot_product_attention(
                qh, kf, vf, attn_mask=mask, scale=1.0, enable_gqa=True)

        lib_err = float((sdpa().reshape(B, KV, G, hd) - got).abs().max())
        lib_ms = time_ms(torch, sdpa, iters=200, warmup=10)
        del kf, vf
        nbytes = (2 * B * vl * KV * hd + 2 * 4 * B * vl * KV
                  + 2 * 4 * B * KV * G * hd)
        flops = 4 * B * KV * G * hd * vl
        b_ms, b_by = bound_ms(flops, nbytes, FP32_OPS_PER_S)
        timed[vl] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                         library_max_abs_err=lib_err, bytes=nbytes,
                         flops=flops)
        print(f"lm: decode_attention at B={B}, S={size}, KV={KV}, G={G}, "
              f"hd={hd}, valid_len {vl}: {ms:.4f} ms (200 launches; "
              f"{dev_ms:.4f} ms with the host's issue hidden), plain "
              f"{plain_ms:.4f} ms, SDPA over dequantized float32 K/V "
              f"{lib_ms:.4f} ms (max |diff| {lib_err:.3g}), bound "
              f"{b_ms:.5f} ms ({b_by}; {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP float32); kernel vs plain max "
              f"|err| {err:.3g}; sm clock, power, limit: "
              f"{nvidia_smi('clocks.sm,power.draw,power.limit')}")
    # the split rule's neighbours: the same launch at other split counts
    sweep = {}
    for n in SPLIT_SWEEP:
        got = launch_split(*ops, size, n)
        bad = close_count(torch, got, decode_attention_plain(*ops, size),
                          DECODE_RTOL, DECODE_ATOL)
        check(bad == 0, f"decode_attention at {n} splits differs from its "
                        f"plain version")
        sweep[n] = 1e3 * sorted(burst_seconds(
            lambda n=n: launch_split(*ops, size, n),
            torch.device("cuda"), calls=200, iters=3))[1]
    print(f"lm: decode_attention at valid_len {size} by split count, with "
          f"the host's issue hidden (the rule picks {splits} of {per} "
          f"positions: {timed[size]['device_ms']:.4f} ms; splits: ms) "
          f"{json.dumps(sweep)}")
    served = timed[size]
    entry = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": TPU_KERNELS["decode_attention"], "launches": launches,
        "max_abs_err": served["max_abs_err"], "ms": served["ms"],
        "device_ms": served["device_ms"],
        "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"], "library_ms": served["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   "(enable_gqa, boolean mask) over dequantized float32 K/V",
        "shape": f"B={B}, S={size}, KV={KV}, G={G}, hd={hd}, valid_len "
                 f"{size} (Qwen2-7B decode, last step)",
        "splits": splits, "positions_per_split": per,
        "at_valid_len": {str(k): v for k, v in timed.items()},
        "ms_by_splits": {str(k): v for k, v in sweep.items()}}
    del run, params, cache, rep, ops, c, q
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def replay_decode(torch, run, gen: int, attend) -> dict:
    """Teacher-forced replay of a served run on the card: the same prompt,
    then each served token decoded with ``attend`` (the plain decode
    attention, or the kernel to check determinism). Returns the replay's
    cache, how many rows' prefill greedy token agrees, and per step the max |logits difference| over the
    served logits, its share of the step's largest |logit|, the greedy
    tokens that differ and those of them that are not near ties (the
    served logits of the two tokens further apart than twice the row's
    difference)."""
    from repro_torch.train.serve_step import make_decode_step, make_prefill

    model, params = run.model, run.params
    B = run.batch["tokens"].shape[0]
    prefill, decode = make_prefill(model), make_decode_step(model)
    cache = model.init_cache(B, run.cache_len)
    logits, cache = prefill(params, run.batch, cache)
    out = {"prefill_agree": int((logits.argmax(-1).to(torch.int32)
                                 == run.tokens[:, :1]).sum()),
           "max_diff": [], "share": [], "disagree": [], "unexplained": []}
    for i in range(gen - 1):
        lp, cache = decode(params, run.tokens[:, i:i + 1], cache,
                           run.start + i, attend)
        served = run.logits[i]
        diff = (lp - served).abs().amax(dim=(1, 2))           # per row
        out["max_diff"].append(float(diff.max()))
        out["share"].append(out["max_diff"][-1]
                            / float(served.abs().max()))
        replay_tok = lp.argmax(-1)[:, 0]
        served_tok = run.tokens[:, i + 1].long()
        off = replay_tok != served_tok
        out["disagree"].append(int(off.sum()))
        unexplained = 0
        if bool(off.any()):
            sv = served[:, 0]
            rows = off.nonzero()[:, 0]
            gap = (sv[rows, served_tok[rows]] - sv[rows, replay_tok[rows]])
            unexplained = int((gap > 2 * diff[rows]).sum())
        out["unexplained"].append(unexplained)
    out["cache"] = cache
    return out


# phase 7b: decode serving of the other decoder-only configs at published
# widths, bfloat16, int8 KV store, batch 32 x (512 + LM_CONFIGS_GEN); the
# depth is cut only where the bfloat16 weights would not fit the card
# (llama4: ~2.2 G parameters a layer, ~216 GB at 48 layers)
LM_CONFIGS = (("gemma_7b", None), ("granite_20b", None),
              ("granite_34b", None), ("deepseek_moe_16b", None),
              ("llama4_scout_17b_a16e", 14))
LM_CONFIGS_BATCH, LM_CONFIGS_PROMPT, LM_CONFIGS_GEN = 32, 512, 16
# MoE replays. The routing is hypersensitive to rounding: a bfloat16
# difference in one attention output flips near-tied top-k choices, a flip
# changes which other tokens the small decode capacity drops, and a token
# routed elsewhere carries a different hidden state into every later
# layer: in a free-running plain replay far more than 1% of the decode
# decisions differ (PERF.md). So the served run is held three
# ways: a replay on the kernel must route and score exactly as it did
# (determinism); a replay on the plain attention with the served routing
# forced must give its logits within LM_REPLAY_SHARE on every step (the
# kernel through the whole MoE model); and the decisions that differ in
# the free-running plain replay and in the forced replay's own routing
# are counted and printed beside MOE_ROUTING_EXPECTED, the share expected
# before it was measured (not a pass / fail limit).
MOE_ROUTING_EXPECTED = 0.01


def moe_route_recorder(layers_mod, sink: list, forced=None,
                       data_rank: int = 0):
    """A patch of ``models.layers.moe_route`` that calls the real routing
    and appends each call's route to ``sink`` (on the device, no
    read-back). With ``forced`` (the routes of another run, in call
    order) each call returns that run's experts, positions and kept mask
    instead, weighted by this run's own gates at those experts; on a mesh
    rank that holds a block of the groups, the block of ``data_rank``."""
    real = layers_mod.moe_route
    order = iter(forced or ())

    def recording(router, xt, cfg, cap):
        r = real(router, xt, cfg, cap)
        sink.append(r)
        if forced is None:
            return r
        f = next(order)
        g = xt.shape[0]
        expert, pos, keep = (
            (t if t.shape[0] == g else t[data_rank * g:(data_rank + 1) * g]
             ).to(xt.device) for t in (f.expert, f.pos, f.keep))
        gates = (xt.float() @ router.float()).softmax(dim=-1)
        topv = gates.gather(-1, expert)
        weight = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
        return layers_mod.MoERoute(weight=weight, expert=expert, pos=pos,
                                   keep=keep)

    return mock.patch.object(layers_mod, "moe_route", recording)


def routing_differs(torch, a: list, b: list, skip: int, shape):
    """(steps, layers, tokens) bool: the decode routings of two runs (after
    the first ``skip`` calls, the prefill's) that differ in a token's
    experts or kept mask."""
    return torch.stack([((x.expert != y.expert) | (x.keep != y.keep))
                        .any(-1).reshape(-1)
                        for x, y in zip(a[skip:], b[skip:])]).reshape(shape)


def phase_serve_lm_configs(torch, np) -> dict:
    """``repro_torch.launch.serve.main`` on each of LM_CONFIGS at published
    widths with the int8 KV store; returns the ``decode_attention``
    launches by config."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.train.serve_step import make_decode_step

    gen, steps = LM_CONFIGS_GEN, LM_CONFIGS_GEN - 1
    argv = ["--kv-quant", "--batch", str(LM_CONFIGS_BATCH), "--prompt-len",
            str(LM_CONFIGS_PROMPT), "--gen", str(gen), "--device", "cuda"]
    launches_by_config = {}
    for arch, layers in LM_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)
        cut = (full if layers is None
               else dataclasses.replace(full, num_layers=layers))
        if layers is not None:
            print(f"reduced: {arch} served with {layers} of its "
                  f"{full.num_layers} layers (published widths): its "
                  f"bfloat16 weights take ~2.2 G parameters a layer, "
                  f"~216 GB at full depth against the card's 80 GB")
        decode_attention.launches = 0
        decode_attention_plain.calls = 0
        served = []
        t0 = time.perf_counter()
        with mock.patch.object(serve, "get_config", lambda a, c=cut: c), \
                moe_route_recorder(L, served):
            run = serve.main(["--arch", arch] + argv, keep_logits=True)
        wall = time.perf_counter() - t0
        launches, plain_calls = (decode_attention.launches,
                                 decode_attention_plain.calls)
        cfg, params = run.model.cfg, run.params
        nl = cfg.num_layers
        B, S = run.batch["tokens"].shape
        check(nl == cut.num_layers and cfg.d_model == full.d_model,
              f"{arch} ran {nl} layers of width {cfg.d_model}")
        check(launches == nl * steps, f"{arch}: decode_attention launched "
                                      f"{launches} times, not {nl} layers "
                                      f"x {steps} steps")
        check(plain_calls == 0, f"{arch}: the plain decode attention ran "
                                f"{plain_calls} times on the main path")
        check(tuple(run.tokens.shape) == (B, gen)
              and int(run.tokens.min()) >= 0
              and int(run.tokens.max()) < cfg.padded_vocab,
              f"{arch}: generated tokens out of shape or range")
        check(all(bool(torch.isfinite(lg).all()) for lg in run.logits),
              f"{arch}: non-finite decode logits")
        line = {"path": "lm serve config", "arch": arch, "layers": nl,
                "published_layers": full.num_layers,
                "d_model": cfg.d_model, "family": cfg.family, "batch": B,
                "prompt": S, "gen": gen, "kv_cache": "int8",
                "wall_s": wall, "prefill_s": run.prefill_s,
                "decode_s": run.decode_s,
                "decode_ms_p50": run.step_percentile_ms(0.5),
                "decode_ms_p95": run.step_percentile_ms(0.95),
                "decode_tokens_per_s": run.decode_tokens_per_s,
                "peak_gib": run.peak_bytes / 2**30,
                "weight_gb": sum(p.numel() * p.element_size()
                                 for p in params.parameters()) / 1e9,
                "decode_attention_launches": launches}
        plain_runs = 1
        if cfg.is_moe:
            shape = (steps, nl, B)
            check(len(served) == nl * gen, f"{arch}: {len(served)} "
                                           f"routings, not {nl * gen}")
            # determinism: on the kernel again, the same routing and logits
            again = []
            with moe_route_recorder(L, again):
                krep = replay_decode(torch, run, gen, decode_attention)
            same = sum(int(((a.expert != b.expert) | (a.keep != b.keep))
                           .sum()) for a, b in zip(served, again))
            check(len(again) == len(served) and same == 0
                  and max(krep["max_diff"]) == 0.0,
                  f"{arch}: a replay on the kernel differs from the served "
                  f"run ({same} routing decisions, max |dlogits| "
                  f"{max(krep['max_diff'])})")
            del krep, again
            # free running on the plain attention: counted
            free = []
            with moe_route_recorder(L, free):
                frep = replay_decode(torch, run, gen, decode_attention_plain)
            free_d = routing_differs(torch, served, free, nl, shape)
            del free
            # the served routing forced on the plain attention: held
            own = []
            with moe_route_recorder(L, own, forced=served):
                rep = replay_decode(torch, run, gen, decode_attention_plain)
            own_d = routing_differs(torch, served, own, nl, shape)
            plain_runs = 2
            pre = sum(int(((a.expert != b.expert) | (a.keep != b.keep))
                          .sum()) for a, b in zip(served[:nl], own[:nl]))
            dropped = sum(int((~r.keep).sum()) for r in served[nl:])
            line.update({
                "replay_on_the_kernel_identical": True,
                "prefill_routing_pairs_differing": pre,
                "decode_routing_decisions": free_d.numel(),
                "free_replay_decisions_differing": int(free_d.sum()),
                "free_replay_share_differing": float(free_d.float().mean()),
                "free_replay_differing_by_step":
                    free_d.sum(dim=(1, 2)).tolist(),
                "free_replay_worst_share_of_max_logit": max(frep["share"]),
                "forced_replay_own_decisions_differing": int(own_d.sum()),
                "forced_replay_own_share_differing":
                    float(own_d.float().mean()),
                "forced_replay_own_differing_by_layer_step0":
                    own_d[0].sum(-1).tolist(),
                "routing_share_expected": MOE_ROUTING_EXPECTED,
                "decode_pairs_dropped_served": dropped,
                "decode_pairs": steps * nl * B * cfg.top_k,
                "decode_capacity": L.moe_groups(B, cfg)[2]})
            del frep, own, free_d, own_d
        else:
            rep = replay_decode(torch, run, gen, decode_attention_plain)
        check(decode_attention_plain.calls == plain_runs * nl * steps,
              f"{arch}: the replay did not run the plain decode attention")
        line.update({
            "replay_prefill_tokens_agreeing": rep["prefill_agree"],
            "replay_worst_share_of_max_logit": max(rep["share"]),
            "replay_share_by_step": rep["share"],
            "replay_greedy_tokens_disagreeing": sum(rep["disagree"]),
            "replay_disagreements_not_near_ties": sum(rep["unexplained"]),
            "tolerance_share": LM_REPLAY_SHARE})
        check(max(rep["share"]) <= LM_REPLAY_SHARE,
              f"{arch}: decode logits on the kernel differ from the plain "
              f"replay past the stated tolerance")
        check(sum(rep["unexplained"]) == 0,
              f"{arch}: a greedy token differs from the plain replay where "
              f"the logits are not near a tie")
        check(rep["prefill_agree"] == B, f"{arch}: the prefill's greedy "
                                         f"tokens are not reproducible")
        # one decode step under the sync debug mode "error"
        decode = make_decode_step(run.model)
        tok = run.tokens[:, steps - 1:steps]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(params, tok, rep["cache"], S + steps - 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        line["sm clock, power, limit"] = nvidia_smi(
            "clocks.sm,power.draw,power.limit")
        print(json.dumps(line))
        launches_by_config[arch] = launches
        del run, params, rep, served, tok, decode
    gc.collect()
    torch.cuda.empty_cache()
    return launches_by_config


# the training phase: Qwen2-7B at full width, depth cut to TRAIN_LAYERS
# of 28 (float32 params, grads and both AdamW moments take 16 B a
# parameter: ~122 GB at 28 layers, ~32 GB at 4, ~20 GB at 2; 2 since
# phase 9 joined the time limit), batch 8 x 512 tokens, remat "full";
# TRAIN_STEPS exact steps, then as many with imc_linear
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8, 512, 3
# the plain imc_mvm's (Q, R, T) float64 partials are held TRAIN_CHECK_Q
# query rows at a time
TRAIN_CHECK_Q = 256


# kernel names of gathers, scatters, top-k, sorts and scans: the MoE's
# routing, dispatch and combine and their backward (the embedding lookup
# and its backward fall here too)
INDEX_KERNEL_NAMES = ("index", "scatter", "gather", "topk", "sort", "scan")


def device_groups(per: dict) -> dict:
    """A step's device milliseconds (``profile_device_ms``'s per-name
    dict) in groups: the ``imc_mvm`` kernels, cuBLAS / CUTLASS matmuls,
    the index kernels (INDEX_KERNEL_NAMES), and the rest (elementwise,
    reductions, copies)."""
    out = {"imc_mvm": 0.0, "matmul": 0.0, "index": 0.0, "other": 0.0}
    for name, ms in per.items():
        low = name.lower()
        if "imc_mvm_kernel" in name or "imc_dac_kernel" in name:
            out["imc_mvm"] += ms
        elif any(k in low for k in ("nvjet", "gemm", "cutlass", "xmma")):
            out["matmul"] += ms
        elif any(k in low for k in INDEX_KERNEL_NAMES):
            out["index"] += ms
        else:
            out["other"] += ms
    return out


def timed_train_steps(torch, step_fn, state, batches):
    """One step a batch: all but the last timed with CUDA events, then the
    last under the profiler (the device's time by kernel). Returns the
    state after them, and the step ms, losses, grad norms and device
    times."""
    events, metrics = [], []
    for batch in batches[:-1]:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        state, mt = step_fn(state, batch)
        metrics.append(mt)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    events.append(ev)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    def profiled():
        nonlocal state
        state, mt = step_fn(state, batches[-1])
        metrics.append(mt)

    dev_ms, top, per, _ = profile_device_ms(torch, profiled, steps=1)
    return state, {"ms": ms, "loss": [float(mt["loss"]) for mt in metrics],
                   "grad_norm": [float(mt["grad_norm"]) for mt in metrics],
                   "device_ms": dev_ms, "top": top, "per": per}


def imc_recorder(layers_mod):
    """A patch of ``models.layers.imc_mvm`` that calls the kernel's wrapper
    and keeps the first call's operands, knobs and result."""
    real = layers_mod.imc_mvm
    rec = {}

    def recording(q, w, **kw):
        out = real(q, w, **kw)
        rec.setdefault("call", (q, w, kw, out))
        return out

    return rec, mock.patch.object(layers_mod, "imc_mvm", recording)


def phase_train_lm(torch, np):
    """Qwen2-7B training at full width through ``build_model`` ->
    ``init_train_state`` -> ``make_train_step`` ->
    ``TokenPipeline.get_for``, exact then with ``imc_linear`` (the
    ``imc_mvm`` kernel in every FFN down-projection); the kernel at the
    training shape against its plain version; a checkpoint round trip.
    Returns the numbers the ``imc_mvm`` entry gains."""
    import dataclasses
    import gc
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.kernels import _build
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import (
        AdamWConfig,
        TrainConfig,
        TrainState,
        adamw_init,
        init_train_state,
        make_train_step,
    )

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the exact product would not be float32")
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2_7b"), num_layers=TRAIN_LAYERS)
    cfg_imc = dataclasses.replace(cfg, imc_linear=True)
    model, model_imc = build_model(cfg, "cuda"), build_model(cfg_imc, "cuda")
    tcfg = TrainConfig(
        optimizer=AdamWConfig(total_steps=2 * (TRAIN_STEPS + 1)),
        remat="full")
    pipe = TokenPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         vocab=cfg.vocab_size)
    _build.load("imc_mvm")   # set-up: the kernel builds before the steps
    t0 = time.perf_counter()
    state = init_train_state(model, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def run(m, first):
        nonlocal state
        batches = [pipe.get_for(m.cfg, s, "cuda")
                   for s in range(first, first + TRAIN_STEPS + 1)]
        state, out = timed_train_steps(torch, make_train_step(m, tcfg),
                                       state, batches)
        return out

    exact = run(model, 0)
    imc_mvm.launches = 0
    imc_mvm_plain.calls = 0
    imc = run(model_imc, TRAIN_STEPS + 1)
    launches, plain = imc_mvm.launches, imc_mvm_plain.calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = TRAIN_STEPS + 1
    # remat "full" runs each block's forward again in backward, but stops
    # after the exact product, before the kernel: one launch a layer a step
    expected = cfg.num_layers * steps
    for key in ("loss", "grad_norm"):
        for name, r in (("exact", exact), ("imc", imc)):
            check(all(np.isfinite(r[key])), f"non-finite {name} {key}: "
                                            f"{r[key]}")
    check(launches == expected, f"imc_mvm launched {launches} times in "
                                f"{steps} imc_linear steps, not {expected} "
                                f"({cfg.num_layers} layers x steps)")
    check(plain == 0, f"the plain imc_mvm ran {plain} times on the card's "
                      f"training path")
    check(state.step == 2 * steps, "the train state's step is off")

    # the IMC-over-exact loss gap on one batch and the same parameters;
    # the IMC forward keeps layer 0's kernel operands
    batch = pipe.get_for(cfg, 2 * steps, "cuda")
    rec, patch = imc_recorder(L)
    with torch.no_grad():
        loss_exact = float(model.loss(state.params, batch, remat="none"))
        with patch:
            loss_imc = float(model_imc.loss(state.params, batch,
                                            remat="none"))
    check(np.isfinite(loss_exact) and np.isfinite(loss_imc),
          "non-finite evaluation loss")
    k = imc_launch_check(torch, cfg, rec.pop("call"), [
        slice(i, i + TRAIN_CHECK_Q) for i in range(0, tokens, TRAIN_CHECK_Q)])
    Q, R, Dp = k["Q"], k["R"], k["Dp"]
    ms, mm_ms, b_ms, b_by = (k["ms"], k["matmul_ms"], k["bound_ms"],
                             k["bound_by"])
    mism, plain_s = k["mismatches"], k["plain_s"]

    # a checkpoint of the trained state, restored into a state of another
    # draw and zero moments: every leaf and counter must equal bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state.step, state)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*.bin"))
        other = model.init(seed=1, trainable=True)
        target = TrainState(params=other,
                            opt=adamw_init(list(other.parameters())), step=0)
        t0 = time.perf_counter()
        got_ckpt = mgr.restore_latest(target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    check(got_ckpt is not None and got_ckpt[0] == state.step,
          "the checkpoint did not restore")
    restored = got_ckpt[1]
    saved = (list(state.params.parameters()) + state.opt["mu"]
             + state.opt["nu"])
    back = (list(restored.params.parameters()) + restored.opt["mu"]
            + restored.opt["nu"])
    differ = sum(not torch.equal(a, b) for a, b in zip(saved, back))
    check(len(saved) == len(back) and differ == 0
          and restored.step == state.step
          and restored.opt["step"] == state.opt["step"],
          f"the restored state differs from the saved one ({differ} leaves)")
    del restored, back, target, other, got_ckpt

    # the first step of each run builds cuBLAS handles and workspaces
    line = {"path": "lm train", "arch": cfg.name, "layers": cfg.num_layers,
            "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "remat": tcfg.remat, "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype, "init_s": init_s}
    for name, r in (("exact", exact), ("imc", imc)):
        med = float(np.median(r["ms"][1:]))
        dev = r["device_ms"]
        line.update({
            f"{name}_step_ms": r["ms"],
            f"{name}_ms_median_after_first": med,
            f"{name}_tokens_per_s": 1e3 * tokens / med,
            f"{name}_loss": r["loss"], f"{name}_grad_norm": r["grad_norm"],
            f"{name}_device_ms_per_step": dev,
            f"{name}_device_share_of_step": None if dev is None
            else dev / med,
            f"{name}_device_ms_by_group": device_groups(r["per"]),
            f"{name}_device_ms_by_kernel": r["top"]})
    line.update({
        "eval_loss_exact": loss_exact, "eval_loss_imc": loss_imc,
        "imc_minus_exact_loss": loss_imc - loss_exact,
        "peak_gib": peak, "imc_mvm_launches": launches,
        "imc_mvm_launches_per_step": launches / steps,
        "imc_mvm_plain_calls": plain,
        "checkpoint_gb": nbytes / 1e9, "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s,
        "sm clock, power, limit":
            nvidia_smi("clocks.sm,power.draw,power.limit")})
    print(json.dumps(line))
    print(f"train: imc_mvm at the training shape Q={Q}, R={R}, Dp={Dp}: "
          f"{ms:.4f} ms (5 launches), float32 torch.matmul of the same "
          f"operands (TF32 off, no DAC / ADC) {mm_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}); kernel vs plain: {mism} mismatches "
          f"(plain {plain_s:.2f} s in {-(-Q // TRAIN_CHECK_Q)} query "
          f"blocks); phase {time.perf_counter() - t_phase:.1f} s")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_launches": launches,
            "train_launches_per_step": launches / steps,
            "train_shape": f"Q={Q}, R={R}, Dp={Dp} (Qwen2-7B FFN "
                           f"down-projection, {TRAIN_BATCH} x {TRAIN_SEQ} "
                           f"tokens)",
            "train_ms": ms, "train_matmul_ms": mm_ms,
            "train_bound_ms": b_ms, "train_bound_by": b_by,
            "train_plain_ms": 1e3 * plain_s, "train_mismatches": mism}


# phase 8b: training the MoE family at published widths: deepseek_moe_16b
# with MOE_TRAIN_LAYERS of 28 layers (~2.77 G float32 parameters x 16 B,
# ~44 GB of state), batch 8 x 512, remat "full", exact; then granite_20b
# with IMC_TRAIN_LAYERS of 52 layers and imc_linear (the imc_mvm kernel in
# every FFN down-projection, d_ff 24,576), IMC_TRAIN_STEPS steps (the
# last of each run's steps is the profiled one)
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "deepseek_moe_16b", 4
IMC_TRAIN_ARCH, IMC_TRAIN_LAYERS, IMC_TRAIN_STEPS = "granite_20b", 4, 2
def phase_train_configs(torch, np) -> dict:
    """deepseek_moe_16b training through ``build_model`` ->
    ``init_train_state`` -> ``make_train_step`` -> ``TokenPipeline.get_for``
    (exact), then granite_20b with ``imc_linear``: its ``imc_mvm``
    launches counted and one launch at the training shape held against
    the plain version on its first and last query rows. Returns the
    numbers the ``imc_mvm`` entry gains."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import (
        AdamWConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    t_phase = time.perf_counter()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    results = {}
    for arch, layers, steps, imc in (
            (MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, TRAIN_STEPS + 1, False),
            (IMC_TRAIN_ARCH, IMC_TRAIN_LAYERS, IMC_TRAIN_STEPS, True)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers, imc_linear=imc)
        print(f"reduced: training {arch} at published widths with {layers} "
              f"of its {full.num_layers} layers (float32 params, grads and "
              f"AdamW moments: 16 B a parameter), batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, {steps - 1} timed and 1 profiled step"
              f"{', imc_linear' if imc else ''}")
        model = build_model(cfg, "cuda")
        tcfg = TrainConfig(optimizer=AdamWConfig(total_steps=steps),
                           remat="full")
        pipe = TokenPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             vocab=cfg.vocab_size)
        t0 = time.perf_counter()
        state = init_train_state(model, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batches = [pipe.get_for(cfg, s, "cuda") for s in range(steps)]
        imc_mvm.launches = 0
        imc_mvm_plain.calls = 0
        state, r = timed_train_steps(torch, make_train_step(model, tcfg),
                                     state, batches)
        launches, plain = imc_mvm.launches, imc_mvm_plain.calls
        peak = torch.cuda.max_memory_allocated() / 2**30
        for key in ("loss", "grad_norm"):
            check(all(np.isfinite(r[key])), f"{arch}: non-finite {key}: "
                                            f"{r[key]}")
        want = layers * steps if imc else 0
        check(launches == want, f"{arch}: imc_mvm launched {launches} "
                                f"times in {steps} steps, not {want}")
        check(plain == 0, f"{arch}: the plain imc_mvm ran {plain} times")
        med = float(np.median(r["ms"][1:] or r["ms"]))
        dev = r["device_ms"]
        line = {
            "path": "lm train config", "arch": arch, "layers": layers,
            "published_layers": full.num_layers, "imc_linear": imc,
            "params": sum(p.numel() for p in state.params.parameters()),
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": tcfg.remat,
            "init_s": init_s, "step_ms": r["ms"], "step_ms_used": med,
            "tokens_per_s": 1e3 * tokens / med, "loss": r["loss"],
            "grad_norm": r["grad_norm"], "device_ms_per_step": dev,
            "device_share_of_step": None if dev is None else dev / med,
            "device_ms_by_group": device_groups(r["per"]),
            "device_ms_by_kernel": r["top"], "peak_gib": peak,
            "imc_mvm_launches": launches,
            "sm clock, power, limit":
                nvidia_smi("clocks.sm,power.draw,power.limit")}
        if imc:
            line.update(imc_training_shape(torch, np, model, state, pipe,
                                           cfg, L))
            results = {"granite_train_launches": launches,
                       "granite_train_launches_per_step": launches / steps,
                       **{k: line[k] for k in (
                           "granite_train_shape", "granite_train_ms",
                           "granite_train_matmul_ms",
                           "granite_train_bound_ms",
                           "granite_train_bound_by",
                           "granite_train_plain_ms",
                           "granite_train_checked_rows",
                           "granite_train_mismatches")}}
        print(json.dumps(line))
        del state, model, batches
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train configs: phase {time.perf_counter() - t_phase:.1f} s")
    return results


def imc_launch_check(torch, cfg, call, rows: list,
                     tokens: int = TRAIN_BATCH * TRAIN_SEQ) -> dict:
    """One recorded ``imc_mvm`` launch (operands, knobs, result) at
    ``cfg``'s training shape (``tokens`` query rows): the result's query
    ``rows`` (slices) against the plain version, bit for bit, and the
    kernel timed beside a float32 ``torch.matmul`` of the same operands
    (TF32 off, no DAC / ADC) and its bound."""
    from repro_torch.core.imc.array import ArrayConfig, default_full_scale
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain

    q, w, kw, got = call
    Q, Dp = q.shape
    R = w.shape[0]
    acfg = ArrayConfig(adc_bits=cfg.imc_adc_bits,
                       bits_per_cell=cfg.imc_mlc_bits)
    check((Q, R, Dp) == (tokens, cfg.d_model, cfg.d_ff)
          and kw["full_scale"] == default_full_scale(acfg),
          f"the kernel ran at {(Q, R, Dp)}, not {cfg.name}'s training "
          f"shape")
    plain_s, mism, checked = 0.0, 0, 0
    for r in rows:
        t0 = time.perf_counter()
        want = imc_mvm_plain(q[r], w, **kw)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        mism += int((got[r] != want).sum())
        checked += want.shape[0]
        del want
    check(mism == 0, f"imc_mvm at {cfg.name}'s training shape differs "
                     f"from its plain version in {mism} elements")
    ms = time_ms(torch, lambda: imc_mvm(q, w, **kw), iters=5, warmup=1)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        wt = w.t()
        mm_ms = time_ms(torch, lambda: torch.matmul(q, wt), iters=5,
                        warmup=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    b_ms, b_by = bound_ms(2 * Q * R * Dp, (Q * Dp + R * Dp + Q * R) * 4,
                          FP32_OPS_PER_S)
    return {"Q": Q, "R": R, "Dp": Dp, "ms": ms, "matmul_ms": mm_ms,
            "bound_ms": b_ms, "bound_by": b_by, "plain_s": plain_s,
            "mismatches": mism, "checked_rows": checked}


def imc_training_shape(torch, np, model, state, pipe, cfg,
                       layers_mod, prefix: str = "granite_train",
                       tokens: int = TRAIN_BATCH * TRAIN_SEQ,
                       batch=None) -> dict:
    """``imc_launch_check`` of the first launch of an evaluation forward
    on ``batch`` (default: the pipeline's batch IMC_TRAIN_STEPS;
    ``tokens`` query rows), on its first and last TRAIN_CHECK_Q query
    rows; the keys start with ``prefix``."""
    if batch is None:
        batch = pipe.get_for(cfg, IMC_TRAIN_STEPS, "cuda")
    rec, patch = imc_recorder(layers_mod)
    with torch.no_grad(), patch:
        loss = float(model.loss(state.params, batch, remat="none"))
    check(np.isfinite(loss), "non-finite evaluation loss")
    n = tokens
    k = imc_launch_check(torch, cfg, rec.pop("call"), [
        slice(0, TRAIN_CHECK_Q), slice(n - TRAIN_CHECK_Q, n)], tokens)
    print(f"train: imc_mvm at {cfg.name}'s training shape Q={k['Q']}, "
          f"R={k['R']}, Dp={k['Dp']}: {k['ms']:.4f} ms (5 launches), "
          f"float32 torch.matmul {k['matmul_ms']:.4f} ms, bound "
          f"{k['bound_ms']:.4f} ms ({k['bound_by']}); kernel vs plain on "
          f"query rows 0-{TRAIN_CHECK_Q - 1} and {n - TRAIN_CHECK_Q}-"
          f"{n - 1}: {k['mismatches']} mismatches (plain "
          f"{k['plain_s']:.2f} s)")
    return {"eval_loss_imc": loss,
            f"{prefix}_shape": f"Q={k['Q']}, R={k['R']}, Dp={k['Dp']} "
                               f"({cfg.name} FFN down-projection, "
                               f"{n} tokens)",
            f"{prefix}_ms": k["ms"],
            f"{prefix}_matmul_ms": k["matmul_ms"],
            f"{prefix}_bound_ms": k["bound_ms"],
            f"{prefix}_bound_by": k["bound_by"],
            f"{prefix}_plain_ms": 1e3 * k["plain_s"],
            f"{prefix}_checked_rows": k["checked_rows"],
            f"{prefix}_mismatches": k["mismatches"]}


# phase 7c: the recurrent families at published width and full depth,
# bfloat16, batch 32 x (512 + 16) as phase 7b: hymba_1_5b with the int8
# KV store (its attention heads run decode_attention) and xlstm_125m (no
# attention: --kv-quant changes nothing); then Hymba's ring run, batch
# RING_BATCH x (RING_PROMPT + RING_GEN), whose decode wraps the window
RECURRENT_CONFIGS = ("hymba_1_5b", "xlstm_125m")
RING_BATCH, RING_PROMPT, RING_GEN = 4, 2048, 64
# the ring run's depth (the wrap is the same in every layer): 8 of Hymba's
# 32 layers since phase 10b joined the time limit
RING_LAYERS = 8
# The state carry is held in float32: the served bfloat16 run's decode
# logits differ from its own forward_train by more than 2^-4 of the max
# logit, bfloat16 rounding amplified through the random-weight layers (a
# random xLSTM is chaotic: PERTURBATION, a relative change of the
# embedding that small, moves its float32 logits by a visible share,
# printed beside the check). The float32 copy runs CARRY_BATCH rows of
# the same prompts.
CARRY_BATCH = 8
PERTURBATION = 1e-7


def _prompt_and_tokens(torch, run):
    """The prompt's tokens and the generated tokens, padded to a multiple
    of the training forward's chunk (256 for mLSTM, 64 for Mamba);
    causality leaves the earlier positions as they are."""
    import torch.nn.functional as nnf

    seq = torch.cat([run.batch["tokens"], run.tokens], dim=1)
    chunk = {"ssm": 256, "hybrid": 64}.get(run.model.cfg.family, 1)
    return nnf.pad(seq, (0, (-seq.shape[1]) % chunk))


def teacher_forced_logits(torch, run, seq, rows):
    """``forward_train``'s logits over the prompt and the generated tokens
    ``seq`` (its rows ``rows``): after the VLM's patches, or over the
    encoder-decoder's encoded frames."""
    from repro_torch.models import transformer as T

    params, cfg = run.params, run.model.cfg
    if cfg.is_encoder_decoder:
        memory = T.encode(params, run.batch["frames"][rows], cfg,
                          remat="none")
        return T.forward_train(params, seq, cfg, remat="none",
                               memory=memory)
    if cfg.family == "vlm":
        tok_x = T.embed_tokens(params, seq, cfg)
        x = torch.cat([run.batch["patches"][rows].to(tok_x.dtype), tok_x], 1)
        return T.forward_train(params, x, cfg, remat="none",
                               is_embedded=True)
    return T.forward_train(params, seq, cfg, remat="none")


def perturbation_share(torch, run) -> float:
    """How far ``forward_train``'s logits at the generated positions move
    when every embedding entry is scaled by ``1 + PERTURBATION * N(0, 1)``:
    max |difference| over the largest |logit|."""
    from repro_torch.models import transformer as T

    params, cfg = run.params, run.model.cfg
    S = run.batch["tokens"].shape[1]
    n = run.tokens.shape[1]
    seq = _prompt_and_tokens(torch, run)
    g = torch.Generator(device=seq.device).manual_seed(0)
    noise = torch.randn(params.embed.shape, generator=g,
                        device=seq.device, dtype=params.embed.dtype)
    with torch.no_grad():
        a = T.forward_train(params, seq, cfg, remat="none")[:, S:S + n]
        saved = params.embed.detach().clone()
        params.embed.mul_(1 + PERTURBATION * noise)
        b = T.forward_train(params, seq, cfg, remat="none")[:, S:S + n]
        params.embed.copy_(saved)
    return float((a - b).abs().max() / a.abs().max())


def forward_train_shares(torch, run, gen: int) -> list[float]:
    """Each decode step's served logits against ``forward_train`` of the
    prompt and the generated tokens at that position: per step, max
    |difference| over the step's largest |served logit|."""
    B = run.batch["tokens"].shape[0]
    seq = _prompt_and_tokens(torch, run)
    diff = torch.zeros(gen - 1, device=seq.device)
    rows = max(1, B // 4)
    with torch.no_grad():
        for r in range(0, B, rows):
            full = teacher_forced_logits(torch, run, seq[r:r + rows],
                                         slice(r, r + rows))
            for i in range(gen - 1):
                # the decode's position i sits at run.start + i in the
                # full sequence (after the patches, for the VLM)
                d = (run.logits[i][r:r + rows, 0]
                     - full[:, run.start + i]).abs()
                diff[i] = torch.maximum(diff[i], d.max())
            del full
    top = torch.stack([lg.abs().max() for lg in run.logits])
    return (diff / top).tolist()


def float32_carry(torch, arch: str, argv: list, layers: int | None = None
                  ) -> tuple[list, object]:
    """``serve.main`` on a float32 copy of ``arch`` (the same seeded
    draw; ``layers`` of them, default all), and its decode logits against
    ``forward_train`` per step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    with mock.patch.object(serve, "get_config", lambda a, c=cfg: c):
        run = serve.main(["--arch", arch] + argv, keep_logits=True)
    return forward_train_shares(torch, run, run.tokens.shape[1]), run


def state_bytes(cache) -> int:
    """Bytes of the recurrent states in a serving cache (MambaState,
    MLSTMState, SLSTMState; the KV caches not counted)."""
    import dataclasses

    total = 0
    for entry in cache:
        for st in (entry if isinstance(entry, tuple) else (entry,)):
            if type(st).__name__.endswith("State"):
                total += sum(getattr(st, f.name).numel()
                             * getattr(st, f.name).element_size()
                             for f in dataclasses.fields(st))
    return total


def recurrent_serve_line(torch, run, arch, full, wall, launches) -> dict:
    cfg, params = run.model.cfg, run.params
    B, S = run.batch["tokens"].shape
    wbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    return {"path": "lm serve recurrent", "arch": arch,
            "layers": cfg.num_layers, "published_layers": full.num_layers,
            "d_model": cfg.d_model, "family": cfg.family, "batch": B,
            "prompt": S, "gen": run.tokens.shape[1],
            "kv_cache": "int8" if cfg.family == "hybrid" else "none",
            "wall_s": wall, "prefill_s": run.prefill_s,
            "decode_s": run.decode_s,
            "decode_ms_p50": run.step_percentile_ms(0.5),
            "decode_ms_p95": run.step_percentile_ms(0.95),
            "decode_tokens_per_s": run.decode_tokens_per_s,
            "peak_gib": run.peak_bytes / 2**30, "weight_gb": wbytes / 1e9,
            "weight_read_bound_ms": 1e3 * wbytes / HBM_BYTES_PER_S,
            "decode_attention_launches": launches}


def phase_serve_recurrent(torch, np) -> dict:
    """``repro_torch.launch.serve.main`` on RECURRENT_CONFIGS and Hymba's
    ring run; returns the ``decode_attention`` numbers the kernel entry
    gains."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.launch import serve
    from repro_torch.train.serve_step import make_decode_step

    t_phase = time.perf_counter()
    gen, steps = LM_CONFIGS_GEN, LM_CONFIGS_GEN - 1
    argv = ["--kv-quant", "--batch", str(LM_CONFIGS_BATCH), "--prompt-len",
            str(LM_CONFIGS_PROMPT), "--gen", str(gen), "--device", "cuda"]
    out = {}
    for arch in RECURRENT_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)
        decode_attention.launches = 0
        decode_attention_plain.calls = 0
        t0 = time.perf_counter()
        run = serve.main(["--arch", arch] + argv, keep_logits=True)
        wall = time.perf_counter() - t0
        launches, plain_calls = (decode_attention.launches,
                                 decode_attention_plain.calls)
        cfg, params = run.model.cfg, run.params
        nl = cfg.num_layers
        B, S = run.batch["tokens"].shape
        attn_layers = nl if cfg.family == "hybrid" else 0
        check(nl == full.num_layers and cfg.d_model == full.d_model,
              f"{arch} ran {nl} layers of width {cfg.d_model}")
        check(launches == attn_layers * steps,
              f"{arch}: decode_attention launched {launches} times, not "
              f"{attn_layers} attention layers x {steps} steps")
        check(plain_calls == 0, f"{arch}: the plain decode attention ran "
                                f"{plain_calls} times on the main path")
        check(tuple(run.tokens.shape) == (B, gen)
              and int(run.tokens.min()) >= 0
              and int(run.tokens.max()) < cfg.padded_vocab,
              f"{arch}: generated tokens out of shape or range")
        check(all(bool(torch.isfinite(lg).all()) for lg in run.logits),
              f"{arch}: non-finite decode logits")
        line = recurrent_serve_line(torch, run, arch, full, wall, launches)
        t0 = time.perf_counter()
        bf16 = forward_train_shares(torch, run, gen)
        # the state carry, held in float32 (CARRY_BATCH)
        carry_argv = argv[:]
        carry_argv[carry_argv.index("--batch") + 1] = str(CARRY_BATCH)
        f32, crun = float32_carry(torch, arch, carry_argv)
        check(max(f32) <= LM_REPLAY_SHARE,
              f"{arch}: float32 decode logits differ from forward_train "
              f"past the stated tolerance ({max(f32)})")
        line.update({
            "bf16_forward_train_worst_share_of_max_logit": max(bf16),
            "float32_forward_train_worst_share_of_max_logit": max(f32),
            "float32_forward_train_share_by_step": f32,
            "float32_decode_attention_launches": crun.launches,
            "float32_perturbation_share": perturbation_share(torch, crun),
            "perturbation": PERTURBATION,
            "forward_train_check_s": time.perf_counter() - t0,
            "tolerance_share": LM_REPLAY_SHARE})
        del crun
        if attn_layers:
            # every attention call of a replay on the kernel and the
            # plain version alike; then a free-running plain replay,
            # printed (bfloat16 rounding amplified, as above)
            rep, k = kernel_vs_plain_replay(torch, run, gen)
            check(k["calls"] == nl * steps
                  and k["valid_len"] == list(range(S + 1, S + gen)),
                  f"{arch}: the replay's attention calls ({k['calls']}, "
                  f"valid_len {k['valid_len']}) are not the decode's")
            free = replay_decode(torch, run, gen, decode_attention_plain)
            line.update({
                "kernel_vs_plain_calls": k["calls"],
                "kernel_vs_plain_max_abs": k["max_abs"],
                "kernel_vs_plain_mismatches": k["mismatches"],
                "plain_replay_worst_share_of_max_logit": max(free["share"]),
                "plain_replay_greedy_tokens_disagreeing":
                    sum(free["disagree"])})
            del free
        else:
            rep = replay_decode(torch, run, gen, None)
            check(max(rep["max_diff"]) == 0.0,
                  f"{arch}: a replay differs from the served run")
        check(rep["prefill_agree"] == B, f"{arch}: the prefill's greedy "
                                         f"tokens are not reproducible")
        line["state_gb"] = state_bytes(rep["cache"]) / 1e9
        # one decode step under the sync debug mode "error"
        decode = make_decode_step(run.model)
        tok = run.tokens[:, steps - 1:steps]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(params, tok, rep["cache"], S + steps - 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # the device's share of a decode step and its operations (three
        # steps under the profiler), for the CUDA-graph lead (H2)
        dev_ms, top, _, count = profile_device_ms(
            torch, lambda: decode(params, tok, rep["cache"], S + steps - 1),
            steps=3)
        line.update({
            "decode_device_ms_per_step": dev_ms,
            "decode_device_ops_per_step": sum(count.values()),
            "decode_device_share_of_p50": None if dev_ms is None
            else dev_ms / line["decode_ms_p50"],
            "decode_device_ms_by_kernel": top,
            "sm clock, power, limit":
                nvidia_smi("clocks.sm,power.draw,power.limit")})
        print(json.dumps(line))
        out[arch] = launches
        del run, params, rep, decode, tok
    out.update(ring_run(torch, np))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve recurrent: phase {time.perf_counter() - t_phase:.1f} s")
    return out


def launch_checker(torch, seen: list):
    """An ``attend`` that launches ``decode_attention`` (its result drives
    the decode) and holds each launch against the plain version on the
    same inputs, appending to ``seen`` (valid_len, cache slots, max
    |difference|, elements past rtol / atol DECODE_RTOL or not finite;
    the last two 0-dim device tensors, so that no launch waits)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )

    def both(q, k8, v8, ks, vs, valid_len):
        got = decode_attention(q, k8, v8, ks, vs, valid_len)
        want = decode_attention_plain(q, k8, v8, ks, vs, valid_len)
        bad = (got - want).abs() > DECODE_ATOL + DECODE_RTOL * want.abs()
        seen.append((valid_len, k8.shape[1], (got - want).abs().max(),
                     (bad | ~torch.isfinite(got)).sum()))
        return got

    return both


def kernel_vs_plain_replay(torch, run, gen: int) -> tuple[dict, dict]:
    """A teacher-forced replay of a served run in which every attention
    call runs the kernel and its plain version on the same inputs: the
    replay must reproduce the served logits exactly, and each call's
    outputs agree within rtol / atol DECODE_RTOL. Returns the replay and
    a summary (calls, valid_len and cache slots seen, max |difference|,
    elements past the tolerance)."""
    seen = []
    rep = replay_decode(torch, run, gen, launch_checker(torch, seen))
    summary = {
        "calls": len(seen),
        "valid_len": sorted({v for v, _, _, _ in seen}),
        "slots": sorted({n for _, n, _, _ in seen}),
        "max_abs": float(torch.stack([d for _, _, d, _ in seen]).max()),
        "mismatches": int(torch.stack([b for _, _, _, b in seen]).sum())}
    check(max(rep["max_diff"]) == 0.0,
          "a replay on the kernel differs from the served run")
    check(summary["mismatches"] == 0,
          f"the kernel differs from its plain version in "
          f"{summary['mismatches']} elements past rtol / atol {DECODE_RTOL}")
    return rep, summary


def ring_run(torch, np) -> dict:
    """Hymba (RING_LAYERS layers) at batch RING_BATCH x (RING_PROMPT +
    RING_GEN): the decode wraps the sliding window; a replay runs the
    kernel and its plain version on the same inputs at every layer of
    every step."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.launch import serve

    gc.collect()
    torch.cuda.empty_cache()
    arch = "hymba_1_5b"
    full = get_config(arch)
    window = full.sliding_window
    check(RING_PROMPT >= window, "the ring run's prompt does not fill the "
                                 "window")
    decode_attention.launches = 0
    decode_attention_plain.calls = 0
    t0 = time.perf_counter()
    cut = dataclasses.replace(full, num_layers=RING_LAYERS)
    with mock.patch.object(serve, "get_config", lambda a: cut):
        run = serve.main(["--arch", arch, "--kv-quant", "--batch",
                          str(RING_BATCH), "--prompt-len", str(RING_PROMPT),
                          "--gen", str(RING_GEN), "--device", "cuda"],
                         keep_logits=True)
    wall = time.perf_counter() - t0
    launches, plain_calls = (decode_attention.launches,
                             decode_attention_plain.calls)
    nl, steps = run.model.cfg.num_layers, RING_GEN - 1
    check(launches == nl * steps and plain_calls == 0,
          f"ring run: decode_attention launched {launches} times (the "
          f"plain version {plain_calls}), not {nl} x {steps}")
    rep, k = kernel_vs_plain_replay(torch, run, RING_GEN)
    check(k["calls"] == nl * steps, f"ring replay: {k['calls']} attention "
                                    f"calls, not {nl * steps}")
    check(k["valid_len"] == [window] and k["slots"] == [window],
          f"ring run: valid_len {k['valid_len']} over {k['slots']} slots, "
          f"not the whole {window}-slot window on every wrapped step")
    line = recurrent_serve_line(torch, run, arch, full, wall, launches)
    del rep
    # the ring's alignment after the wrap: a float32 copy of the run
    # (int8 store, so the kernel) against forward_train over the whole
    # sequence with the sliding-window mask
    bf16 = forward_train_shares(torch, run, RING_GEN)
    del run
    f32, crun = float32_carry(torch, arch, [
        "--kv-quant", "--batch", str(RING_BATCH), "--prompt-len",
        str(RING_PROMPT), "--gen", str(RING_GEN), "--device", "cuda"],
        RING_LAYERS)
    check(max(f32) <= LM_REPLAY_SHARE,
          f"ring run: float32 decode logits differ from forward_train past "
          f"the stated tolerance ({max(f32)})")
    line.update({
        "path": "lm serve ring", "window": window,
        "wrapped_steps": steps, "kernel_vs_plain_calls": k["calls"],
        "valid_len": k["valid_len"], "kernel_vs_plain_max_abs": k["max_abs"],
        "kernel_vs_plain_mismatches": k["mismatches"],
        "bf16_forward_train_worst_share_of_max_logit": max(bf16),
        "float32_forward_train_worst_share_of_max_logit": max(f32),
        "float32_decode_attention_launches": crun.launches,
        "sm clock, power, limit":
            nvidia_smi("clocks.sm,power.draw,power.limit")})
    print(json.dumps(line))
    del crun
    return {"ring_launches": launches, "ring_checked_calls": k["calls"],
            "ring_max_abs_err": k["max_abs"]}


# phase 8c: training the recurrent families at published width, batch
# TRAIN_BATCH x TRAIN_SEQ, remat "full": xlstm_125m exact at full depth
# (~0.18 G float32 parameters), then hymba_1_5b exact and with
# imc_linear at 4 of its 32 layers (~3.9 s a step at 32: its depth is cut
# for the script's time limit, the layers being alike; 8 in PR 28); (arch,
# layers or None for all, imc_linear runs)
RECURRENT_TRAIN = (("xlstm_125m", None, (False,)),
                   ("hymba_1_5b", 4, (False, True)))


def phase_train_recurrent(torch, np) -> dict:
    """Training through ``build_model`` -> ``init_train_state`` ->
    ``make_train_step`` -> ``TokenPipeline.get_for`` on RECURRENT_TRAIN;
    returns the numbers the ``imc_mvm`` entry gains."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import (
        AdamWConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    t_phase = time.perf_counter()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps = TRAIN_STEPS + 1
    results = {}
    for arch, layers, runs in RECURRENT_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        pipe = TokenPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             vocab=cfg.vocab_size)
        t0 = time.perf_counter()
        state = init_train_state(build_model(cfg, "cuda"), seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tcfg = TrainConfig(optimizer=AdamWConfig(
            total_steps=steps * len(runs)), remat="full")
        for j, imc in enumerate(runs):
            mcfg = dataclasses.replace(cfg, imc_linear=imc)
            model = build_model(mcfg, "cuda")
            batches = [pipe.get_for(mcfg, s, "cuda")
                       for s in range(j * steps, (j + 1) * steps)]
            imc_mvm.launches = 0
            imc_mvm_plain.calls = 0
            state, r = timed_train_steps(
                torch, make_train_step(model, tcfg), state, batches)
            launches, plain = imc_mvm.launches, imc_mvm_plain.calls
            peak = torch.cuda.max_memory_allocated() / 2**30
            for key in ("loss", "grad_norm"):
                check(all(np.isfinite(r[key])),
                      f"{arch}: non-finite {key}: {r[key]}")
            want = cfg.num_layers * steps if imc else 0
            check(launches == want, f"{arch}: imc_mvm launched {launches} "
                                    f"times in {steps} steps, not {want}")
            check(plain == 0, f"{arch}: the plain imc_mvm ran {plain} "
                              f"times")
            med = float(np.median(r["ms"][1:]))
            dev = r["device_ms"]
            line = {
                "path": "lm train recurrent", "arch": arch,
                "layers": cfg.num_layers, "imc_linear": imc,
                "params": sum(p.numel()
                              for p in state.params.parameters()),
                "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "remat": tcfg.remat, "dtype": cfg.dtype, "init_s": init_s,
                "step_ms": r["ms"], "step_ms_median_after_first": med,
                "tokens_per_s": 1e3 * tokens / med, "loss": r["loss"],
                "grad_norm": r["grad_norm"], "device_ms_per_step": dev,
                "device_share_of_step": None if dev is None else dev / med,
                "device_ms_by_group": device_groups(r["per"]),
                "device_ms_by_kernel": r["top"], "peak_gib": peak,
                "imc_mvm_launches": launches,
                "sm clock, power, limit":
                    nvidia_smi("clocks.sm,power.draw,power.limit")}
            if imc:
                line.update(imc_training_shape(torch, np, model, state, pipe,
                                               mcfg, L, "hymba_train"))
                results = {"hymba_train_launches": launches,
                           "hymba_train_launches_per_step": launches / steps,
                           **{k: line[k] for k in line
                              if k.startswith("hymba_train_")}}
            print(json.dumps(line))
            del batches, model
        del state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train recurrent: phase {time.perf_counter() - t_phase:.1f} s")
    return results


# phase 7d: the encoder-decoder and VLM families at published width,
# bfloat16, the int8 KV store, batch 32 x (512 + 16) as phase 7b:
# whisper_medium at full depth (24 encoder and 24 decoder layers; 256
# frames + 256 tokens), internvl2_76b with VLM_SERVE_LAYERS of its 80
# layers (64 patches + 448 tokens; its bfloat16 weights would not fit the
# card at 80). Whisper's state carry (the cross K/V at the memory's
# length, ROADMAP F4) is held on a float32 copy of CARRY_BATCH rows
# against forward_train over the encoded frames.
VLM_SERVE_LAYERS = 32
ENCDEC_VLM_SERVE = (("whisper_medium", None),
                    ("internvl2_76b", VLM_SERVE_LAYERS))


def layer_params(cfg) -> int:
    """Parameters of one attention + SwiGLU FFN layer of ``cfg`` (norms
    left out): what one InternVL2 layer adds."""
    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    return 2 * d * h * hd + 2 * d * kv * hd + 3 * d * f


def print_vlm_cut(full, layers: int, what: str, bytes_per_param: int):
    per = layer_params(full)
    head = 2 * full.padded_vocab * full.d_model
    print(f"reduced: {full.name} {what} with {layers} of its "
          f"{full.num_layers} layers (published widths): a layer holds "
          f"{per / 1e9:.3f} G parameters ({per * bytes_per_param / 1e9:.2f} "
          f"GB), the embedding and head {head / 1e9:.2f} G "
          f"({head * bytes_per_param / 1e9:.2f} GB); {layers} layers come "
          f"to ~{(head + layers * per) * bytes_per_param / 1e9:.0f} GB, "
          f"{full.num_layers} to ~"
          f"{(head + full.num_layers * per) * bytes_per_param / 1e9:.0f} GB "
          f"against the card's 80 GB")


def decode_attention_served(torch, cache, G: int, vl: int) -> dict:
    """``decode_attention`` on a served layer's int8 cache at ``vl`` with
    ``G`` query heads a KV head: held against its plain version and timed
    beside it and its bound."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )

    B, S, KV, hd = cache.k.shape
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, KV, G, hd), generator=g, device="cuda") * hd ** -0.5
    ops = (q, cache.k, cache.v, cache.k_scale, cache.v_scale)
    got = decode_attention(*ops, vl)
    want = decode_attention_plain(*ops, vl)
    bad = close_count(torch, got, want, DECODE_RTOL, DECODE_ATOL)
    check(bad == 0, f"decode_attention differs from its plain version on "
                    f"the served cache ({B}, {S}, {KV}, {G}, {hd})")
    nbytes = (2 * B * vl * KV * hd + 2 * 4 * B * vl * KV
              + 2 * 4 * B * KV * G * hd)
    b_ms, b_by = bound_ms(4 * B * KV * G * hd * vl, nbytes, FP32_OPS_PER_S)
    return {"shape": f"B={B}, S={S}, KV={KV}, G={G}, hd={hd}",
            "valid_len": vl,
            "ms": time_ms(torch, lambda: decode_attention(*ops, vl),
                          iters=200, warmup=10),
            "plain_ms": time_ms(torch, lambda: decode_attention_plain(
                *ops, vl), iters=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": float((got - want).abs().max())}


def phase_serve_encdec_vlm(torch, np) -> dict:
    """``repro_torch.launch.serve.main`` on ENCDEC_VLM_SERVE; returns the
    ``decode_attention`` launches by config."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.launch import serve
    from repro_torch.train.serve_step import make_decode_step

    t_phase = time.perf_counter()
    gen, steps = LM_CONFIGS_GEN, LM_CONFIGS_GEN - 1
    argv = ["--kv-quant", "--batch", str(LM_CONFIGS_BATCH), "--prompt-len",
            str(LM_CONFIGS_PROMPT), "--gen", str(gen), "--device", "cuda"]
    out = {}
    for arch, layers in ENCDEC_VLM_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)
        cut = (full if layers is None
               else dataclasses.replace(full, num_layers=layers))
        if layers is not None:
            print_vlm_cut(full, layers, "served in bfloat16", 2)
        decode_attention.launches = 0
        decode_attention_plain.calls = 0
        t0 = time.perf_counter()
        with mock.patch.object(serve, "get_config", lambda a, c=cut: c):
            run = serve.main(["--arch", arch] + argv, keep_logits=True)
        wall = time.perf_counter() - t0
        launches, plain_calls = (decode_attention.launches,
                                 decode_attention_plain.calls)
        cfg, params = run.model.cfg, run.params
        nl = cfg.num_layers
        B = run.batch["tokens"].shape[0]
        check(nl == cut.num_layers and cfg.d_model == full.d_model
              and cfg.num_encoder_layers == full.num_encoder_layers,
              f"{arch} ran {nl} layers of width {cfg.d_model}")
        check(launches == nl * steps, f"{arch}: decode_attention launched "
                                      f"{launches} times, not {nl} layers "
                                      f"x {steps} steps")
        check(plain_calls == 0, f"{arch}: the plain decode attention ran "
                                f"{plain_calls} times on the main path")
        check(tuple(run.tokens.shape) == (B, gen)
              and int(run.tokens.min()) >= 0
              and int(run.tokens.max()) < cfg.padded_vocab,
              f"{arch}: generated tokens out of shape or range")
        check(all(bool(torch.isfinite(lg).all()) for lg in run.logits),
              f"{arch}: non-finite decode logits")
        wbytes = sum(p.numel() * p.element_size()
                     for p in params.parameters())
        # what a decode step reads: the decoder's layers and the head (the
        # encoder runs once, in the prefill)
        dec_bytes = sum(p.numel() * p.element_size()
                        for p in params.layers.parameters())
        dec_bytes += params.lm_head.numel() * params.lm_head.element_size()
        line = {"path": "lm serve encdec vlm", "arch": arch, "layers": nl,
                "encoder_layers": cfg.num_encoder_layers,
                "published_layers": full.num_layers,
                "d_model": cfg.d_model, "family": cfg.family, "batch": B,
                "prompt": {k: v.shape[1] for k, v in run.batch.items()},
                "decode_start": run.start, "cache_len": run.cache_len,
                "gen": gen, "kv_cache": "int8", "wall_s": wall,
                "prefill_s": run.prefill_s, "decode_s": run.decode_s,
                "decode_ms_p50": run.step_percentile_ms(0.5),
                "decode_ms_p95": run.step_percentile_ms(0.95),
                "decode_tokens_per_s": run.decode_tokens_per_s,
                "peak_gib": run.peak_bytes / 2**30,
                "weight_gb": wbytes / 1e9,
                "weight_read_bound_ms": 1e3 * wbytes / HBM_BYTES_PER_S,
                "decode_attention_launches": launches}
        # every attention call of a replay on the kernel and the plain
        # version alike; then a free-running plain replay, printed
        rep, k = kernel_vs_plain_replay(torch, run, gen)
        check(k["calls"] == nl * steps
              and k["valid_len"] == list(range(run.start + 1,
                                               run.start + gen))
              and k["slots"] == [run.cache_len],
              f"{arch}: the replay's attention calls ({k['calls']}, "
              f"valid_len {k['valid_len']}, slots {k['slots']}) are not the "
              f"decode's")
        check(rep["prefill_agree"] == B, f"{arch}: the prefill's greedy "
                                         f"tokens are not reproducible")
        cache = rep["cache"]
        if cfg.is_encoder_decoder:
            xbytes = sum(x.k.numel() * x.k.element_size() * 2
                         for _, x in cache)
            check(all(x.k.shape[1] == run.batch["frames"].shape[1]
                      for _, x in cache),
                  f"{arch}: the cross K/V are not at the memory's length")
            dec_bytes += xbytes
            line["cross_kv_gb"] = xbytes / 1e9
        self_kv = cache[0][0] if cfg.is_encoder_decoder else cache[0]
        line.update({
            "decode_read_gb": dec_bytes / 1e9,
            "decode_read_bound_ms": 1e3 * dec_bytes / HBM_BYTES_PER_S,
            "kernel_vs_plain_calls": k["calls"],
            "kernel_vs_plain_max_abs": k["max_abs"],
            "kernel_vs_plain_mismatches": k["mismatches"],
            "decode_attention_at_last_step": decode_attention_served(
                torch, self_kv, cfg.num_heads // cfg.num_kv_heads,
                run.start + gen - 1)})
        free = replay_decode(torch, run, gen, decode_attention_plain)
        line.update({
            "plain_replay_worst_share_of_max_logit": max(free["share"]),
            "plain_replay_greedy_tokens_disagreeing": sum(free["disagree"]),
            "plain_replay_disagreements_not_near_ties":
                sum(free["unexplained"])})
        del free
        # one decode step under the sync debug mode "error"
        decode = make_decode_step(run.model)
        tok = run.tokens[:, steps - 1:steps]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(params, tok, cache, run.start + steps - 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        line["bf16_forward_train_worst_share_of_max_logit"] = max(
            forward_train_shares(torch, run, gen))
        del rep, cache, self_kv, decode, tok
        if cfg.is_encoder_decoder:
            # F4 on the card: a float32 copy (CARRY_BATCH rows) against
            # forward_train over its encoded frames at every position
            t0 = time.perf_counter()
            carry_argv = argv[:]
            carry_argv[carry_argv.index("--batch") + 1] = str(CARRY_BATCH)
            f32, crun = float32_carry(torch, arch, carry_argv)
            check(max(f32) <= LM_REPLAY_SHARE,
                  f"{arch}: float32 decode logits differ from forward_train "
                  f"past the stated tolerance ({max(f32)})")
            line.update({
                "float32_forward_train_worst_share_of_max_logit": max(f32),
                "float32_forward_train_share_by_step": f32,
                "float32_decode_attention_launches": crun.launches,
                "forward_train_check_s": time.perf_counter() - t0,
                "tolerance_share": LM_REPLAY_SHARE})
            del crun
        line["sm clock, power, limit"] = nvidia_smi(
            "clocks.sm,power.draw,power.limit")
        print(json.dumps(line))
        out[arch] = launches
        del run, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve encdec vlm: phase {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 8d: training the encoder-decoder and the VLM at published width,
# batch TRAIN_BATCH x TRAIN_SEQ (Whisper: 256 frames + 256 tokens, so its
# FFN down-projections take 2,048 query rows; InternVL2: 64 patches + 448
# tokens), remat "full": whisper_medium at full depth (~0.81 G float32
# parameters, ~13 GB of state) exact and with imc_linear (one imc_mvm
# launch an encoder and a decoder layer a step), internvl2_76b with
# VLM_TRAIN_LAYERS of its 80 layers (its embedding and head alone are 2.1
# G parameters, ~34 GB of float32 params, grads and moments), exact
VLM_TRAIN_LAYERS = 1
ENCDEC_VLM_TRAIN = (("whisper_medium", None, (False, True)),
                    ("internvl2_76b", VLM_TRAIN_LAYERS, (False,)))


def phase_train_encdec_vlm(torch, np) -> dict:
    """Training through ``build_model`` -> ``init_train_state`` ->
    ``make_train_step`` -> ``TokenPipeline.get_for`` on ENCDEC_VLM_TRAIN;
    returns the numbers the ``imc_mvm`` entry gains."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import (
        AdamWConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    t_phase = time.perf_counter()
    steps = TRAIN_STEPS + 1
    results = {}
    for arch, layers, runs in ENCDEC_VLM_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full = get_config(arch)
        cfg = (full if layers is None
               else dataclasses.replace(full, num_layers=layers))
        if layers is not None:
            print_vlm_cut(full, layers, "trained (float32 params, grads and "
                          "AdamW moments: 16 B a parameter)", 16)
        pipe = TokenPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             vocab=cfg.vocab_size)
        t0 = time.perf_counter()
        state = init_train_state(build_model(cfg, "cuda"), seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tcfg = TrainConfig(optimizer=AdamWConfig(
            total_steps=steps * len(runs)), remat="full")
        for j, imc in enumerate(runs):
            mcfg = dataclasses.replace(cfg, imc_linear=imc)
            model = build_model(mcfg, "cuda")
            batches = [pipe.get_for(mcfg, s, "cuda")
                       for s in range(j * steps, (j + 1) * steps)]
            # the text tokens a step trains on (the decoder's, or the
            # VLM's after its patches)
            text = batches[0]["tokens"].numel()
            imc_mvm.launches = 0
            imc_mvm_plain.calls = 0
            state, r = timed_train_steps(
                torch, make_train_step(model, tcfg), state, batches)
            launches, plain = imc_mvm.launches, imc_mvm_plain.calls
            peak = torch.cuda.max_memory_allocated() / 2**30
            for key in ("loss", "grad_norm"):
                check(all(np.isfinite(r[key])),
                      f"{arch}: non-finite {key}: {r[key]}")
            ffn_layers = cfg.num_layers + cfg.num_encoder_layers
            want = ffn_layers * steps if imc else 0
            check(launches == want, f"{arch}: imc_mvm launched {launches} "
                                    f"times in {steps} steps, not {want}")
            check(plain == 0, f"{arch}: the plain imc_mvm ran {plain} "
                              f"times")
            med = float(np.median(r["ms"][1:]))
            dev = r["device_ms"]
            line = {
                "path": "lm train encdec vlm", "arch": arch,
                "layers": cfg.num_layers,
                "encoder_layers": cfg.num_encoder_layers,
                "published_layers": full.num_layers, "imc_linear": imc,
                "params": sum(p.numel()
                              for p in state.params.parameters()),
                "batch": {k: tuple(v.shape) for k, v in batches[0].items()},
                "remat": tcfg.remat, "dtype": cfg.dtype, "init_s": init_s,
                "step_ms": r["ms"], "step_ms_median_after_first": med,
                "tokens_per_s": 1e3 * TRAIN_BATCH * TRAIN_SEQ / med,
                "text_tokens_per_s": 1e3 * text / med, "loss": r["loss"],
                "grad_norm": r["grad_norm"], "device_ms_per_step": dev,
                "device_share_of_step": None if dev is None else dev / med,
                "device_ms_by_group": device_groups(r["per"]),
                "device_ms_by_kernel": r["top"], "peak_gib": peak,
                "imc_mvm_launches": launches,
                "sm clock, power, limit":
                    nvidia_smi("clocks.sm,power.draw,power.limit")}
            if imc:
                # the first launch is the encoder's first layer, over
                # the TRAIN_BATCH x TRAIN_SEQ / 2 frames
                line.update(imc_training_shape(
                    torch, np, model, state, pipe, mcfg, L, "whisper_train",
                    tokens=TRAIN_BATCH * TRAIN_SEQ // 2))
                results = {"whisper_train_launches": launches,
                           "whisper_train_launches_per_step":
                               launches / steps,
                           **{k: line[k] for k in line
                              if k.startswith("whisper_train_")}}
            print(json.dumps(line))
            del batches, model
        del state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train encdec vlm: phase {time.perf_counter() - t_phase:.1f} s")
    return results


# phase 8e: the hierarchical DCN reduction on the card: the emulated route
# over DCN_PODS pod slices with each wire compression, Qwen2-7B at full
# width, batch TRAIN_BATCH x TRAIN_SEQ, remat "full", imc_linear (one
# imc_mvm launch a layer a pod a step, at the per-pod shape of 2,048 query
# rows), DCN_STEPS timed and 1 profiled step a method, at DCN_TOPK_FRAC.
# Each method's layers of 28: float32 params and AdamW moments take 12 B a
# parameter, the fold's accumulator and a pod's grads 8 B more, and
# topk_ef's residuals 4 B a pod (8 B at 2 pods): ~45 GB at 2 layers with
# them, leaving room for the top-k's int64 keys (8 B an element of a
# leaf: 4.4 GB for the embedding or head) and the checks' copies of the
# grads; every method at 2 layers, for the script's time limit (the
# embedding and head, the leaves the compressors spend most on, stay)
DCN_PODS, DCN_TOPK_FRAC, DCN_STEPS = 2, 0.01, 3
DCN_TRAIN = (("none", 2), ("int8", 2), ("topk", 2), ("topk_ef", 2))


def grouped(torch, ts: list, groups: list) -> list:
    """The reference's tree leaves from per-parameter tensors
    (``tree_leaf_groups``): a parameter alone, or a stacked leaf's layers
    stacked."""
    return [ts[idx[0]] if len(idx) == 1
            else torch.stack([ts[j] for j in idx]) for idx in groups]


def dcn_collectives_on_nccl(torch, C, g: list, e: list, key: int) -> dict:
    """``dcn_allreduce_tree`` (every method) and ``cross_pod_allreduce``
    (none / int8 / topk) on a 1-rank NCCL group, leaf by leaf over the
    card's gradient leaves ``g`` (residuals ``e``), against the emulated
    route's one-pod fold of ``dcn_send``: mismatching leaves."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
            for method in C.DCN_METHODS:
                bad = 0
                for i, gi in enumerate(g):
                    ei = [e[i]] if method == "topk_ef" else []
                    red, new = C.dcn_allreduce_tree(
                        [gi[None]], [t[None] for t in ei] or {}, mesh,
                        "pod", method, DCN_TOPK_FRAC, key)
                    sent, kept = C.dcn_send([gi], ei or {}, method,
                                            DCN_TOPK_FRAC, C.fold_in(key, 0))
                    bad += not torch.equal(red[0],
                                           torch.zeros_like(gi) + sent[0])
                    if method == "topk_ef":
                        bad += not torch.equal(new[0][0], kept[0])
                    del red, new, sent, kept
                    if method != "topk_ef":
                        got = C.cross_pod_allreduce(gi, mesh, "pod", method,
                                                    DCN_TOPK_FRAC, key)
                        want = {"none": lambda: gi,
                                "topk": lambda: C._topk(gi, DCN_TOPK_FRAC),
                                "int8": lambda: C._int8_stochastic(
                                    gi, C.fold_in(key, 0))}[method]()
                        bad += not torch.equal(got, want)
                        del got, want
                out[method] = bad
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    return out


def phase_train_dcn(torch, np) -> dict:
    """Qwen2-7B training through ``build_model`` -> ``init_train_state``
    -> ``make_train_step`` -> ``TokenPipeline.get_for`` with
    ``dcn_pods=DCN_PODS`` and each ``dcn_compression`` (the emulated
    route, ``imc_linear``): finite losses, the ``imc_mvm`` launches of
    every step counted, ``none`` beside ``microbatches=DCN_PODS``, one
    ``dcn_send`` of the whole tree timed; int8's codes and bounds, the EF
    invariant and the top-k mask against the CPU's, the NCCL collectives
    and the kernel at the per-pod shape checked. Returns the numbers the
    ``imc_mvm`` entry gains."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist import compression as C
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import (
        AdamWConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the exact product would not be float32")
    t_phase = time.perf_counter()
    full = get_config("qwen2_7b")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    pod_rows = TRAIN_BATCH // DCN_PODS
    steps = DCN_STEPS + 1
    results = {"dcn_train_launches": {}, "dcn_train_launches_per_step": {}}
    for method, layers in DCN_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(full, num_layers=layers, imc_linear=True)
        print(f"reduced: the DCN hierarchy ({method}) trains {full.name} at "
              f"published widths with {layers} of its {full.num_layers} "
              f"layers (float32 params and moments 12 B a parameter, the "
              f"fold's accumulator and a pod's grads 8 B"
              f"{', the residuals 8 B' if method == 'topk_ef' else ''}; "
              f"and the script's time limit), batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} in {DCN_PODS} pod slices emulated on the card, "
              f"imc_linear")
        model = build_model(cfg, "cuda")
        pipe = TokenPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             vocab=cfg.vocab_size)
        batches = [pipe.get_for(cfg, s, "cuda") for s in range(steps)]
        opt = AdamWConfig(total_steps=steps)
        tcfg = TrainConfig(optimizer=opt, remat="full", dcn_pods=DCN_PODS,
                           dcn_compression=method,
                           dcn_topk_frac=DCN_TOPK_FRAC)
        ref = None
        if method == "none":
            # the route it equals on the CPU: microbatches=DCN_PODS, one
            # step from the same draw
            state = init_train_state(model, 0)
            state, _ = make_train_step(model, TrainConfig(
                optimizer=opt, remat="full", microbatches=DCN_PODS))(
                state, batches[0])
            ref = [p.detach().clone() for p in state.params.parameters()]
            del state
        t0 = time.perf_counter()
        state = init_train_state(model, 0, tcfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        step_fn = make_train_step(model, tcfg)
        check(step_fn.dcn_route == "emulated"
              and step_fn.dcn_pods == DCN_PODS,
              f"{method}: route {step_fn.dcn_route} over "
              f"{step_fn.dcn_pods} pods")
        imc_mvm.launches = 0
        imc_mvm_plain.calls = 0
        events, metrics, mb_diff = [], [], None
        for s in range(DCN_STEPS):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, m = step_fn(state, batches[s])
            ev[1].record()
            events.append(ev)
            metrics.append(m)
            if ref is not None:
                mb_diff = max(float((p.detach() - r).abs().max()) for p, r
                              in zip(state.params.parameters(), ref))
                ref = None

        def profiled():
            nonlocal state
            state, m = step_fn(state, batches[DCN_STEPS])
            metrics.append(m)

        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in events]
        dev_ms, top, per, _ = profile_device_ms(torch, profiled, steps=1)
        launches, plain = imc_mvm.launches, imc_mvm_plain.calls
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(m["loss"]) for m in metrics]
        gnorms = [float(m["grad_norm"]) for m in metrics]
        check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
              f"{method}: non-finite losses {losses} or grad norms "
              f"{gnorms}")
        want = cfg.num_layers * DCN_PODS * steps
        check(launches == want, f"{method}: imc_mvm launched {launches} "
                                f"times in {steps} steps, not {want} "
                                f"(layers x pods x steps)")
        check(plain == 0, f"{method}: the plain imc_mvm ran {plain} times")
        sent_b, raw_b = metrics[0]["dcn_bytes"], metrics[0]["dcn_raw_bytes"]
        med = float(np.median(ms[1:]))
        line = {
            "path": "lm train dcn", "arch": full.name, "layers": layers,
            "published_layers": full.num_layers, "pods": DCN_PODS,
            "dcn_compression": method, "topk_frac": DCN_TOPK_FRAC,
            "route": step_fn.dcn_route, "imc_linear": True,
            "params": sum(p.numel() for p in state.params.parameters()),
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": tcfg.remat,
            "init_s": init_s, "step_ms": ms,
            "step_ms_median_after_first": med,
            "tokens_per_s": 1e3 * tokens / med, "loss": losses,
            "grad_norm": gnorms, "dcn_bytes": sent_b,
            "dcn_raw_bytes": raw_b, "dcn_over_raw": sent_b / raw_b,
            "device_ms_per_step": dev_ms,
            "device_share_of_step": None if dev_ms is None else dev_ms / med,
            "device_ms_by_group": device_groups(per),
            "device_ms_by_kernel": top, "peak_gib": peak,
            "imc_mvm_launches": launches,
            "imc_mvm_launches_per_step": launches / steps}
        if mb_diff is not None:
            line["none_vs_microbatches_max_abs_diff"] = mb_diff
        results["dcn_train_launches"][method] = launches
        results["dcn_train_launches_per_step"][method] = launches / steps

        # pod 0's gradients on the reference's tree (stacked layer leaves
        # whole) and its residual row: one dcn_send of the whole tree
        half = {k: v[:pod_rows] for k, v in batches[0].items()}
        leaves = list(state.params.parameters())
        groups = T.tree_leaf_groups(state.params)
        grads = list(torch.autograd.grad(
            model.loss(state.params, half, remat="full"), leaves))
        g = grouped(torch, grads, groups)
        del grads
        e = (grouped(torch, [r[0] for r in state.ef], groups)
             if state.ef else [])
        key = C.per_step_key(tcfg.seed, state.step)
        line["dcn_send_ms"] = time_ms(
            torch, lambda: C.dcn_send(g, e or {}, method, DCN_TOPK_FRAC,
                                      key), iters=2, warmup=1)
        if method == "int8":
            bad = 0
            for i, gi in enumerate(g):
                q, sc = C._int8_quantize(gi, C.fold_in(key, i))
                bad += not (torch.equal(q, q.round())
                            and float(q.abs().max()) <= 127
                            and bool(((q * sc - gi).abs() <= sc).all()))
                del q
            check(bad == 0, f"int8: {bad} leaves with codes off [-127, 127]"
                            f" or more than one scale step off")
            line["int8_leaves_checked"] = len(g)
        if method == "topk_ef":
            bad = 0
            for gi, ei in zip(g, e):
                (s_i,), (k_i,) = C.topk_ef_compress([gi], [ei],
                                                    DCN_TOPK_FRAC)
                bad += not torch.equal(s_i + k_i, gi + ei)
                del s_i, k_i
            check(bad == 0, f"topk_ef: sent + new residual != grads + old "
                            f"residual on {bad} of {len(g)} leaves")
            # the embedding's accumulator: the card's mask and the CPU's
            acc = g[0] + e[0]
            mask = C._topk_mask(acc, DCN_TOPK_FRAC).cpu()
            t0 = time.perf_counter()
            cpu_mask = C._topk_mask(acc.cpu(), DCN_TOPK_FRAC)
            line["mask_cpu_s"] = time.perf_counter() - t0
            check(torch.equal(mask, cpu_mask),
                  "the embedding's top-k mask on the card differs from the "
                  "CPU's")
            line["mask_checked_elements"] = acc.numel()
            del acc, mask, cpu_mask
            line["ef_invariant_leaves"] = len(g)
            nccl = dcn_collectives_on_nccl(torch, C, g, e, key)
            check(not any(nccl.values()),
                  f"the 1-rank NCCL collectives differ from the emulated "
                  f"route: {nccl}")
            line["nccl_mismatching_leaves"] = nccl
        del g, e
        if method == "none":
            line.update(imc_training_shape(
                torch, np, model, state, pipe, cfg, L, "dcn_train",
                tokens=tokens // DCN_PODS, batch=half))
            results.update({k: line[k] for k in line
                            if k.startswith("dcn_train_")})
        line["sm clock, power, limit"] = nvidia_smi(
            "clocks.sm,power.draw,power.limit")
        print(json.dumps(line))
        print(f"train dcn: {method} over {DCN_PODS} pods, {layers} layers: "
              f"{med:.2f} ms a step ({1e3 * tokens / med:.0f} tokens/s), "
              f"peak {peak:.2f} GiB, dcn/raw {sent_b / raw_b:.5f}, "
              f"imc_mvm {launches / steps:.0f} launches a step, dcn_send "
              f"{line['dcn_send_ms']:.2f} ms"
              + (f", none vs microbatches={DCN_PODS}: max abs "
                 f"{mb_diff:.3g}" if mb_diff is not None else ""))
        del state, model, batches, half
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train dcn: phase {time.perf_counter() - t_phase:.1f} s")
    return results


# phase 9: DB search over a device mesh. The one card holds 2 and then 4
# processes, a gloo group (NCCL refuses two ranks on one card; gloo stages
# each collective through the host), each rank serving serve_db's four
# routes at the iPRG2012 scale over make_debug_mesh's (1, n) mesh: its own
# block of the bank on the card, the (Q, k) candidates gathered over
# 'model' and merged. Held request by request against phase 4's
# one-process runs of the same stream
MESH_WORLDS = (2, 4)
MESH_ROUTES = ((False, False), (True, False), (False, True), (True, True))
# the continuous runs over the mesh: (path, flags), each with
# --continuous --num-slots NUM_SLOTS --append APPEND, after the routes
# whose library they reuse (mesh_rank). The OMS run adds --fused, as
# phase 5b does: without it a merged batch's base takes the unfused
# banded route (45.7 q/s on 2 ranks and a 79.6 s replay on an H100,
# PERF.md)
MESH_CONTINUOUS = (("fused", ["--fused"]),
                   ("oms fused-e2e", ["--oms", "--fused", "--fused-e2e"]))
# the timing loops of each flush-sync route (20 and 10 until the
# continuous runs joined phase 9)
MESH_KERNEL_ITERS, MESH_WALL_ITERS = 5, 3
MESH_JOIN_S = 600
MESH_MATMUL = (2048, 4096, 4096)  # collective matmuls' M, K, N, float32
NCCL_LOCAL_IDENTITIES = 4096


def wall_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Host wall-clock ms of ``fn`` (the card synchronized around it): a
    step of the mesh routes crosses the host through gloo."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def mesh_route(torch, dist, rank: int, world: int, fused_e2e: bool,
               oms: bool) -> dict:
    """One rank's ``serve_db`` run of one route over the debug mesh (the
    kernels' counts set to 0 just before and read just after), then, on
    the first served batch of 32: the kernel on this rank's block alone on
    the card (the ranks take turns), the gather + merge of its candidates
    and the whole route, all ranks together."""
    import gc

    from repro_torch.launch import serve_db
    from repro_torch.serve import db_search as DS

    path, kernel, argv = serve_route(fused_e2e, oms)
    recorder = recording_executor(MAX_BATCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in serve_db.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    s = serve_db.main(argv, executor_cls=recorder)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in serve_db.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    db, enc, batch, _, _, plan = recorder.got
    base = db.coords[db.axis] * db.shard_rows
    if oms:
        starts = torch.from_numpy(plan.starts).to(batch.device)
        ends = starts + torch.from_numpy(plan.lens).to(batch.device)
        tiles = int(plan.num_tiles)

    def local():
        if oms and fused_e2e:
            return DS._local_oms_e2e(batch, enc, db.data, base, K,
                                     db.num_rows, db.dim, starts, ends, tiles)
        if oms:
            return DS._local_oms_topk_fused(batch, db.data, base, K,
                                            db.num_rows, db.dim, starts,
                                            ends, tiles)
        if fused_e2e:
            return DS._local_topk_e2e(batch, enc, db.data, base, K,
                                      db.num_rows, db.dim)
        return DS._local_topk_fused(batch, db.data, base, K, db.num_rows,
                                    db.dim)

    def route():
        if oms and fused_e2e:
            return DS.oms_search_levels(db, enc, batch, plan, K,
                                        fused_e2e=True)
        if oms:
            return DS.oms_search_encoded(db, batch, plan, K)
        if fused_e2e:
            return DS.search_database_levels(db, enc, batch, K,
                                             fused_e2e=True)
        return DS.search_database_encoded(db, batch, K)

    kernel_ms = None
    for turn in range(world):
        if turn == rank:
            kernel_ms = time_ms(torch, local, iters=MESH_KERNEL_ITERS,
                                warmup=2)
        dist.barrier()
    vals, gidx = local()

    def gather_merge():
        return DS._gather_merge(db, vals, gidx, K)

    out = {
        "path": path, "kernel": kernel, "wall_s": wall,
        "summary": {key: s[key] for key in (
            "count", "qps", "p50_ms", "p95_ms", "identified", "correct",
            "library_s", "bank_build_s", "batches", "device_busy_s")},
        "results": recorder.results, "batches": recorder.batches,
        "launches": launches, "peak_gib": peak,
        "block_rows": int(db.data.shape[0]), "on_card": db.data.is_cuda,
        "num_shards": db.num_shards, "kernel_ms": kernel_ms,
        "gather_merge_ms": wall_ms(torch, gather_merge,
                                   iters=MESH_WALL_ITERS),
        "route_ms": wall_ms(torch, route, iters=MESH_WALL_ITERS)}
    del recorder.got, db, enc, batch, vals, gidx
    return out


def mesh_matmuls(torch, world: int) -> dict:
    """``ring_matmul_reduce`` and ``ag_matmul_pipelined`` over the (1, n)
    mesh on the card (float32, TF32 off): against one ``x @ w`` (largest
    difference over its largest magnitude) and bit for bit against a
    replay of their order from this rank's gathered partial products."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.collective_matmul import (
        ag_matmul_pipelined,
        ring_matmul_reduce,
    )
    from repro_torch.dist.sharding import all_gather_axis, axis_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    M, Kd, N = MESH_MATMUL
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(M, Kd, device="cuda", generator=g)
    w = torch.randn(Kd, N, device="cuda", generator=g)
    c = axis_ranks(mesh, "model").index(dist.get_rank())
    kl, ml, nl = Kd // world, M // world, N // world
    ring = ring_matmul_reduce(x, w, mesh)
    ag = ag_matmul_pipelined(x, w, mesh)
    plain = x @ w
    parts = all_gather_axis((x[:, c * kl:(c + 1) * kl]
                             @ w[c * kl:(c + 1) * kl])[None], mesh, "model", 0)
    acc = parts[c]
    for t in range(1, world):
        acc = acc + parts[(c - t) % world]
    wl = w[:, c * nl:(c + 1) * nl]
    col = torch.cat([x[s * ml:(s + 1) * ml] @ wl for s in range(world)])
    replay_ag = all_gather_axis(col, mesh, "model", 1)
    scale = float(plain.abs().max())
    out = {
        "ring_replay_equal": bool(torch.equal(ring, acc)),
        "ag_replay_equal": bool(torch.equal(ag, replay_ag)),
        "ring_rel_err": float((ring - plain).abs().max()) / scale,
        "ag_rel_err": float((ag - plain).abs().max()) / scale,
        "ring_ms": wall_ms(torch, lambda: ring_matmul_reduce(x, w, mesh), 5),
        "ag_ms": wall_ms(torch, lambda: ag_matmul_pipelined(x, w, mesh), 5),
        "plain_ms": time_ms(torch, lambda: x @ w, iters=10)}
    return out


def memoize_library(serve_db) -> None:
    """Patches ``serve_db``'s library generation in this rank so that a
    route reuses the library the route before it drew from the same
    configuration (the draws are deterministic, so only set-up time is
    saved). The OMS routes' configuration differs from the exact routes'
    only in its modification masses, which move precursors and not
    spectra (``spectra.synthetic.generate_dataset`` draws the spectra
    first): their dataset is drawn anew, and the encoded references and
    decoys of the exact routes are kept (since phase 10c joined the time
    limit: the ranks encode in turn, 24.8 s a library on 4 ranks). The
    encodings are kept on the host, as a sharded ``serve_db`` keeps them;
    another library drops the old one first. Returns what it holds (the
    dataset ``ds``, the encoded ``refs`` and ``decoys``)."""
    import dataclasses

    held: dict = {}
    generate, encode, decoys = (serve_db.generate_dataset,
                                serve_db.encode_and_pack,
                                serve_db.make_decoys)

    def generate_dataset(ms, device):
        if held.get("ms") != ms:
            lib = dataclasses.replace(ms, modification_mass_range=(0.0, 0.0))
            if held.get("lib") != lib:
                held.clear()
                held.update(lib=lib, decoy_key=object())
            held.update(ms=ms, ds=generate(ms, device=device))
        return held["ds"]

    def make_decoys(spectra):
        if spectra is held["ds"].spectra and "decoys" in held:
            return held["decoy_key"]
        return decoys(spectra)

    def encode_and_pack(spectra, cfg):
        if spectra is held["decoy_key"]:
            return held["decoys"]
        name = "refs" if spectra is held["ds"].spectra else None
        if name is None and "refs" in held and "decoys" not in held and (
                spectra.shape == held["ds"].spectra.shape):
            name = "decoys"
        if name is None:
            return encode(spectra, cfg)
        if name not in held:
            held[name] = encode(spectra, cfg).cpu()
        return held[name]

    serve_db.generate_dataset = generate_dataset
    serve_db.make_decoys = make_decoys
    serve_db.encode_and_pack = encode_and_pack
    return held


def mesh_continuous_recorder():
    """A ``SearchExecutor`` subclass for the continuous mesh runs: every
    dispatched batch as (request ids, the registry's appends and
    compactions at dispatch), every request's query, precursor and result
    (request id -> (indices, scores, accept, match, has_candidate)), and
    the admissions that found another batch still in flight on the card
    (its ``ready`` event not yet fired)."""
    from repro_torch.serve import SearchExecutor

    class Recording(SearchExecutor):
        batches: list = []
        queries: dict = {}
        results: dict = {}
        dispatches = overlapped = 0

        def __init__(self, server):
            super().__init__(server)
            self.outstanding = []

        def dispatch(self, reqs):
            busy = any(not h.ready.query() for h in self.outstanding
                       if h.ready is not None)
            banks = self.server.banks
            Recording.batches.append(([r.rid for r in reqs], banks.appends,
                                      banks.compactions))
            for r in reqs:
                Recording.queries[r.rid] = (r.query, r.precursor)
            h = super().dispatch(reqs)
            Recording.dispatches += 1
            Recording.overlapped += busy
            self.outstanding.append(h)
            return h

        def finalize(self, handle):
            self.outstanding.remove(handle)
            live = super().finalize(handle)
            for r in live:
                res = r.result
                Recording.results[r.rid] = (
                    res.indices.copy(), res.scores.copy(), bool(res.accept),
                    int(res.match), bool(res.has_candidate))
            return live

    return Recording


def continuous_argv(flags: list) -> list:
    return serve_route(False, False)[2][:-1] + flags + [
        "--continuous", "--num-slots", str(NUM_SLOTS), "--append",
        str(APPEND)]


def replay_one_process(torch, flags: list, held: dict, rec,
                       device: str = "cuda", num_features: int = 1024
                       ) -> dict:
    """The continuous mesh run's recorded batches replayed, in their
    order and two in flight, through a one-process continuous server on
    ``device`` over the same library (its suffix held out and appended
    before the first batch that saw the append, as ``serve_db`` holds it
    out; ``num_features`` bins a spectrum); request id -> result as the
    recorder keeps it."""
    from repro_torch.serve import (
        BankRegistry,
        DBSearchServer,
        OMSConfig,
        QueryEncoder,
    )
    from repro_torch.serve.queue import Request

    e2e, oms = "--fused-e2e" in flags, "--oms" in flags
    refs, decoys = held["refs"], held["decoys"]
    keep = refs.shape[0] - int(APPEND * refs.shape[0])
    prec = held["ds"].precursor.cpu().numpy() if oms else None
    reg = BankRegistry(fused="--fused" in flags)
    reg.register("tenant0", refs[:keep].to(device),
                 decoys=decoys[:keep].to(device), pin=True,
                 precursor=None if prec is None else prec[:keep])
    enc = (QueryEncoder.from_config(dim=refs.shape[1],
                                    num_features=num_features, num_levels=16,
                                    seed=0, device=device) if e2e else None)
    srv = DBSearchServer(reg, k=K, fdr=0.01, max_batch_size=MAX_BATCH,
                         buckets=4, oms=OMSConfig(tol=20.0, open_tol=200.0)
                         if oms else None, encoder=enc, fused_e2e=e2e,
                         continuous=True, num_slots=NUM_SLOTS)
    out, appended, flight = {}, 0, []

    def finalize(h):
        for r in srv.executor.finalize(h):
            res = r.result
            out[r.rid] = (res.indices.copy(), res.scores.copy(),
                          bool(res.accept), int(res.match),
                          bool(res.has_candidate))

    for rids, appends, _ in rec.batches:
        if appends > appended:
            srv.append("tenant0", refs[keep:].to(device),
                       decoys[keep:].to(device),
                       precursor=None if prec is None else prec[keep:])
            appended = appends
        flight.append(srv.executor.dispatch([
            Request(rid=r, query=rec.queries[r][0], t_submit=0.0,
                    tenant="tenant0", precursor=rec.queries[r][1])
            for r in rids]))
        if len(flight) == NUM_SLOTS:
            finalize(flight.pop(0))
    for h in flight:
        finalize(h)
    del srv, reg, enc
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_continuous(torch, dist, rank: int, path: str, flags: list,
                    held: dict) -> dict:
    """One rank's ``serve_db --continuous --append`` run of one route over
    the debug mesh (the kernels' counts set to 0 just before and read
    just after); then rank 0 replays its batches in one process."""
    import gc

    from repro_torch.launch import serve_db

    rec = mesh_continuous_recorder()
    gc.collect()
    torch.cuda.empty_cache()
    for fn in serve_db.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    s = serve_db.main(continuous_argv(flags), executor_cls=rec)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in serve_db.KERNELS.items()}
    replay, replay_s = None, None
    if rank == 0:
        t0 = time.perf_counter()
        replay = replay_one_process(torch, flags, held, rec)
        replay_s = time.perf_counter() - t0
    dist.barrier()
    return {"path": path, "wall_s": wall, "launches": launches,
            "summary": {key: s[key] for key in (
                "count", "qps", "p50_ms", "p95_ms", "identified",
                "batches", "scheduler", "append_rows")},
            "batches": rec.batches, "results": rec.results,
            "dispatches": rec.dispatches, "overlapped": rec.overlapped,
            "replay": replay, "replay_s": replay_s}


def mesh_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of phase 9, in a process of its own: joins the gloo group
    through the ``file://`` store, serves every route, runs the collective
    matmuls and writes its results to ``<out>/rank<r>.pkl`` (a failure
    writes its traceback to ``<out>/rank<r>.err`` first)."""
    import pickle
    import traceback

    out_dir = Path(out)
    try:
        sys.path.insert(0, str(SRC))
        import torch
        import torch.distributed as dist

        from repro_torch.launch import serve_db

        torch.cuda.set_device(0)
        held = memoize_library(serve_db)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            # each continuous run after the routes whose library it reuses
            routes = [mesh_route(torch, dist, rank, world, e2e, oms)
                      for e2e, oms in MESH_ROUTES[:2]]
            cont = [mesh_continuous(torch, dist, rank, *MESH_CONTINUOUS[0],
                                    held)]
            routes += [mesh_route(torch, dist, rank, world, e2e, oms)
                       for e2e, oms in MESH_ROUTES[2:]]
            cont.append(mesh_continuous(torch, dist, rank,
                                        *MESH_CONTINUOUS[1], held))
            res = {"routes": routes, "continuous": cont,
                   "matmuls": mesh_matmuls(torch, world)}
        finally:
            dist.destroy_process_group()
        (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_ranks(world: int, out: Path) -> list:
    """``world`` processes of ``mesh_rank`` (spawned; the kernels were
    built in this process); joined within MESH_JOIN_S, else killed and
    failed. Returns each rank's results."""
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank,
                         args=(r, world, str(out / "store"), str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_JOIN_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        alive = sum(p.is_alive() for p in procs)
        errs = [f.read_text() for f in sorted(out.glob("rank*.err"))]
        check(alive == 0 and not errs and all(
            p.exitcode == 0 for p in procs),
            f"{world} ranks: {alive} still running after {MESH_JOIN_S} s, "
            f"exit codes {[p.exitcode for p in procs]}, errors {errs}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def fdr_replay(torch, np, one: dict, batches: list, oms: bool) -> dict:
    """The FDR accept mask and match of every request when the mesh run's
    batches (request id lists, searched on the whole bank) are filtered
    with the one-process run's scores: request id -> (accept, match)."""
    import types

    from repro_torch.serve import fdr_route

    decoys = types.SimpleNamespace(num_decoys=IDENTITIES * REPLICATES)
    out = {}
    for rids in batches:
        idx = torch.from_numpy(np.stack([one[r][0] for r in rids]))
        vals = torch.from_numpy(np.stack([one[r][1] for r in rids]))
        valid = (torch.tensor([one[r][4] for r in rids]) if oms else None)
        routed = fdr_route(decoys, idx, vals, fdr=0.01, valid=valid)
        for i, r in enumerate(rids):
            out[r] = (bool(routed.accept[i]), int(routed.match[i]))
    return out


def nccl_local_serve(torch) -> dict:
    """``serve_db --fused`` on a 1-rank NCCL group (a ``file://`` store):
    ``make_debug_mesh`` gives the (1, 1) mesh and the local route; a
    smaller library (NCCL_LOCAL_IDENTITIES x 4)."""
    import contextlib
    import io
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import serve_db

    argv = ["--hd-dim", str(DIM), "--identities", str(NCCL_LOCAL_IDENTITIES),
            "--refs-per-identity", str(REPLICATES), "--queries", "512",
            "--k", str(K), "--max-batch", str(MAX_BATCH), "--device", "cuda",
            "--fused"]
    serve_db.topk_hamming.launches = 0
    text = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            with contextlib.redirect_stdout(text):
                s = serve_db.main(argv)
        finally:
            dist.destroy_process_group()
    mesh_line = next(line for line in text.getvalue().splitlines()
                     if line.startswith("mesh:"))
    return {"mesh_line": mesh_line, "count": s["count"], "qps": s["qps"],
            "identified": s["identified"],
            "launches": serve_db.topk_hamming.launches}


def mesh_continuous_report(torch, np, world: int, path: str, flags: list,
                           got: list, limit: str) -> list:
    """Checks and prints one continuous mesh run (its ranks' results
    ``got``): every rank's batches and results rank 0's, every request
    rank 0's one-process replay's, the merged batches' requests the
    one-process run's (phase 4) and their FDR masks a replay on its
    scores, the route's kernels launched on every rank. Returns each
    rank's launches of those kernels."""
    kernels = [name + ("_banded" if "--oms" in flags else "") for name in (
        ["encode_search"] if "--fused-e2e" in flags else []) + (
        ["topk_hamming"] if "--fused" in flags else [])]
    head, replay = got[0], got[0]["replay"]
    res = head["results"]
    check(sorted(res) == sorted(replay) == list(range(QUERIES)),
          f"continuous mesh {path} on {world} ranks: served "
          f"{len(res)} of {QUERIES} requests")

    def differ(a, b) -> int:
        return int((a[0] != b[0]).any() or (a[1] != b[1]).any()
                   or a[2:] != b[2:])

    ranks_diff = sum(int(g["batches"] != head["batches"]) + sum(
        differ(g["results"][r], res[r]) for r in res) for g in got[1:])
    replay_diff = sum(differ(res[r], replay[r]) for r in res)
    # the merged batches searched the whole bank: phase 4's run of the
    # same stream, and its scores' FDR over those batches
    one, _ = ONE_PROCESS[path]
    merged = [rids for rids, appends, _ in head["batches"] if appends]
    merged_rids = [r for rids in merged for r in rids]
    one_diff = sum(int((res[r][0] != one[r][0]).any()
                       or (res[r][1] != one[r][1]).any()
                       or res[r][4] != one[r][4]) for r in merged_rids)
    fdr = fdr_replay(torch, np, one, merged, "--oms" in flags)
    fdr_diff = sum(fdr[r] != (res[r][2], res[r][3]) for r in merged_rids)
    s = head["summary"]
    line = {
        "path": f"mesh continuous {path} --append {APPEND}", "ranks": world,
        "processes_on_one_card": True, "backend": "gloo",
        "num_slots": NUM_SLOTS, "queries": s["count"], "qps": s["qps"],
        "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"],
        "batches": s["batches"], "merged_batches": len(merged),
        "plan_exchanges": s["scheduler"]["exchanges"],
        "dispatches": head["dispatches"],
        "admissions_with_another_batch_in_flight": head["overlapped"],
        "identified_at_fdr": s["identified"],
        "identified_replay": sum(m >= 0 for _, _, _, m, _ in replay.values()),
        "mismatches_vs_one_process_replay": replay_diff,
        "merged_mismatches_vs_one_process": one_diff,
        "merged_fdr_mismatches_vs_replay": fdr_diff,
        "ranks_differing_from_rank0": ranks_diff,
        "launches": [g["launches"] for g in got],
        "run_s": [g["wall_s"] for g in got], "replay_s": head["replay_s"],
        "card, power limit": limit}
    print(json.dumps(line))
    print(f"mesh continuous {path}: {world} ranks on one card, "
          f"{line['qps']:.1f} q/s, p50 {line['p50_ms']:.2f} ms, p95 "
          f"{line['p95_ms']:.2f} ms, {line['batches']} batches "
          f"({line['merged_batches']} merged), "
          f"{line['admissions_with_another_batch_in_flight']} of "
          f"{line['dispatches']} admissions with another batch in flight, "
          f"{line['plan_exchanges']} plan exchanges; {replay_diff} "
          f"mismatches vs the one-process replay, {one_diff} merged vs one "
          f"process, {fdr_diff} FDR, {ranks_diff} ranks vs rank 0")
    check(all(g["launches"][k] > 0 for g in got for k in kernels),
          f"mesh continuous {path}: {kernels} not all launched on every "
          f"rank: {line['launches']}")
    check(replay_diff == 0 and one_diff == 0 and fdr_diff == 0
          and ranks_diff == 0 and merged
          and line["identified_at_fdr"] == line["identified_replay"],
          f"mesh continuous {path} on {world} ranks differs from one "
          f"process")
    return [{k: g["launches"][k] for k in kernels} for g in got]


def phase_mesh(torch, np) -> dict:
    """Phase 9 (see the module docstring): per world size and route the
    served requests against the one-process run's (phase 4's, or run here
    when phase 4 did not run), the FDR accept masks against a replay of
    the mesh run's batches on the one-process scores, every rank's results
    against rank 0's, the kernels' launches, each rank's block and peak
    memory; the continuous runs (``mesh_continuous_report``); the
    collective matmuls; a 1-rank NCCL ``serve_db``. Returns each route's
    launches and times by world size."""
    import gc
    import tempfile

    from repro_torch.launch import serve_db

    t_phase = time.perf_counter()
    for e2e, oms in MESH_ROUTES:
        path, _, argv = serve_route(e2e, oms)
        if path not in ONE_PROCESS:
            recorder = recording_executor(MAX_BATCH)
            s = serve_db.main(argv, executor_cls=recorder)
            ONE_PROCESS[path] = (recorder.results, s["identified"])
            recorder.got = None
    nccl = nccl_local_serve(torch)
    print(json.dumps({"path": "serve_db on a 1-rank NCCL group", **nccl}))
    check(nccl["mesh_line"] == "mesh: {'data': 1, 'model': 1}"
          and nccl["launches"] > 0 and nccl["count"] == 512,
          f"the 1-rank NCCL serve_db: {nccl}")
    gc.collect()
    torch.cuda.empty_cache()
    limit = nvidia_smi("name,power.limit")
    results = {path: {} for path, _, _ in (serve_route(e, o)
                                           for e, o in MESH_ROUTES)}
    for world in MESH_WORLDS:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn_ranks(world, Path(tmp))
        spawn_s = time.perf_counter() - t0
        for i, (e2e, oms) in enumerate(MESH_ROUTES):
            got = [r["routes"][i] for r in ranks]
            path, kernel = got[0]["path"], got[0]["kernel"]
            one, one_identified = ONE_PROCESS[path]
            mesh_res = got[0]["results"]
            check(sorted(mesh_res) == sorted(one),
                  f"{path} on {world} ranks served other requests than "
                  f"the one-process run")
            mismatches = sum(
                int((mesh_res[r][0] != one[r][0]).sum()
                    + (mesh_res[r][1] != one[r][1]).sum()
                    + (mesh_res[r][4] != one[r][4])) for r in one)
            replay = fdr_replay(torch, np, one, got[0]["batches"], oms)
            fdr_diff = sum(replay[r] != (mesh_res[r][2], mesh_res[r][3])
                           for r in one)
            ranks_diff = sum(
                int(any((g["results"][r][0] != mesh_res[r][0]).any()
                        or (g["results"][r][1] != mesh_res[r][1]).any()
                        or g["results"][r][2:] != mesh_res[r][2:]
                        for r in mesh_res)) for g in got[1:])
            replay_identified = sum(m >= 0 for _, m in replay.values())
            line = {
                "path": f"mesh {path}", "ranks": world,
                "processes_on_one_card": True, "backend": "gloo",
                "queries": got[0]["summary"]["count"],
                "qps": got[0]["summary"]["qps"],
                "p50_ms": got[0]["summary"]["p50_ms"],
                "p95_ms": got[0]["summary"]["p95_ms"],
                "batches": got[0]["summary"]["batches"],
                "identified_at_fdr": got[0]["summary"]["identified"],
                "identified_replay": replay_identified,
                "identified_one_process": one_identified,
                "mismatches_vs_one_process": mismatches,
                "fdr_mismatches_vs_replay": fdr_diff,
                "ranks_differing_from_rank0": ranks_diff,
                "block_rows": [g["block_rows"] for g in got],
                "kernel_ms_a_shard": [g["kernel_ms"] for g in got],
                "gather_merge_ms": [g["gather_merge_ms"] for g in got],
                "route_ms": [g["route_ms"] for g in got],
                "launches": [g["launches"][kernel] for g in got],
                "peak_gib": [g["peak_gib"] for g in got],
                "library_s": got[0]["summary"]["library_s"],
                "bank_build_s": got[0]["summary"]["bank_build_s"],
                "run_s": [g["wall_s"] for g in got],
                "card, power limit": limit}
            print(json.dumps(line))
            print(f"mesh {path}: {world} ranks on one card, "
                  f"{line['qps']:.1f} q/s, p50 {line['p50_ms']:.2f} ms, "
                  f"{kernel} {min(line['kernel_ms_a_shard']):.4f}-"
                  f"{max(line['kernel_ms_a_shard']):.4f} ms a shard, "
                  f"gather + merge {max(line['gather_merge_ms']):.3f} ms, "
                  f"route {max(line['route_ms']):.3f} ms, peak "
                  f"{max(line['peak_gib']):.2f} GiB a rank; {mismatches} "
                  f"mismatches vs one process, {fdr_diff} FDR, identified "
                  f"{line['identified_at_fdr']} (replay {replay_identified},"
                  f" one process {one_identified})")
            check(all(g["on_card"] and g["num_shards"] == world
                      and g["launches"][kernel] > 0 for g in got),
                  f"mesh {path}: a rank's block off the card, or {kernel} "
                  f"not launched on a rank: {line['launches']}")
            check(mismatches == 0 and fdr_diff == 0 and ranks_diff == 0
                  and line["identified_at_fdr"] == replay_identified,
                  f"mesh {path} on {world} ranks differs from the "
                  f"one-process route")
            results[path][world] = {
                "launches": line["launches"],
                "kernel_ms_a_shard": line["kernel_ms_a_shard"],
                "gather_merge_ms": line["gather_merge_ms"],
                "route_ms": line["route_ms"], "qps": line["qps"]}
        for i, (path, flags) in enumerate(MESH_CONTINUOUS):
            got = [r["continuous"][i] for r in ranks]
            launches = mesh_continuous_report(torch, np, world, path, flags,
                                              got, limit)
            results[path][world]["continuous_launches"] = launches
        mm = [r["matmuls"] for r in ranks]
        print(json.dumps({"path": "mesh collective matmuls", "ranks": world,
                          "shape": MESH_MATMUL, "per_rank": mm,
                          "card, power limit": limit}))
        check(all(m["ring_replay_equal"] and m["ag_replay_equal"]
                  and m["ring_rel_err"] < 1e-5 and m["ag_rel_err"] < 1e-5
                  for m in mm),
              f"collective matmuls on {world} ranks: {mm}")
        print(f"mesh: {world} ranks in {spawn_s:.1f} s")
        del ranks
    print(f"mesh: phase {time.perf_counter() - t_phase:.1f} s")
    return results


# phase 10: the dense LM over a device mesh. Qwen2-7B served at full width
# and depth (bfloat16, the int8 KV store, phase 7b's 32 x (512 + 16)) and
# trained at full width with TRAIN_LAYERS layers (batch TRAIN_BATCH x
# TRAIN_SEQ, remat "full", imc_linear), first in this process, then by 2
# and 4 processes sharing the card in a gloo group over (data, model)
# meshes: DTensor parameters, activations and optimizer state, the
# kernels on each rank's blocks. Processes on one card, not a multi-card
# deployment: what the sharding layer and its collectives cost, and no
# multi-card speed-up. Then the LM launchers on a 1-rank NCCL group.
LM_MESH_JOBS = {2: (("serve", (1, 2)), ("train", (2, 1)),
                    ("train", (1, 2)), ("moe serve", (1, 2)),
                    ("moe decode", (2, 1)), ("whisper serve", (1, 2)),
                    ("whisper train", (1, 2)), ("kv_seq serve", (1, 2))),
                4: (("serve", (1, 4)), ("train", (2, 2)),
                    ("restore", (1, 4)), ("moe train", (2, 2)),
                    ("vlm serve", (1, 4)), ("kv_seq serve", (1, 4)))}
LM_MESH_STEPS = 2
# the dense serving cell's depth: 4 of Qwen2-7B's 28 layers since phase
# 10b joined the time limit (28 until PR 28)
LM_MESH_SERVE_LAYERS = 4
LM_MESH_JOIN_S = 600
LM_MESH_LOSS_RTOL = 1e-3
LM_MESH_ARGV = ["--arch", "qwen2_7b", "--kv-quant",
                "--batch", str(LM_CONFIGS_BATCH),
                "--prompt-len", str(LM_CONFIGS_PROMPT),
                "--gen", str(LM_CONFIGS_GEN), "--device", "cuda"]


def lm_mesh_train_cfg():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.train import AdamWConfig, TrainConfig

    cfg = dataclasses.replace(get_config("qwen2_7b"), num_layers=TRAIN_LAYERS,
                              imc_linear=True)
    # the bfloat16 view of the float32 master weights: the (data) FSDP
    # gathers move half the bytes through gloo's host staging
    return cfg, TrainConfig(optimizer=AdamWConfig(total_steps=10),
                            remat="full", cast_params_bf16=True)


def lm_mesh_serve_cfg():
    """Qwen2-7B at published width, LM_MESH_SERVE_LAYERS layers, the int8
    KV store."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen2_7b"), kv_quant_int8=True,
                               num_layers=LM_MESH_SERVE_LAYERS)


def gloo_delta(SH, before: dict) -> tuple[int, float]:
    """(gloo collectives, their host ms) since the ``before`` snapshot."""
    n = sum(SH.GLOO_COLLECTIVES.values()) - before["n"]
    ms = 1e3 * (sum(SH.GLOO_COLLECTIVE_S.values()) - before["s"])
    return n, ms


def gloo_snapshot(SH) -> dict:
    return {"n": sum(SH.GLOO_COLLECTIVES.values()),
            "s": sum(SH.GLOO_COLLECTIVE_S.values())}


def lm_mesh_serve(torch, dist, mesh, ref: dict) -> dict:
    """One rank's Qwen2-7B serving on ``mesh``: the prompt, then the
    one-process run's tokens forced into the decode steps; each step's
    whole logits against the one-process run's, timings, launches and
    collectives, and ``decode_attention`` at this rank's cache shape
    against its plain version."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.serve_step import make_decode_step, make_prefill

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = lm_mesh_serve_cfg()
    B, P, G = LM_CONFIGS_BATCH, LM_CONFIGS_PROMPT, LM_CONFIGS_GEN
    model = build_model(cfg, "cuda", mesh)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = TokenPipeline(B, P, cfg.vocab_size).get_for(cfg, 0, "cuda", mesh)
    cache = model.init_cache(B, P + G)
    prefill, decode = make_prefill(model), make_decode_step(model)
    tokens = ref["tokens"].cuda()
    decode_attention.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = SH.full_value(logits).argmax(-1).to(torch.int32)
    prefill_agree = int((first == tokens[:, :1]).sum())
    step_ms, coll_n, coll_ms, share = [], 0, 0.0, []
    for i in range(G - 1):
        snap = gloo_snapshot(SH)
        t0 = time.perf_counter()
        lp, cache = decode(params, tokens[:, i:i + 1], cache, P + i)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        n, ms = gloo_delta(SH, snap)
        coll_n, coll_ms = coll_n + n, coll_ms + ms
        want = ref["logits"][i].cuda()
        got = SH.full_value(lp)
        share.append(float((got - want).abs().max())
                     / float(want.abs().max()))
    launches = decode_attention.launches
    h0, hl = SH.local_range(L.Q_AXES, (B, 1, cfg.num_heads,
                                       cfg.resolved_head_dim), 2)
    g = min(hl, cfg.num_heads // cfg.num_kv_heads)
    kernel = decode_attention_served(torch, cache[0], g, P + G - 1)
    steps = len(step_ms)
    ms = torch.tensor(step_ms, dtype=torch.float64)
    return {"init_s": init_s, "prefill_s": prefill_s,
            "prefill_agree": prefill_agree,
            "decode_p50_ms": float(torch.quantile(ms, 0.5)),
            "decode_p95_ms": float(torch.quantile(ms, 0.95)),
            "tokens_per_s": B * steps / (sum(step_ms) / 1e3),
            "max_share": max(share), "share": share,
            "launches": launches,
            "gloo_collectives_a_step": coll_n / steps,
            "gloo_ms_a_step": coll_ms / steps,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "cache_shape": tuple(cache[0].k.shape),
            "query_heads": [h0, hl], "kernel": kernel}


def lm_mesh_train(torch, dist, mesh, ref: dict, ckpt_dir=None) -> tuple:
    """One rank's LM_MESH_STEPS Qwen2-7B training steps on ``mesh``
    (imc_linear): losses against the one-process run's, step times,
    ``imc_mvm`` launches a step and the first launch's operands on this
    rank's ff shard against the plain version; with ``ckpt_dir`` the
    state is saved there and each rank's blocks are read back from the
    files. Returns (the numbers, the state)."""
    import gc

    from repro_torch.core.imc.array import ArrayConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, tcfg = lm_mesh_train_cfg()
    model = build_model(cfg, "cuda", mesh)
    state = init_train_state(model, seed=0, tcfg=tcfg)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    rec, patch = imc_recorder(L)
    imc_mvm.launches = 0
    losses, step_ms, coll_n, coll_ms = [], [], 0, 0.0
    with patch:
        for s in range(LM_MESH_STEPS):
            batch = pipe.get_for(cfg, s, "cuda", mesh)
            dist.barrier()
            snap = gloo_snapshot(SH)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            n, ms = gloo_delta(SH, snap)
            coll_n, coll_ms = coll_n + n, coll_ms + ms
    launches = imc_mvm.launches
    q, w, kw, got = rec.pop("call")
    Q = q.shape[0]
    mism = 0
    for r in (slice(0, TRAIN_CHECK_Q), slice(Q - TRAIN_CHECK_Q, Q)):
        mism += int((got[r] != imc_mvm_plain(q[r], w, **kw)).sum())
    shard = (Q, w.shape[0], q.shape[1])
    del rec, q, w, got
    out = {"losses": losses,
           "loss_rel_err": max(abs(a - b) / abs(b)
                               for a, b in zip(losses, ref["losses"])),
           "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (
               sum(step_ms[1:] or step_ms) / len(step_ms[1:] or step_ms)
               / 1e3),
           "imc_launches_a_step": launches / LM_MESH_STEPS,
           "imc_shard_shape": shard, "imc_whole_tiles":
               shard[2] % ArrayConfig().cols == 0,
           "imc_mismatches": mism,
           "gloo_collectives_a_step": coll_n / LM_MESH_STEPS,
           "gloo_ms_a_step": coll_ms / LM_MESH_STEPS,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, keep=1)
        t0 = time.perf_counter()
        mgr.save(state.step, state)
        out["save_s"] = time.perf_counter() - t0
        out["saved_blocks_differ"] = blocks_differ(torch, SH, mgr, state)
    return out, state


def blocks_differ(torch, SH, mgr, state) -> int:
    """The leaves of ``state`` whose local block differs from the same
    block read from the newest checkpoint's files."""
    from repro_torch.dist.checkpoint import _flatten

    step = mgr.list_steps()[-1]
    leaves = [v for _, v in _flatten(state) if isinstance(v, torch.Tensor)]
    return sum(not torch.equal(
        t.to_local().detach().cpu(), mgr.leaf_block(step, i, t.device_mesh,
                                                    t.placements))
        for i, t in enumerate(leaves))


def lm_mesh_restore(torch, mesh, ckpt_dir) -> dict:
    """The checkpoint the (2, 2) mesh saved, restored into a state placed
    on ``mesh``: its step, validation, placements and blocks."""
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.models import transformer as T
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import init_train_state
    from repro_torch.train.train_step import state_axes

    cfg, tcfg = lm_mesh_train_cfg()
    target = init_train_state(build_model(cfg, "cuda", mesh), seed=1,
                              tcfg=tcfg)
    mgr = CheckpointManager(ckpt_dir, keep=1)
    sh = SH.tree_shardings(state_axes(T.param_axes(target.params, cfg),
                                      tcfg), target, mesh)
    # the blocks are compared below, so the files' CRC-32s are not read
    step = mgr.list_steps()[-1]
    t0 = time.perf_counter()
    state = mgr.restore(step, target, sh)
    restore_s = time.perf_counter() - t0
    from repro_torch.dist.checkpoint import _flatten

    placed = all(SH.on_mesh(v) and v.device_mesh == mesh
                 for _, v in _flatten(state) if isinstance(v, torch.Tensor))
    return {"step": step, "restore_s": restore_s, "placed": placed,
            "blocks_differ": blocks_differ(torch, SH, mgr, state)}


# phase 10's kv_seq job: granite_20b at published width (MQA: its 1 kv
# head divides no model axis, so without kv_seq every rank holds the whole
# cache), KV_SEQ_LAYERS of its 52 layers with the int8 KV store, its
# caches' slots striped over model (rules.replace(kv_seq="model")) on
# (1, 2) and (1, 4): 1,032 and 516 of the 2,064 slots a rank. Each rank
# attends every query head over its block on decode_attention_partial and
# the blocks combine through two gloo all-reduces a layer a step.
KV_SEQ_LAYERS = 4
KV_SEQ_BATCH, KV_SEQ_PROMPT, KV_SEQ_GEN = 8, 2048, 16


def kv_seq_cfg():
    """granite_20b at published width, KV_SEQ_LAYERS layers, the int8 KV
    store."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("granite_20b"), kv_quant_int8=True,
                               num_layers=KV_SEQ_LAYERS)


def kv_seq_one_process(torch) -> tuple[dict, dict]:
    """The kv_seq job's run in this process (no mesh, the whole cache):
    the prefill's logits, greedy tokens and every decode step's logits,
    and its timings."""
    import gc

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.serve_step import make_decode_step, make_prefill

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = kv_seq_cfg()
    B, P, G = KV_SEQ_BATCH, KV_SEQ_PROMPT, KV_SEQ_GEN
    model = build_model(cfg, "cuda")
    params = model.init(seed=0)
    batch = TokenPipeline(B, P, cfg.vocab_size).get_for(cfg, 0, "cuda")
    cache = model.init_cache(B, P + G)
    prefill, decode = make_prefill(model), make_decode_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    ref = {"prefill": logits.float().cpu(), "logits": []}
    tok = logits.argmax(-1).to(torch.int32)
    tokens, step_ms = [tok], []
    for i in range(G - 1):
        t0 = time.perf_counter()
        logits, cache = decode(params, tok, cache, P + i)
        tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        ref["logits"].append(logits.float().cpu())
        tokens.append(tok)
    ref["tokens"] = torch.cat(tokens, dim=1).cpu()
    ms = torch.tensor(step_ms, dtype=torch.float64)
    line = {"prefill_s": prefill_s,
            "decode_p50_ms": float(torch.quantile(ms, 0.5)),
            "decode_p95_ms": float(torch.quantile(ms, 0.95)),
            "tokens_per_s": B * len(step_ms) / (sum(step_ms) / 1e3),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "cache_shape": tuple(cache[0].k.shape)}
    # the kernels alone in this process (the ranks time theirs while the
    # other ranks share the card): decode_attention over the whole cache,
    # and the partial form over a (1, 2) and a (1, 4) rank's first block
    heads = cfg.num_heads // cfg.num_kv_heads
    line["whole_cache_kernel"] = decode_attention_served(torch, cache[0],
                                                         heads, P + G)
    c = cache[0]
    for world in (2, 4):
        n = (P + G) // world
        blk = type(c)(*(t[:, :n].contiguous() for t in (
            c.k, c.v, c.k_scale, c.v_scale)))
        line[f"block_kernel_{world}"] = partial_on_block(
            torch, blk, heads, (n, n // 2 + 1, 0))
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return ref, line


def cache_bytes(cache) -> int:
    """Bytes of a rank's int8 caches: K, V and their scales."""
    return sum(t.numel() * t.element_size() for c in cache
               for t in (c.k, c.v, c.k_scale, c.v_scale))


def partial_on_block(torch, cache, G: int, counts: tuple) -> dict:
    """``decode_attention_partial`` on a rank's block of a striped int8
    cache with every query head (``G`` a kv head), held against its plain
    version at each count of ``counts`` (output and log-sum-exp; a count
    of 0 is an empty block: 0 and -inf), and timed at the first beside
    its bound."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_partial,
        decode_attention_partial_plain,
    )

    B, S, KV, hd = cache.k.shape
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((B, KV, G, hd), generator=g, device="cuda") * hd ** -0.5
    ops = (q, cache.k, cache.v, cache.k_scale, cache.v_scale)
    err = 0.0
    for n in counts:
        out, lse = decode_attention_partial(*ops, n)
        want_out, want_lse = decode_attention_partial_plain(*ops, n)
        if n == 0:
            check(bool((out == 0).all()) and bool((lse == float("-inf"))
                                                  .all()),
                  f"decode_attention_partial on an empty block ({B}, {S}, "
                  f"{KV}, {G}, {hd}): not 0 and -inf")
            continue
        bad = (close_count(torch, out, want_out, DECODE_RTOL, DECODE_ATOL)
               + close_count(torch, lse, want_lse, DECODE_RTOL, DECODE_ATOL))
        check(bad == 0, f"decode_attention_partial differs from its plain "
                        f"version on the rank's block ({B}, {S}, {KV}, {G}, "
                        f"{hd}) at count {n}")
        err = max(err, float((out - want_out).abs().max()),
                  float((lse - want_lse).abs().max()))
    n = counts[0]
    nbytes = (2 * B * n * KV * hd + 2 * 4 * B * n * KV
              + 4 * B * KV * G * (2 * hd + 1))
    b_ms, b_by = bound_ms(4 * B * KV * G * hd * n, nbytes, FP32_OPS_PER_S)
    return {"shape": f"B={B}, S={S}, KV={KV}, G={G}, hd={hd}", "count": n,
            "counts_checked": list(counts),
            "ms": time_ms(torch, lambda: decode_attention_partial(*ops, n),
                          iters=200, warmup=10),
            "plain_ms": time_ms(torch, lambda: decode_attention_partial_plain(
                *ops, n), iters=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


def kv_seq_mesh_serve(torch, dist, mesh, ref: dict) -> dict:
    """One rank's granite_20b serving with its caches' slots striped over
    ``model``: the prompt, then the one-process run's tokens forced into
    the decode steps; the prefill's and each step's whole logits against
    the one-process run's, timings, launches and collectives, the cache
    bytes a rank beside the whole cache's, and
    ``decode_attention_partial`` on this rank's block against its plain
    version (a mid-block count and an empty block)."""
    import gc

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.serve_step import make_decode_step, make_prefill

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    SH.set_mesh(mesh, SH.DEFAULT_RULES.replace(kv_seq="model"))
    cfg = kv_seq_cfg()
    B, P, G = KV_SEQ_BATCH, KV_SEQ_PROMPT, KV_SEQ_GEN
    model = build_model(cfg, "cuda", mesh)
    params = model.init(seed=0)
    batch = TokenPipeline(B, P, cfg.vocab_size).get_for(cfg, 0, "cuda", mesh)
    cache = model.init_cache(B, P + G)
    blk = cache[0].seq_block
    check(blk is not None and all(c.seq_block == blk for c in cache),
          f"kv_seq on {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}: "
          f"the caches are not striped ({blk})")
    prefill, decode = make_prefill(model), make_decode_step(model)
    tokens = ref["tokens"].cuda()

    def share(got, want) -> float:
        want = want.cuda()
        return float((SH.full_value(got).float() - want).abs().max()
                     / want.abs().max())

    dist.barrier()
    decode_attention.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = SH.full_value(logits).argmax(-1).to(torch.int32)
    prefill_agree = int((first == tokens[:, :1]).sum())
    shares = [share(logits, ref["prefill"])]
    step_ms, coll_n, coll_ms = [], 0, 0.0
    for i in range(G - 1):
        snap = gloo_snapshot(SH)
        t0 = time.perf_counter()
        lp, cache = decode(params, tokens[:, i:i + 1], cache, P + i)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        n, ms = gloo_delta(SH, snap)
        coll_n, coll_ms = coll_n + n, coll_ms + ms
        shares.append(share(lp, ref["logits"][i]))
    launches = decode_attention.launches
    rows, kv, hd = cache[0].k.shape[0], cfg.num_kv_heads, cfg.resolved_head_dim
    whole = cfg.num_layers * rows * (P + G) * kv * (2 * hd + 2 * 4)
    kernel = partial_on_block(torch, cache[0], cfg.num_heads // kv,
                              (blk.length, blk.length // 2 + 1, 0))
    ms = torch.tensor(step_ms, dtype=torch.float64)
    return {"prefill_s": prefill_s, "prefill_agree": prefill_agree,
            "decode_p50_ms": float(torch.quantile(ms, 0.5)),
            "decode_p95_ms": float(torch.quantile(ms, 0.95)),
            "tokens_per_s": B * len(step_ms) / (sum(step_ms) / 1e3),
            "max_share": max(shares), "share": shares,
            "launches": launches,
            "gloo_collectives_a_step": coll_n / len(step_ms),
            "gloo_ms_a_step": coll_ms / len(step_ms),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "cache_shape": tuple(cache[0].k.shape), "seq_block": tuple(blk),
            "cache_bytes": cache_bytes(cache), "whole_cache_bytes": whole,
            "kernel": kernel}


def kv_seq_report(mesh: str, world: int, got: list, one: dict,
                  launches: dict, limit: str) -> None:
    """The kv_seq job's line and checks on ``mesh``."""
    print(json.dumps({"path": "lm mesh kv_seq serve", "mesh": mesh,
                      "ranks": world, "processes_on_one_card": True,
                      "backend": "gloo", "per_rank": got,
                      "one_process": one, "card, power limit": limit},
                     default=str))
    want = (KV_SEQ_GEN - 1) * KV_SEQ_LAYERS
    check(all(g["launches"] == want for g in got),
          f"decode_attention launches a rank with kv_seq on {mesh}: "
          f"{[g['launches'] for g in got]}, want {want}")
    check(all(g["max_share"] <= LM_REPLAY_SHARE for g in got),
          f"kv_seq serving on {mesh}: logits off the one-process run by "
          f"{[g['max_share'] for g in got]} of the step's largest")
    blocks = [g["seq_block"][:2] for g in got]
    sl = (KV_SEQ_PROMPT + KV_SEQ_GEN) // world
    check(blocks == [(r * sl, sl) for r in range(world)]
          and all(g["cache_bytes"] * world == g["whole_cache_bytes"]
                  for g in got),
          f"kv_seq on {mesh}: blocks {blocks}, cache bytes "
          f"{[g['cache_bytes'] for g in got]}")
    launches["decode_attention"][f"kv_seq {mesh}"] = got[0]["launches"]
    k = got[0]["kernel"]
    print(f"lm mesh kv_seq serve {mesh}: granite_20b {KV_SEQ_LAYERS} "
          f"layers, prefill {max(g['prefill_s'] for g in got):.3f} s "
          f"({min(g['prefill_agree'] for g in got)} of {KV_SEQ_BATCH} first "
          f"tokens agree), decode p50 {got[0]['decode_p50_ms']:.2f} / p95 "
          f"{got[0]['decode_p95_ms']:.2f} ms, {got[0]['tokens_per_s']:.1f} "
          f"tokens/s, gloo {got[0]['gloo_collectives_a_step']:.0f} "
          f"collectives a step, {got[0]['gloo_ms_a_step']:.2f} ms, peak "
          f"{[round(g['peak_gib'], 2) for g in got]} GiB, cache "
          f"{got[0]['cache_bytes'] / 2**20:.1f} MiB a rank (whole on every "
          f"rank without kv_seq: {got[0]['whole_cache_bytes'] / 2**20:.1f} "
          f"MiB), decode_attention_partial {got[0]['launches']} launches a "
          f"rank at {k['shape']} count {k['count']} ({k['ms']:.4f} ms, plain "
          f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms); logits "
          f"within {max(g['max_share'] for g in got):.2e} of the largest "
          f"(one process: {one['decode_p50_ms']:.2f} ms p50, prefill "
          f"{one['prefill_s']:.3f} s; there, alone on the card, the partial "
          f"on this block {one[f'block_kernel_{world}']['ms']:.4f} ms and "
          f"decode_attention over the whole cache "
          f"{one['whole_cache_kernel']['ms']:.4f} ms)")


# phase 10b: the MoE (expert-parallel), encoder-decoder and VLM families
# over the same gloo groups, in phase 10's rank processes: deepseek_moe_16b
# served at full width and depth on (1, 2) (32 experts and 8 kv heads a
# rank) and, cut to FAMILY_SHORT_LAYERS layers, decoded briefly on (2, 1)
# (a decode step's 32 tokens are one MoE group, which does not divide
# ``data``, so every rank routes it whole) and trained with 2 of its 28
# layers on (2, 2); whisper_medium served at full width and depth and
# trained (2 encoder and 2 decoder layers, imc_linear, whole 128-column
# ``ff`` tiles a rank) on (1, 2); internvl2_76b served at full width with
# FAMILY_VLM_LAYERS of its 80 layers on (1, 4). Each beside the same run in
# this process. The MoE serving runs take this process's routing (the
# forced replay of phase 7b), so that their logits answer for the kernel
# and the sharding and not for bfloat16's routing flips; the decisions
# the mesh itself made are counted against this process's (descriptive).
FAMILY_SHORT_LAYERS, FAMILY_SHORT_GEN = 2, 2
FAMILY_VLM_LAYERS = 2
# Whisper's serving decoder: 12 of its 24 layers (its 24 encoder layers
# whole) since phase 10c joined the time limit
FAMILY_WHISPER_SERVE_LAYERS = 12
# the MoE's serving depth on (1, 2): 8 of deepseek's 28 layers since phase
# 10c joined the time limit (its prefill took 22.2 s at 28, PERF.md)
FAMILY_MOE_SERVE_LAYERS = 8
# phase 10c: xlstm_125m served at full width and depth on (1, 2), (2, 1)
# and (1, 4), hymba_1_5b served at full width and depth on (1, 2) (both as
# float32 copies, as phase 7c checks them: random-weight recurrent stacks
# amplify bfloat16 rounding past LM_REPLAY_SHARE, PERF.md) with every
# decode_attention launch held against its plain version, hymba_1_5b
# trained with REC_TRAIN_LAYERS of its 32 layers and imc_linear on (2, 2)
# (its ff of 5,504 is 2,752 columns a rank: not whole 128-column tiles,
# so _imc_linear gathers ff), and the DCN process-group route over a model
# sharded within each pod ("dcn", below)
REC_TRAIN_LAYERS = 4
REC_SERVE = ("xlstm serve", "hymba serve")
REC_MESH_JOBS = {2: (("xlstm serve", (1, 2)), ("xlstm serve", (2, 1)),
                     ("hymba serve", (1, 2))),
                 4: (("xlstm serve", (1, 4)), ("hymba train", (2, 2)),
                     ("dcn", (2, 1, 2)))}
FAMILY_SERVE = {"moe serve": ("deepseek_moe_16b", FAMILY_MOE_SERVE_LAYERS,
                              LM_CONFIGS_GEN),
                "moe decode": ("deepseek_moe_16b", FAMILY_SHORT_LAYERS,
                               FAMILY_SHORT_GEN),
                "whisper serve": ("whisper_medium",
                                  FAMILY_WHISPER_SERVE_LAYERS,
                                  LM_CONFIGS_GEN),
                "vlm serve": ("internvl2_76b", FAMILY_VLM_LAYERS,
                              LM_CONFIGS_GEN),
                "xlstm serve": ("xlstm_125m", None, LM_CONFIGS_GEN),
                "hymba serve": ("hymba_1_5b", None, LM_CONFIGS_GEN)}
# job -> (arch, layers, encoder layers, imc_linear)
FAMILY_TRAIN = {"moe train": ("deepseek_moe_16b", 1, 0, False),
                "whisper train": ("whisper_medium", 2, 2, True),
                "hymba train": ("hymba_1_5b", REC_TRAIN_LAYERS, 0, True)}
FAMILY_LOSS_RTOL = 2e-3


def family_cfg(job: str):
    """The config of a phase 10b job: published widths, its depth cut,
    the int8 KV store for serving, imc_linear where the job trains it."""
    import dataclasses

    from repro_torch.configs import get_config

    if job in FAMILY_SERVE:
        arch, layers, _ = FAMILY_SERVE[job]
        cfg = dataclasses.replace(get_config(arch), kv_quant_int8=True)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        if job in REC_SERVE:
            cfg = dataclasses.replace(cfg, dtype="float32")
        return cfg
    arch, layers, enc, imc = FAMILY_TRAIN[job]
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers,
                               num_encoder_layers=enc or
                               cfg.num_encoder_layers, imc_linear=imc)


def family_train_cfg():
    from repro_torch.train import AdamWConfig, TrainConfig

    return TrainConfig(optimizer=AdamWConfig(total_steps=10), remat="full",
                       cast_params_bf16=True)


def routes_share(mine: list, theirs: list, skip: int,
                 data_rank: int = 0) -> float:
    """The share of tokens, after the first ``skip`` calls, whose experts
    or kept mask differ between this rank's routes and another run's
    (cut to this rank's block of groups)."""
    bad = total = 0
    for r, f in zip(mine[skip:], theirs[skip:], strict=True):
        g = r.expert.shape[0]
        e2, k2 = f.expert, f.keep
        if e2.shape[0] != g:
            e2, k2 = (t[data_rank * g:(data_rank + 1) * g] for t in (e2, k2))
        bad += int(((r.expert.cpu() != e2) | (r.keep.cpu() != k2))
                   .any(-1).sum())
        total += g * r.expert.shape[1]
    return bad / max(total, 1)


def host_routes(layers_mod, routes: list) -> list:
    """Recorded routes as host copies, without autograd."""
    return [layers_mod.MoERoute(*(t.detach().cpu() for t in (
        r.weight, r.expert, r.pos, r.keep))) for r in routes]


def family_one_process(torch, jobs) -> tuple[dict, dict]:
    """This process's runs phases 10b and 10c hold the meshes against, for
    the serving and training ``jobs`` named: each serving job's launcher
    run (tokens, every decode step's logits, the MoE's routes) and each
    training job's steps (losses, routes)."""
    import gc

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import init_train_state, make_train_step

    refs, lines = {}, {}
    for job, (arch, _, gen) in FAMILY_SERVE.items():
        if job not in jobs:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        cfg = family_cfg(job)
        sink = []
        argv = ["--arch", arch, "--kv-quant", "--batch",
                str(LM_CONFIGS_BATCH), "--prompt-len",
                str(LM_CONFIGS_PROMPT), "--gen", str(gen), "--device",
                "cuda"]
        with mock.patch.object(serve, "get_config", lambda a, c=cfg: c), \
                moe_route_recorder(L, sink):
            run = serve.main(argv, keep_logits=True)
        refs[job] = {"tokens": run.tokens.cpu(), "start": run.start,
                     "cache_len": run.cache_len,
                     "logits": [x.cpu() for x in run.logits],
                     "routes": host_routes(L, sink)}
        lines[job] = {"prefill_s": run.prefill_s,
                      "decode_p50_ms": run.step_percentile_ms(0.5),
                      "decode_p95_ms": run.step_percentile_ms(0.95),
                      "tokens_per_s": run.decode_tokens_per_s,
                      "peak_gib": run.peak_bytes / 2**30,
                      "launches": run.launches}
        del run, sink
    tcfg = family_train_cfg()
    for job in FAMILY_TRAIN:
        if job not in jobs:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        cfg = family_cfg(job)
        model = build_model(cfg, "cuda")
        state = init_train_state(model, seed=0, tcfg=tcfg)
        step_fn = make_train_step(model, tcfg)
        pipe = TokenPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
        sink, losses, step_ms = [], [], []
        with moe_route_recorder(L, sink):
            for s in range(LM_MESH_STEPS):
                batch = pipe.get_for(cfg, s, "cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))
                step_ms.append(1e3 * (time.perf_counter() - t0))
        refs[job] = {"losses": losses, "routes": host_routes(L, sink)}
        lines[job] = {"losses": losses, "step_ms": step_ms}
        del state, step_fn, model, sink
    gc.collect()
    torch.cuda.empty_cache()
    return refs, lines


def family_mesh_serve(torch, dist, mesh, job: str, ref: dict) -> dict:
    """One rank's serving run of a phase 10b job on ``mesh``: the prompt,
    then this process's tokens forced into the decode steps (and, for the
    MoE, its routes); each step's whole logits against this process's,
    timings, launches, collectives, the routing decisions that differ,
    and ``decode_attention`` at this rank's cache block against its plain
    version."""
    import contextlib
    import gc

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.serve_step import make_decode_step, make_prefill

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = family_cfg(job)
    B, P = LM_CONFIGS_BATCH, LM_CONFIGS_PROMPT
    model = build_model(cfg, "cuda", mesh)
    params = model.init(seed=0)
    batch = TokenPipeline(B, P, cfg.vocab_size).get_for(cfg, 0, "cuda", mesh)
    start, steps = ref["start"], len(ref["logits"])
    cache = model.init_cache(B, ref["cache_len"])
    prefill, decode = make_prefill(model), make_decode_step(model)
    tokens = ref["tokens"].cuda()
    data_rank = mesh.get_local_rank("data")
    sink = []
    moe = cfg.family == "moe"
    patch = (moe_route_recorder(L, sink, ref["routes"], data_rank)
             if moe else contextlib.nullcontext())
    # phase 10c holds every launch against the plain version (inside the
    # timed steps)
    calls = []
    attend = launch_checker(torch, calls) if job in REC_SERVE else None
    decode_attention.launches = 0
    dist.barrier()
    with patch:
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        step_ms, coll_n, coll_ms, share = [], 0, 0.0, []
        for i in range(steps):
            snap = gloo_snapshot(SH)
            t0 = time.perf_counter()
            lp, cache = decode(params, tokens[:, i:i + 1], cache, start + i,
                               attend)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            n, ms = gloo_delta(SH, snap)
            coll_n, coll_ms = coll_n + n, coll_ms + ms
            want = ref["logits"][i].cuda()
            got = SH.full_value(lp)
            share.append(float((got - want).abs().max())
                         / float(want.abs().max()))
    launches = decode_attention.launches
    # the first layer's KV cache (a hybrid's or dec_cross layer's first
    # entry); the ssm family has none
    kvc = cache[0][0] if isinstance(cache[0], tuple) else cache[0]
    # and its recurrent state (a hybrid's second entry, an ssm layer's)
    rec = cache[0][1] if isinstance(cache[0], tuple) else cache[0]
    attention = hasattr(kvc, "k")
    kernel = None
    if attention:
        _, hl = SH.local_range(L.Q_AXES, (B, 1, cfg.num_heads,
                                          cfg.resolved_head_dim), 2)
        g = min(hl, cfg.num_heads // cfg.num_kv_heads)
        kernel = decode_attention_served(torch, kvc, g, start + steps)
    ms = torch.tensor(step_ms, dtype=torch.float64)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prefill_s": prefill_s,
           "decode_p50_ms": float(torch.quantile(ms, 0.5)),
           "decode_p95_ms": float(torch.quantile(ms, 0.95)),
           "tokens_per_s": B * steps / (sum(step_ms) / 1e3),
           "max_share": max(share), "share": share, "launches": launches,
           "want_launches": cfg.num_layers * steps if attention else 0,
           "gloo_collectives_a_step": coll_n / steps,
           "gloo_ms_a_step": coll_ms / steps,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "cache_shape": tuple(kvc.k.shape) if attention else None,
           "state_shapes": None if hasattr(rec, "k") else [
               tuple(t.shape) for t in vars(rec).values()],
           "kernel": kernel}
    if calls:
        out["checked_launches"] = len(calls)
        out["checked_max_abs"] = float(torch.stack([d for _, _, d, _ in
                                                    calls]).max())
        out["checked_mismatches"] = int(torch.stack([b for _, _, _, b in
                                                     calls]).sum())
    if cfg.is_encoder_decoder:
        out["cross_shape"] = tuple(cache[0][1].k.shape)
    if moe:
        # the decode steps' decisions (the prefill's calls come first)
        out["routing_differs"] = routes_share(sink, ref["routes"],
                                              cfg.num_layers, data_rank)
        out["prefill_routing_differs"] = routes_share(
            sink[:cfg.num_layers], ref["routes"][:cfg.num_layers], 0,
            data_rank)
        local = SH.local_range(("experts", None, None),
                               (cfg.num_experts, 1, 1), 0)[1]
        out["experts_a_rank"] = local
    return out


def family_mesh_train(torch, dist, mesh, job: str, ref: dict) -> dict:
    """One rank's LM_MESH_STEPS training steps of a phase 10b job on
    ``mesh``: losses against this process's, step times, collectives, the
    routing decisions that differ (MoE), and for imc_linear the launches
    a step and the first launch's operands on this rank's ff shard against
    the plain version."""
    import contextlib
    import gc

    from repro_torch.core.imc.array import ArrayConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, tcfg = family_cfg(job), family_train_cfg()
    model = build_model(cfg, "cuda", mesh)
    state = init_train_state(model, seed=0, tcfg=tcfg)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    rec, patch = imc_recorder(L)
    sink = []
    routes = (moe_route_recorder(L, sink) if cfg.family == "moe"
              else contextlib.nullcontext())
    imc_mvm.launches = 0
    losses, step_ms, coll_n, coll_ms = [], [], 0, 0.0
    with patch, routes:
        for s in range(LM_MESH_STEPS):
            batch = pipe.get_for(cfg, s, "cuda", mesh)
            dist.barrier()
            snap = gloo_snapshot(SH)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            n, ms = gloo_delta(SH, snap)
            coll_n, coll_ms = coll_n + n, coll_ms + ms
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "encoder_layers": cfg.num_encoder_layers, "losses": losses,
           "loss_rel_err": max(abs(a - b) / abs(b) for a, b in
                               zip(losses, ref["losses"])),
           "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (
               sum(step_ms[1:] or step_ms) / len(step_ms[1:] or step_ms)
               / 1e3),
           "imc_launches_a_step": imc_mvm.launches / LM_MESH_STEPS,
           "gloo_collectives_a_step": coll_n / LM_MESH_STEPS,
           "gloo_ms_a_step": coll_ms / LM_MESH_STEPS,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if cfg.imc_linear:
        q, w, kw, got = rec.pop("call")
        Q = q.shape[0]
        mism = 0
        rows = (slice(0, TRAIN_CHECK_Q), slice(Q - TRAIN_CHECK_Q, Q))
        t0 = time.perf_counter()
        for r in rows:
            mism += int((got[r] != imc_mvm_plain(q[r], w, **kw)).sum())
        plain_ms = 1e3 * (time.perf_counter() - t0)
        shard = (Q, w.shape[0], q.shape[1])
        # this rank's launch timed while the others wait (the ranks share
        # the card): the ranks take turns
        for turn in range(dist.get_world_size()):
            dist.barrier()
            if turn == dist.get_rank():
                ms = time_ms(torch, lambda: imc_mvm(q, w, **kw), iters=5,
                             warmup=1)
        dist.barrier()
        out.update(imc_shard_shape=shard, imc_mismatches=mism,
                   imc_whole_tiles=shard[2] % ArrayConfig().cols == 0,
                   imc_ms=ms, imc_plain_ms_checked_rows=plain_ms)
        del q, w, got
    if cfg.family == "moe":
        out["routing_differs"] = routes_share(
            sink, ref["routes"], 0, mesh.get_local_rank("data"))
    return out


def family_report(job: str, mesh: str, world: int, got: list, one: dict,
                  limit: str, launches: dict) -> None:
    """Phase 10b's (and 10c's) line and checks for one job's ranks
    (``got``) beside this process's run (``one``); the kernels' launches
    a rank go into ``launches``."""
    phase = "recurrent" if job in REC_MESH_NAMES else "family"
    line = {"path": f"{phase} mesh {job}", "mesh": mesh, "ranks": world,
            "processes_on_one_card": True, "backend": "gloo",
            "one_process": one, "per_rank": got,
            "card, power limit": limit}
    print(json.dumps(line, default=str))
    g0 = got[0]
    cell = f"{g0['arch']} {mesh}"
    peaks = [round(g["peak_gib"], 2) for g in got]
    gloo = (f"gloo {g0['gloo_ms_a_step']:.1f} ms a step "
            f"({g0['gloo_collectives_a_step']:.0f} collectives)")
    if job in FAMILY_SERVE:
        check(all(g["launches"] == g["want_launches"] for g in got),
              f"{cell}: decode_attention launches a rank "
              f"{[g['launches'] for g in got]}, want {g0['want_launches']}")
        check(all(g["max_share"] <= LM_REPLAY_SHARE for g in got),
              f"{cell}: logits off the one-process run by "
              f"{[g['max_share'] for g in got]} of the step's largest")
        if g0["want_launches"]:
            launches["decode_attention"][cell] = g0["launches"]
        moe = ""
        if "checked_launches" in g0:
            check(all(g["checked_launches"] == g["want_launches"]
                      and g["checked_mismatches"] == 0 for g in got),
                  f"{cell}: decode_attention launches held against the "
                  f"plain version: "
                  f"{[(g['checked_launches'], g['checked_mismatches']) for g in got]}")
            moe = (f"; every launch on every rank against the plain "
                   f"version ({sum(g['checked_launches'] for g in got)} "
                   f"launches, max |err| "
                   f"{max(g['checked_max_abs'] for g in got):.2e}, 0 past "
                   f"rtol / atol {DECODE_RTOL}; the timed steps include the "
                   f"plain calls)")
        if "routing_differs" in g0:
            moe = (f"; {g0['experts_a_rank']} experts a rank, routing "
                   f"decisions differing from one process's: decode "
                   f"{max(g['routing_differs'] for g in got):.4f}, prefill "
                   f"{max(g['prefill_routing_differs'] for g in got):.4f} "
                   f"(this process's routes forced)")
        k = g0["kernel"]
        kernel = ("no attention" if k is None else
                  f"decode_attention {g0['launches']} launches a rank at "
                  f"{k['shape']} ({k['ms']:.4f} ms, plain "
                  f"{k['plain_ms']:.4f} ms, max err "
                  f"{k['max_abs_err']:.2e})")
        print(f"{phase} mesh {job} {cell}: {g0['layers']} layers, "
              f"{g0['dtype']}, prefill "
              f"{max(g['prefill_s'] for g in got):.3f} s (one process "
              f"{one['prefill_s']:.3f}), decode p50 "
              f"{g0['decode_p50_ms']:.2f} / p95 {g0['decode_p95_ms']:.2f} ms "
              f"(one process {one['decode_p50_ms']:.2f} / "
              f"{one['decode_p95_ms']:.2f}), {g0['tokens_per_s']:.1f} "
              f"tokens/s, peak {peaks} GiB, {gloo}; {kernel}; logits "
              f"within {max(g['max_share'] for g in got):.2e} of the "
              f"largest{moe}")
        return
    want_imc = (g0["layers"] + g0["encoder_layers"]
                if "imc_shard_shape" in g0 else 0)
    check(all(g["loss_rel_err"] <= FAMILY_LOSS_RTOL
              and g["imc_launches_a_step"] == want_imc
              and g.get("imc_mismatches", 0) == 0 for g in got),
          f"{cell} training: "
          f"{[(g['losses'], g['imc_launches_a_step'], g.get('imc_mismatches')) for g in got]}"
          f" vs one process {one['losses']}")
    if want_imc:
        launches["imc_mvm"][cell] = g0["imc_launches_a_step"]
    extra = ""
    if want_imc:
        extra = (f", imc_mvm {g0['imc_launches_a_step']:.0f} launches a "
                 f"rank a step on the shard {g0['imc_shard_shape']} (whole "
                 f"tiles: {g0['imc_whole_tiles']}; "
                 f"{g0['imc_ms']:.4f} ms a launch with the other ranks "
                 f"idle, plain {g0['imc_plain_ms_checked_rows']:.1f} ms on "
                 f"the {2 * TRAIN_CHECK_Q} checked rows), "
                 f"{sum(g['imc_mismatches'] for g in got)} mismatches")
    if "routing_differs" in g0:
        extra += (f", routing decisions differing from one process's "
                  f"{max(g['routing_differs'] for g in got):.4f}")
    print(f"{phase} mesh {job} {cell}: step "
          f"{[round(x, 1) for x in g0['step_ms']]} ms (one process "
          f"{[round(x, 1) for x in one['step_ms']]}), "
          f"{g0['tokens_per_s']:.1f} tokens/s, peak {peaks} GiB, loss "
          f"{g0['losses']} (one process {one['losses']}, off by "
          f"{max(g['loss_rel_err'] for g in got):.2e} relative), {gloo}"
          f"{extra}")


# the DCN job of phase 10c: xlstm_125m at full width and depth, float32
# (so that a loss and a parameter can be held within DCN_MESH_RTOL),
# TRAIN_BATCH x TRAIN_SEQ in 2 pod slices, DCN_MESH_STEPS steps with each of
# DCN_MESH_METHODS on a (pod 2, data 1, model 2) mesh of 4 processes (the
# process-group route, each pod's two ranks computing its slice on the
# model sharded over ``model``), beside the emulated route in this process
# and, for ``none``, beside the emulated route run by each pod's own
# (data, model) ranks (the same sharded arithmetic, folded in pod order)
DCN_MESH_METHODS = ("none", "topk_ef")
DCN_MESH_STEPS = 2
DCN_MESH_RTOL = 1e-5
# after the first update the routes' rounding, amplified by xLSTM's random
# weights, moves a loss and the parameters: ``none`` is held against one
# process by these limits, checked in every run to lie below the
# control's gaps (one pod's sends dropped in one process): the losses
# after the first update relatively, the mean |parameter difference| in
# units of the learning rates the steps applied. Each is the geometric
# mean of a sound run's gap and the control's on the H100 (PERF.md):
# loss 1.19e-4 and 1.11e-3, mean 0.233 and 0.338
DCN_MESH_LOSS_RTOL = 3.6e-4
DCN_MESH_MEAN_LR = 0.28
REC_MESH_NAMES = REC_SERVE + ("hymba train", "dcn")


def dcn_mesh_setup(method: str):
    """(config, TrainConfig) of the DCN job for one method."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.train import AdamWConfig, TrainConfig

    cfg = dataclasses.replace(get_config("xlstm_125m"), dtype="float32")
    return cfg, TrainConfig(optimizer=AdamWConfig(total_steps=10),
                            remat="full", dcn_pods=2,
                            dcn_compression=method)


def dcn_applied_lr() -> float:
    """The sum of the learning rates the DCN job's steps apply (its
    warmup's first steps)."""
    from repro_torch.train.optimizer import schedule

    opt = dcn_mesh_setup("none")[1].optimizer
    return sum(schedule(opt, s + 1) for s in range(DCN_MESH_STEPS))


def dcn_steps(torch, mesh, method: str, sends=None, send=None) -> tuple:
    """DCN_MESH_STEPS steps of the DCN job from seed 0 over ``mesh``
    (None: this process): (route, losses, step ms, the metrics' DCN
    bytes, the state). ``sends``: a list that gets, for every step's
    ``dcn_send_leaf`` calls of the process-group route with a residual,
    (step, the elements where ``sent + new residual != grads + old
    residual``, the old residual's non-zero elements). ``send``: a
    stand-in for the train step's ``dcn_send_leaf`` (the control)."""
    import contextlib

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist import compression as C
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train import train_step as TS

    cfg, tcfg = dcn_mesh_setup(method)
    model = build_model(cfg, "cuda", mesh)
    state = init_train_state(model, seed=0, tcfg=tcfg)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    real = C.dcn_send_leaf
    step = [0]

    def checked(g, e, i, method, frac, key, u=None):
        sent, ne = real(g, e, i, method, frac, key, u)
        if e is not None:
            sends.append((step[0], int(((sent + ne) != (g.float() + e))
                                       .sum()), int((e != 0).sum())))
        return sent, ne

    patch = (mock.patch.object(C, "dcn_send_leaf", checked)
             if sends is not None else
             mock.patch.object(TS, "dcn_send_leaf", send)
             if send is not None else contextlib.nullcontext())
    losses, step_ms, sent_bytes = [], [], []
    for s in range(DCN_MESH_STEPS):
        step[0] = s
        batch = pipe.get_for(cfg, s, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patch:
            state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        sent_bytes.append((m["dcn_bytes"], m["dcn_raw_bytes"]))
    return step_fn.dcn_route, losses, step_ms, sent_bytes, state


def dropped_pod_send(torch):
    """The control's ``dcn_send_leaf`` for the emulated route: pod 1's
    sends are zeros (the route sends pod 0's leaves from leaf 0 on, then
    pod 1's, every step)."""
    from repro_torch.dist import compression as C

    starts = [0]

    def send(g, e, i, *args):
        sent, ne = C.dcn_send_leaf(g, e, i, *args)
        starts[0] += i == 0
        return (torch.zeros_like(sent) if starts[0] % 2 == 0 else sent), ne
    return send


def loss_gap(losses: list, want: list) -> list:
    """Each step's |loss - wanted| relative to the wanted loss."""
    return [abs(a - b) / abs(b) for a, b in zip(losses, want, strict=True)]


def dcn_one_process(torch) -> tuple[dict, dict]:
    """The DCN job's emulated route in this process: each method's losses
    and DCN bytes, ``none``'s parameters after (host copies), and the
    control (``none`` with one pod's sends dropped): its losses' and
    parameters' gaps from ``none``'s."""
    import gc

    from repro_torch.dist import sharding as SH

    refs, lines = {}, {}
    for method in DCN_MESH_METHODS:
        gc.collect()
        torch.cuda.empty_cache()
        route, losses, step_ms, sent, state = dcn_steps(torch, None, method)
        check(route == "emulated", f"the DCN job in one process: {route}")
        refs[method] = {"losses": losses, "bytes": sent}
        if method == "none":
            refs[method]["params"] = [p.detach().cpu() for p in
                                      state.params.parameters()]
        lines[method] = {"losses": losses, "step_ms": step_ms,
                         "bytes": sent}
        del state
    _, losses, _, _, state = dcn_steps(torch, None, "none",
                                       send=dropped_pod_send(torch))
    lines["control"] = {
        "losses": losses,
        "loss_rel_err": loss_gap(losses, refs["none"]["losses"]),
        "vs_one_process": param_gap(torch, SH, state.params,
                                    refs["none"]["params"],
                                    dcn_applied_lr())}
    del state
    return refs, lines


def param_gap(torch, SH, params, ref: list, lr: float) -> dict:
    """This state's whole parameters against ``ref`` (host tensors):
    elements outside rtol DCN_MESH_RTOL (atol 0), the largest and the mean
    |difference| in units of ``lr`` (the learning rates the steps
    applied) and as they are."""
    outside = total = 0
    worst = mean = 0.0
    for p, want in zip(params.parameters(), ref, strict=True):
        got = SH.full_value(p).detach().cpu()
        d = (got - want).abs()
        outside += int((d > DCN_MESH_RTOL * want.abs()).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
        mean += float(d.sum())
    return {"outside_rtol": outside, "elements": total,
            "max_lr": worst / lr, "mean_lr": mean / total / lr,
            "max": worst, "mean": mean / total}


def dcn_mesh_train(torch, dist, mesh, ref: dict) -> dict:
    """One rank's DCN job on the (pod, data, model) ``mesh``: each method's
    losses and DCN bytes against this process's emulated route, the step
    times, the error-feedback invariant's mismatches on every step, the
    old residual's non-zero elements on the last, the residual rows'
    shape; for ``none`` the parameters against this process's and
    against the emulated route run by the pod's own (data, model)
    ranks."""
    import gc

    from repro_torch.dist import sharding as SH

    out = {"pod": mesh.get_local_rank("pod")}
    lr = dcn_applied_lr()
    for method in DCN_MESH_METHODS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sends = []
        dist.barrier()
        snap = gloo_snapshot(SH)
        route, losses, step_ms, sent, state = dcn_steps(torch, mesh, method,
                                                        sends)
        n, ms = gloo_delta(SH, snap)
        last = DCN_MESH_STEPS - 1
        r = {"route": route, "losses": losses, "step_ms": step_ms,
             "bytes": sent,
             "loss_rel_err": loss_gap(losses, ref[method]["losses"]),
             "invariant_mismatches": sum(x[1] for x in sends),
             "leaves_sent": [sum(x[0] == s for x in sends)
                             for s in range(DCN_MESH_STEPS)],
             "old_residual_nonzero_last_step": sum(
                 x[2] for x in sends if x[0] == last),
             "ef_rows": sorted({tuple(e.shape[:1]) for e in state.ef})
             if state.ef else [],
             "gloo_collectives": n, "gloo_ms": ms,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "whole_tree_gib": 4 * sum(p.numel() for p in
                                       state.params.parameters()) / 2**30}
        if method == "none":
            r["vs_one_process"] = param_gap(torch, SH, state.params,
                                            ref[method]["params"], lr)
            mine = [SH.full_value(p).detach().cpu()
                    for p in state.params.parameters()]
            del state
            _, sub_losses, _, _, sub = dcn_steps(torch, mesh["data", "model"],
                                                 method)
            r["vs_pod_emulated"] = param_gap(torch, SH, sub.params, mine, lr)
            r["pod_emulated_losses"] = sub_losses
            del sub, mine
        else:
            del state
        out[method] = r
    return out


def dcn_report(world: int, got: list, one: dict, limit: str) -> None:
    """Phase 10c's DCN line and checks."""
    print(json.dumps({"path": "recurrent mesh dcn", "mesh": "2x1x2",
                      "ranks": world, "processes_on_one_card": True,
                      "backend": "gloo", "one_process": one,
                      "per_rank": got, "card, power limit": limit},
                     default=str))
    check(all(g[m]["route"] == "shard_map" for g in got
              for m in DCN_MESH_METHODS),
          "the DCN job did not take the process-group route")
    none = [g["none"] for g in got]
    ctl = one["control"]
    # the first step's loss is taken from the same parameters by both
    # routes: rtol 1e-5. After an update xLSTM's random-weight stack
    # amplifies the routes' rounding (a 1e-7 perturbation moves its logits
    # by 0.009 of the largest, phase 7c): the later losses and the
    # parameters are held against one process by limits the control must
    # exceed, and bit for bit against the emulated route run by the pod's
    # own ranks, which sums in the same order
    check(all(g["loss_rel_err"][0] <= DCN_MESH_RTOL for g in none),
          f"DCN none: first loss {[g['losses'][0] for g in none]} against "
          f"one process's {one['none']['losses'][0]} past rtol "
          f"{DCN_MESH_RTOL}")
    check(min(ctl["loss_rel_err"][1:]) > DCN_MESH_LOSS_RTOL
          and ctl["vs_one_process"]["mean_lr"] > DCN_MESH_MEAN_LR,
          f"DCN none: the control (one pod's sends dropped) is within the "
          f"limits (losses {ctl['loss_rel_err']} against rtol "
          f"{DCN_MESH_LOSS_RTOL}, mean {ctl['vs_one_process']['mean_lr']} "
          f"lr against {DCN_MESH_MEAN_LR}): the check could not see it")
    check(all(max(g["loss_rel_err"][1:]) <= DCN_MESH_LOSS_RTOL
              for g in none),
          f"DCN none: losses after the first update "
          f"{[g['losses'] for g in none]} against one process's "
          f"{one['none']['losses']} past rtol {DCN_MESH_LOSS_RTOL}")
    # AdamW moves an element by at most its step's lr (|m| <= sqrt(v)
    # after bias correction), and each route rounds it to float32 once a
    # step: 1e-6 covers the ulps of parameters under 4 in magnitude
    lr = dcn_applied_lr()
    check(all(g["vs_one_process"]["max"] <= 2 * lr + 1e-6
              and g["vs_one_process"]["mean_lr"] <= DCN_MESH_MEAN_LR
              for g in none),
          f"DCN none: parameters off one process's past 2 lr a step or a "
          f"mean of {DCN_MESH_MEAN_LR} lr: "
          f"{[g['vs_one_process'] for g in none]}")
    check(all(g["vs_pod_emulated"]["outside_rtol"] == 0
              and g["pod_emulated_losses"] == g["losses"] for g in none),
          f"DCN none: losses or parameters off the pod's emulated route: "
          f"{[(g['losses'], g['pod_emulated_losses'], g['vs_pod_emulated']) for g in none]}")
    ef = [g["topk_ef"] for g in got]
    check(all(g["invariant_mismatches"] == 0 and min(g["leaves_sent"]) > 0
              and g["old_residual_nonzero_last_step"] > 0
              and g["ef_rows"] == [(1,)] for g in ef),
          f"DCN topk_ef: sent + new residual != grads + old residual, no "
          f"old residual on the last step, or residual rows other than "
          f"(1, ...): {[(g['invariant_mismatches'], g['leaves_sent'], g['old_residual_nonzero_last_step'], g['ef_rows']) for g in ef]}")
    for m in DCN_MESH_METHODS:
        check(all(g[m]["bytes"] == one[m]["bytes"] for g in got),
              f"DCN {m}: dcn_bytes {[g[m]['bytes'] for g in got]} against "
              f"one process's {one[m]['bytes']}")
    g = none[0]
    print(f"recurrent mesh dcn 2x1x2: xlstm_125m (12 layers, float32) on "
          f"the process-group route over 2 pods of (data 1, model 2), "
          f"{DCN_MESH_STEPS} steps: none step "
          f"{[round(x, 1) for x in g['step_ms']]} ms (one process "
          f"{[round(x, 1) for x in one['none']['step_ms']]}), losses off "
          f"one process's by {[max(x['loss_rel_err'][s] for x in none) for s in range(DCN_MESH_STEPS)]} "
          f"relative (the control, one pod's sends dropped: "
          f"{ctl['loss_rel_err']}), losses and parameters equal to the "
          f"pod's emulated route "
          f"({max(x['vs_pod_emulated']['max_lr'] for x in none):.2e} lr) and "
          f"within {max(x['vs_one_process']['max_lr'] for x in none):.3f} "
          f"lr (mean {max(x['vs_one_process']['mean_lr'] for x in none):.4f}"
          f" lr; the control {ctl['vs_one_process']['mean_lr']:.4f}) of one "
          f"process's, in units of the learning rates the steps applied "
          f"({lr:.3g} in all) "
          f"({g['vs_one_process']['outside_rtol']} of "
          f"{g['vs_one_process']['elements']} outside rtol {DCN_MESH_RTOL}); "
          f"topk_ef step {[round(x, 1) for x in ef[0]['step_ms']]} ms (one "
          f"process {[round(x, 1) for x in one['topk_ef']['step_ms']]}), "
          f"sent + new residual == grads + old residual on all "
          f"{sum(sum(x['leaves_sent']) for x in ef)} sends of every rank and "
          f"step ({min(x['old_residual_nonzero_last_step'] for x in ef)} "
          f"non-zero old residual elements or more a rank on the last), "
          f"residual rows (1, ...), dcn {ef[0]['bytes'][0][0] / 2**20:.2f} "
          f"MiB a pod ({ef[0]['bytes'][0][1] / ef[0]['bytes'][0][0]:.1f}x "
          f"smaller), as one process's; peak none "
          f"{[round(x['peak_gib'], 2) for x in none]}, topk_ef "
          f"{[round(x['peak_gib'], 2) for x in ef]} GiB a rank (the whole "
          f"float32 tree {g['whole_tree_gib']:.2f} GiB)")


def lm_mesh_rank(rank: int, world: int, store: str, out: str,
                 jobs: tuple) -> None:
    """One rank of phases 10-10c, in a process of its own: joins the gloo
    group through the ``file://`` store, runs ``jobs`` ((job, mesh shape)
    pairs: a (data, model) mesh, or (pod, data, model) for three dims) and
    writes its results to ``<out>/rank<r>.pkl`` (a failure writes its
    traceback to ``<out>/rank<r>.err`` first)."""
    import gc
    import pickle
    import traceback

    import os

    out_dir = Path(out)
    # four processes' caching allocators share the card: segments that
    # grow in place leave less reserved but unused memory in each
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        sys.path.insert(0, str(SRC))
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.dist import sharding as SH

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        # this script's own file, holding the MoE's recorded routes
        ref = torch.load(out_dir / "one_process.pt", weights_only=False)
        res, state = {}, None
        try:
            for job, shape in jobs:
                names = ("pod", "data", "model")[-len(shape):]
                mesh = init_device_mesh("cuda", shape, mesh_dim_names=names)
                t0 = time.perf_counter()
                if job == "serve":
                    r = lm_mesh_serve(torch, dist, mesh, ref["serve"])
                elif job == "train":
                    state = None
                    gc.collect()
                    r, state = lm_mesh_train(
                        torch, dist, mesh, ref["train"],
                        out_dir / "ckpt" if world == 4 else None)
                elif job == "restore":
                    r = lm_mesh_restore(torch, mesh, out_dir / "ckpt")
                elif job == "kv_seq serve":
                    state = None
                    gc.collect()
                    r = kv_seq_mesh_serve(torch, dist, mesh, ref["kv_seq"])
                elif job == "dcn":
                    state = None
                    gc.collect()
                    r = dcn_mesh_train(torch, dist, mesh, ref["dcn"])
                else:
                    state = None
                    gc.collect()
                    run = (family_mesh_serve if job in FAMILY_SERVE
                           else family_mesh_train)
                    r = run(torch, dist, mesh, job, ref["family"][job])
                r["wall_s"] = time.perf_counter() - t0
                res[job, shape] = r
                SH.set_mesh(None)
        finally:
            dist.destroy_process_group()
        (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_lm_ranks(world: int, out: Path, jobs: tuple) -> list:
    """``world`` processes of ``lm_mesh_rank`` running ``jobs`` (spawned;
    the kernels were built in this process); joined within
    LM_MESH_JOIN_S, else killed and failed. Returns each rank's
    results."""
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=lm_mesh_rank,
                         args=(r, world, str(out / "store"), str(out), jobs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + LM_MESH_JOIN_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        alive = sum(p.is_alive() for p in procs)
        errs = [f.read_text() for f in sorted(out.glob("rank*.err"))]
        check(alive == 0 and not errs and all(
            p.exitcode == 0 for p in procs),
            f"{world} ranks: {alive} still running after {LM_MESH_JOIN_S} "
            f"s, exit codes {[p.exitcode for p in procs]}, errors {errs}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def lm_mesh_one_process(torch) -> dict:
    """This process's runs phase 10 holds the meshes against: the serving
    launcher (its generated tokens and every decode step's logits) and
    LM_MESH_STEPS training steps."""
    import gc

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with mock.patch.object(serve, "get_config",
                           lambda arch: lm_mesh_serve_cfg()):
        run = serve.main(LM_MESH_ARGV, keep_logits=True)
    serve_s = time.perf_counter() - t0
    ref = {"serve": {"tokens": run.tokens.cpu(),
                     "logits": [x.cpu() for x in run.logits]}}
    line = {"prefill_s": run.prefill_s,
            "decode_p50_ms": run.step_percentile_ms(0.5),
            "decode_p95_ms": run.step_percentile_ms(0.95),
            "tokens_per_s": run.decode_tokens_per_s,
            "peak_gib": run.peak_bytes / 2**30, "launches": run.launches,
            "wall_s": serve_s}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    cfg, tcfg = lm_mesh_train_cfg()
    model = build_model(cfg, "cuda")
    state = init_train_state(model, seed=0, tcfg=tcfg)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    losses, step_ms = [], []
    for s in range(LM_MESH_STEPS):
        batch = pipe.get_for(cfg, s, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    ref["train"] = {"losses": losses}
    del state, step_fn, model
    gc.collect()
    torch.cuda.empty_cache()
    return ref, line, {"losses": losses, "step_ms": step_ms}


def nccl_local_lm(torch) -> dict:
    """``launch.train`` and ``launch.serve`` (the reduced Qwen2-7B, the
    kernels on) on a 1-rank NCCL group (a ``file://`` store):
    ``make_debug_mesh`` gives the (1, 1) ``DeviceMesh``, the parameters
    are DTensors on it."""
    import contextlib
    import io
    import tempfile

    import torch.distributed as dist

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.imc_mvm import imc_mvm
    from repro_torch.launch import serve, train

    text = io.StringIO()
    decode_attention.launches = imc_mvm.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            with contextlib.redirect_stdout(text):
                st = train.main(["--arch", "qwen2_7b", "--reduced",
                                 "--steps", "2", "--imc-linear", "--batch",
                                 "4", "--seq", "64", "--log-every", "1"])
                run = serve.main(["--arch", "qwen2_7b", "--reduced",
                                  "--kv-quant", "--batch", "4",
                                  "--prompt-len", "64", "--gen", "8"])
            on_mesh = all(SH.on_mesh(p) for p in st.params.parameters())
        finally:
            SH.set_mesh(None)
            dist.destroy_process_group()
    lines = text.getvalue().splitlines()
    return {"mesh_lines": [ln for ln in lines if ln.startswith("mesh:")],
            "params_on_mesh": on_mesh,
            "imc_launches": imc_mvm.launches,
            "decode_attention_launches": decode_attention.launches,
            "tokens_shape": list(run.tokens.shape),
            "train_lines": [ln for ln in lines if ln.startswith("step ")]}


def phase_lm_mesh(torch, np, jobs: dict = LM_MESH_JOBS) -> dict:
    """Phases 10 and 10b (LM_MESH_JOBS), 10c (REC_MESH_JOBS), or both in
    one spawn of each world (``jobs``: world -> (job, mesh shape)
    pairs): the one-process runs the jobs need, the 2- and 4-rank gloo
    groups on the card, each mesh's line and checks, then (with phase
    10's jobs) the 1-rank NCCL launchers. Returns the kernels' launches
    a rank."""
    import tempfile

    t_phase = time.perf_counter()
    limit = nvidia_smi("name,power.limit")
    names = {job for pairs in jobs.values() for job, _ in pairs}
    dense = "serve" in names
    ref, rec_s = {}, 0.0
    if dense:
        ref, one_serve, one_train = lm_mesh_one_process(torch)
        print(json.dumps({"path": "lm mesh: one process",
                          "serve": one_serve, "train": one_train,
                          "card, power limit": limit}))
    if "kv_seq serve" in names:
        ref["kv_seq"], one_kv_seq = kv_seq_one_process(torch)
    for phase, members in (("family", names - set(REC_MESH_NAMES)),
                           ("recurrent", names & set(REC_MESH_NAMES))):
        t0 = time.perf_counter()
        refs, lines = family_one_process(torch, members)
        if phase == "recurrent" and "dcn" in members:
            ref["dcn"], lines["dcn"] = dcn_one_process(torch)
        ref.setdefault("family", {}).update(refs)
        ref.setdefault("lines", {}).update(lines)
        if members:
            print(json.dumps({"path": f"{phase} mesh: one process",
                              **lines, "seconds": time.perf_counter() - t0,
                              "card, power limit": limit}, default=str))
        if phase == "recurrent":
            rec_s += time.perf_counter() - t0
    one_family = ref.pop("lines")
    launches = {"decode_attention": {}, "imc_mvm": {}}
    for world in sorted(jobs):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            torch.save(ref, Path(tmp) / "one_process.pt")
            ranks = spawn_lm_ranks(world, Path(tmp), jobs[world])
        spawn_s = time.perf_counter() - t0
        rec_jobs = [j for j in jobs[world] if j[0] in REC_MESH_NAMES]
        # 10c's share of this spawn: its jobs' time on the slowest rank and
        # its share of the start-up
        rec_s += max(sum(r[j]["wall_s"] for j in rec_jobs) for r in ranks)
        rec_s += (spawn_s - max(sum(v["wall_s"] for v in r.values())
                                for r in ranks)) * len(rec_jobs) / len(
                                    jobs[world])
        for job, shape in jobs[world]:
            got = [r[job, shape] for r in ranks]
            mesh = "x".join(map(str, shape))
            if job == "dcn":
                dcn_report(world, got, one_family["dcn"], limit)
                continue
            if job in FAMILY_SERVE or job in FAMILY_TRAIN:
                family_report(job, mesh, world, got, one_family[job],
                              limit, launches)
                continue
            if job == "kv_seq serve":
                kv_seq_report(mesh, world, got, one_kv_seq, launches, limit)
                continue
            line = {"path": f"lm mesh {job}", "mesh": mesh, "ranks": world,
                    "processes_on_one_card": True, "backend": "gloo",
                    "per_rank": got, "card, power limit": limit}
            print(json.dumps(line, default=str))
            if job == "serve":
                want = LM_CONFIGS_GEN - 1
                want *= LM_MESH_SERVE_LAYERS
                check(all(g["launches"] == want for g in got),
                      f"decode_attention launches a rank on {mesh}: "
                      f"{[g['launches'] for g in got]}, want {want}")
                check(all(g["max_share"] <= LM_REPLAY_SHARE for g in got),
                      f"serving on {mesh}: logits off the one-process run "
                      f"by {[g['max_share'] for g in got]} of the step's "
                      f"largest")
                launches["decode_attention"][mesh] = got[0]["launches"]
                print(f"lm mesh serve {mesh}: prefill "
                      f"{max(g['prefill_s'] for g in got):.3f} s, decode "
                      f"p50 {got[0]['decode_p50_ms']:.2f} / p95 "
                      f"{got[0]['decode_p95_ms']:.2f} ms, "
                      f"{got[0]['tokens_per_s']:.1f} tokens/s, peak "
                      f"{[round(g['peak_gib'], 2) for g in got]} GiB, gloo "
                      f"{got[0]['gloo_ms_a_step']:.2f} ms a step "
                      f"({got[0]['gloo_collectives_a_step']:.0f} "
                      f"collectives), decode_attention "
                      f"{got[0]['launches']} launches a rank at "
                      f"{got[0]['kernel']['shape']} "
                      f"({got[0]['kernel']['ms']:.4f} ms, plain "
                      f"{got[0]['kernel']['plain_ms']:.4f} ms); logits within "
                      f"{max(g['max_share'] for g in got):.2e} of the "
                      f"largest (one process: "
                      f"{one_serve['decode_p50_ms']:.2f} ms p50)")
            elif job == "train":
                check(all(g["loss_rel_err"] <= LM_MESH_LOSS_RTOL
                          and g["imc_mismatches"] == 0
                          and g["imc_launches_a_step"] == TRAIN_LAYERS
                          for g in got),
                      f"training on {mesh}: {[(g['losses'], g['imc_mismatches'], g['imc_launches_a_step']) for g in got]} vs one process {ref['train']['losses']}")
                if "saved_blocks_differ" in got[0]:
                    check(all(g["saved_blocks_differ"] == 0 for g in got),
                          f"the checkpoint saved on {mesh} differs from the "
                          f"state")
                launches["imc_mvm"][mesh] = got[0]["imc_launches_a_step"]
                print(f"lm mesh train {mesh}: step "
                      f"{[round(x, 1) for x in got[0]['step_ms']]} ms, "
                      f"{got[0]['tokens_per_s']:.1f} tokens/s, peak "
                      f"{[round(g['peak_gib'], 2) for g in got]} GiB, loss "
                      f"{got[0]['losses']} (one process "
                      f"{ref['train']['losses']}), imc_mvm "
                      f"{got[0]['imc_launches_a_step']:.0f} launches a rank "
                      f"a step on the shard {got[0]['imc_shard_shape']}, "
                      f"{sum(g['imc_mismatches'] for g in got)} mismatches, "
                      f"gloo {got[0]['gloo_ms_a_step']:.0f} ms a step")
            else:
                check(all(g["step"] == LM_MESH_STEPS and g["placed"]
                          and g["blocks_differ"] == 0 for g in got),
                      f"the (2, 2) checkpoint restored on {mesh}: {got}")
                print(f"lm mesh: the checkpoint saved on 2x2 restored on "
                      f"{mesh} in {max(g['restore_s'] for g in got):.1f} s "
                      f"(saved in {ranks[0]['train', (2, 2)]['save_s']:.1f}"
                      f" s), every block as the files hold it")
        print(f"lm mesh: {world} ranks in {spawn_s:.1f} s")
    if dense:
        nccl = nccl_local_lm(torch)
        print(json.dumps({"path": "lm launchers on a 1-rank NCCL group",
                          **nccl}))
        check(nccl["mesh_lines"] == [
            "mesh: {'data': 1, 'model': 1} devices=1"] * 2
            and nccl["params_on_mesh"] and nccl["imc_launches"] > 0
            and nccl["decode_attention_launches"] > 0
            and nccl["tokens_shape"] == [4, 8],
            f"the LM launchers on a 1-rank NCCL group: {nccl}")
    if names & set(REC_MESH_NAMES):
        print(f"recurrent mesh: phase 10c {rec_s:.1f} s (its one-process "
              f"runs, its jobs on the slowest rank and its share of each "
              f"spawn's start-up)")
    print(f"lm mesh: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# phases that run alone after the build with ``--only NAME[,NAME]``
STANDALONE = {"7c": lambda torch, np: phase_serve_recurrent(torch, np),
              "8c": lambda torch, np: phase_train_recurrent(torch, np),
              "7d": lambda torch, np: phase_serve_encdec_vlm(torch, np),
              "8d": lambda torch, np: phase_train_encdec_vlm(torch, np),
              "8e": lambda torch, np: phase_train_dcn(torch, np),
              "9": lambda torch, np: phase_mesh(torch, np),
              "10": lambda torch, np: phase_lm_mesh(torch, np),
              "10c": lambda torch, np: phase_lm_mesh(torch, np,
                                                     REC_MESH_JOBS)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = []
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or not set(
                argv[1].split(",")) <= set(STANDALONE):
            print(f"usage: chip_smoke.py [--only "
                  f"{'|'.join(STANDALONE)}[,...]]", file=sys.stderr)
            return 2
        only = argv[1].split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    phase_build(_build)
    if only:
        # the named standalone phases alone: no kernels or ok line
        for name in only:
            print(json.dumps({"phase": name,
                              "result": STANDALONE[name](torch, np)}))
        print(f"total: {time.perf_counter() - t0:.1f} s")
        return 0
    phase_kernels_vs_plain(torch, np)
    tuned = phase_tune(torch, np)
    print(f"reduced: pipelines: queries {QUERIES} of iPRG2012's "
          f"{IPRG_QUERIES} (time limit); references {IDENTITIES * REPLICATES} "
          f"synthetic targets and as many decoys (full); clustering one "
          f"paper-average bucket of {CLUSTER_IDENTITIES * CLUSTER_REPLICATES}"
          f" spectra (not cut)")
    pipes = phase_pipelines(torch, np)
    imc = next(e for e in tuned if e["name"] == "imc_mvm")
    imc.update(
        pipeline_launches={"run_db_search": pipes["db_launches"],
                           "run_clustering": pipes["cluster_launches"],
                           "isa_mvm_compute": pipes["isa_launches"]},
        pipeline_shapes={"db_search_chunk": pipes["db_shape"],
                         "clustering_bucket": pipes["cluster_shape"]},
        pipeline_check_mismatches=pipes["check_mismatches"],
        pipeline_check_plain_ms=pipes["db_check_plain_ms"],
        pipeline_analog_over_ideal=pipes["analog_over_ideal"])
    print(f"reduced: queries {QUERIES} per run of iPRG2012's {IPRG_QUERIES} "
          f"(time limit); bank rows {2 * IDENTITIES * REPLICATES} (full), "
          f"D={DIM}; the OMS window (-20, +200) over synthetic precursors "
          f"uniform on 400-1600 selects more of the bank than iPRG2012's "
          f"candidate fraction {IPRG_CANDIDATE_FRACTION}")
    kernels = [phase_serve(torch, np, fused_e2e=e2e, oms=oms)
               for oms in (False, True) for e2e in (False, True)]
    print(f"continuous serving: {NUM_SLOTS} slots; {APPEND:.0%} of the bank "
          f"({int(APPEND * IDENTITIES * REPLICATES)} refs and as many decoys) "
          f"held out and appended halfway through the run, then compacted")
    cont = phase_serve_continuous(torch, np)
    kernels[0].update(continuous_launches=cont["launches"]["topk_hamming"],
                      delta_ms=cont["delta_scan_ms"],
                      delta_plain_ms=cont["delta_scan_plain_ms"],
                      delta_bound_ms=cont["delta_scan_bound_ms"])
    cont_oms = phase_serve_continuous_oms(torch, np)
    kernels[3].update(continuous_launches=cont_oms["launches"][
        "encode_search_banded"])
    kernels[2].update(continuous_merged_launches=cont_oms["launches"][
        "topk_hamming_banded"])
    print(f"clustering: {CLUSTER_IDENTITIES} identities x "
          f"{CLUSTER_REPLICATES} spectra per tenant, one paper-average "
          f"bucket each (core/imc/energy.py), 2 tenants; not cut")
    entry = phase_serve_cluster(torch, np)
    cont_cluster = phase_serve_cluster_continuous(torch, np)
    entry.update(continuous_launches=cont_cluster["launches"]["hamming_pop"])
    phase_bucket(torch, np, entry)
    kernels.append(entry)
    kernels += tuned
    print(f"reduced: Qwen2-7B at full width and depth, batch {LM_BATCH} x "
          f"prompt {LM_PROMPT} + {LM_GEN} generated tokens instead of the "
          f"reference's decode_32k shape (batch 128 x 32,768: 124 GB of "
          f"int8 cache alone, and a (B, H, S, S) prefill logit buffer); "
          f"parameters are the port's seeded random draw")
    dec = phase_serve_lm(torch, np)
    kernels.append(dec)
    dec["launches_by_config"] = phase_serve_lm_configs(torch, np)
    print(f"reduced: training Qwen2-7B at full width with {TRAIN_LAYERS} of "
          f"its 28 layers (float32 params, grads and AdamW moments: ~122 GB "
          f"at 28 layers, more than the card's 80 GB), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, {TRAIN_STEPS} timed and 1 profiled step, "
          f"exact then imc_linear; parameters are the port's seeded random "
          f"draw")
    imc.update(phase_train_lm(torch, np))
    imc.update(phase_train_configs(torch, np))
    print(f"recurrent: hymba_1_5b and xlstm_125m at published width and "
          f"full depth (serving; training hymba_1_5b with 4 of its 32 "
          f"layers, for the time limit); serving batch {LM_CONFIGS_BATCH} x "
          f"({LM_CONFIGS_PROMPT} + {LM_CONFIGS_GEN}) as phase 7b, the ring "
          f"run {RING_BATCH} x ({RING_PROMPT} + {RING_GEN}); training batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}; parameters are the port's seeded "
          f"random draw")
    rec = phase_serve_recurrent(torch, np)
    dec["launches_by_config"]["hymba_1_5b"] = rec.pop("hymba_1_5b")
    dec["launches_by_config"]["xlstm_125m"] = rec.pop("xlstm_125m")
    dec.update(rec)
    imc.update(phase_train_recurrent(torch, np))
    print(f"encoder-decoder and VLM: whisper_medium at published width and "
          f"full depth, internvl2_76b at published width with "
          f"{VLM_SERVE_LAYERS} (serving) and {VLM_TRAIN_LAYERS} (training) of "
          f"its 80 layers; serving batch {LM_CONFIGS_BATCH} x "
          f"({LM_CONFIGS_PROMPT} + {LM_CONFIGS_GEN}) as phase 7b, training "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}; the frontends are stubs fed "
          f"the token pipeline's embeddings; parameters are the port's "
          f"seeded random draw")
    dec["launches_by_config"].update(phase_serve_encdec_vlm(torch, np))
    imc.update(phase_train_encdec_vlm(torch, np))
    imc.update(phase_train_dcn(torch, np))
    print(f"mesh: the iPRG2012-scale bank over {MESH_WORLDS} ranks, "
          f"processes sharing the one card in a gloo group (not a "
          f"multi-card deployment); {QUERIES} queries per route, as phase "
          f"4; the 1-rank NCCL serve_db with {NCCL_LOCAL_IDENTITIES} x "
          f"{REPLICATES} references")
    mesh = phase_mesh(torch, np)
    for entry in kernels[:4]:
        entry["mesh"] = {f"{world} ranks": by_world for world, by_world in
                         mesh[SERVED_PATHS[entry["name"]]].items()}
    print(f"reduced: lm mesh: Qwen2-7B served at full width with "
          f"{LM_MESH_SERVE_LAYERS} of its 28 layers (the time limit, since "
          f"phase 10b), batch {LM_CONFIGS_BATCH} x ({LM_CONFIGS_PROMPT} + "
          f"{LM_CONFIGS_GEN}), and trained at full width with "
          f"{TRAIN_LAYERS} of 28 layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{LM_MESH_STEPS} steps, by 2 and 4 processes sharing the card in "
          f"a gloo group (not a multi-card deployment); granite_20b served "
          f"at full width with {KV_SEQ_LAYERS} of its 52 layers, batch "
          f"{KV_SEQ_BATCH} x ({KV_SEQ_PROMPT} + {KV_SEQ_GEN}), its caches' "
          f"slots striped over model (kv_seq) on (1, 2) and (1, 4); "
          f"parameters are the port's seeded random draw")
    print(f"reduced: family mesh: deepseek_moe_16b served at full width "
          f"with {FAMILY_MOE_SERVE_LAYERS} of its 28 layers (the time "
          f"limit, since phase 10c) and decoded {FAMILY_SHORT_GEN - 1} "
          f"step(s) with {FAMILY_SHORT_LAYERS} layers, trained with 1 of "
          f"28 (2 until phase 10c); whisper_medium served with "
          f"{FAMILY_WHISPER_SERVE_LAYERS} of its 24 decoder layers and all "
          f"24 encoder layers (full depth until phase 10c), trained with 2 "
          f"+ 2 of 24 + 24 layers; internvl2_76b served with "
          f"{FAMILY_VLM_LAYERS} of 80 layers (the time limit, 4 until phase "
          f"10c, and four processes' share of the card's 80 GB); "
          f"llama4_scout_17b_a16e over a mesh on CPU ranks only (the "
          f"tests)")
    print(f"recurrent mesh: xlstm_125m served at full width and depth on "
          f"(1, 2), (2, 1) and (1, 4) and hymba_1_5b on (1, 2), batch "
          f"{LM_CONFIGS_BATCH} x ({LM_CONFIGS_PROMPT} + {LM_CONFIGS_GEN}), "
          f"as float32 copies (phase 7c's check: bfloat16 random-weight "
          f"recurrent stacks amplify rounding past {LM_REPLAY_SHARE}); "
          f"xlstm_125m float32 trained on a (pod 2, data 1, model 2) mesh, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {DCN_MESH_STEPS} steps a "
          f"method; run in phase 10's rank processes")
    print(f"reduced: recurrent mesh: hymba_1_5b trained at full width with "
          f"{REC_TRAIN_LAYERS} of its 32 layers on (2, 2), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {LM_MESH_STEPS} steps (the time "
          f"limit, as phase 8c)")
    lm_mesh = phase_lm_mesh(torch, np, {w: LM_MESH_JOBS[w] + REC_MESH_JOBS[w]
                                        for w in LM_MESH_JOBS})
    dec["mesh_launches_a_rank"] = lm_mesh["decode_attention"]
    imc["mesh_launches_a_rank_a_step"] = lm_mesh["imc_mvm"]
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
