"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of a checkout, with one card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero and prints
no result:

1. ``build``            delete and rebuild every kernel library from
                        ``src/repro_torch/csrc`` with ``nvcc`` (sm_90a),
                        one ``nvcc`` per source, all started together;
                        each kernel's registers, stack, local (spill)
                        and static shared memory (``cuobjdump
                        --dump-resource-usage``) and each library's
                        counts of HGMMA (wgmma) and HMMA (mma.sync)
                        instructions in its SASS;
2. ``kernel:lstm_seq``  the kernel against its plain PyTorch version on
                        the card at five shapes (the fifth the
                        generalist actor's F = 84 at M_max = 8) with
                        ragged (an all-false and a random row among
                        them) and full masks, and
                        three tail masks: the rows of a tile ending at
                        different steps, a fully masked tile, rows
                        unmasked again after a masked gap (atol = rtol =
                        1e-4: the same float32 sums in another order
                        over up to 97 recurrent steps); its launch plan
                        (``ops.seq_plan``); kernel, plain and cuDNN
                        ``torch.nn.LSTM`` times at the serving shape and
                        at (97, 32, 84, 256), back to back and replayed
                        from a CUDA graph, and the kernel's time per
                        step, beside its bound; the F = 84 plan;
3. ``kernel:flash_attention``  the prefill attention kernel against
                        ``attention_chunked`` at the internlm2-1.8b
                        prefill shape and four others (causal, window,
                        MHA with D = 64, GQA group 4 with a ragged S,
                        float32 with odd S), whisper-tiny's encoder and
                        cross-attention prefill (non-causal, Sk = 1500
                        keys for Sq = 1500 and 4 queries), a ragged
                        cross call (Sq = 77), a float32 one with
                        Sq != Sk, the olmoe-1b-7b prefill,
                        whisper-tiny's decoder self-attention prefill
                        (causal, 4 prompt tokens) and the jamba-v0.1-52b
                        (32 heads over 8, phase 30) and internvl2-76b
                        (64 over 8, phase 33) prefills, each element within
                        ``kernels.attn_tolerance`` (one bf16 ulp plus
                        1.5e-2 of its row's RMS; 1e-4 in float32);
                        kernel (back to back, and replayed from a CUDA
                        graph), plain and ``scaled_dot_product_attention``
                        times beside the bound, the kernel's TFLOP/s and
                        its time over SDPA's; causal Sq != Sk must raise
                        before any launch;
4. ``kernel:decode_gqa``  the decode attention kernel (the cache split
                        over the card by ``split_plan``, then merged)
                        against ``decode_attention_ref`` at the decode
                        shape of phase 8, the batcher's of phase 9,
                        whisper-tiny's self (132 slots, ragged) and
                        cross (1500 frames, full), olmoe-1b-7b's
                        (16 heads of 128, group 1) decode shape and its
                        batcher's (phase 28: 16 slots of 512),
                        jamba-v0.1-52b's (group 4) and internvl2-76b's
                        (group 8) decode shapes and their batchers'
                        (phases 31 and 34), and
                        four others (ragged lengths, a 32768-slot cache,
                        float32, short bf16 rows where one dropped key
                        fails the check), the same tolerance; kernel,
                        plain and SDPA + mask times replayed from a CUDA
                        graph (and the kernel's and SDPA's back to back)
                        beside the bound, and the bound's share of the
                        kernel's time;
5. ``serve:relmas``     the driver ``repro_torch.launch.serve.main`` at
                        the paper's policy width (hidden 256, paper6
                        fleet, mixed workload, 96 RQ slots, 64 jobs,
                        60 periods, 32 streams); the kernel must launch
                        exactly once per tick; the actor's masks are
                        recorded (each call's longest valid prefix:
                        mean, p50, max) and the kernel is timed again on
                        every recorded call, beside the bound for its
                        mask;
6. ``serve:fcfs``       the same streams under the FCFS heuristic;
7. ``parity``           the same streams through the port on the CPU
                        (plain versions) and on the card, relmas and
                        fcfs: equal ``counted``, per-stream ``hits``
                        within 1% of ``counted``; with host-clock
                        spans (synchronised) around the engine, the
                        actor and the greedy heuristic on the card run;
8. ``lm:prefill_decode``  internlm2-1.8b at full width (24 layers,
                        bf16 weights drawn on the card from seed 0):
                        ``make_prefill_step`` on 4 prompts of 2048
                        tokens (cache padded to 2176 slots), then 128
                        greedy ``make_decode_step`` steps; exactly 24
                        ``flash_attention`` launches per prefill and 24
                        ``decode_gqa`` launches per step; a profiled
                        prefill gives ``flash_attention``'s share of its
                        kernel time;
9. ``lm:batcher``       ``ContinuousBatcher`` at full width, 16 slots,
                        smax 512, 16 requests of 16 prompt and 64 new
                        tokens; all served, 24 ``decode_gqa`` launches
                        per batched decode step;
10. ``lm:parity``       the same weights cut to 2 layers, on the CPU
                        (plain versions) and on the card (kernels):
                        prefill of 2 x 256 tokens and 16 teacher-forced
                        decode steps, logits within the bf16 tolerance
                        ``LM_TOL`` and greedy ids equal wherever the
                        CPU's top-2 gap exceeds it;
11. ``kernel:ssd_chunk``  the Mamba-2 SSD intra-chunk kernel against
                        ``ssd_intra_ref`` at the mamba2-2.7b prefill
                        shape, two small ones (C = 16 and 64, head
                        counts 7 and 9 that no 4-head group divides) and
                        the jamba-v0.1-52b prefill's (N = 16, 128 heads
                        in blocks of 32), in
                        two draws (decays kept above exp(-60) over a
                        chunk, and the model's range of A, which drives
                        them past the clip), each element within 1e-4 of
                        its (batch*chunk, head) block's RMS
                        (``ssd_chunk.ref.ssd_err``); ``ssd_forward``
                        with a ragged T = 100 (chunk 32) against the
                        sequential ``ssd_scan_ref``; kernel and plain
                        times beside the bound and its share of the
                        kernel's time; the route (3xTF32 on the tensor
                        cores) with each check's err/bound;
12. ``lm:mamba2_prefill_decode``  mamba2-2.7b at full width and depth (64
                        layers, bf16 weights drawn on the card from seed
                        0): ``make_prefill_step`` on 4 prompts of 2048
                        tokens, then 32 greedy decode steps; exactly 64
                        ``ssd_chunk`` launches per prefill;
13. ``lm:mamba2_batcher``  ``ContinuousBatcher`` on the full model, 8
                        slots, smax 128, 8 requests of 16 prompt and 16
                        new tokens (decode runs no kernel: the one-token
                        recurrence is plain in the reference too);
14. ``lm:mamba2_parity``  the mamba2 weights cut to 2 layers, CPU
                        against card as in phase 10, within
                        ``MAMBA_TOL``;
15. ``kernel:lstm_cell``  the fused LSTM step against ``lstm_cell_ref``
                        at the rollout shape (B, F, H) = (8, 16, 256),
                        the update shapes (32, 16, 256) and (32, 23, 256),
                        the generalist's (8, 84, 256), (32, 84, 256) and
                        (32, 93, 256), the sharded rounds' rollouts
                        (phases 39-40: (4, 16, 256) and (4, 84, 256) a
                        rank of 2, (2, 16, 256) a shard of 4), the JAX
                        kernel tests' shapes and H = 8 and 16, in
                        float32 (within 1e-5) and bfloat16 (3e-2); the
                        autograd Function's gradient against autograd of
                        the plain version (1e-5); kernel, plain and
                        ``torch.lstm_cell`` times (device time from a
                        CUDA graph, and eager back-to-back calls) beside
                        the bound;
16. ``train:rl_train``  the training driver ``repro_torch.launch.rl_train.
                        main`` at the paper's policy width (hidden 256,
                        light workload, paper6, 96 RQ slots, 64 jobs, 30
                        periods, 8 episodes a round, batch 32): three
                        rounds, the first a warm-up round, one update per
                        episode, a crash at ``--fail-at 16`` and a rerun
                        in the same outdir that must resume, an eval on 2
                        seeds and, in the rerun, the fcfs, prema and
                        herald baselines;
                        ``lstm_cell`` launches exactly T = 97 per rollout
                        or eval period and 5 T per update; round,
                        rollout-period and update times (synchronised
                        host clock) and peak memory;
17. ``train:parity``    one round (rollout, ring write, 4 updates) at
                        hidden 256 and 8 periods from the same state,
                        buffer and draws on the CPU (plain versions) and
                        on the card (kernels): equal ``counted`` and
                        ``hits``, transitions within ``TRAIN_TOL``,
                        losses within rtol 1e-3, parameters within
                        2 lr per update;
18. ``baseline:magma``  MAGMA at the paper's 100 x 100 through
                        ``evaluate_batch_baseline`` on mixed / paper6,
                        96 RQ slots, 64 jobs, 8 streams, the arrivals
                        of a 60-period episode with its depth cut to
                        1 period (2 before phases 45-46): 101 engine
                        calls a period (each
                        over 800 rows), the elite non-decreasing and at
                        or above the Herald individual in every period;
                        seconds a period and the SLA beside Herald's; a
                        profiled fitness call;
19. ``train:churn``     ``rl_train`` under ``--churn mixed`` at
                        hidden 256 (light, paper6, 96 RQ slots, 64 jobs,
                        episodes cut to 10 periods (30 before phases
                        39-42 came, 15 before 45-46), 8 episodes a
                        round): two rounds, an eval on 2
                        seeds, the fcfs, herald and magma (12 x 6; 24 x
                        12 before phases 45-46) baselines (on the static
                        fleet, as the reference); ``lstm_cell`` exactly T
                        per period and 5 T per update; then fcfs, herald
                        and magma (12 x 6) under ``mixed`` on 2 seeds, and an
                        eval batch under the ``fail`` preset commits no
                        sub-job to an SA in a period in which it is
                        invalid (policy, Herald);
20. ``train:generalist``  ``rl_train`` over paper6, 4simba_4eyeriss and
                        2simba_2eyeriss as one generalist (m_max 8,
                        F = 84) under ``--churn mixed``, ``--best-metric
                        min_fleet``: two rounds of 30-period episodes,
                        a per-fleet eval, the same exact launch counts;
21. ``serve:generalist``  ``launch/serve.py`` with that checkpoint on
                        big_little, a fleet it never trained on, 32
                        streams x 60 periods: ``lstm_seq`` exactly once a
                        tick at F = 84; tick p50/p99, then synchronised
                        spans for the actor's and engine's shares;
22. ``generalist:parity``  one churned generalist round (hidden 256, 8
                        periods) on the CPU and on the card from the
                        same state, buffer and draws, held to phase
                        17's criteria (and an equal ``fleet`` column);
23. ``telemetry:serve`` (run after phase 7) phase 5's driver again with
                        ``--log-jsonl --window 16``: every record valid,
                        each kind there (4 ``serve_window``), the header
                        naming the card and its power limit, SLA,
                        counted, completions and per-stream metrics
                        equal to phase 5's (telemetry off), one
                        ``lstm_seq`` launch a tick, the device block's
                        60 ticks and 60 x 32 depths; tick p50/p99 on,
                        then off; then two runs cut to 12 periods with
                        ``--profile-dir`` (off, on; four, in turns,
                        before phases 45-46), each trace read for the
                        tick loop's device busy share, each
                        ``serving.*`` range's host time and the
                        device-to-host copies a tick (equal in both),
                        printed by size and deleted;
24. ``telemetry:train`` (run after phase 17) ``rl_train`` at hidden 256
                        with episodes cut to 5 periods (10 before phases
                        39-42 came): a warm-up
                        round of 8 episodes and a tail round of 2 with
                        2 updates, an eval on 1 seed, off / on with
                        ``--log-jsonl`` (off / on / on / off before
                        phases 45-46 came): a valid stream whose
                        rounds carry the device block (one SLA an
                        episode, one reward a period), round metrics
                        and final actor and critic weights equal to
                        the runs without the flag, exact ``lstm_cell``
                        launches; then profiled with and without the
                        flag: the five ``relmas.*`` ranges (four
                        without), device-to-host copies a round no
                        more than without;
25. ``lm:whisper_prefill_decode`` (run after phase 14) whisper-tiny at
                        full width and depth (4 encoder and 4 decoder
                        layers, bf16 weights drawn on the card from
                        seed 0): ``make_prefill_step`` on 8 clips of
                        1500 stub frames (N(0, 1) x 0.1) and a 4-token
                        prompt, cache padded to 132 slots, then 128
                        greedy steps; exactly 12 ``flash_attention``
                        launches per prefill (4 encoder, 4 self, 4
                        cross) and 8 ``decode_gqa`` per step (4 self,
                        4 cross); prefill ms, step p50/p99, tokens/s,
                        peak memory, profiled busy shares;
26. ``lm:whisper_parity``  the whole model on the CPU (plain versions)
                        and on the card (kernels), bf16, 2 clips, 16
                        prompt tokens and 16 teacher-forced steps,
                        within ``LM_TOL``;
27. ``lm:olmoe_prefill_decode``  olmoe-1b-7b at full width and depth
                        (16 layers of 64 experts, top-8; 6.9 B
                        parameters): prefill of 4 x 2048 tokens and 128
                        greedy steps as phase 8; exactly 16
                        ``flash_attention`` launches per prefill and 16
                        ``decode_gqa`` per step; the share of the
                        prefill's assignments that capacity dropped;
28. ``lm:olmoe_batcher``  ``ContinuousBatcher`` on olmoe as phase 9
                        (16 slots, 16 requests);
29. ``lm:olmoe_parity``  the olmoe weights cut to 2 layers, CPU against
                        card as phase 10: in float32 with equal routes
                        and logits within ``OLMOE_F32_TOL``, then in
                        bf16, every route flip a CPU near-tie (k-th and
                        (k+1)-th router logits within ``ROUTE_MARGIN``)
                        and the rows without a flip within ``LM_TOL``;
30. ``lm:jamba_prefill_decode``  jamba-v0.1-52b at full width, cut to
                        one super-block (8 of its 32 layers: 52 B
                        parameters are 104 GB of bf16, over the card's
                        80 GB; 7 Mamba-2 sublayers, one attention, 4
                        MoE FFNs of 16 experts top-2, 13.3 B parameters
                        with the embedding and head), bf16 weights drawn
                        on the card from seed 0: prefill of 4 x 2048
                        tokens, 32 greedy steps; exactly 1
                        ``flash_attention`` and 7 ``ssd_chunk`` launches
                        per prefill and 1 ``decode_gqa`` per step; the
                        cache's shapes; prefill ms beside its bound
                        (``prefill_bound``), decode p50/p99 beside one
                        read of the weights, peak memory, profiled busy
                        shares;
31. ``lm:jamba_batcher``  ``ContinuousBatcher`` on it as phase 13 (8
                        slots, 16 requests);
32. ``lm:jamba_parity``  CPU (plain versions) against the card
                        (kernels) sublayer by sublayer in float32 on the
                        first sublayer of each kind (l0 ssm + mlp, l1
                        ssm + moe, l4 attn + mlp; the depth is cut to
                        leave the training phases their time), each
                        sublayer fed the card's input to it and moved to
                        the CPU alone (at most ~11 GB), its output and
                        cache within ``SUBLAYER_F32_TOL`` with the MoE
                        routes pinned; then the whole super-block in
                        bf16 with the routes pinned, within
                        ``JAMBA_TOL``; the host's free memory printed,
                        and the phase fails on a host with too little;
33. ``lm:vlm_prefill_decode``  internvl2-76b at full width, cut to 8 of
                        its 80 layers (80 x 1.71 GB plus 4.2 GB of
                        embedding and head are over 80 GB): prefill of
                        4 x (256 stub patches, N(0, 1), + 1792 text
                        tokens), 128 greedy steps from position 2048;
                        exactly 8 ``flash_attention`` launches per
                        prefill and 8 ``decode_gqa`` per step, as phase
                        30 otherwise;
34. ``lm:vlm_batcher``  the batcher on it, text only as the reference's
                        (16 slots, 16 requests of 32 + 32 tokens);
35. ``lm:vlm_parity``  its weights cut to 2 layers, CPU against card
                        as phase 10 with the patches before the text,
                        within ``LM_TOL``;
36. ``train:lm``        the LM training driver ``repro_torch.launch.
                        train.main`` on internlm2-1.8b at full width and
                        depth (24 layers, bf16 weights drawn on the card
                        from seed 0, AdamW with float32 moments, remat
                        on): 12 steps of 4 x 2048 tokens, a checkpoint
                        every 6 steps (~18.9 GB each, in a directory
                        deleted at the end; the free disk printed
                        first), a crash at step 8 and the resume from
                        step 6: exactly one restart, the final loss
                        below the first, finite gnorms, exactly 48
                        ``flash_attention`` launches per executed step
                        (24 forward, 24 in the remat recompute); step
                        p50 / p99 (first step excluded), tokens/s, peak
                        memory, save and restore seconds beside the
                        step's bound (``train_bound``); then one step
                        profiled (busy share, top kernels, the flash
                        kernel's share; its launches checked apart and
                        left out of the kernels line) and the plain
                        attention backward's time at the step's shape
                        and its share of the step;
37. ``train:lm_parity``  internlm2-1.8b cut to 2 layers at full width in
                        float32 (0.51 B parameters, remat on), 2 steps
                        (3 before phases 45-46) of ``make_train_step`` at 2 x 128 tokens from
                        the same seed-0 weights and synthetic batches
                        on the card (float32 flash kernel, plain
                        backward) and on the CPU: losses within rtol
                        1e-4, gnorms within 1e-3, every parameter within
                        2 lr per update;
38. ``train:lm_families``  3 steps each at full width, cut in depth, on
                        2 x 512 positions in the configs' own dtypes:
                        mamba2-2.7b (2 layers: ``ssd_chunk`` under
                        autograd at N = 128), olmoe-1b-7b (2 layers: MoE
                        dispatch and aux), whisper-tiny (whole: non-
                        causal D 64 flash, cross-attention, encoder
                        remat; 1500 stub frames) and internvl2-76b (2
                        layers: 256 patches before 256 text tokens,
                        masked out of the loss; 4 x 512 positions in
                        the config's 4 microbatches): finite losses and
                        gnorms, launch counts as the layer counts
                        predict.  jamba-v0.1-52b is left out: one
                        super-block is 13.3 B parameters, whose float32
                        moments alone (106 GB) exceed the card.
39. ``train:sharded``   (run after phase 22) the sharded rounds' in-
                        process oracle (``sharded_rounds_reference``) at
                        D = 4, hidden 256, paper6: a warm-up round and an
                        update round (4 updates, each on the batch of 32
                        gathered from the four shards' read rings), 8
                        episodes x 12 periods a round, on the card
                        (kernels) and on the CPU (plain versions) from
                        the same state and draws: ``counted`` and
                        ``hits`` equal, masks and the rings' ``ptr``,
                        ``size`` and ``pending_n`` equal, ring values
                        within ``TRAIN_TOL``, losses within rtol 1e-4,
                        parameters within 2 lr per update, exact
                        ``lstm_cell`` launches; then the same in the
                        local-sample topology (``update_gather=False``:
                        each shard's update on its own 8 rows, the
                        gradients and losses averaged over the 4);
40. ``train:sharded_ranks``  the unsharded rounds at that size, timed;
                        then 2 ranks sharing the card over gloo
                        (``spawn_ranks`` of ``sharded_rounds_rank``:
                        ``make_sharded_train_rounds`` on a
                        ``DeviceMesh`` of 2), the same rounds and then
                        the generalist's over paper6 and 4simba_4eyeriss
                        (m_max 8, F = 84; 10 periods; each round's fleet
                        from the shared seed, the ``fleet`` column in
                        the ring pairs), each against the oracle at
                        D = 2 on the card from the same seeds: the
                        replicas' learner states bit-equal to each other
                        and to the oracle's, each rank's ring pair and
                        metrics the oracle's, each rank's ``lstm_cell``
                        launches what its 4 episodes and 4 updates
                        imply, no JAX or test module in a rank; wall
                        time and episodes/s of the ranks, the oracle and
                        the unsharded rounds;
41. ``train:sharded_nccl``  with two or more cards, phase 40's
                        specialist rounds on 2 NCCL ranks, one a card,
                        against the oracle on the first card; with one
                        card a line that says so;
42. ``train:sharded_driver``  ``rl_train --devices 2``: with one card the
                        device-count error naming
                        ``torch.cuda.device_count()`` (no rank starts,
                        no outdir); with two or more, two NCCL ranks
                        crash at ``--fail-at 8`` and the run resumes at
                        ``--devices 1``; it prints which of the two ran.
43. ``train:lm_mesh``   (after phase 38) internlm2-1.8b at full width
                        (d 2048, 16 / 8 heads of 128, d_ff 8192, vocab
                        92,544) cut to 2 layers in float32: the
                        one-process run on the card (3 train steps of
                        4 x 512 from seed 0, then a prefill of 4 x 512
                        and 16 greedy decode steps), and each kernel at
                        every head-shard shape a (data, model) mesh gives
                        it (replicated kv heads too) against its plain
                        version; then one spawn of 2 ranks sharing the
                        card over gloo (``spawn_ranks`` of
                        ``launch.train.mesh_steps_rank``, a ``cuda``
                        ``DeviceMesh``): the 3 train steps on a (2, 1)
                        and on a (1, 2) mesh (DTensor parameters, moments
                        and batch; ``flash_attention`` on each rank's
                        head shard), loss and gnorm within rtol 1e-4 of
                        the one-process run and every parameter within 2
                        lr per step; the (2, 1) parameters saved and
                        ``reshard_restore``d onto (1, 2), every leaf's
                        block bit-equal; on (1, 2) the prefill and the
                        16 greedy steps (``decode_gqa`` on each rank's
                        kv heads, the cache written in the block that
                        owns the slot): tokens equal, logits within
                        ``LM_F32_TOL``; each leaf's local shape and
                        placements, each rank's launches (added to the
                        kernels line), peak memory and seconds, the
                        spawn's seconds;
44. ``train:lm_mesh_nccl``  with four or more cards, the same on a
                        (2, 2) mesh (restored onto (4, 1)) over NCCL, a
                        card a rank; with fewer a line that says so;
45. ``dryrun:production``  the dry run (``launch/dryrun.py``) of the
                        production meshes on fake CUDA tensors over a
                        fake process group of 512 ranks, five
                        subprocesses side by side: internlm2-1.8b's
                        train_4k, prefill_32k and decode_32k on 16x16
                        with their roofline cost modules, its train_4k
                        on 2x16x16, llama3-405b's train_4k on 16x16
                        from 1- and 2-layer traces (its 126 layers x 8
                        microbatches extrapolated) with its cost
                        modules, relmas on 16x16, and the cells the
                        families' mesh steps opened: olmoe-1b-7b's
                        train_4k and mamba2-2.7b's prefill_32k (from 1-
                        and 2-layer traces) and whisper-tiny's
                        decode_32k; each record's ``ok``, memory, three
                        roofline terms, dominant term and collectives by
                        kind; every cell ok, nothing allocated on the
                        card after FakeTensorMode's CUDA context (one
                        1-element tensor, freed), no kernel launched;
                        internlm2-1.8b's train_4k on 16x16 must fit
                        80 GB a chip and lie at least the 388.6 GB of
                        the global logits gradient below the 469.2 GB it
                        needed when the mesh loss held that gradient
                        (ROADMAP C1; now the loss on each rank's vocab
                        block), and llama3-405b's is printed beside its
                        127.2 GB of then;
46. ``dryrun:check``    (started with phase 45) the dry run of train:lm's
                        step (internlm2-1.8b at full width and depth,
                        4 x 2048) on a 1x1 mesh: its FLOPs beside
                        ``train_bound``'s, its ``per_chip_total_bytes``
                        within 25% of train:lm's measured peak, its
                        compute term beside train:lm's step p50.
47. ``train:families_mesh``  (in a child process beside phases 36-37
                        and 43-44, read after them) every family's steps
                        on a (data, model) mesh: olmoe-1b-7b (64 experts
                        top-8) and mamba2-2.7b at full width cut to 2
                        layers, whisper-tiny whole (1500 stub frames),
                        all three in float32, and jamba-v0.1-52b and
                        internvl2-76b at smoke width with heads of 64
                        (the kernels' D; their full width does not fit
                        two ranks' float32 state on the card); first
                        each kernel at every shape the phase gives it,
                        drawn from its configs and sizes
                        (``families_shard_shapes``: each family's rows
                        and heads on (1, 1), (2, 1) and (1, 2) in the
                        train, prefill and decode steps, whisper's
                        encoder and cross attention and cross cache
                        too), against its plain version; then each
                        family one process on the card (2
                        train steps of 2 x 128 from seed 0, then a
                        prefill of 2 x 64, after the VLM's patches, and
                        8 greedy decode steps), then one spawn of 2
                        ranks sharing the card over gloo running every
                        family on (2, 1) and on (1, 2)
                        (``launch.train.mesh_steps_rank``: the loss on
                        each rank's vocab block, the MoE dispatch on its
                        rows, ``ssd_chunk`` and the attention kernels on
                        its heads, whisper's cross-attention decode on
                        its kv heads of the cache), each held to its
                        one-process run as phase 43: loss and gnorm
                        within rtol 1e-4, every parameter within 2 lr
                        per step, tokens equal, logits within
                        ``LM_F32_TOL``; each leaf's local shape and
                        placements, each rank's launches (added to the
                        kernels line), peak memory and seconds, the
                        largest logit gap a step; every shape at which
                        the one-process runs or the ranks launched a
                        kernel (``ops.SHAPES``) must be one of those
                        checked first.
48. ``legacy:runners``  (in the "sharded" child, after phase 42) the
                        legacy per-period runners on one stream at
                        serve:relmas's configuration (mixed on paper6,
                        hidden 256, 96 RQ slots, 64 jobs, 60 periods,
                        the actor from seed 0): (a) one episode through
                        ``make_policy_period`` + ``run_episode`` at
                        sigma 0 on the step route (exactly 97 x 60 =
                        5,820 ``lstm_cell`` launches) and on the
                        sequence route (60 ``lstm_seq`` launches), each
                        held to one ``collect_episodes`` run of the step
                        route on the same trace with a zero noise block
                        (``counted`` and ``hits`` equal, transitions
                        within 1e-5) and to the same episode on the CPU
                        (``counted`` equal, ``hits`` within 1% of it,
                        transitions within 1e-4); (b) fcfs, prema and
                        herald through ``make_baseline_period`` on two
                        seeds picked for their three different
                        schedules, cut to 40 periods, equal to
                        ``evaluate_batch_baseline``
                        (and the three must differ); (c)
                        (a)'s step-route episode with
                        ``simulate_segments`` swapped in at module
                        level (``counted`` and ``hits`` equal), the
                        engine inputs of its first 4 periods run through
                        both engines (within rtol 1e-5), and the periods
                        per second of the segment-engine loop, the
                        current-engine loop and ``collect_episodes`` at
                        32 streams (20 periods), taken once; (d)
                        ``ddpg_update_scan``, 8 updates of 32 rows of
                        (a)'s transitions (8 x 485 = 3,880 ``lstm_cell``
                        launches), equal to 8 ``ddpg_update`` calls on
                        the same indices, the buffer the same object and
                        unchanged; (e) ``train_rounds_scan``, two rounds
                        (a warm-up) at smoke width, equal to
                        ``train_rounds_host``; (f)
                        ``examples/torch_quickstart.py`` in a process of
                        its own, started first, beside (a)-(e) (exit 0,
                        2,178 ``lstm_cell`` launches, which it prints).
                        The launches of (a), (d) and (f) go to the
                        kernels line.  Every ``lstm_cell`` shape of
                        (a), (d), (e) and (f) must be in
                        ``CELL_SHAPES``.

Order and concurrency, to hold the script to half its 1200 s limit: the
kernel checks (phases 2-4, 11, 15) run first, alone on the card; then
phases 5-7 and 23; then the RELMAS training phases run in two child
processes of this script (``--rl-group``: 16-22 and 24 in one, 39-42
and 48 in the other; each console printed when it ends, their
``lstm_cell`` and ``lstm_seq`` launches added to the kernels line)
beside the LM serving phases (8-14, 25-35), so these three groups'
times are taken side by side; then phase
38 alone (its internvl2 step peaks at 71 GB of the card); then phases
45-46's subprocesses (at a lower priority) and phase 47's child
process start beside phases 36-37 and 43-44, and are read last.

Then a ``kernels`` JSON line, the card's name and power limit as
``nvidia-smi`` reports them, and a last JSON line
``{"ok": true, "device": {...}}``.  Every phase prints its seconds.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # H100 SXM, bf16 tensor cores, dense
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
TOL = 1e-4
# (B, Hq, Hkv, Sq, Sk, D, causal, window, dtype); the first is the
# internlm2-1.8b prefill of phase 8, then causal windowed, MHA at D = 64,
# GQA group 4 with a ragged S and float32 with odd S; then whisper-tiny's
# encoder (phase 25: non-causal, 1500 frames) and cross-attention
# prefill (4 prompt tokens against 1500 frames), a ragged cross call, a
# float32 one with Sq != Sk, the olmoe-1b-7b prefill (phase 27),
# whisper-tiny's decoder self-attention prefill (its 4 prompt tokens),
# and the jamba-v0.1-52b (phase 30: 32 query heads over 8 KV heads) and
# internvl2-76b (phase 33: 64 over 8, group 8) prefills.  The head
# shards of phase 47's meshes are not here: that phase draws them from
# its configs (families_shard_shapes) and checks them itself
FLASH_SHAPES = [(4, 16, 8, 2048, 2048, 128, True, 0, torch.bfloat16),
                (1, 16, 8, 4096, 4096, 128, True, 1024, torch.bfloat16),
                (2, 36, 36, 1024, 1024, 64, True, 0, torch.bfloat16),
                (1, 8, 2, 777, 777, 128, True, 0, torch.bfloat16),
                (3, 4, 2, 300, 300, 64, True, 0, torch.float32),
                (8, 6, 6, 1500, 1500, 64, False, 0, torch.bfloat16),
                (8, 6, 6, 4, 1500, 64, False, 0, torch.bfloat16),
                (2, 6, 6, 77, 1500, 64, False, 0, torch.bfloat16),
                (3, 4, 2, 50, 333, 128, False, 0, torch.float32),
                (4, 16, 16, 2048, 2048, 128, True, 0, torch.bfloat16),
                (8, 6, 6, 4, 4, 64, True, 0, torch.bfloat16),
                (4, 32, 8, 2048, 2048, 128, True, 0, torch.bfloat16),
                (4, 64, 8, 2048, 2048, 128, True, 0, torch.bfloat16)]
# (B, Hq, Hkv, S, D, lengths, dtype); lengths an int (every row's),
# "full", "ragged" or "batcher" (1 to 96); the first is the
# internlm2-1.8b decode of phase 8 halfway through its 128 steps, the
# sixth the batcher's of phase 9 (16 slots of 512)
LM_B, LM_S, LM_PAD, LM_STEPS = 4, 2048, 2048 + 128, 128
LM_MID = LM_S + LM_STEPS // 2
# jamba-v0.1-52b at full width, one super-block: 8 of its 32 layers
# (its 52 B parameters are 104 GB in bf16, over the card's 80 GB);
# prefill 4 x 2048, 32 steps, the batcher as mamba2's
JAMBA_ARCH, JAMBA_LAYERS = "jamba-v0.1-52b", 8
JB_B, JB_S, JB_STEPS = 4, 2048, 32
# internvl2-76b at full width, 8 of its 80 layers (80 x 1.71 GB of
# layers and 4.2 GB of embedding and head are over 80 GB); prefill
# 4 x (256 stub patches + 1792 text tokens), 128 steps
VLM_ARCH, VLM_LAYERS = "internvl2-76b", 8
VL_B, VL_TXT, VL_STEPS = 4, 1792, 128
DECODE_SHAPES = [(LM_B, 16, 8, LM_PAD, 128, LM_MID, torch.bfloat16),
                 (32, 16, 8, 4096, 128, "ragged", torch.bfloat16),
                 (4, 16, 8, 32768, 128, "full", torch.bfloat16),
                 (3, 4, 4, 100, 64, "ragged", torch.float32),
                 (16, 16, 8, 64, 128, "ragged", torch.bfloat16),
                 (16, 16, 8, 512, 128, "batcher", torch.bfloat16),
                 # whisper-tiny's decode (phase 25): self-attention over
                 # its 132-slot cache, cross-attention over 1500 frames;
                 # olmoe-1b-7b's (phase 27) halfway through its steps
                 (8, 6, 6, 132, 64, "ragged", torch.bfloat16),
                 (8, 6, 6, 1500, 64, "full", torch.bfloat16),
                 (4, 16, 16, LM_PAD, 128, LM_MID, torch.bfloat16),
                 # and olmoe-1b-7b's batcher (phase 28), as phase 9's
                 (16, 16, 16, 512, 128, "batcher", torch.bfloat16),
                 # jamba-v0.1-52b's decode (phase 30, group 4) halfway
                 # through its 32 steps and its batcher's (phase 31: 8
                 # slots of 128); internvl2-76b's (phase 33, group 8)
                 # and its batcher's (phase 34: 16 slots of 512)
                 (JB_B, 32, 8, JB_S + JB_STEPS, 128, JB_S + JB_STEPS // 2,
                  torch.bfloat16),
                 (8, 32, 8, 128, 128, "batcher", torch.bfloat16),
                 (VL_B, 64, 8, LM_PAD, 128, LM_MID, torch.bfloat16),
                 (16, 64, 8, 512, 128, "batcher", torch.bfloat16)]
LM_ARCH = "internlm2-1.8b"
# the internlm2 and olmoe batchers: one wave of requests through 16
# slots (depth cut to leave the training phases their time: two waves
# until the LM mesh phases came), prompts of BATCHER_PROMPT tokens (32
# until the dry-run phases came: ``add`` feeds a prompt token by token
# through the batched step, so the prompts were 512 of the 576 steps)
BATCHER_REQUESTS, BATCHER_PROMPT = 16, 16
# card (kernels) against CPU (plain versions), bf16 weights and
# activations: the tolerance of the port against JAX on the CPU
# (tests/test_torch_lm.py), a few bf16 ulps of |logit| < 8 per logit
LM_TOL = dict(atol=0.1, rtol=0.02, mean=0.01)
# the mamba2 2-layer parity: bf16 weights and activations are rounded
# at more places per layer than in the dense model (projections, the
# conv sum, the gate, two norms), so a bf16 ulp flip anywhere moves the
# logits further; LM_TOL with 1.5x its atol and twice its mean bound
MAMBA_TOL = dict(atol=0.15, rtol=0.02, mean=0.02)
MAMBA_ARCH = "mamba2-2.7b"
MB_B, MB_S, MB_STEPS = 4, 2048, 32
# its batcher: one wave through its 8 slots (two waves of 16 requests
# until the dry-run phases came)
MB_BATCHER_REQUESTS = 8
# whisper-tiny: 8 clips of 1500 stub frames, a 4-token prompt and 128
# greedy steps, 132 of the decoder's 448 positions
WH_ARCH = "whisper-tiny"
WH_B, WH_PROMPT, WH_STEPS = 8, 4, 128
# olmoe-1b-7b at the internlm2 phases' shapes (LM_B, LM_S, LM_STEPS)
OLMOE_ARCH = "olmoe-1b-7b"
# its 2-layer parity in float32: the flash kernel's float32 bound (1e-4
# of a row's RMS) over two layers and float32 sums over d = 2048 and the
# 50432-wide head in another order; a route flip moves logits by ~0.1
OLMOE_F32_TOL = dict(atol=2e-3, rtol=1e-3, mean=2e-4)
# in bf16 the two sides' float32 router logits differ by up to ~1e-2 (a
# bf16 ulp of the hidden state through the router): a token whose k-th
# and (k+1)-th logits are closer than this may pick another expert
ROUTE_MARGIN = 0.05
# (BC, C, N, H, P); the first is the mamba2-2.7b prefill of phase 12:
# 4 prompts of 2048 tokens in chunks of 128, 80 heads of 64, state 128;
# the last jamba-v0.1-52b's (phase 30): 128 heads of 64, state 16 (phase
# 47's head shards: families_shard_shapes)
SSD_SHAPES = [(MB_B * MB_S // 128, 128, 128, 80, 64), (6, 16, 32, 7, 16),
              (5, 64, 128, 9, 64), (JB_B * JB_S // 128, 128, 16, 128, 64)]
SERVE_ARGS = ["--workload", "mixed", "--fleet", "paper6", "--hidden", "256",
              "--batched", "--streams", "32", "--requests", "32",
              "--scenario", "steady", "--rate-scale", "1.0",
              "--periods", "60", "--max-rq", "96", "--max-jobs", "64"]
KERNEL_SHAPES = [(97, 32, 16, 256), (97, 1, 16, 256), (97, 32, 16, 64),
                 (12, 33, 23, 64), (97, 32, 84, 256)]
# the generalist serving actor at M_max = 8: F = 4 + 2*8 + 8*8 = 84
GEN_SEQ_SHAPE = (97, 32, 84, 256)
# (B, F, H) of the lstm_cell check: the rollout step (8 episodes), the
# update steps (batch 32; actor F = 16, critic F + G = 23), the JAX
# kernel tests' shapes (tests/test_kernels.py), H = 8 and 16, the
# generalist's below, and the sharded rounds' rollouts (phases 39-40): a
# rank's 4 episodes of 8 over 2 ranks, a shard's 2 of 8 in the oracle at
# D = 4 (their updates take the gathered batch of 32), and phase 48's:
# the legacy one-stream step (1, 16, 256); the quickstart's hidden-32
# actor on one stream and its updates of 16; train_rounds_scan at hidden
# 8 (2 episodes, updates of 8).  Phase 48 fails if its runs give the
# kernel a shape that is not here (legacy_shapes_checked).
CELL_SHAPES = [(8, 16, 256), (32, 16, 256), (32, 23, 256), (4, 16, 64),
               (97, 16, 256), (32, 20, 128), (1, 7, 32), (129, 16, 64),
               (8, 16, 8), (32, 23, 16), (8, 84, 256), (32, 84, 256),
               (32, 93, 256), (4, 16, 256), (2, 16, 256), (4, 84, 256),
               (1, 16, 256), (1, 16, 32), (16, 16, 32), (16, 23, 32),
               (2, 16, 8), (8, 23, 8)]
# the generalist's steps: rollout (8 episodes; 4 on a rank of 2) and
# update (batch 32; actor F = 84, critic F + G = 93)
GEN_CELL_SHAPES = [(8, 84, 256), (32, 84, 256), (32, 93, 256),
                   (4, 84, 256)]
CELL_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
RL_T = 97                       # LSTM steps: 1 primer + 96 RQ slots
# train:rl_train's and train:generalist's episodes, cut from 60 to 30
# periods to make room for the LM mesh phases
RL_PERIODS = 30
RL_ARGS = ["--workload", "light", "--fleet", "paper6", "--hidden", "256",
           "--max-rq", "96", "--max-jobs", "64", "--periods", str(RL_PERIODS),
           "--batch-episodes", "8", "--batch-size", "32", "--episodes", "24",
           "--updates-per-episode", "1", "--warmup-episodes", "8",
           "--ckpt-every", "8", "--eval-every", "24", "--eval-seeds", "2"]
RL_FAIL_AT = 16
# card against CPU for one round: float32 sums in another order (the
# kernel's FMA chains against the CPU's GEMMs over 97 steps; the
# engine's event times)
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)
# LM training (phases 36-38): internlm2-1.8b at full width and depth,
# 12 steps of 4 x 2048 tokens, a checkpoint every 6 steps, a crash at 8;
# its parity 2 steps (3 until the dry-run phases came) at 2 x 128 on 2
# layers in float32; the families 3 steps at 2 x 512 positions each
# ((arch, layers or None for all))
TR_B, TR_S, TR_STEPS, TR_EVERY, TR_FAIL = 4, 2048, 12, 6, 8
TR_ARGS = ["--arch", LM_ARCH, "--batch", str(TR_B), "--seq", str(TR_S),
           "--steps", str(TR_STEPS), "--ckpt-every", str(TR_EVERY),
           "--fail-at", str(TR_FAIL), "--log-every", "1", "--seed", "0"]
TP_B, TP_S, TP_STEPS = 2, 128, 2
TF_B, TF_S, TF_STEPS = 2, 512, 3
TRAIN_FAMILIES = (("mamba2-2.7b", 2), ("olmoe-1b-7b", 2),
                  ("whisper-tiny", None), ("internvl2-76b", 2))
# the LM on a (data, model) mesh (phases 43-44): internlm2-1.8b at full
# width cut to 2 layers in float32, 3 train steps of 4 x 512 on each
# mesh, a prefill of 4 x 512 and 16 greedy steps on the head-split one;
# logits held to the float32 tolerance of the LM parity phases
LMM_LAYERS, LMM_B, LMM_S, LMM_STEPS, LMM_DEC = 2, 4, 512, 3, 16
LMM_PAD = LMM_S + LMM_DEC
LMM_MESHES = ((2, 1), (1, 2))
LMM_NCCL_MESH = (2, 2)
LM_F32_TOL = OLMOE_F32_TOL
# every family's steps on a (data, model) mesh (phase 47): (arch, config
# cuts) at full width cut in depth in float32 (olmoe, mamba2), whisper-
# tiny whole in float32, jamba and internvl2 at smoke width with heads of
# 64 (the attention kernels take D 64 or 128; their full width does not
# fit two ranks' float32 state on one card); 2 train steps
# of 2 x 128, a prefill of 2 x 64 (after the VLM's patches) and 8 greedy
# steps, on (2, 1) and (1, 2), held to LMM's criteria
FAMILIES_MESH = (("olmoe-1b-7b", dict(n_layers=2, param_dtype="float32")),
                 ("mamba2-2.7b", dict(n_layers=2, param_dtype="float32")),
                 ("whisper-tiny", dict(param_dtype="float32")),
                 ("jamba-v0.1-52b", dict(smoke=True, head_dim=64)),
                 ("internvl2-76b", dict(smoke=True, head_dim=64)))
FM_B, FM_S, FM_STEPS, FM_SB, FM_SS, FM_DEC, FM_PAD = 2, 128, 2, 2, 64, 8, 80
FM_MESHES = ((2, 1), (1, 2))
FM_RANK_TIMEOUT_S = 420
# the dry run (phases 45-46): groups of ``launch/dryrun.py`` main's argv,
# each group one subprocess of a fake process group of 512 ranks on
# ``cuda`` fake tensors (the production meshes: 16x16, 2x16x16), the
# groups side by side; llama3-405b's 126 layers x 8 microbatches traced
# at 1 and 2 layers and extrapolated (``--extrapolate``); then the
# internlm2-1.8b step of train:lm (4 x 2048, full width and depth) on a
# 1x1 mesh (started with the groups), held to train:lm's measured peak
# within DRY_MEM_TOL
DRY_PRODUCTION = [[["--arch", LM_ARCH, "--shape", "train_4k", "--roofline"]],
                  [["--arch", LM_ARCH, "--shape", "prefill_32k",
                    "--roofline"],
                   ["--arch", LM_ARCH, "--shape", "decode_32k", "--roofline"],
                   ["--arch", "relmas"]],
                  [["--arch", LM_ARCH, "--shape", "train_4k", "--multi-pod"]],
                  [["--arch", "llama3-405b", "--shape", "train_4k",
                    "--roofline", "--extrapolate"]],
                  # the families' cells on 16x16 that A.5 opened (the deep
                  # ones from 1- and 2-unit traces)
                  [["--arch", "olmoe-1b-7b", "--shape", "train_4k",
                    "--extrapolate"],
                   ["--arch", "mamba2-2.7b", "--shape", "prefill_32k",
                    "--extrapolate"],
                   ["--arch", "whisper-tiny", "--shape", "decode_32k"]]]
# the 16x16 records while the mesh loss held the global batch's logits
# gradient (ROADMAP C1): internlm2-1.8b train_4k per-chip GB and that
# buffer; llama3-405b train_4k per-chip GB
DRY_GLOBAL_LOSS = dict(internlm2_gb=469.2, loss_buffer_gb=388.6,
                       llama3_gb=127.2)
DRY_TIMEOUT_S = 420
DRY_MEM_TOL = 0.25
# what train:lm measured, for dryrun:check (peak GB, step p50 s)
TRAIN_LM_MEASURED: dict = {}


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    try:
        yield
    except BaseException:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s",
              flush=True)
        raise
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f}s", flush=True)


def n_sm() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


LSTM_MASKS = ("ragged", "full", "ends", "dead_tile", "gap")


def lstm_inputs(T, B, F, H, gen, full_mask=False, kind=None, rows=1):
    """Inputs of one call; ``kind`` one of ``LSTM_MASKS`` (default
    "full" if ``full_mask`` else "ragged"); ``rows`` is the plan's tile,
    which "dead_tile" masks out whole (the second tile, or the only
    one)."""
    kind = kind or ("full" if full_mask else "ragged")
    xs = torch.randn((T, B, F), generator=gen)
    wx = torch.randn((F, 4 * H), generator=gen) * 0.1
    wh = torch.randn((H, 4 * H), generator=gen) * 0.1
    b = torch.randn((4 * H,), generator=gen) * 0.1
    t = torch.arange(T)[:, None]
    mask = torch.ones((T, B), dtype=torch.bool)
    if kind == "ragged":
        # ragged prefixes; with 3+ rows also an all-false and a random row
        lens = torch.randint(1, T + 1, (B,), generator=gen)
        mask = t < lens[None, :]
        if B >= 3:
            mask[:, 1] = False
            mask[:, 2] = torch.rand((T,), generator=gen) < 0.6
    elif kind == "ends":
        # consecutive rows (one tile) end at steps a fifth of T apart
        mask = t < torch.clamp(T - (torch.arange(B) % 5) * (T // 5),
                               min=1)[None, :]
    elif kind == "dead_tile":
        lo = rows if B > rows else 0
        mask[:, lo:lo + rows] = False
    elif kind == "gap":
        # every other row masked over the middle third, then live again
        gap = (t >= T // 3) & (t < 2 * T // 3)
        mask[:, ::2] = ~gap.expand(T, B)[:, ::2]
    return [x.cuda().contiguous() for x in (xs, mask, wx, wh, b)]


def lstm_plan(ops, T, B, F, H):
    lib = ops._lib()
    return ops.seq_plan(B, H, ops.resident_clusters(
        lib, torch.device("cuda", 0), F, H))


def lstm_bound_ms(T, B, F, H, mask) -> tuple[float, str]:
    """Least time for the call: its float32 multiply-adds on the
    unmasked steps over the float32 peak, or its bytes (each input read
    once, hs written once) over the memory rate, whichever is larger."""
    steps = int(mask.sum())
    flops = 2.0 * steps * (F + H) * 4 * H
    nbytes = 4 * (T * B * F + F * 4 * H + H * 4 * H + 4 * H + T * B * H) \
        + T * B
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                      else "bytes")


def check_kernel(ops, ref, CARD):
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    with torch.no_grad():
        for (T, B, F, H) in KERNEL_SHAPES:
            plan = lstm_plan(ops, T, B, F, H)
            smem = ops._lib().lstm_seq_smem_bytes(plan.units, plan.rows, F, H)
            print(f"  lstm_seq T={T} B={B} F={F} H={H}: {plan}, {smem} B of "
                  f"dynamic shared memory per CTA", flush=True)
            for kind in LSTM_MASKS:
                args = lstm_inputs(T, B, F, H, gen, kind=kind,
                                   rows=plan.rows)
                got = ops.lstm_seq(*args)
                want = ref.lstm_seq_ref(*args)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ok = torch.allclose(got, want, atol=TOL, rtol=TOL)
                print(f"  lstm_seq T={T} B={B} F={F} H={H} mask={kind} "
                      f"max_abs_err={err:.3e} ok={ok}", flush=True)
                if not ok:
                    raise AssertionError(f"lstm_seq disagrees with its plain "
                                         f"version at {(T, B, F, H)}, "
                                         f"{kind} mask")
                max_err = max(max_err, err)
            args = lstm_inputs(T, B, F, H, gen, kind="full")
            ms = cuda_ms(lambda: ops.lstm_seq(*args), reps=20)
            print(f"  lstm_seq T={T} B={B} F={F} H={H} full mask "
                  f"[{CARD}]: kernel_ms={ms:.4f}", flush=True)
    info = seq_times(ops, ref, *KERNEL_SHAPES[0], gen, CARD)
    gen_info = seq_times(ops, ref, *GEN_SEQ_SHAPE, gen, CARD)
    plan = lstm_plan(ops, *GEN_SEQ_SHAPE)
    smem = ops._lib().lstm_seq_smem_bytes(plan.units, plan.rows,
                                          *GEN_SEQ_SHAPE[2:])
    resident = ops.resident_clusters(ops._lib(), torch.device("cuda", 0),
                                     *GEN_SEQ_SHAPE[2:])
    print(f"  lstm_seq generalist shape {GEN_SEQ_SHAPE} [{CARD}]: plan "
          f"{plan}, {smem} B of dynamic shared memory per CTA, resident "
          f"clusters {resident}; device ms {gen_info['ms']:.4f} bound "
          f"{gen_info['bound_ms']:.4f} ({gen_info['bound_by']})", flush=True)
    return dict(max_abs_err=max_err, **info)


def seq_times(ops, ref, T, B, F, H, gen, CARD) -> dict:
    """Kernel, plain and cuDNN times at (T, B, F, H), full mask: the same
    function as cuDNN's LSTM there (weights in PyTorch's (4H, in)
    layout), back to back and replayed from a CUDA graph."""
    with torch.no_grad():
        args = lstm_inputs(T, B, F, H, gen, full_mask=True)
        xs, mask, wx, wh, b = args
        lstm = torch.nn.LSTM(F, H).cuda()
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
        lib_err = (lstm(xs)[0] - ref.lstm_seq_ref(*args)).abs().max().item()
        # eager: back-to-back calls from Python; graph: device time
        kernel_ms = cuda_ms(lambda: ops.lstm_seq(*args), reps=50)
        plain_ms = cuda_ms(lambda: ref.lstm_seq_ref(*args), reps=10)
        library_ms = cuda_ms(lambda: lstm(xs), reps=50)
        g_kernel = graph_ms(lambda: ops.lstm_seq(*args))
        g_plain = graph_ms(lambda: ref.lstm_seq_ref(*args), calls=10)
        g_library = graph_ms(lambda: lstm(xs))
        bound_ms, bound_by = lstm_bound_ms(T, B, F, H, mask)
    print(f"  lstm_seq T={T} B={B} F={F} H={H} full mask [{CARD}]: "
          f"device (CUDA graph) kernel_ms={g_kernel:.4f} (per step "
          f"{g_kernel * 1e3 / T:.3f} us) plain_ms={g_plain:.4f} "
          f"library_ms={g_library:.4f}; eager back-to-back "
          f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (cuDNN nn.LSTM, max_abs_err vs "
          f"plain {lib_err:.2e}); bound_ms={bound_ms:.4f} ({bound_by}, "
          f"{bound_ms / g_kernel:.3f} of the kernel's device time)",
          flush=True)
    return dict(ms=g_kernel, plain_ms=g_plain, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=g_library)


def build_all(names) -> None:
    """Delete every built library of ``names`` and rebuild them from
    source, one ``nvcc`` per source, all started together."""
    from repro_torch.kernels import _build
    for name in names:
        for f in _build.BUILD_DIR.glob(f"lib{name}_*.so"):
            f.unlink()

    def one(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return lib, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for lib, sec in pool.map(one, names):
            print(f"  nvcc {lib.name}: {sec:.1f}s", flush=True)
            resource_usage(lib)


def resource_usage(lib) -> None:
    """Print each kernel's registers, stack, local (spill) and static
    shared memory from ``cuobjdump --dump-resource-usage`` and the
    library's counts of HGMMA (wgmma) and HMMA (mma.sync) instructions
    from its SASS."""
    import re
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("    cuobjdump not found: resource usage not measured",
              flush=True)
        return
    run = lambda flag: subprocess.run([tool, flag, str(lib)],
                                      capture_output=True, text=True,
                                      timeout=120).stdout
    name = None
    for line in run("--dump-resource-usage").splitlines():
        if "Function" in line:          # "Function <mangled name>:"
            name = line.partition("Function")[2].strip().rstrip(":")
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}", "", name)
        if "REG:" in line and name is not None:
            keep = " ".join(f for f in line.split() if f.split(":")[0] in
                            ("REG", "STACK", "SHARED", "LOCAL"))
            print(f"    {name[:60]}: {keep}", flush=True)
    sass = run("--dump-sass").splitlines()
    hgmma = sum("HGMMA" in ln for ln in sass)
    hmma = sum("HMMA" in ln and "HGMMA" not in ln for ln in sass)
    print(f"    HGMMA instructions: {hgmma}; HMMA (mma.sync): {hmma}",
          flush=True)


def attn_bound_ms(flops, nbytes, dtype) -> tuple[float, str]:
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                      else "bytes")


def visible_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs a call computes: all Sq * Sk without the
    causal mask, the lower triangle (or band) with it."""
    if not causal:
        return Sq * Sk
    i = np.arange(Sq)
    return int(np.minimum(i + 1, window if window > 0 else Sq).sum())


def check_flash(ops, ref, CARD, shapes=None):
    """The kernel at every shape of ``shapes`` (FLASH_SHAPES by
    default) against its plain version, timed beside it and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn_tolerance import attn_err
    gen = torch.Generator(device="cuda").manual_seed(1)
    main = None
    max_err = 0.0
    with torch.no_grad():
        for (B, Hq, Hkv, Sq, Sk, D, causal, window, dt) in (
                shapes or FLASH_SHAPES):
            q = torch.randn((B, Hq, Sq, D), generator=gen,
                            device="cuda").to(dt)
            k, v = (torch.randn((B, Hkv, Sk, D), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            call = lambda: ops.flash_attention(q, k, v, causal=causal,
                                               window=window)
            got = call()
            want = ref.attention_chunked(q, k, v, causal=causal,
                                         window=window)
            torch.cuda.synchronize()
            err, over = attn_err(got, want)
            ok = over <= 1.0
            if window > 0:      # the same function: an explicit band mask
                i = torch.arange(Sq, device="cuda")
                mask = (i[:, None] >= i[None, :]) & \
                    (i[:, None] - i[None, :] < window)
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
            else:
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
            lib_err = (lib().float() - want.float()).abs().max().item()
            ms = cuda_ms(call, reps=10)
            # bf16: the same calls replayed from a CUDA graph, device time
            # only, with no host dispatch between short calls
            g_ms = graph_ms(call, calls=10) if dt == torch.bfloat16 \
                else float("nan")
            plain_ms = cuda_ms(lambda: ref.attention_chunked(
                q, k, v, causal=causal, window=window), reps=3, warmup=1)
            library_ms = cuda_ms(lib, reps=10)
            esz = q.element_size()
            flops = 4.0 * B * Hq * D * visible_pairs(Sq, Sk, causal, window)
            nbytes = esz * B * D * (2 * Hq * Sq + 2 * Hkv * Sk)
            bound_ms, bound_by = attn_bound_ms(flops, nbytes, dt)
            print(f"  flash_attention B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} "
                  f"Sk={Sk} D={D} causal={causal} window={window} "
                  f"{str(dt)[6:]} [{CARD}]: "
                  f"max_abs_err={err:.3e} err/bound={over:.3f} ok={ok} "
                  f"kernel_ms={ms:.4f} (CUDA graph {g_ms:.4f}) "
                  f"plain_ms={plain_ms:.4f} "
                  f"sdpa_ms={library_ms:.4f} (max_abs_err vs plain "
                  f"{lib_err:.2e}) bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"TFLOP/s={flops / ms / 1e9:.1f} "
                  f"kernel_over_sdpa={ms / library_ms:.3f}", flush=True)
            if not ok:
                raise AssertionError(f"flash_attention disagrees with its "
                                     f"plain version at "
                                     f"{(B, Hq, Hkv, Sq, Sk, D, causal)}")
            max_err = max(max_err, err)
            if main is None:
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms)
        # causal attention with Sq != Sk has no agreed alignment: refused
        q = torch.zeros((1, 6, 4, 64), dtype=torch.bfloat16, device="cuda")
        k = torch.zeros((1, 6, 1500, 64), dtype=torch.bfloat16, device="cuda")
        before = ops.LAUNCHES
        try:
            ops.flash_attention(q, k, k, causal=True)
        except ValueError as e:
            print(f"  flash_attention causal Sq=4 Sk=1500 refused: {e}",
                  flush=True)
        else:
            raise AssertionError("flash_attention took causal Sq != Sk")
        if ops.LAUNCHES != before:
            raise AssertionError("flash_attention launched on causal Sq != Sk")
    return dict(max_abs_err=max_err, **main)


def check_decode(ops, ref, CARD, shapes=None):
    """The kernel at every shape of ``shapes`` (DECODE_SHAPES by
    default) against its plain version, timed beside it and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn_tolerance import attn_err
    gen = torch.Generator(device="cuda").manual_seed(2)
    main = None
    max_err = 0.0
    with torch.no_grad():
        for (B, Hq, Hkv, S, D, lengths, dt) in shapes or DECODE_SHAPES:
            q = torch.randn((B, Hq, 1, D), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((B, Hkv, S, D), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            if isinstance(lengths, int):
                length = torch.full((B,), lengths, dtype=torch.int32,
                                    device="cuda")
            elif lengths == "full":
                length = torch.full((B,), S, dtype=torch.int32, device="cuda")
            elif lengths == "batcher":
                length = torch.randint(1, 97, (B,), generator=gen,
                                       device="cuda", dtype=torch.int32)
            else:
                length = torch.randint(1, S + 1, (B,), generator=gen,
                                       device="cuda", dtype=torch.int32)
            got = ops.decode_attention(q, k, v, length)
            want = ref.decode_attention_ref(q, k, v, length)
            torch.cuda.synchronize()
            err, over = attn_err(got, want)
            ok = over <= 1.0
            mask = (torch.arange(S, device="cuda")[None, :]
                    < length[:, None])[:, None, None, :]
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
            lib_err = (lib().float() - want.float()).abs().max().item()
            # back to back (host dispatch included), then device time
            # from CUDA graph replays: a call of ~20 us is otherwise the
            # host's ctypes call, not the kernel
            eager_ms = cuda_ms(lambda: ops.decode_attention(
                q, k, v, length), reps=50)
            ms = graph_ms(lambda: ops.decode_attention(q, k, v, length))
            plain_ms = graph_ms(lambda: ref.decode_attention_ref(
                q, k, v, length), calls=10)
            eager_lib_ms = cuda_ms(lib, reps=50)
            library_ms = graph_ms(lib)
            esz = q.element_size()
            rows = int(length.sum().item())
            flops = 4.0 * rows * (Hq // Hkv) * Hkv * D
            nbytes = esz * (2 * rows * Hkv * D + 2 * B * Hq * D) + 4 * B
            bound_ms, bound_by = attn_bound_ms(flops, nbytes, dt)
            n_split, split_rows = ops.split_plan(B, Hkv, S, n_sm())
            print(f"  decode_gqa B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} "
                  f"length={lengths} (sum {rows}) {str(dt)[6:]} "
                  f"split={n_split}x{split_rows} [{CARD}]: "
                  f"max_abs_err={err:.3e} err/bound={over:.3f} ok={ok} "
                  f"kernel_ms={ms:.4f} (CUDA graph; back to back "
                  f"{eager_ms:.4f}) plain_ms={plain_ms:.4f} (graph) "
                  f"sdpa_ms={library_ms:.4f} (graph; back to back "
                  f"{eager_lib_ms:.4f}; max_abs_err vs plain "
                  f"{lib_err:.2e}) bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"bound/kernel={bound_ms / ms:.3f} "
                  f"GB/s={nbytes / ms / 1e6:.0f} "
                  f"kernel_over_sdpa={ms / library_ms:.3f}", flush=True)
            if not ok:
                raise AssertionError(f"decode_gqa disagrees with its plain "
                                     f"version at {(B, Hq, Hkv, S, D)}")
            max_err = max(max_err, err)
            if main is None:
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms)
    return dict(max_abs_err=max_err, **main)


class Spans:
    """Synchronised host-clock spans around named functions of a module,
    installed for one run and removed after it."""

    def __init__(self, targets):
        self.targets = targets          # [(module, attr, label)]
        self.us = {label: 0.0 for _, _, label in targets}
        self.each = {label: [] for _, _, label in targets}

    def __enter__(self):
        self.saved = []
        for mod, attr, label in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def timed(*a, _fn=fn, _label=label, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                us = (time.perf_counter() - t0) * 1e6
                self.us[_label] += us
                self.each[_label].append(us)
                return out
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def serve_phase(serve_cli, ops, policy, CARD):
    calls = []                  # the actor's (xs, mask, wx, wh, b) per tick
    real = ops.lstm_seq

    def recording(xs, mask, *w):
        calls.append((xs.clone(), mask.clone(), *w))
        return real(xs, mask, *w)
    ops.lstm_seq = recording
    with captured_serving(serve_cli) as results:
        ops.LAUNCHES = 0
        try:
            out = serve_cli.main(SERVE_ARGS + ["--policy", policy])
        finally:
            ops.lstm_seq = real
        launches = ops.LAUNCHES
    if not out["counted"] > 0 or not 0.0 <= out["sla_rate"] <= 1.0:
        raise AssertionError(f"serve:{policy}: counted={out['counted']} "
                             f"sla_rate={out['sla_rate']}")
    expected = out["ticks"] if policy == "relmas" else 0
    if launches != expected:
        raise AssertionError(f"serve:{policy}: lstm_seq launched "
                             f"{launches} times in {out['ticks']} ticks, "
                             f"expected {expected}")
    print(f"  serve:{policy} [{CARD}]: ticks={out['ticks']} "
          f"lstm_seq launches={launches} tick_p50_ms="
          f"{out['tick_p50_us'] / 1e3:.3f} tick_p99_ms="
          f"{out['tick_p99_us'] / 1e3:.3f} sla_rate={out['sla_rate']:.4f} "
          f"counted={out['counted']}", flush=True)
    if calls:
        serve_masks(ops, calls, CARD)
    return launches, out, results[0]


@contextlib.contextmanager
def captured_serving(serve_cli):
    """Collect the full ``serve_stream`` result of every batched driver
    run (``main`` returns only the summary) while the block is open."""
    results, real = [], serve_cli.serve_batched

    def capturing(*a, **k):
        out, res = real(*a, **k)
        results.append(res)
        return out, res
    serve_cli.serve_batched = capturing
    try:
        yield results
    finally:
        serve_cli.serve_batched = real


def serve_masks(ops, calls, CARD):
    """The actor's masks of a serving run: each call's longest valid
    prefix, and the kernel timed again on every recorded call beside
    the bound for its mask."""
    longest, live, ms, bound = [], [], [], []
    with torch.no_grad():
        for xs, mask, wx, wh, b in calls:
            T, B, F = xs.shape
            steps = torch.arange(1, T + 1, device=mask.device)[:, None]
            ends = (mask * steps).amax(0)          # last live step + 1
            longest.append(int(ends.max()))
            live.append(float(mask.float().mean()))
            ms.append(cuda_ms(lambda: ops.lstm_seq(xs, mask, wx, wh, b),
                              reps=20))
            bound.append(lstm_bound_ms(T, B, F, wh.shape[0], mask)[0])
    full = calls[0]
    full_ms = cuda_ms(lambda: ops.lstm_seq(
        full[0], torch.ones_like(full[1]), *full[2:]), reps=20)
    print(f"  serve:relmas actor masks [{CARD}]: calls={len(calls)} "
          f"T={calls[0][0].shape[0]} longest valid prefix mean="
          f"{np.mean(longest):.1f} p50={pct(longest, 50):.0f} "
          f"max={max(longest)}; live share of (step, row) mean="
          f"{np.mean(live):.4f}; kernel on the recorded calls mean_ms="
          f"{np.mean(ms):.4f} p50_ms={pct(ms, 50):.4f} max_ms="
          f"{max(ms):.4f} (sum {np.sum(ms):.3f} ms per run), bound mean_ms="
          f"{np.mean(bound):.4f}; the same inputs with a full mask "
          f"{full_ms:.4f} ms", flush=True)


def parity_phase(serve_cli, policy, CARD):
    from repro_torch.core import baselines
    from repro_torch.kernels.lstm_seq import ops
    from repro_torch.sim import engine
    results = {}
    for dev in ("cpu", "cuda"):
        args = serve_cli.parse_args(SERVE_ARGS + ["--policy", policy,
                                                  "--device", dev])
        svc = serve_cli.build_service(args)
        if dev == "cpu":
            _, results[dev] = serve_cli.serve_batched(svc, args)
            continue
        spans = Spans([(engine, "simulate", "engine"),
                       (ops, "lstm_seq", "lstm_seq"),
                       (baselines, "_greedy_sa", "greedy_sa")])
        with spans:
            _, results[dev] = serve_cli.serve_batched(svc, args)
        tick_us = float(np.sum(results[dev]["stats"]["tick_wall_us"]))
        shares = " ".join(f"{k}_share={v / tick_us:.4f}"
                          for k, v in spans.us.items() if v)
        print(f"  parity:{policy} card run with synchronised spans "
              f"[{CARD}]: tick_total_ms={tick_us / 1e3:.1f} {shares}",
              flush=True)
    cpu, gpu = results["cpu"], results["cuda"]
    n_diff = 0
    for s, (mc, mg) in enumerate(zip(cpu["metrics"], gpu["metrics"])):
        if mc["counted"] != mg["counted"]:
            raise AssertionError(f"parity:{policy} stream {s}: counted "
                                 f"{mg['counted']} on the card, "
                                 f"{mc['counted']} on the CPU")
        if abs(mc["hits"] - mg["hits"]) > 0.01 * mc["counted"]:
            raise AssertionError(f"parity:{policy} stream {s}: hits "
                                 f"{mg['hits']} vs {mc['hits']}")
        key = lambda c: (c["rid"], c["hit"], c["missed"])
        a = {key(c) for c in cpu["completions"][s]}
        b = {key(c) for c in gpu["completions"][s]}
        n_diff += len(a ^ b)
    print(f"  parity:{policy}: streams={len(cpu['metrics'])} "
          f"counted={cpu['aggregate']['counted']} "
          f"hits cpu={cpu['aggregate']['hits']} "
          f"card={gpu['aggregate']['hits']} "
          f"completions differing={n_diff}", flush=True)


def lm_counts():
    from repro_torch.kernels.decode_gqa import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return fa_ops, dec_ops


def lm_from_seed(arch: str, n_layers: int | None = None):
    """``arch`` at full width and depth (or its first ``n_layers``), bf16
    weights drawn on the card from seed 0."""
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return LM(cfg, device="cuda").init(gen)


def check_ids(label, logits, toks, cfg):
    if not torch.isfinite(logits.float()).all() or \
            not bool(((toks >= 0) & (toks < cfg.vocab_padded)).all()):
        raise AssertionError(f"{label}: non-finite logits or ids out of "
                             f"range")


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def profile_window(fn, label, CARD, top=6, share=None):
    """Run ``fn()`` under ``torch.profiler`` and print the device's busy
    share of the window (kernel time over host wall time), the kernel
    count, the kernels with the most device time and the operations
    with the most host time; with ``share``, also the device time of
    the kernels whose name holds that string and its share of the
    window's kernel time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    kernels = [e for e in events if e.device_type ==
               torch.autograd.DeviceType.CUDA and dev(e) > 0]
    dev_us = sum(dev(e) for e in kernels)
    if dev_us == 0:
        print(f"  profile {label} [{CARD}]: wall_ms={wall_us / 1e3:.2f} "
              f"device time not measured (the profiler saw no kernel)",
              flush=True)
        return
    n_kernels = sum(e.count for e in kernels)
    by_dev = sorted(kernels, key=dev, reverse=True)[:top]
    host = [e for e in events if e.device_type ==
            torch.autograd.DeviceType.CPU]
    by_host = sorted(host, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:top]
    print(f"  profile {label} [{CARD}]: wall_ms={wall_us / 1e3:.2f} "
          f"kernel_ms={dev_us / 1e3:.2f} device_busy_share="
          f"{dev_us / wall_us:.4f} kernels={n_kernels}", flush=True)
    print("    device: " + "; ".join(
        f"{e.key[:48]} x{e.count} {dev(e) / 1e3:.2f}ms" for e in by_dev),
        flush=True)
    print("    host: " + "; ".join(
        f"{e.key[:32]} x{e.count} {e.self_cpu_time_total / 1e3:.2f}ms"
        for e in by_host), flush=True)
    if share is not None:
        mine = [e for e in kernels if share in e.key]
        mine_us = sum(dev(e) for e in mine)
        print(f"    {share}: x{sum(e.count for e in mine)} "
              f"{mine_us / 1e3:.2f}ms of {dev_us / 1e3:.2f}ms kernel time "
              f"(share {mine_us / dev_us:.4f})", flush=True)


def timed_prefill_decode(prefill, decode, tokens, steps, extra=None,
                         prefix=0):
    """One prefill of ``tokens`` (B, S) (with the batch keys ``extra``,
    such as whisper's frames or the VLM's patches, of which ``prefix``
    positions precede the text), then ``steps`` greedy decode steps,
    each timed on the host clock and ended by a synchronise.  Returns
    (prefill_ms, step_ms, ids (B, steps + 1), logits, cache)."""
    B, S = tokens.shape
    S += prefix
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill({"tokens": tokens, **(extra or {})})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step_ms, out = [], [tok]
    for i in range(steps):
        pos = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
        t0 = time.perf_counter()
        tok, logits, cache = decode(cache, {"token": tok[:, None],
                                            "pos": pos})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
    return prefill_ms, step_ms, torch.stack(out, 1), logits, cache


def lm_prefill_decode_phase(model, CARD):
    from repro_torch.models import make_decode_step, make_prefill_step
    fa_ops, dec_ops = lm_counts()
    cfg = model.cfg
    prefill = make_prefill_step(model, pad_to=LM_PAD)
    decode = make_decode_step(model)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (LM_B, LM_S), generator=gen,
                           device="cuda", dtype=torch.int32)
    run = lambda steps: timed_prefill_decode(prefill, decode, tokens, steps)

    run(2)                                      # warm-up: cuBLAS, kernels
    torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = 0
    prefill_ms, step_ms, toks, logits, cache = run(LM_STEPS)
    launches = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != (cfg.n_layers, cfg.n_layers * LM_STEPS):
        raise AssertionError(f"lm:prefill_decode: launches flash_attention="
                             f"{launches[0]} decode_gqa={launches[1]}, "
                             f"expected {cfg.n_layers} and "
                             f"{cfg.n_layers * LM_STEPS}")
    check_ids("lm:prefill_decode", logits, toks, cfg)
    if tuple(cache["k"].shape) != (cfg.n_layers, LM_B, cfg.n_kv, LM_PAD,
                                   cfg.head_dim):
        raise AssertionError(f"lm:prefill_decode: cache {cache['k'].shape}")
    with torch.no_grad():
        profile_window(lambda: prefill({"tokens": tokens}), "prefill", CARD,
                       share="flash_attention")
        pos = torch.full((LM_B,), LM_S, dtype=torch.int32, device="cuda")
        tok = toks[:, :1]
        profile_window(lambda: [decode(cache, {"token": tok, "pos": pos})
                                for _ in range(4)], "4 decode steps", CARD,
                       share="decode_gqa")
    n_params = model.param_count()
    wbytes = n_params * 2
    kv_bytes = 2 * cfg.n_layers * LM_B * cfg.n_kv * cfg.head_dim * 2 * (
        LM_S + LM_STEPS // 2)
    dec_s = sum(step_ms) / 1e3
    print(f"  lm:prefill_decode {cfg.name} params={n_params} "
          f"B={LM_B} S={LM_S} pad_to={LM_PAD} steps={LM_STEPS} [{CARD}]: "
          f"prefill_ms={prefill_ms:.2f} decode_p50_ms={pct(step_ms, 50):.3f} "
          f"decode_p99_ms={pct(step_ms, 99):.3f} "
          f"decode_tokens_per_s={LM_B * LM_STEPS / dec_s:.1f} "
          f"prefill_tokens_per_s={LM_B * LM_S / prefill_ms * 1e3:.0f} "
          f"peak_mem_gb={peak_gb:.2f} "
          f"launches flash_attention={launches[0]} "
          f"decode_gqa={launches[1]} "
          f"step_weight_read_bound_ms={wbytes / PEAK_BYTES * 1e3:.3f} "
          f"(+kv {kv_bytes / PEAK_BYTES * 1e3:.3f})", flush=True)
    return launches


def serve_batcher(model, *, n, n_slots, smax, prompt_len, max_new):
    """``n`` synthetic requests through a ``ContinuousBatcher`` until
    all are served.  Returns (done, batched decode steps, wall s)."""
    from repro_torch.serving import ContinuousBatcher, synth_requests
    cfg = model.cfg
    reqs = synth_requests([cfg.name], n=n, horizon_us=1000.0,
                          qos_budget_us={cfg.name: 1e9}, vocab=cfg.vocab,
                          prompt_len=prompt_len, max_new=max_new, seed=1)
    batcher = ContinuousBatcher(model, n_slots=n_slots, smax=smax)
    steps = [0]
    inner = batcher._step

    def counted_step():
        steps[0] += 1
        return inner()
    batcher._step = counted_step
    pending, done = list(reqs), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or batcher.active():
        while pending and batcher.has_free_slot():
            batcher.add(pending.pop(0))
        done += batcher.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.tokens_out) for r in done)
    if len(done) != n or n_tok != max_new * n:
        raise AssertionError(f"batcher served {len(done)} of {n} requests, "
                             f"{n_tok} tokens")
    if not all(0 <= t < cfg.vocab_padded for r in done for t in r.tokens_out):
        raise AssertionError("batcher: ids out of range")
    return done, steps[0], wall


def lm_batcher_phase(model, CARD):
    _, dec_ops = lm_counts()
    cfg = model.cfg
    dec_ops.LAUNCHES = 0
    done, steps, wall = serve_batcher(model, n=BATCHER_REQUESTS,
                                      n_slots=16, smax=512,
                                      prompt_len=BATCHER_PROMPT,
                                      max_new=64)
    launches = dec_ops.LAUNCHES
    n_tok = sum(len(r.tokens_out) for r in done)
    if launches != cfg.n_layers * steps:
        raise AssertionError(f"lm:batcher: decode_gqa launched {launches} "
                             f"times in {steps} steps")
    print(f"  lm:batcher {cfg.name} slots=16 smax=512 [{CARD}]: "
          f"requests={len(done)} tokens_out={n_tok} "
          f"batched_decode_steps={steps} (prompt feeding included) "
          f"wall_s={wall:.2f} tokens_out_per_s={n_tok / wall:.1f} "
          f"ms_per_step={wall / steps * 1e3:.3f} "
          f"decode_gqa launches={launches}", flush=True)


def cut_layers(tree, n):
    """The first ``n`` layers of stacked (L, ...) parameters."""
    if isinstance(tree, dict):
        return {k: cut_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def cut_models(model_full, n_layers=2, dtype=None):
    """The full-width weights cut to ``n_layers`` (in ``dtype`` if given,
    else as they are) as one model on the card and one on the CPU."""
    from repro_torch.models import LM
    cfg = dataclasses.replace(model_full.cfg, n_layers=n_layers)
    gpu, cpu = LM(cfg, device="cuda"), LM(cfg, device="cpu")
    gpu.params = dict(model_full.params)
    gpu.params["stack"] = cut_layers(model_full.params["stack"], n_layers)
    if dtype is not None:
        gpu.params = cast(gpu.params, dtype)
    cpu.params = to_cpu(gpu.params)
    return gpu, cpu


def cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def parity_history(gpu, cpu, B, S, steps, extra=None, seed=4, prefix=0):
    """Prefill of B x S tokens (with the batch keys ``extra``, on the
    CPU, of which ``prefix`` positions precede the text, as the VLM's
    patches), then ``steps`` teacher-forced decode steps, on the CPU
    (plain versions) and on the card (kernels), in turns.  Returns
    [(kind, cpu logits, card logits on the CPU), ...] in float32."""
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(
        rng.integers(0, cpu.cfg.vocab, (B, S + steps)).astype(np.int32))
    history, caches, out = [], {}, {}
    with torch.no_grad():
        for name, m in (("cpu", cpu), ("gpu", gpu)):
            out[name], caches[name] = m.prefill(
                {"tokens": tokens[:, :S], **(extra or {})},
                pad_to=prefix + S + steps)
        history.append(("prefill", out["cpu"].float(),
                        out["gpu"].float().cpu()))
        for i in range(steps):          # teacher forcing: the given ids
            batch = {"token": tokens[:, S + i:S + i + 1],
                     "pos": torch.full((B,), prefix + S + i,
                                       dtype=torch.int32)}
            for name, m in (("cpu", cpu), ("gpu", gpu)):
                out[name], caches[name] = m.decode_step(caches[name], batch)
            history.append(("decode", out["cpu"].float(),
                            out["gpu"].float().cpu()))
    return history


def parity_check(history, tol, label, exempt=None):
    """Logits within ``tol`` and greedy ids equal wherever the CPU's
    top-2 gap exceeds it, on every row not in ``exempt`` (one (B,) bool
    per history entry, or None).  Returns (worst by kind, the largest
    mean difference, ids compared, rows compared)."""
    atol, rtol = tol["atol"], tol["rtol"]
    worst = {"prefill": 0.0, "decode": 0.0}
    mean_err, checked, rows = [], 0, 0
    for i, (kind, c, g) in enumerate(history):
        if exempt is not None:
            keep = ~exempt[i]
            c, g = c[keep], g[keep]
        rows += c.shape[0]
        if c.shape[0] == 0:
            continue
        diff = (c - g).abs()
        worst[kind] = max(worst.get(kind, 0.0), diff.max().item())
        mean_err.append(diff.mean().item())
        if not torch.allclose(g, c, atol=atol, rtol=rtol):
            raise AssertionError(f"{label}: {kind} logits differ by "
                                 f"{diff.max().item():.3e}")
        # greedy ids must agree where the CPU's top-2 gap exceeds the
        # tolerance
        top2 = torch.topk(c, 2, dim=-1)
        gap = top2.values[:, 0] - top2.values[:, 1]
        sure = gap > atol + rtol * top2.values[:, 0].abs()
        checked += int(sure.sum())
        if not bool(((top2.indices[:, 0] == g.argmax(-1)) | ~sure).all()):
            raise AssertionError(f"{label}: greedy id differs at a {kind} "
                                 f"step with a top-2 gap above the "
                                 f"tolerance")
    if not mean_err or max(mean_err) > tol["mean"]:
        raise AssertionError(f"{label}: mean logit difference "
                             f"{max(mean_err, default=float('nan')):.3e}")
    return worst, max(mean_err), checked, rows


def parity_print(label, what, worst, mean_err, checked, n_ids, tol, CARD):
    errs = " ".join(f"{k}={v:.3e}" for k, v in worst.items())
    print(f"  {label} {what}, CPU vs [{CARD}]: max_abs_err {errs} "
          f"(atol {tol['atol']}, rtol "
          f"{tol['rtol']}) max_mean_abs_err={mean_err:.3e} (limit "
          f"{tol['mean']}) greedy ids equal where compared={checked} "
          f"(of {n_ids})", flush=True)


def parity_run(model_full, tol, label, CARD, B=2, S=256, steps=16):
    """2 layers of the full-width weights, CPU (plain versions) against
    the card (kernels): prefill of B x S tokens, then ``steps``
    teacher-forced decode steps; logits within ``tol`` and greedy ids
    equal wherever the CPU's top-2 gap exceeds it."""
    gpu, cpu = cut_models(model_full)
    history = parity_history(gpu, cpu, B, S, steps)
    worst, mean_err, checked, _ = parity_check(history, tol, label)
    parity_print(label, f"{gpu.cfg.name} cut to {gpu.cfg.n_layers} layers, "
                 f"B={B} S={S} + {steps} teacher-forced steps", worst,
                 mean_err, checked, B * (steps + 1), tol, CARD)
    return steps


def lm_parity_phase(model_full, CARD):
    fa_ops, dec_ops = lm_counts()
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = 0
    steps = parity_run(model_full, LM_TOL, "lm:parity", CARD)
    if (fa_ops.LAUNCHES, dec_ops.LAUNCHES) != (2, 2 * steps):
        raise AssertionError(f"lm:parity: launches {fa_ops.LAUNCHES}, "
                             f"{dec_ops.LAUNCHES}")


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------
def ssd_inputs(BC, C, N, H, P, draw, gen):
    """cm, bm, xdt, cum on the card.  ``draw`` "kernels" is
    tests/test_kernels.py's range (dt = softplus(z) / 2,
    A = -exp(0.3 z)): decays stay far above exp(-60) over a chunk, so an
    error far below the diagonal shows.  "model" is the model's range
    (A down to -16, as ssm_init sets it), which drives cum past the
    clip."""
    import torch.nn.functional as F
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    cm, bm = rnd(BC, C, N) * 0.3, rnd(BC, C, N) * 0.3
    xdt = rnd(BC, H, C, P) * 0.25
    if draw == "kernels":
        la = -F.softplus(rnd(BC, H, C)) * 0.5 * torch.exp(
            rnd(H) * 0.3)[None, :, None]
    else:
        la = -F.softplus(rnd(BC, H, C) + 1.0) * torch.linspace(
            1.0, 16.0, H, device="cuda")[None, :, None]
    return cm, bm, xdt, torch.cumsum(la, dim=-1)


def ssd_bytes(BC, C, N, H, P) -> int:
    """cm, bm, xdt, cum read once and y written once."""
    return 4 * (2 * BC * C * N + 2 * BC * H * C * P + BC * H * C)


def ssd_bound_ms(BC, C, N, H, P) -> tuple[float, str]:
    """Least time for the call: its float32 operations with S computed
    once per chunk over the lower triangle (2N per entry), then per head
    the decay product (1) and (S o L) . xdt (2P per entry), over the
    float32 peak; or its bytes (cm, bm, xdt, cum read once, y written
    once) over the memory rate; whichever is larger.  The exps are left
    out."""
    tri = C * (C + 1) // 2
    flops = BC * tri * 2.0 * N + BC * H * tri * (2.0 * P + 1.0)
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = ssd_bytes(BC, C, N, H, P) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                      else "bytes")


def check_ssd(ops, ref, CARD, shapes=None):
    """The kernel at every shape of ``shapes`` (SSD_SHAPES by default)
    and both draws against its plain version, timed beside it; then
    ``ssd_forward`` against the sequential scan."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    main = None
    max_err = 0.0
    with torch.no_grad():
        for (BC, C, N, H, P) in shapes or SSD_SHAPES:
            for draw in ("kernels", "model"):
                args = ssd_inputs(BC, C, N, H, P, draw, gen)
                # the plain version first: the kernel's output then never
                # lands on a freed block that already holds the answer
                want = ref.ssd_intra_ref(*args)
                got = ops.ssd_intra(*args)
                torch.cuda.synchronize()
                err, over = ref.ssd_err(got, want)
                ok = over <= 1.0
                print(f"  ssd_chunk BC={BC} C={C} N={N} H={H} P={P} "
                      f"draw={draw} min_cum={args[3].min().item():.1f} "
                      f"route=3xtf32 [{CARD}]: max_abs_err={err:.3e} "
                      f"err/bound={over:.4f} (SSD_TOL {ref.SSD_TOL:g}) "
                      f"ok={ok}", flush=True)
                if not ok:
                    raise AssertionError(f"ssd_chunk disagrees with its "
                                         f"plain version at "
                                         f"{(BC, C, N, H, P)}, {draw}")
                max_err = max(max_err, err)
            ms = cuda_ms(lambda: ops.ssd_intra(*args), reps=20)
            plain_ms = cuda_ms(lambda: ref.ssd_intra_ref(*args), reps=5,
                               warmup=1)
            bound_ms, bound_by = ssd_bound_ms(BC, C, N, H, P)
            hg = ops.head_group(BC, H, n_sm())
            print(f"  ssd_chunk BC={BC} C={C} N={N} H={H} P={P} "
                  f"heads/block={hg} [{CARD}]: "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"bound/kernel={bound_ms / ms:.3f} "
                  f"GB/s={ssd_bytes(BC, C, N, H, P) / ms / 1e6:.0f} "
                  f"library_ms=none (no single PyTorch call computes it)",
                  flush=True)
            if main is None:
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None)
        # the public forward with a ragged T, against the sequential scan
        # (tests/test_kernels.py's tolerance between the JAX routes)
        B, T, H, P, N, chunk = 2, 100, 5, 32, 64, 32
        rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
        x = rnd(B, T, H, P) * 0.5
        dt = torch.nn.functional.softplus(rnd(B, T, H)) * 0.5
        A = -torch.exp(rnd(H) * 0.3)
        Bm, Cm = rnd(B, T, N) * 0.3, rnd(B, T, N) * 0.3
        y, S = ops.ssd_forward(x, dt, A, Bm, Cm, chunk=chunk)
        ys, Ss = ref.ssd_scan_ref(x, dt, A, Bm, Cm)
        torch.cuda.synchronize()
        err = max((y - ys).abs().max().item(), (S - Ss).abs().max().item())
        ok = torch.allclose(y, ys, atol=5e-4, rtol=1e-3) and \
            torch.allclose(S, Ss, atol=5e-4, rtol=1e-3)
        print(f"  ssd_forward B={B} T={T} H={H} P={P} N={N} chunk={chunk} "
              f"against ssd_scan_ref [{CARD}]: max_abs_err={err:.3e} "
              f"(atol 5e-4, rtol 1e-3) ok={ok}", flush=True)
        if not ok:
            raise AssertionError("ssd_forward disagrees with ssd_scan_ref")
    return dict(max_abs_err=max_err, **main)


def mamba_prefill_decode_phase(model, CARD):
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.models import make_decode_step, make_prefill_step
    cfg = model.cfg
    prefill = make_prefill_step(model, pad_to=MB_S + MB_STEPS)
    decode = make_decode_step(model)
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (MB_B, MB_S), generator=gen,
                           device="cuda", dtype=torch.int32)
    run = lambda steps: timed_prefill_decode(prefill, decode, tokens, steps)

    run(2)                                      # warm-up: cuBLAS, kernels
    torch.cuda.reset_peak_memory_stats()
    ssd_ops.LAUNCHES = 0
    prefill_ms, step_ms, toks, logits, cache = run(MB_STEPS)
    launches = ssd_ops.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != cfg.n_layers:
        raise AssertionError(f"lm:mamba2_prefill_decode: ssd_chunk launched "
                             f"{launches} times in one prefill, expected "
                             f"{cfg.n_layers}")
    check_ids("lm:mamba2_prefill_decode", logits, toks, cfg)
    H, N, P = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    conv_dim = cfg.ssm_expand * cfg.d_model + 2 * N
    if tuple(cache["ssm"].shape) != (cfg.n_layers, MB_B, H, N, P) or \
            tuple(cache["conv"].shape) != (cfg.n_layers, MB_B,
                                           cfg.ssm_conv - 1, conv_dim) or \
            not torch.isfinite(cache["ssm"]).all():
        raise AssertionError(f"lm:mamba2_prefill_decode: cache "
                             f"{tuple(cache['ssm'].shape)} "
                             f"{tuple(cache['conv'].shape)}")
    with torch.no_grad():
        profile_window(lambda: prefill({"tokens": tokens}), "mamba2 prefill",
                       CARD, top=12, share="ssd_chunk")
        pos = torch.full((MB_B,), MB_S, dtype=torch.int32, device="cuda")
        tok = toks[:, :1]
        profile_window(lambda: [decode(cache, {"token": tok, "pos": pos})
                                for _ in range(4)], "mamba2 4 decode steps",
                       CARD)
    n_params = model.param_count()
    wbytes = n_params * 2
    state_bytes = 2 * cache["ssm"].numel() * 4     # read and written
    dec_s = sum(step_ms) / 1e3
    print(f"  lm:mamba2_prefill_decode {cfg.name} params={n_params} "
          f"B={MB_B} S={MB_S} steps={MB_STEPS} [{CARD}]: "
          f"prefill_ms={prefill_ms:.2f} decode_p50_ms={pct(step_ms, 50):.3f} "
          f"decode_p99_ms={pct(step_ms, 99):.3f} "
          f"decode_tokens_per_s={MB_B * MB_STEPS / dec_s:.1f} "
          f"prefill_tokens_per_s={MB_B * MB_S / prefill_ms * 1e3:.0f} "
          f"peak_mem_gb={peak_gb:.2f} ssd_chunk launches={launches} "
          f"step_weight_read_bound_ms={wbytes / PEAK_BYTES * 1e3:.3f} "
          f"(+ssm state {state_bytes / PEAK_BYTES * 1e3:.3f})", flush=True)
    return launches


def mamba_batcher_phase(model, CARD):
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    ssd_ops.LAUNCHES = 0
    done, steps, wall = serve_batcher(model, n=MB_BATCHER_REQUESTS,
                                      n_slots=8, smax=128, prompt_len=16,
                                      max_new=16)
    n_tok = sum(len(r.tokens_out) for r in done)
    if ssd_ops.LAUNCHES != 0:
        raise AssertionError(f"lm:mamba2_batcher: ssd_chunk launched "
                             f"{ssd_ops.LAUNCHES} times; decode runs none")
    print(f"  lm:mamba2_batcher {model.cfg.name} slots=8 smax=128 "
          f"[{CARD}]: requests={len(done)} tokens_out={n_tok} "
          f"batched_decode_steps={steps} (prompt feeding included) "
          f"wall_s={wall:.2f} tokens_out_per_s={n_tok / wall:.1f} "
          f"ms_per_step={wall / steps * 1e3:.3f}", flush=True)


def mamba_parity_phase(model_full, CARD):
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    ssd_ops.LAUNCHES = 0
    parity_run(model_full, MAMBA_TOL, "lm:mamba2_parity", CARD)
    if ssd_ops.LAUNCHES != 2:
        raise AssertionError(f"lm:mamba2_parity: ssd_chunk launched "
                             f"{ssd_ops.LAUNCHES} times, expected 2")


# ---------------------------------------------------------------------------
# Whisper (encoder-decoder) and OLMoE (MoE)
# ---------------------------------------------------------------------------
def whisper_frames(cfg, B, seed, device):
    """Stub audio embeddings: N(0, 1) x 0.1, as the JAX smoke tests draw
    them (tests/test_models_smoke.py)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((B, cfg.n_frames, cfg.d_model), generator=gen,
                       device=device) * 0.1


def whisper_prefill_decode_phase(model, CARD):
    from repro_torch.models import make_decode_step, make_prefill_step
    fa_ops, dec_ops = lm_counts()
    cfg = model.cfg
    pad = WH_PROMPT + WH_STEPS
    prefill = make_prefill_step(model, pad_to=pad)
    decode = make_decode_step(model)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (WH_B, WH_PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    frames = whisper_frames(cfg, WH_B, 0, "cuda")
    run = lambda steps: timed_prefill_decode(prefill, decode, tokens, steps,
                                             {"frames": frames})
    run(2)                                      # warm-up: cuBLAS, kernels
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9     # weights and all
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = 0
    prefill_ms, step_ms, toks, logits, cache = run(WH_STEPS)
    launches = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a prefill: 4 encoder, 4 decoder self and 4 cross; a step: 4 self
    # and 4 cross
    want = (cfg.enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers * WH_STEPS)
    if launches != want:
        raise AssertionError(f"lm:whisper_prefill_decode: launches "
                             f"flash_attention={launches[0]} decode_gqa="
                             f"{launches[1]}, expected {want}")
    check_ids("lm:whisper_prefill_decode", logits, toks, cfg)
    shapes = {p: tuple(cache[p]["k"].shape) for p in ("self", "cross")}
    if shapes != {"self": (cfg.n_layers, WH_B, cfg.n_kv, pad, cfg.head_dim),
                  "cross": (cfg.n_layers, WH_B, cfg.n_kv, cfg.n_frames,
                            cfg.head_dim)}:
        raise AssertionError(f"lm:whisper_prefill_decode: cache {shapes}")
    with torch.no_grad():
        profile_window(lambda: prefill({"tokens": tokens, "frames": frames}),
                       "whisper prefill", CARD, share="flash_attention")
        pos = torch.full((WH_B,), WH_PROMPT, dtype=torch.int32,
                         device="cuda")
        tok = toks[:, :1]
        profile_window(lambda: [decode(cache, {"token": tok, "pos": pos})
                                for _ in range(4)], "whisper 4 decode steps",
                       CARD, share="decode_gqa")
    n_params = model.param_count()
    cross_bytes = 2 * cache["cross"]["k"].numel() * 2
    dec_s = sum(step_ms) / 1e3
    print(f"  lm:whisper_prefill_decode {cfg.name} params={n_params} "
          f"B={WH_B} frames={cfg.n_frames} prompt={WH_PROMPT} pad_to={pad} "
          f"steps={WH_STEPS} [{CARD}]: prefill_ms={prefill_ms:.2f} "
          f"decode_p50_ms={pct(step_ms, 50):.3f} "
          f"decode_p99_ms={pct(step_ms, 99):.3f} "
          f"decode_tokens_per_s={WH_B * WH_STEPS / dec_s:.1f} "
          f"peak_mem_gb={peak_gb:.3f} (held before the run {held_gb:.3f}) "
          f"launches flash_attention={launches[0]} "
          f"decode_gqa={launches[1]} cross_cache_mb={cross_bytes / 1e6:.1f} "
          f"step_read_bound_ms={(n_params * 2 + cross_bytes) / PEAK_BYTES * 1e3:.4f}",
          flush=True)
    return launches


def whisper_parity_phase(model, CARD, B=2, S=16, steps=16):
    """The whole model (4 + 4 layers, it is small) on the CPU (plain
    versions) and on the card (kernels), bf16, the same frames: prefill
    of B x S tokens, then teacher-forced decode steps, within
    ``LM_TOL``."""
    from repro_torch.models import LM
    fa_ops, dec_ops = lm_counts()
    cpu = LM(model.cfg, device="cpu")
    cpu.params = to_cpu(model.params)
    frames = whisper_frames(model.cfg, B, 1, "cpu")
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = 0
    history = parity_history(model, cpu, B, S, steps, {"frames": frames})
    cfg = model.cfg
    if (fa_ops.LAUNCHES, dec_ops.LAUNCHES) != (
            cfg.enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers * steps):
        raise AssertionError(f"lm:whisper_parity: launches "
                             f"{fa_ops.LAUNCHES}, {dec_ops.LAUNCHES}")
    worst, mean_err, checked, _ = parity_check(history, LM_TOL,
                                               "lm:whisper_parity")
    parity_print("lm:whisper_parity", f"{cfg.name} whole model, B={B} "
                 f"frames={cfg.n_frames} S={S} + {steps} teacher-forced "
                 f"steps", worst, mean_err, checked, B * (steps + 1), LM_TOL,
                 CARD)


@contextlib.contextmanager
def moe_probe(pin=False):
    """Record every MoE call of the port while it lasts: its device, the
    top-k expert ids (B, S, k) in the router's order and each token's
    gap between its k-th and (k+1)-th router logits; and every
    dispatch's dropped and total assignments.  With ``pin``, the card's
    i-th MoE call takes the expert ids of the i-th CPU call (which runs
    first), gated by its own logits."""
    from repro_torch.models import moe as MOE
    rec = {"calls": [], "dropped": 0, "assigned": 0}
    route, disp = MOE.route, MOE._group_dispatch

    def probe_route(p, x, top_k):
        logits = x.float() @ p["router"]
        top = torch.topk(logits, top_k + 1, dim=-1)
        rec["calls"].append((x.device.type, top.indices[..., :top_k].cpu(),
                             (top.values[..., top_k - 1]
                              - top.values[..., top_k]).cpu()))
        idx, gates, all_logits = route(p, x, top_k)
        if pin and x.device.type == "cuda":
            n = sum(c[0] == "cuda" for c in rec["calls"]) - 1
            idx = [c for c in rec["calls"] if c[0] == "cpu"][n][1]
            idx = idx.to(x.device)
            gates = torch.softmax(torch.gather(logits, -1, idx),
                                  dim=-1).to(x.dtype)
        return idx, gates, all_logits

    def dispatch(x, eidx, n_experts, C):
        slots, slot = disp(x, eidx, n_experts, C)
        rec["dropped"] += int((slot == n_experts * C).sum())
        rec["assigned"] += slot.numel()
        return slots, slot
    MOE.route, MOE._group_dispatch = probe_route, dispatch
    try:
        yield rec
    finally:
        MOE.route, MOE._group_dispatch = route, disp


def olmoe_prefill_decode_phase(model, CARD):
    from repro_torch.models import make_decode_step, make_prefill_step
    fa_ops, dec_ops = lm_counts()
    cfg = model.cfg
    prefill = make_prefill_step(model, pad_to=LM_PAD)
    decode = make_decode_step(model)
    gen = torch.Generator(device="cuda").manual_seed(8)
    tokens = torch.randint(0, cfg.vocab, (LM_B, LM_S), generator=gen,
                           device="cuda", dtype=torch.int32)
    run = lambda steps: timed_prefill_decode(prefill, decode, tokens, steps)
    run(2)                                      # warm-up: cuBLAS, kernels
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9     # weights and all
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = 0
    prefill_ms, step_ms, toks, logits, cache = run(LM_STEPS)
    launches = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != (cfg.n_layers, cfg.n_layers * LM_STEPS):
        raise AssertionError(f"lm:olmoe_prefill_decode: launches "
                             f"flash_attention={launches[0]} decode_gqa="
                             f"{launches[1]}, expected {cfg.n_layers} and "
                             f"{cfg.n_layers * LM_STEPS}")
    check_ids("lm:olmoe_prefill_decode", logits, toks, cfg)
    if tuple(cache["k"].shape) != (cfg.n_layers, LM_B, cfg.n_kv, LM_PAD,
                                   cfg.head_dim):
        raise AssertionError(f"lm:olmoe_prefill_decode: cache "
                             f"{tuple(cache['k'].shape)}")
    with torch.no_grad(), moe_probe() as rec:
        prefill({"tokens": tokens})
    drop = rec["dropped"] / rec["assigned"]
    with torch.no_grad():
        profile_window(lambda: prefill({"tokens": tokens}), "olmoe prefill",
                       CARD, top=8, share="flash_attention")
        pos = torch.full((LM_B,), LM_S, dtype=torch.int32, device="cuda")
        tok = toks[:, :1]
        profile_window(lambda: [decode(cache, {"token": tok, "pos": pos})
                                for _ in range(4)], "olmoe 4 decode steps",
                       CARD, top=8, share="decode_gqa")
    n_params = model.param_count()
    dec_s = sum(step_ms) / 1e3
    print(f"  lm:olmoe_prefill_decode {cfg.name} params={n_params} "
          f"B={LM_B} S={LM_S} pad_to={LM_PAD} steps={LM_STEPS} [{CARD}]: "
          f"prefill_ms={prefill_ms:.2f} decode_p50_ms={pct(step_ms, 50):.3f} "
          f"decode_p99_ms={pct(step_ms, 99):.3f} "
          f"decode_tokens_per_s={LM_B * LM_STEPS / dec_s:.1f} "
          f"prefill_tokens_per_s={LM_B * LM_S / prefill_ms * 1e3:.0f} "
          f"peak_mem_gb={peak_gb:.2f} (held before the run {held_gb:.2f}) "
          f"launches flash_attention={launches[0]} "
          f"decode_gqa={launches[1]} prefill_dropped_assignments="
          f"{rec['dropped']} of {rec['assigned']} (share {drop:.4f}, "
          f"capacity factor {cfg.capacity_factor}) "
          f"step_weight_read_bound_ms={n_params * 2 / PEAK_BYTES * 1e3:.3f}",
          flush=True)
    return launches


def olmoe_batcher_phase(model, CARD):
    _, dec_ops = lm_counts()
    cfg = model.cfg
    dec_ops.LAUNCHES = 0
    done, steps, wall = serve_batcher(model, n=BATCHER_REQUESTS,
                                      n_slots=16, smax=512,
                                      prompt_len=BATCHER_PROMPT,
                                      max_new=64)
    launches = dec_ops.LAUNCHES
    n_tok = sum(len(r.tokens_out) for r in done)
    if launches != cfg.n_layers * steps:
        raise AssertionError(f"lm:olmoe_batcher: decode_gqa launched "
                             f"{launches} times in {steps} steps")
    print(f"  lm:olmoe_batcher {cfg.name} slots=16 smax=512 [{CARD}]: "
          f"requests={len(done)} tokens_out={n_tok} "
          f"batched_decode_steps={steps} (prompt feeding included) "
          f"wall_s={wall:.2f} tokens_out_per_s={n_tok / wall:.1f} "
          f"ms_per_step={wall / steps * 1e3:.3f} "
          f"decode_gqa launches={launches}", flush=True)


def route_flips(rec, n_layers, starts):
    """Pair the CPU's and the card's MoE calls of one run (each model
    call runs its n_layers in turn; call g's tokens sit at positions
    starts[g], starts[g] + 1, ...) and sort the tokens whose expert set
    differs into primary flips and flips downstream of another.  A
    token's router input at layer l depends on the routes of its own
    and earlier positions at layers below l (attention, and the
    capacity, which an expert hands out in position order), so a flip
    at (l, t) with one at (l' < l, t' <= t) in its row may be caused by
    it; a primary flip has none and must be a near-tie.  Returns
    (primary CPU margins, number downstream, (B,) earliest flipped
    position of each row, or a large number)."""
    cpu = [c for c in rec["calls"] if c[0] == "cpu"]
    gpu = [c for c in rec["calls"] if c[0] == "cuda"]
    if len(cpu) != len(gpu) or len(cpu) != n_layers * len(starts):
        raise AssertionError(f"lm:olmoe_parity: {len(cpu)} CPU and "
                             f"{len(gpu)} card MoE calls for "
                             f"{len(starts)} model calls")
    B = cpu[0][1].shape[0]
    none = 1 << 30
    first = torch.full((n_layers, B), none, dtype=torch.long)
    primary, downstream = [], 0
    for i, (c, g) in enumerate(zip(cpu, gpu)):
        layer, start = i % n_layers, starts[i // n_layers]
        flip = (c[1].sort(-1).values != g[1].sort(-1).values).any(-1)
        reach = first[:layer].amin(0) if layer else torch.full((B,), none)
        for b, t in flip.nonzero().tolist():
            if reach[b] <= start + t:
                downstream += 1
            else:
                primary.append(c[2][b, t].item())
            first[layer, b] = min(first[layer, b].item(), start + t)
    return primary, downstream, first.amin(0)


def olmoe_parity_phase(model_full, CARD, B=2, S=256, steps=16):
    """2 layers of the full-width weights, CPU against card: a forward
    pass over B x S tokens, then parity_history's prefill and
    teacher-forced steps.  float32 first (the bf16 weights cast up):
    routes equal at every layer and token, logits within
    ``OLMOE_F32_TOL``.  Then bf16: a token whose k-th and (k+1)-th
    router logits are within ``ROUTE_MARGIN`` may pick another expert
    on one side, and through attention and the capacity competition
    that moves every later token of its row.  Every primary flip must
    be such a CPU near-tie; the logits of every token with no flip at
    or before its position in its row are held to ``LM_TOL``.  Last,
    the same bf16 runs with the card's routes pinned to the CPU's
    (``moe_probe(pin=True)``): every logit within ``LM_TOL``."""
    fa_ops, dec_ops = lm_counts()
    L_ = 2
    # parity_history's prompts
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, model_full.cfg.vocab, (B, S + steps)).astype(np.int32))[:, :S]
    # float32: every leaf cast up; bf16: the weights as drawn (the
    # router float32)
    for f32, tol in ((True, OLMOE_F32_TOL), (False, LM_TOL)):
        label = f"lm:olmoe_parity[{'float32' if f32 else 'bfloat16'}]"
        gpu, cpu = cut_models(model_full, L_,
                              torch.float32 if f32 else None)
        with torch.no_grad(), moe_probe() as rec:
            fwd = [m.forward({"tokens": tokens}).float().cpu()
                   for m in (cpu, gpu)]
        primary, downstream, first = route_flips(rec, L_, [0])
        n_fwd = len(primary)
        keep = torch.arange(S)[None, :] < first[:, None]     # (B, S)
        entries = [("forward", fwd[0][keep], fwd[1][keep])]
        fa_ops.LAUNCHES = dec_ops.LAUNCHES = 0
        with moe_probe() as rec:
            history = parity_history(gpu, cpu, B, S, steps)
        if (fa_ops.LAUNCHES, dec_ops.LAUNCHES) != (L_, L_ * steps):
            raise AssertionError(f"{label}: launches {fa_ops.LAUNCHES}, "
                                 f"{dec_ops.LAUNCHES}")
        p2, d2, first2 = route_flips(rec, L_, [0] + list(range(S, S + steps)))
        primary += p2
        downstream += d2
        # history entry i's logits sit at position S - 1 + i
        exempt = [first2 <= S - 1 + i for i in range(len(history))]
        if f32 and (primary or downstream):
            raise AssertionError(f"{label}: {len(primary) + downstream} "
                                 f"tokens routed differently in float32 "
                                 f"(CPU margins {primary})")
        if primary and max(primary) >= ROUTE_MARGIN:
            raise AssertionError(f"{label}: a primary route flip at a CPU "
                                 f"margin of {max(primary):.4f}, above "
                                 f"{ROUTE_MARGIN}")
        worst, mean_err, checked, rows = parity_check(
            entries + history, tol, label,
            [torch.zeros(int(keep.sum()), dtype=torch.bool)] + exempt)
        n_tok = B * (2 * S + steps) * L_       # forward, then the history
        parity_print(label, f"{gpu.cfg.name} cut to {L_} layers, B={B} "
                     f"S={S} forward + prefill + {steps} teacher-forced "
                     f"steps; route flips: {len(primary)} primary ({n_fwd} "
                     f"in the forward, the rest in the prefill of the same "
                     f"prompt and the steps; CPU margins "
                     f"{[round(m, 5) for m in primary]}, accepted under "
                     f"{ROUTE_MARGIN}) and {downstream} downstream "
                     f"of {n_tok} token-layers; forward tokens compared="
                     f"{int(keep.sum())} of {B * S}, prefill/decode rows "
                     f"compared={rows - int(keep.sum())} of "
                     f"{B * len(history)}", worst, mean_err, checked,
                     int(keep.sum()) + B * (steps + 1), tol, CARD)
        if not keep.any():
            raise AssertionError(f"{label}: no token left to compare")
        if not f32:
            with torch.no_grad(), moe_probe(pin=True):
                fwd = [m.forward({"tokens": tokens}).float().cpu()
                       for m in (cpu, gpu)]
                history = parity_history(gpu, cpu, B, S, steps)
            label += " routes pinned"
            worst, mean_err, checked, _ = parity_check(
                [("forward", fwd[0].flatten(0, 1), fwd[1].flatten(0, 1))]
                + history, tol, label)
            parity_print(label, f"the same runs with the card's expert ids "
                         f"the CPU's, every token compared", worst, mean_err,
                         checked, B * (S + steps + 1), tol, CARD)
        del gpu, cpu
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Jamba (hybrid) and InternVL2 (VLM)
# ---------------------------------------------------------------------------
# the jamba sublayer parity in float32: OLMOE_F32_TOL, the flash and
# decode kernels' float32 bounds and ssd_chunk's 3xTF32 (1e-4 of a
# block's RMS) through one sublayer, float32 sums in another order
SUBLAYER_F32_TOL = OLMOE_F32_TOL
# the jamba super-block in bf16, routes pinned: MAMBA_TOL, set for two
# Mamba-2 layers, over eight sublayers (seven Mamba-2): its bounds
# grown as sqrt(8 / 2) = 2, rounding differences adding as a random walk
JAMBA_TOL = dict(atol=0.3, rtol=0.04, mean=0.04)


def host_free_gb() -> float:
    """The host's available memory (``MemAvailable``), GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise AssertionError("no MemAvailable in /proc/meminfo")


def layer_kinds(cfg) -> list[tuple[str, str]]:
    """(mixer, ffn) of every layer of the stack, in order."""
    from repro_torch.models import transformer as T
    if cfg.family == "hybrid":
        return T.sb_layout(cfg) * (cfg.n_layers // cfg.attn_every)
    return [T._kinds(cfg)] * cfg.n_layers


def prefill_bound(model, B, S) -> tuple[float, str, float]:
    """Least time of a prefill of B x S positions (the VLM's patches
    included): its bf16 matrix products (projections, MLPs, every
    expert's capacity slots as the reference runs them, causal
    attention, the patch projector, the last position's head) over the
    bf16 peak plus each Mamba-2 layer's SSD intra-chunk bound
    (``ssd_bound_ms``); or one read of the weights; whichever is larger.
    Returns (ms, bound by, bf16 TFLOP)."""
    from repro_torch.models import moe as MOE
    cfg = model.cfg
    d, D, T_ = cfg.d_model, cfg.head_dim, B * S
    d_inner, H = cfg.ssm_expand * d, cfg.n_ssm_heads
    mixer = {"attn": 2 * T_ * d * D * (2 * cfg.n_heads + 2 * cfg.n_kv)
             + 4 * B * cfg.n_heads * D * S * (S + 1) / 2,
             "ssm": 2 * T_ * d * (3 * d_inner + 2 * cfg.ssm_state + H)}
    ffn = {"mlp": 2 * T_ * 3 * d * cfg.d_ff, "": 0}
    if cfg.is_moe:
        C = MOE.capacity(S, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        ffn["moe"] = (2 * B * cfg.n_experts * C * 3 * d * cfg.d_ff
                      + 2 * T_ * d * cfg.n_experts)
    kinds = layer_kinds(cfg)
    flops = sum(mixer[m] + ffn[f] for m, f in kinds)
    flops += 2 * B * d * cfg.vocab_padded
    if cfg.family == "vlm":
        flops += 2 * B * cfg.n_patches * cfg.vit_dim * d
    chunk = cfg.ssd_chunk
    ssd_ms = sum(m == "ssm" for m, _ in kinds) * (ssd_bound_ms(
        B * -(-S // chunk), chunk, cfg.ssm_state, H, cfg.ssm_headdim)[0]
        if H else 0.0)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3 + ssd_ms
    t_bytes = model.param_count() * 2 / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops / 1e12


def train_bound(model, B, S) -> tuple[float, str, float]:
    """Least time of one train step of B x S tokens (dense, MoE, SSM,
    VLM stacks): 6 x the matrix products of a forward of the stack and
    the head (forward 2, backward 4 per multiply-add pair), one more
    forward of the stack for remat, the causal attention products twice
    forward (the kernel and its recompute) and once backward over the
    causal triangle (scores recomputed, dP, dV, dQ, dK: 10 B H D S(S+1)/2;
    the plain backward's work on the full S x S above that is its own
    waste, not the function's), all over the bf16 peak; or each
    parameter, gradient and moment read and written once; whichever is
    larger.  Returns (ms, bound by, TFLOP)."""
    from repro_torch.models import moe as MOE
    cfg = model.cfg
    d, D, T_ = cfg.d_model, cfg.head_dim, B * S
    d_inner, H = cfg.ssm_expand * d, cfg.n_ssm_heads
    proj = {"attn": 2 * T_ * d * D * (2 * cfg.n_heads + 2 * cfg.n_kv),
            "ssm": 2 * T_ * d * (3 * d_inner + 2 * cfg.ssm_state + H)}
    ffn = {"mlp": 2 * T_ * 3 * d * cfg.d_ff, "": 0}
    if cfg.is_moe:
        C = MOE.capacity(S, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        ffn["moe"] = (2 * B * cfg.n_experts * C * 3 * d * cfg.d_ff
                      + 2 * T_ * d * cfg.n_experts)
    kinds = layer_kinds(cfg)
    stack = sum(proj[m] + ffn[f] for m, f in kinds)
    head = 2 * T_ * d * cfg.vocab_padded
    n_attn = sum(m == "attn" for m, _ in kinds)
    attn = n_attn * (2 * 4 + 10) * B * cfg.n_heads * D * S * (S + 1) / 2
    flops = 3 * (stack + head) + stack + attn
    n = model.param_count()
    moment = 4 if cfg.moment_dtype == "float32" else 2
    nbytes = n * 2 * (2 * 2 + 2 * moment)       # p, g, m, v: read + write
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops / 1e12


def jamba_prefill_decode_phase(model, CARD):
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.models import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T
    fa_ops, dec_ops = lm_counts()
    cfg = model.cfg
    nsb = cfg.n_layers // cfg.attn_every
    kinds = layer_kinds(cfg)
    n_attn = sum(m == "attn" for m, _ in kinds)
    n_ssm = len(kinds) - n_attn
    pad = JB_S + JB_STEPS
    prefill = make_prefill_step(model, pad_to=pad)
    decode = make_decode_step(model)
    gen = torch.Generator(device="cuda").manual_seed(9)
    tokens = torch.randint(0, cfg.vocab, (JB_B, JB_S), generator=gen,
                           device="cuda", dtype=torch.int32)
    run = lambda steps: timed_prefill_decode(prefill, decode, tokens, steps)
    run(2)                                      # warm-up: cuBLAS, kernels
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9     # weights and all
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
    prefill_ms, step_ms, toks, logits, cache = run(JB_STEPS)
    launches = (fa_ops.LAUNCHES, dec_ops.LAUNCHES, ssd_ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a prefill: one flash per attention sublayer, one ssd_chunk per
    # Mamba-2 sublayer; a step: one decode_gqa per attention sublayer
    want = (n_attn, n_attn * JB_STEPS, n_ssm)
    if launches != want:
        raise AssertionError(f"lm:jamba_prefill_decode: launches "
                             f"flash_attention, decode_gqa, ssd_chunk = "
                             f"{launches}, expected {want}")
    check_ids("lm:jamba_prefill_decode", logits, toks, cfg)
    H, N, P = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    conv_dim = cfg.ssm_expand * cfg.d_model + 2 * N
    want_shapes = {}
    for i, (mixer, _) in enumerate(T.sb_layout(cfg)):
        want_shapes[f"l{i}"] = (
            {"k": (nsb, JB_B, cfg.n_kv, pad, cfg.head_dim),
             "v": (nsb, JB_B, cfg.n_kv, pad, cfg.head_dim)}
            if mixer == "attn" else
            {"ssm": (nsb, JB_B, H, N, P),
             "conv": (nsb, JB_B, cfg.ssm_conv - 1, conv_dim)})
    shapes = {k: {n: tuple(x.shape) for n, x in c.items()}
              for k, c in cache.items()}
    if shapes != want_shapes or not all(
            torch.isfinite(c["ssm"]).all() and c["ssm"].dtype ==
            torch.float32 for c in cache.values() if "ssm" in c):
        raise AssertionError(f"lm:jamba_prefill_decode: cache {shapes}")
    with torch.no_grad(), moe_probe() as rec:
        prefill({"tokens": tokens})
    drop = rec["dropped"] / rec["assigned"]
    with torch.no_grad():
        profile_window(lambda: prefill({"tokens": tokens}), "jamba prefill",
                       CARD, top=8, share="ssd_chunk")
        pos = torch.full((JB_B,), JB_S, dtype=torch.int32, device="cuda")
        tok = toks[:, :1]
        profile_window(lambda: [decode(cache, {"token": tok, "pos": pos})
                                for _ in range(4)], "jamba 4 decode steps",
                       CARD, top=8, share="decode_gqa")
    n_params = model.param_count()
    bound_ms, bound_by, tflop = prefill_bound(model, JB_B, JB_S)
    dec_s = sum(step_ms) / 1e3
    print(f"  lm:jamba_prefill_decode {cfg.name} cut to {cfg.n_layers} of "
          f"32 layers ({nsb} super-block) params={n_params} B={JB_B} "
          f"S={JB_S} pad_to={pad} steps={JB_STEPS} [{CARD}]: "
          f"prefill_ms={prefill_ms:.2f} (bound {bound_ms:.2f}, {bound_by}: "
          f"{tflop:.1f} TFLOP of bf16 products) "
          f"decode_p50_ms={pct(step_ms, 50):.3f} "
          f"decode_p99_ms={pct(step_ms, 99):.3f} "
          f"decode_tokens_per_s={JB_B * JB_STEPS / dec_s:.1f} "
          f"prefill_tokens_per_s={JB_B * JB_S / prefill_ms * 1e3:.0f} "
          f"peak_mem_gb={peak_gb:.2f} (held before the run {held_gb:.2f}) "
          f"launches flash_attention={launches[0]} decode_gqa={launches[1]} "
          f"ssd_chunk={launches[2]} prefill_dropped_assignments="
          f"{rec['dropped']} of {rec['assigned']} (share {drop:.4f}) "
          f"step_weight_read_bound_ms={n_params * 2 / PEAK_BYTES * 1e3:.3f}",
          flush=True)
    return launches


def jamba_batcher_phase(model, CARD):
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    _, dec_ops = lm_counts()
    cfg = model.cfg
    n_attn = sum(m == "attn" for m, _ in layer_kinds(cfg))
    dec_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
    done, steps, wall = serve_batcher(model, n=16, n_slots=8, smax=128,
                                      prompt_len=16, max_new=16)
    n_tok = sum(len(r.tokens_out) for r in done)
    if (dec_ops.LAUNCHES, ssd_ops.LAUNCHES) != (n_attn * steps, 0):
        raise AssertionError(f"lm:jamba_batcher: decode_gqa, ssd_chunk "
                             f"launched {dec_ops.LAUNCHES}, "
                             f"{ssd_ops.LAUNCHES} times in {steps} steps")
    print(f"  lm:jamba_batcher {cfg.name} slots=8 smax=128 [{CARD}]: "
          f"requests={len(done)} tokens_out={n_tok} "
          f"batched_decode_steps={steps} (prompt feeding included) "
          f"wall_s={wall:.2f} tokens_out_per_s={n_tok / wall:.1f} "
          f"ms_per_step={wall / steps * 1e3:.3f} "
          f"decode_gqa launches={dec_ops.LAUNCHES}", flush=True)


def hold(label, what, cpu, gpu, tol) -> float:
    """``gpu`` (brought to the CPU) within ``tol`` of ``cpu``; returns
    the largest difference."""
    c, g = cpu.float(), gpu.float().cpu()
    diff = (c - g).abs()
    if c.shape != g.shape or not torch.allclose(
            g, c, atol=tol["atol"], rtol=tol["rtol"]) or \
            diff.mean().item() > tol["mean"]:
        raise AssertionError(f"{label}: {what} differs by "
                             f"{diff.max().item():.3e} (mean "
                             f"{diff.mean().item():.3e})")
    return diff.max().item()


def snapshot(tree):
    """A copy on the CPU, which later in-place writes do not reach."""
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    return tree.to("cpu", copy=True)


def sublayer_inputs(model, tokens, S, steps):
    """The card's bf16 prefill of tokens[:, :S] and ``steps``
    teacher-forced decode steps, recording every sublayer's input:
    (prefill inputs by sublayer, [step][sublayer] decode inputs)."""
    from repro_torch.models import transformer as T
    seen = {"fwd": [], "dec": []}
    fwd, dec = T._layer_fwd, T._layer_decode

    def rec_fwd(p, x, *a, **k):
        seen["fwd"].append(x.clone())
        return fwd(p, x, *a, **k)

    def rec_dec(p, x, *a, **k):
        seen["dec"].append(x.clone())
        return dec(p, x, *a, **k)
    B = tokens.shape[0]
    T._layer_fwd, T._layer_decode = rec_fwd, rec_dec
    try:
        with torch.no_grad():
            _, cache = model.prefill({"tokens": tokens[:, :S]},
                                     pad_to=S + steps)
            for i in range(steps):
                model.decode_step(cache, {
                    "token": tokens[:, S + i:S + i + 1],
                    "pos": torch.full((B,), S + i, dtype=torch.int32)})
    finally:
        T._layer_fwd, T._layer_decode = fwd, dec
    n = len(seen["fwd"])
    return seen["fwd"], [seen["dec"][j * n:(j + 1) * n]
                         for j in range(steps)]


def jamba_parity_phase(model, CARD, B=1, S=128, steps=4):
    """The full-width super-block, CPU (plain versions) against the card
    (kernels), held in two ways, as a float32 copy of the whole
    super-block (~51 GB) would not fit the host beside the rest:
    sublayer by sublayer in float32, the first sublayer of each (mixer,
    ffn) kind (the later ones repeat its code with other weights, and
    each MoE sublayer costs ~8 s on the host), each fed the card's bf16
    input to it, its weights cast up and copied to the CPU one sublayer
    at a time (at most a MoE sublayer's ~11 GB) and freed after it, its
    output and the cache it writes (after the prefill of B x S and after
    each of ``steps`` decode steps) within ``SUBLAYER_F32_TOL``, with the MoE
    routes pinned to the CPU's and every flip a near-tie; then the
    whole super-block in bf16 (a ~27 GB copy) with the routes pinned,
    its logits within ``JAMBA_TOL``.  Fails, without running, on a host
    with too little memory free."""
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.models import LM
    from repro_torch.models import transformer as T
    fa_ops, dec_ops = lm_counts()
    cfg = model.cfg
    label = "lm:jamba_parity"
    need_gb = 1.5 * model.param_count() * 2 / 1e9
    free_gb = host_free_gb()
    print(f"  {label}: host memory available {free_gb:.1f} GB, the "
          f"super-block's bf16 copy needs {need_gb / 1.5:.1f} GB (asked "
          f"{need_gb:.1f})", flush=True)
    if free_gb < need_gb:
        raise AssertionError(f"{label}: the host has {free_gb:.1f} GB free, "
                             f"the parity needs {need_gb:.1f} GB")
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, S + steps)).astype(np.int32))
    x_fwd, x_dec = sublayer_inputs(model, tokens, S, steps)
    layout = T.sb_layout(cfg)
    if len(x_fwd) != len(layout) * cfg.n_layers // cfg.attn_every:
        raise AssertionError(f"{label}: {len(x_fwd)} sublayer inputs")
    firsts = {}
    for i, kind in enumerate(layout):
        firsts.setdefault(kind, i)
    for i in sorted(firsts.values()):
        mixer, ffn = layout[i]
        t0 = time.perf_counter()
        p_gpu = cast(T.layer_params(model.params["stack"][f"l{i}"], 0),
                     torch.float32)
        p_cpu = to_cpu(p_gpu)
        sides = {}
        with torch.no_grad(), moe_probe(pin=True) as rec:
            for side, p in (("cpu", p_cpu), ("cuda", p_gpu)):  # CPU first
                x = x_fwd[i].to(side, torch.float32)
                y, c, _ = T._layer_fwd(p, x, cfg, mixer, ffn)
                if mixer == "attn":
                    c = {k: torch.nn.functional.pad(v, (0, 0, 0, steps))
                         for k, v in c.items()}
                outs, caches = [y.cpu()], [snapshot(c)]
                for j in range(steps):
                    pos = torch.full((B,), S + j, dtype=torch.int32,
                                     device=side)
                    y, c = T._layer_decode(p, x_dec[j][i].to(side,
                                                            torch.float32),
                                           c, pos, cfg, mixer, ffn)
                    outs.append(y.cpu())
                caches.append(snapshot(c))
                sides[side] = (outs, caches)
        primary = []
        if ffn == "moe":
            primary, downstream, _ = route_flips(
                rec, 1, [0] + list(range(S, S + steps)))
            if primary and max(primary) >= ROUTE_MARGIN:
                raise AssertionError(f"{label}: l{i} flipped a route at a "
                                     f"CPU margin of {max(primary):.4f}")
        worst = max(hold(label, f"l{i} output {n}", c, g, SUBLAYER_F32_TOL)
                    for n, (c, g) in enumerate(zip(*(sides[k][0]
                                                     for k in sides))))
        cworst = max(hold(label, f"l{i} cache {k} ({when})", c[k], g[k],
                          SUBLAYER_F32_TOL)
                     for when, c, g in zip(("prefill", "last step"),
                                           *(sides[k][1] for k in sides))
                     for k in c)
        print(f"  {label} l{i} ({mixer}, {ffn}) in float32, CPU vs "
              f"[{CARD}]: max_abs_err output={worst:.3e} cache="
              f"{cworst:.3e} (atol {SUBLAYER_F32_TOL['atol']}, rtol "
              f"{SUBLAYER_F32_TOL['rtol']}, mean "
              f"{SUBLAYER_F32_TOL['mean']}) route flips pinned: "
              f"{len(primary)} (CPU margins "
              f"{[round(m, 6) for m in primary]}) host free "
              f"{host_free_gb():.1f} GB in {time.perf_counter() - t0:.1f}s",
              flush=True)
        del p_gpu, p_cpu, sides
        gc.collect()
        torch.cuda.empty_cache()
    # the whole super-block in bf16, the card's routes the CPU's
    cpu = LM(cfg, device="cpu")
    cpu.params = to_cpu(model.params)
    n_moe = sum(f == "moe" for _, f in layer_kinds(cfg))
    n_attn = sum(m == "attn" for m, _ in layer_kinds(cfg))
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
    with moe_probe(pin=True) as rec:
        history = parity_history(model, cpu, B, S, steps)
    launches = (fa_ops.LAUNCHES, dec_ops.LAUNCHES, ssd_ops.LAUNCHES)
    if launches != (n_attn, n_attn * steps, len(layer_kinds(cfg)) - n_attn):
        raise AssertionError(f"{label}: launches {launches}")
    primary, downstream, _ = route_flips(rec, n_moe,
                                         [0] + list(range(S, S + steps)))
    worst, mean_err, checked, _ = parity_check(history, JAMBA_TOL, label)
    parity_print(f"{label} routes pinned", f"{cfg.name} super-block in "
                 f"bf16, B={B} S={S} + {steps} teacher-forced steps; the "
                 f"card's own routes would have flipped {len(primary)} "
                 f"primary (CPU margins {[round(m, 5) for m in primary]}) "
                 f"and {downstream} downstream of "
                 f"{B * (S + steps) * n_moe} token-layers; host free "
                 f"{host_free_gb():.1f} GB", worst, mean_err, checked,
                 B * (steps + 1), JAMBA_TOL, CARD)
    if primary and max(primary) >= ROUTE_MARGIN:
        raise AssertionError(f"{label}: a primary route flip at a CPU "
                             f"margin of {max(primary):.4f}")
    del cpu, history
    gc.collect()


def vlm_patches(cfg, B, seed, device):
    """Stub patch embeddings: N(0, 1), as the JAX smoke tests draw them
    (tests/test_models_smoke.py)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((B, cfg.n_patches, cfg.vit_dim), generator=gen,
                       device=device)


def vlm_prefill_decode_phase(model, CARD):
    from repro_torch.models import make_decode_step, make_prefill_step
    fa_ops, dec_ops = lm_counts()
    cfg = model.cfg
    S = cfg.n_patches + VL_TXT
    pad = S + VL_STEPS
    prefill = make_prefill_step(model, pad_to=pad)
    decode = make_decode_step(model)
    gen = torch.Generator(device="cuda").manual_seed(10)
    tokens = torch.randint(0, cfg.vocab, (VL_B, VL_TXT), generator=gen,
                           device="cuda", dtype=torch.int32)
    patches = vlm_patches(cfg, VL_B, 0, "cuda")
    run = lambda steps: timed_prefill_decode(
        prefill, decode, tokens, steps, {"patches": patches},
        prefix=cfg.n_patches)
    run(2)                                      # warm-up: cuBLAS, kernels
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9     # weights and all
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = 0
    prefill_ms, step_ms, toks, logits, cache = run(VL_STEPS)
    launches = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != (cfg.n_layers, cfg.n_layers * VL_STEPS):
        raise AssertionError(f"lm:vlm_prefill_decode: launches "
                             f"flash_attention={launches[0]} decode_gqa="
                             f"{launches[1]}, expected {cfg.n_layers} and "
                             f"{cfg.n_layers * VL_STEPS}")
    check_ids("lm:vlm_prefill_decode", logits, toks, cfg)
    if tuple(cache["k"].shape) != (cfg.n_layers, VL_B, cfg.n_kv, pad,
                                   cfg.head_dim):
        raise AssertionError(f"lm:vlm_prefill_decode: cache "
                             f"{tuple(cache['k'].shape)}")
    with torch.no_grad():
        profile_window(lambda: prefill({"tokens": tokens,
                                        "patches": patches}),
                       "internvl2 prefill", CARD, share="flash_attention")
        pos = torch.full((VL_B,), S, dtype=torch.int32, device="cuda")
        tok = toks[:, :1]
        profile_window(lambda: [decode(cache, {"token": tok, "pos": pos})
                                for _ in range(4)],
                       "internvl2 4 decode steps", CARD, share="decode_gqa")
    n_params = model.param_count()
    bound_ms, bound_by, tflop = prefill_bound(model, VL_B, S)
    kv_bytes = 2 * cfg.n_layers * VL_B * cfg.n_kv * cfg.head_dim * 2 * (
        S + VL_STEPS // 2)
    dec_s = sum(step_ms) / 1e3
    print(f"  lm:vlm_prefill_decode {cfg.name} cut to {cfg.n_layers} of 80 "
          f"layers params={n_params} B={VL_B} patches={cfg.n_patches} "
          f"text={VL_TXT} pad_to={pad} steps={VL_STEPS} [{CARD}]: "
          f"prefill_ms={prefill_ms:.2f} (bound {bound_ms:.2f}, {bound_by}: "
          f"{tflop:.1f} TFLOP of bf16 products) "
          f"decode_p50_ms={pct(step_ms, 50):.3f} "
          f"decode_p99_ms={pct(step_ms, 99):.3f} "
          f"decode_tokens_per_s={VL_B * VL_STEPS / dec_s:.1f} "
          f"prefill_tokens_per_s={VL_B * S / prefill_ms * 1e3:.0f} "
          f"peak_mem_gb={peak_gb:.2f} (held before the run {held_gb:.2f}) "
          f"launches flash_attention={launches[0]} "
          f"decode_gqa={launches[1]} "
          f"step_weight_read_bound_ms={n_params * 2 / PEAK_BYTES * 1e3:.3f} "
          f"(+kv {kv_bytes / PEAK_BYTES * 1e3:.3f})", flush=True)
    return launches


def vlm_batcher_phase(model, CARD):
    """Text-only requests, as the reference's batcher passes no
    patches."""
    _, dec_ops = lm_counts()
    cfg = model.cfg
    dec_ops.LAUNCHES = 0
    done, steps, wall = serve_batcher(model, n=16, n_slots=16, smax=512,
                                      prompt_len=32, max_new=32)
    launches = dec_ops.LAUNCHES
    n_tok = sum(len(r.tokens_out) for r in done)
    if launches != cfg.n_layers * steps:
        raise AssertionError(f"lm:vlm_batcher: decode_gqa launched "
                             f"{launches} times in {steps} steps")
    print(f"  lm:vlm_batcher {cfg.name} (text only) slots=16 smax=512 "
          f"[{CARD}]: requests={len(done)} tokens_out={n_tok} "
          f"batched_decode_steps={steps} (prompt feeding included) "
          f"wall_s={wall:.2f} tokens_out_per_s={n_tok / wall:.1f} "
          f"ms_per_step={wall / steps * 1e3:.3f} "
          f"decode_gqa launches={launches}", flush=True)


def vlm_parity_phase(model_full, CARD, B=2, S=64, steps=8):
    """The internvl2 weights cut to 2 layers, CPU (plain versions)
    against the card (kernels), as phase 10, with the stub patches
    before the text: prefill of B x (n_patches + S), then ``steps``
    teacher-forced steps from position n_patches + S, within
    ``LM_TOL``."""
    fa_ops, dec_ops = lm_counts()
    gpu, cpu = cut_models(model_full)
    cfg = cpu.cfg
    patches = vlm_patches(cfg, B, 1, "cpu")
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = 0
    history = parity_history(gpu, cpu, B, S, steps, {"patches": patches},
                             prefix=cfg.n_patches)
    if (fa_ops.LAUNCHES, dec_ops.LAUNCHES) != (2, 2 * steps):
        raise AssertionError(f"lm:vlm_parity: launches {fa_ops.LAUNCHES}, "
                             f"{dec_ops.LAUNCHES}")
    worst, mean_err, checked, _ = parity_check(history, LM_TOL,
                                               "lm:vlm_parity")
    parity_print("lm:vlm_parity", f"{cfg.name} cut to {cfg.n_layers} "
                 f"layers, B={B} patches={cfg.n_patches} S={S} + {steps} "
                 f"teacher-forced steps", worst, mean_err, checked,
                 B * (steps + 1), LM_TOL, CARD)
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# RELMAS training
# ---------------------------------------------------------------------------
def graph_ms(fn, calls: int = 50) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in one CUDA
    graph, the graph replayed, the mean taken.  Host dispatch drops
    out, so kernels of a few microseconds are timed and not the Python
    that launches them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps=10) / calls


def cell_inputs(B, F, H, dtype, gen):
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    args = [rnd(B, F), rnd(B, H), rnd(B, H), rnd(F, 4 * H) * 0.1,
            rnd(H, 4 * H) * 0.1, rnd(4 * H) * 0.1]
    return [a.to(dtype).contiguous() for a in args]


def cell_bound_ms(B, F, H, esz) -> tuple[float, str]:
    """Least time for one step: its multiply-adds (2 B (F+H) 4H) over the
    float32 peak, or its bytes (x, h, c and the weights read once, h2
    and c2 written once) over the memory rate, whichever is larger."""
    flops = 2.0 * B * (F + H) * 4 * H
    nbytes = esz * (B * F + 2 * B * H + (F + H) * 4 * H + 4 * H + 2 * B * H)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                      else "bytes")


def check_cell(ops, ref, CARD):
    gen = torch.Generator(device="cuda").manual_seed(11)
    max_err = 0.0
    with torch.no_grad():
        for (B, F, H) in CELL_SHAPES:
            for dt, tol in CELL_TOL.items():
                args = cell_inputs(B, F, H, dt, gen)
                got = ops.lstm_cell(*args)
                want = ref.lstm_cell_ref(*args)
                torch.cuda.synchronize()
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got, want))
                ok = all(torch.allclose(g.float(), w.float(), atol=tol,
                                        rtol=tol) for g, w in zip(got, want))
                print(f"  lstm_cell B={B} F={F} H={H} {str(dt)[6:]} "
                      f"max_abs_err={err:.3e} (tol {tol}) ok={ok}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"lstm_cell disagrees with its "
                                         f"plain version at {(B, F, H)} "
                                         f"{dt}")
                if dt == torch.float32:
                    max_err = max(max_err, err)
    # the Function's backward (plain, recomputed gates) after the kernel
    # forward, against autograd through the plain version
    B, F, H = 32, 23, 256
    arrs = cell_inputs(B, F, H, torch.float32, gen)
    wts = [torch.randn((B, H), generator=gen, device="cuda")
           for _ in range(2)]
    grads = []
    for fn in (ops.lstm_cell, ref.lstm_cell_ref):
        args = [a.clone().requires_grad_() for a in arrs]
        h2, c2 = fn(*args)
        ((h2 * wts[0]).sum() + (c2 * wts[1]).sum()).backward()
        grads.append([a.grad for a in args])
    gerr = max((g - w).abs().max().item() for g, w in zip(*grads))
    gok = all(torch.allclose(g, w, atol=1e-5, rtol=1e-5)
              for g, w in zip(*grads))
    print(f"  lstm_cell gradient B={B} F={F} H={H} float32: max_abs_err="
          f"{gerr:.3e} (tol 1e-5) ok={gok}", flush=True)
    if not gok:
        raise AssertionError("lstm_cell's gradient disagrees with autograd "
                             "of its plain version")
    main = None
    with torch.no_grad():
        for (B, F, H) in CELL_SHAPES[:3] + GEN_CELL_SHAPES:
            args = cell_inputs(B, F, H, torch.float32, gen)
            x, h, c, wx, wh, b = args
            w_ih, w_hh = wx.t().contiguous(), wh.t().contiguous()
            b0 = torch.zeros_like(b)
            lib = lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b0)
            lib_err = max((g - w).abs().max().item() for g, w in
                          zip(lib(), ref.lstm_cell_ref(*args)))
            # eager: back-to-back calls from Python, what the step loop
            # pays per call; graph: the device's time for the same work
            eager = [cuda_ms(f, reps=200) for f in (
                lambda: ops.lstm_cell(*args),
                lambda: ref.lstm_cell_ref(*args), lib)]
            ms, plain_ms, library_ms = (graph_ms(f) for f in (
                lambda: ops.lstm_cell(*args),
                lambda: ref.lstm_cell_ref(*args), lib))
            bound_ms, bound_by = cell_bound_ms(B, F, H, 4)
            print(f"  lstm_cell B={B} F={F} H={H} float32 [{CARD}]: "
                  f"device (CUDA graph) kernel_ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                  f"(torch.lstm_cell, max_abs_err vs plain {lib_err:.2e}); "
                  f"eager back-to-back kernel_ms={eager[0]:.5f} "
                  f"plain_ms={eager[1]:.5f} library_ms={eager[2]:.5f}; "
                  f"bound_ms={bound_ms:.5f} ({bound_by})", flush=True)
            if main is None:            # the rollout step: most launches
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms)
    return dict(max_abs_err=max_err, **main)


def rl_expected_launches(rounds, eval_runs, updates, periods=60):
    """lstm_cell launches the training phase implies: T per rollout or
    eval period (the actor's step recurrence), 5 T per DDPG update
    (target actor, target critic, critic, actor, critic on the actor's
    actions)."""
    return RL_T * (periods * (rounds + eval_runs) + 5 * updates)


def rl_train_phase(CARD):
    import io
    import shutil

    from repro_torch.core import ddpg, rollout
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    from repro_torch.launch import rl_train
    out = os.path.join(ROOT, "runs", "chip_smoke_rl_train")
    shutil.rmtree(out, ignore_errors=True)
    # the baselines are scored once, by the resumed run
    args = RL_ARGS + ["--outdir", out]
    base = ["--eval-baselines", "fcfs,prema,herald"]
    spans = Spans([(rl_train, "train_rounds_host", "round"),
                   (rollout, "collect_episodes", "rollout"),
                   (ddpg, "ddpg_update", "update")])
    torch.cuda.reset_peak_memory_stats()
    cell_ops.LAUNCHES = 0
    with spans:
        try:
            rl_train.main(args + ["--fail-at", str(RL_FAIL_AT)])
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
            print(f"  train:rl_train crashed as injected: {e}", flush=True)
        else:
            raise AssertionError("--fail-at did not crash the driver")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            res = rl_train.main(args + base)
    launches = cell_ops.LAUNCHES
    print(log.getvalue(), end="", flush=True)
    if "[resume] restored checkpoint at episode 15" not in log.getvalue():
        raise AssertionError("train:rl_train: the rerun did not resume")
    # 3 rounds rolled out (2 before the crash, 1 after), one eval at the
    # end, 8 updates in each of the two rounds past the warm-up
    want = rl_expected_launches(rounds=3, eval_runs=1, updates=16,
                                periods=RL_PERIODS)
    if launches != want:
        raise AssertionError(f"train:rl_train: lstm_cell launched "
                             f"{launches} times, expected {want}")
    hist = res["history"]
    last = hist[-1]
    if [h["episode"] for h in hist] != [23] or res["state"].step != 16 or \
            not all(np.isfinite(last[k]) for k in
                    ("critic_loss", "actor_loss", "q_mean", "target_mean")) \
            or not 0.0 <= last["eval_sla"] <= 1.0:
        raise AssertionError(f"train:rl_train: history {hist}, step "
                             f"{res['state'].step}")
    n = {k: len(v) for k, v in spans.each.items()}
    if n != {"round": 3, "rollout": 3, "update": 16}:
        raise AssertionError(f"train:rl_train: spans {n}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  train:rl_train light/paper6 hidden=256 T={RL_T} 8 episodes x "
          f"{RL_PERIODS} periods a round, batch 32 [{CARD}]: rounds=3 (1 "
          f"warm-up) "
          f"updates=16 round_ms="
          f"{'/'.join(f'{us / 1e3:.1f}' for us in spans.each['round'])} "
          f"(a warm-up round, then two of 8 updates) rollout_period_ms="
          f"{spans.us['rollout'] / (3e3 * RL_PERIODS):.2f} update_ms p50="
          f"{pct(spans.each['update'], 50) / 1e3:.1f} mean="
          f"{spans.us['update'] / 16e3:.1f} "
          f"peak_mem_gb={peak_gb:.3f} lstm_cell launches={launches} "
          f"critic_loss={last['critic_loss']} eval_sla={last['eval_sla']} "
          f"baselines="
          f"{ {k: v['sla_rate'] for k, v in res['baselines'].items()} }",
          flush=True)
    return launches


def check_round_parity(label, res, mets, dcfg, U, what, CARD,
                       ring_fields=("mask", "mask2"),
                       loss_rtol=1e-3) -> None:
    """One round's CPU (plain versions) and card (kernels) results from
    the same state, buffer and draws: equal ``counted`` and ``hits``,
    ring fields ``ring_fields`` equal and transitions within
    ``TRAIN_TOL``, losses within ``loss_rtol``, parameters within 2 lr
    per update."""
    for k in ("counted", "hits"):
        c, g = mets["cpu"][k].tolist(), mets["cuda"][k].cpu().tolist()
        if c != g:
            raise AssertionError(f"{label}: {k} {g} on the card, {c} "
                                 f"on the CPU")
    (sc, bc, _, mc), (sg, bg, _, mg) = res["cpu"], res["cuda"]
    worst = {}
    for k in ring_fields:
        if not torch.equal(bc[k], bg[k].cpu()):
            raise AssertionError(f"{label}: ring field {k} differs")
    for k in ("s", "a", "r", "s2"):
        worst[k] = (bc[k] - bg[k].cpu()).abs().max().item()
        if not torch.allclose(bg[k].cpu(), bc[k], **TRAIN_TOL):
            raise AssertionError(f"{label}: ring field {k} differs by "
                                 f"{worst[k]:.3e}")
    from repro_torch.core import ddpg as D
    from repro_torch.core.train import INFO_KEYS
    for k in INFO_KEYS + ("sla", "reward", "energy_uj"):
        if not np.isclose(mg[k], mc[k], atol=1e-5, rtol=loss_rtol):
            raise AssertionError(f"{label}: {k} {mg[k]} on the card, "
                                 f"{mc[k]} on the CPU")
    pworst = 0.0
    for name, lr in (("actor", dcfg.actor_lr), ("critic", dcfg.critic_lr),
                     ("target_actor", dcfg.tau * dcfg.actor_lr),
                     ("target_critic", dcfg.tau * dcfg.critic_lr)):
        for c, g in zip(D.tree_leaves(getattr(sc, name)),
                        D.tree_leaves(getattr(sg, name))):
            d = (c - g.cpu()).abs().max().item()
            lim = 2 * lr * U + 1e-5 * c.abs().max().item()
            pworst = max(pworst, d / lim)
            if d > lim:
                raise AssertionError(f"{label}: {name} moved {d:.3e} "
                                     f"apart (limit {lim:.3e})")
    print(f"  {label} {what}, {U} updates, CPU vs [{CARD}]: counted="
          f"{int(mets['cpu']['counted'].sum())} hits="
          f"{int(mets['cpu']['hits'].sum())} (equal) ring max_abs_err "
          + " ".join(f"{k}={v:.3e}" for k, v in worst.items())
          + f" (atol/rtol {TRAIN_TOL['atol']}) critic_loss cpu="
          f"{mc['critic_loss']:.6f} card={mg['critic_loss']:.6f} "
          f"actor_loss cpu={mc['actor_loss']:.6f} "
          f"card={mg['actor_loss']:.6f} params worst/limit={pworst:.3f}",
          flush=True)


def train_parity_phase(CARD):
    """One round from the same state, buffer and draws on the CPU (plain
    versions) and on the card (kernels)."""
    from repro_torch.core import ddpg as D
    from repro_torch.core import policy as P
    from repro_torch.core import rollout
    from repro_torch.core import train as TR
    from repro_torch.core.replay import replay_init
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    from repro_torch.launch import rl_train
    kw = dict(batch_episodes=8, num_updates=4, batch_size=32,
              sigma_min=0.05, sigma_decay=0.97)
    cfg = rl_train.TrainConfig(workload="light", fleet="paper6", hidden=256,
                               periods=8, max_rq=96, max_jobs=64)
    envs = {d: rl_train.build_env(dataclasses.replace(cfg, device=d))
            for d in ("cpu", "cuda")}
    env = envs["cpu"]
    dcfg = D.DDPGConfig(policy=P.PolicyConfig(
        feat_dim=env.feat_dim, act_dim=env.act_dim, hidden=cfg.hidden))
    state0 = D.init_ddpg(torch.Generator().manual_seed(0), dcfg, "cpu")
    n = kw["batch_episodes"] * cfg.periods
    draws = TR.round_draws(env, TR.round_keys(1, 0, 1)[0],
                           batch_episodes=kw["batch_episodes"],
                           num_updates=kw["num_updates"],
                           batch_size=kw["batch_size"], size_after=n)
    res, mets = {}, {}
    inner = rollout.collect_episodes

    def capture(*a, **k):
        out = inner(*a, **k)
        mets[dev] = out[3]
        return out
    rollout.collect_episodes = capture
    try:
        for dev in ("cpu", "cuda"):
            state = D.DDPGState(**{
                f.name: D.tree_map(lambda t: t.to(dev),
                                   getattr(state0, f.name))
                for f in dataclasses.fields(state0) if f.name != "step"},
                step=0)
            buf = replay_init(4000, env.seq_len, env.feat_dim, env.act_dim,
                              dev)
            cell_ops.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[dev] = TR._round_body(envs[dev], dcfg, **kw)(
                state, buf, draws, 0.4, True)
            torch.cuda.synchronize()
            print(f"  train:parity round on {dev} [{CARD}]: "
                  f"{time.perf_counter() - t0:.2f}s lstm_cell launches="
                  f"{cell_ops.LAUNCHES}", flush=True)
    finally:
        rollout.collect_episodes = inner
    want = RL_T * (cfg.periods + 5 * kw["num_updates"])
    if cell_ops.LAUNCHES != want:
        raise AssertionError(f"train:parity: {cell_ops.LAUNCHES} lstm_cell "
                             f"launches on the card, expected {want}")
    check_round_parity("train:parity", res, mets, dcfg, kw["num_updates"],
                       f"hidden=256 8 episodes x {cfg.periods} periods",
                       CARD)
    sg, bg = res["cuda"][:2]
    # where a round's time goes on the card: one update, one period
    from repro_torch.core.replay import replay_sample
    batch = replay_sample(bg, idx=draws["idx"][0].cuda())
    profile_window(lambda: D.ddpg_update(sg, dcfg, batch),
                   "one DDPG update (B = 32, T = 97)", CARD)
    env = envs["cuda"]
    tr, st = env.new_episodes_torch(torch.Generator(device="cuda")
                                    .manual_seed(2), kw["batch_episodes"])
    act = rollout._policy_act_fn(sg.actor, dcfg.policy)
    with torch.no_grad():
        profile_window(lambda: env.period(
            st, tr, lambda f, m, sl, s_: act(f, m, sl, s_, None)),
            "one rollout period (8 episodes)", CARD)


# ---------------------------------------------------------------------------
# RELMAS on a changing fleet: MAGMA, churn, the generalist
# ---------------------------------------------------------------------------
# depth cuts that keep the new phases within ~3 minutes: every MAGMA
# engine call is ~130 ms of host-bound event loop at any row count (3
# periods until the LM mesh phases came)
MAGMA_STREAMS, MAGMA_PERIODS = 8, 1
# cut from 30 to 15 to make room for the sharded phases (39-42), then to
# 10 for the dry-run phases (45-46), with its MAGMA baseline's GA cut
# from 24 x 12 to 12 x 6 (baseline:magma runs the paper's 100 x 100)
CHURN_PERIODS = 10
CHURN_MAGMA = (12, 6)
RLC_ARGS = ["--workload", "light", "--hidden", "256", "--max-rq", "96",
            "--max-jobs", "64", "--periods", "60", "--batch-episodes", "8",
            "--batch-size", "32", "--episodes", "16",
            "--updates-per-episode", "1", "--warmup-episodes", "8",
            "--eval-every", "16", "--ckpt-every", "8", "--eval-seeds", "2",
            "--churn", "mixed"]
GEN_FLEETS = "paper6,4simba_4eyeriss,2simba_2eyeriss"
GEN_SERVE_ARGS = ["--workload", "light", "--fleet", "big_little",
                  "--hidden", "256", "--batched", "--streams", "32",
                  "--requests", "32", "--scenario", "steady",
                  "--rate-scale", "1.0", "--periods", "60", "--max-rq", "96",
                  "--max-jobs", "64"]


def magma_phase(CARD):
    """MAGMA at the paper's 100 x 100 through ``evaluate_batch_baseline``,
    its depth cut to MAGMA_PERIODS periods: every period's search makes
    1 + generations engine calls, its elite never decreases and ends at
    or above the Herald individual it was seeded with."""
    from repro_torch.core import baselines as BL
    from repro_torch.core import rollout
    from repro_torch.launch import rl_train
    from repro_torch.sim import engine
    from repro_torch.sim.env import SchedulingEnv
    from repro_torch.workloads import build_registry
    # the first MAGMA_PERIODS periods of a full 60-period episode: its
    # arrival process (horizon), its depth cut
    ecfg, arr = rl_train._env_cfgs(rl_train.TrainConfig(
        workload="mixed", fleet="paper6", max_rq=96, max_jobs=64))
    env = SchedulingEnv(build_registry("mixed", mas="paper6"),
                        dataclasses.replace(ecfg, periods=MAGMA_PERIODS), arr)
    seeds = range(7000, 7000 + MAGMA_STREAMS)
    mcfg = BL.MagmaConfig()
    inner_search, inner_sim = BL.magma_search_scan, engine.simulate
    count, periods, last = [0], [], {}

    def counting(*a, **k):
        count[0] += 1
        return inner_sim(*a, **k)

    def search(env_, mcfg_, rand, state, slots):
        count[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_search(env_, mcfg_, rand, state, slots)
        torch.cuda.synchronize()
        secs, calls = time.perf_counter() - t0, count[0]
        _, hp, hs = BL.herald(slots, state, env_)
        hfit = BL._magma_fitness(env_, state, slots, hp[:, None],
                                 hs[:, None])[:, 0]
        elite = out[2]
        last.update(state=state, slots=slots, prio=out[0], sa=out[1])
        periods.append(dict(
            secs=secs, calls=calls,
            monotone=bool((elite[:, 1:] >= elite[:, :-1]).all()),
            above_herald=bool((elite[:, -1] >= hfit).all()),
            gain=float((elite[:, -1] - hfit).mean())))
        return out
    engine.simulate, BL.magma_search_scan = counting, search
    try:
        m = rollout.evaluate_batch_baseline(env, BL.make_magma_baseline(mcfg),
                                            seeds)
    finally:
        engine.simulate, BL.magma_search_scan = inner_sim, inner_search
    h = rollout.evaluate_batch_baseline(env, BL.herald, seeds)
    want = mcfg.generations + 1
    if len(periods) != MAGMA_PERIODS or any(
            p["calls"] != want for p in periods):
        raise AssertionError(f"baseline:magma: engine calls a period "
                             f"{[p['calls'] for p in periods]}, expected "
                             f"{want} in each of {MAGMA_PERIODS}")
    if not all(p["monotone"] and p["above_herald"] for p in periods):
        raise AssertionError(f"baseline:magma: elite decreased or ended "
                             f"below Herald's individual: {periods}")
    if m["arrived"] != h["arrived"] or not 0.0 <= m["sla_rate"] <= 1.0:
        raise AssertionError(f"baseline:magma: {m}, herald {h}")
    secs = [p["secs"] for p in periods]
    print(f"  baseline:magma {mcfg.population} x {mcfg.generations} mixed/"
          f"paper6, {MAGMA_STREAMS} streams x {MAGMA_PERIODS} periods, "
          f"96 RQ slots [{CARD}]: s_per_period mean={np.mean(secs):.3f} "
          f"min={min(secs):.3f} max={max(secs):.3f} engine_calls_per_"
          f"period={want} ms_per_engine_call={1e3 * np.mean(secs) / want:.2f}"
          f" ({MAGMA_STREAMS * mcfg.population} rows each); elite "
          f"monotone and >= Herald's individual in every period (mean gain "
          f"{np.mean([p['gain'] for p in periods]):.4f}); sla_rate magma="
          f"{m['sla_rate']:.4f} herald={h['sla_rate']:.4f} counted a "
          f"stream magma={m['counted']:.3f} herald={h['counted']:.3f} "
          f"(of {m['arrived']:.3f} arrived over the whole trace)",
          flush=True)
    # where a MAGMA period's time goes: one generation's fitness call
    pop = lambda x: x[:, None].expand(-1, mcfg.population, -1).contiguous()
    profile_window(lambda: BL._magma_fitness(
        env, last["state"], last["slots"], pop(last["prio"]),
        pop(last["sa"])), f"one MAGMA fitness call "
        f"({MAGMA_STREAMS * mcfg.population} rows)", CARD)


def churn_fail_check(env, pcfg, params, CARD):
    """An eval batch under the ``fail`` preset: no sub-job is committed
    to an SA in a period in which that SA is invalid (the policy masks
    it, Herald sees its poison cost)."""
    from repro_torch.core import baselines as BL
    from repro_torch.core import rollout
    from repro_torch.sim import churn as C
    from repro_torch.sim.engine import INF
    seeds = range(7100, 7108)
    traces, states = rollout.stack_episodes(env, seeds)
    sched = rollout._eval_churn_schedules(env, C.churn_preset("fail"), seeds)
    policy = rollout._policy_act_fn(params, pcfg)
    acts = {"relmas": lambda f, m, sl, s_: policy(f, m, sl, s_, None),
            "herald": lambda f, m, sl, s_: BL.herald(sl, s_, env)}
    inner, rec = env.simulate, {}

    def simulate(state, slots, prio, sa_choice, commit_only=False):
        out = inner(state, slots, prio, sa_choice, commit_only)
        rec.update(start=out[0], fin=out[1], sa=out[5], valid=slots["valid"],
                   sa_valid=state["sa_valid"])
        return out
    env.simulate = simulate
    try:
        for name, act in acts.items():
            st, bad, committed, exposed = states, 0, 0, 0
            with torch.no_grad():
                for p in range(env.cfg.periods):
                    row = {k: v[:, p] for k, v in sched.items()}
                    st, _, _ = env.period(st, traces, act, commit_only=True,
                                          churn=row)
                    com = (rec["valid"]
                           & (rec["start"] < env.cfg.t_s_us - 1e-6)
                           & (rec["fin"] < INF / 2))
                    ok = torch.gather(rec["sa_valid"], 1, rec["sa"])
                    bad += int((com & ~ok).sum())
                    committed += int(com.sum())
                    exposed += int(((~rec["sa_valid"]).any(1)[:, None]
                                    & com).sum())
            if bad or not exposed:
                raise AssertionError(f"train:churn: {name} under the fail "
                                     f"preset committed {bad} sub-jobs to "
                                     f"invalid SAs ({exposed} committed "
                                     f"while an SA was down)")
            print(f"  train:churn fail-preset eval ({len(seeds)} seeds) "
                  f"{name} [{CARD}]: committed={committed} while an SA was "
                  f"down={exposed} on an invalid SA=0", flush=True)
    finally:
        del env.simulate


def churn_baselines_check(env, CARD):
    """The fcfs, herald and magma (``CHURN_MAGMA``, ``--eval-baselines``'s
    GA) baselines through ``evaluate_batch_baseline`` under the ``mixed``
    preset on the eval seeds (``rl_train`` scores them on the static
    fleet, as the reference does): MAGMA carries its generator and the
    churn schedules into every period's search on the card."""
    from repro_torch.core import baselines as BL
    from repro_torch.core import rollout
    from repro_torch.sim import churn as C
    seeds = range(7000, 7002)
    fns = {"fcfs": BL.BASELINES["fcfs"], "herald": BL.herald,
           "magma": BL.make_magma_baseline(BL.MagmaConfig(
               population=CHURN_MAGMA[0], generations=CHURN_MAGMA[1]))}
    out, secs = {}, {}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = rollout.evaluate_batch_baseline(
            env, fn, seeds, churn=C.churn_preset("mixed"))
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    if len({m["arrived"] for m in out.values()}) != 1 or not all(
            0.0 <= m["sla_rate"] <= 1.0 and m["counted"] > 0
            and np.isfinite(m["energy_uj"]) for m in out.values()):
        raise AssertionError(f"train:churn: baselines under churn {out}")
    print(f"  train:churn baselines under --churn mixed ({len(seeds)} "
          f"seeds x {env.cfg.periods} periods) [{CARD}]: "
          + " ".join(f"{k}: sla_rate={m['sla_rate']:.4f} counted="
                     f"{m['counted']:.1f} s={secs[k]:.1f}"
                     for k, m in out.items()), flush=True)


def train_churn_phase(CARD):
    """``rl_train`` under ``--churn mixed``: two rounds, an eval
    on 2 seeds and the fcfs, herald and magma baselines; exact
    ``lstm_cell`` launch counts; then the baselines under churn and the
    fail-preset check."""
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    from repro_torch.launch import rl_train
    out = os.path.join(ROOT, "runs", "chip_smoke_churn")
    shutil.rmtree(out, ignore_errors=True)
    spans = Spans([(rl_train, "train_rounds_host", "round"),
                   (rl_train, "evaluate_batch_baseline", "baseline")])
    cell_ops.LAUNCHES = 0
    with spans:
        res = rl_train.main(RLC_ARGS + [
            "--fleet", "paper6", "--outdir", out,
            "--periods", str(CHURN_PERIODS),
            "--eval-baselines", "fcfs,herald,magma",
            "--magma-population", str(CHURN_MAGMA[0]),
            "--magma-generations", str(CHURN_MAGMA[1])])
    launches = cell_ops.LAUNCHES
    want = rl_expected_launches(rounds=2, eval_runs=1, updates=8,
                                periods=CHURN_PERIODS)
    if launches != want:
        raise AssertionError(f"train:churn: lstm_cell launched {launches} "
                             f"times, expected {want}")
    hist, last = res["history"], res["history"][-1]
    if [h["episode"] for h in hist] != [7, 15] or res["state"].step != 8 \
            or not all(np.isfinite(last[k]) for k in
                       ("critic_loss", "actor_loss")) \
            or not 0.0 <= last["eval_sla"] <= 1.0 \
            or set(res["baselines"]) != {"fcfs", "herald", "magma"}:
        raise AssertionError(f"train:churn: history {hist}, step "
                             f"{res['state'].step}, baselines "
                             f"{res['baselines']}")
    print(f"  train:churn light/paper6 --churn mixed hidden=256 8 episodes "
          f"x {CHURN_PERIODS} periods (cut from 30) a round [{CARD}]: "
          f"round_ms="
          f"{'/'.join(f'{us / 1e3:.1f}' for us in spans.each['round'])} "
          f"(a warm-up round, then one of 8 updates) baseline_s fcfs/herald/"
          f"magma({CHURN_MAGMA[0]}x{CHURN_MAGMA[1]})="
          f"{'/'.join(f'{us / 1e6:.1f}' for us in spans.each['baseline'])} "
          f"lstm_cell launches={launches} eval_sla={last['eval_sla']} "
          f"baselines="
          f"{ {k: v['sla_rate'] for k, v in res['baselines'].items()} }",
          flush=True)
    churn_baselines_check(res["env"], CARD)
    churn_fail_check(res["env"], res["pcfg"], res["state"].actor, CARD)


def train_generalist_phase(CARD) -> str:
    """``rl_train`` over three fleets as one generalist (m_max 8, F = 84)
    under churn, ``--best-metric min_fleet``: two rounds, a per-fleet
    eval, exact ``lstm_cell`` launch counts.  Returns the best
    checkpoint's directory."""
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    from repro_torch.launch import rl_train
    out = os.path.join(ROOT, "runs", "chip_smoke_generalist")
    shutil.rmtree(out, ignore_errors=True)
    spans = Spans([(rl_train, "generalist_rounds_host", "round")])
    cell_ops.LAUNCHES = 0
    with spans:
        res = rl_train.main(RLC_ARGS + [
            "--fleet", GEN_FLEETS, "--policy-kind", "generalist",
            "--best-metric", "min_fleet", "--outdir", out,
            "--periods", str(RL_PERIODS)])
    launches = cell_ops.LAUNCHES
    fleets = GEN_FLEETS.split(",")
    want = rl_expected_launches(rounds=2, eval_runs=len(fleets), updates=8,
                                periods=RL_PERIODS)
    if launches != want:
        raise AssertionError(f"train:generalist: lstm_cell launched "
                             f"{launches} times, expected {want}")
    hist, last = res["history"], res["history"][-1]
    per = last.get("eval_sla_per_fleet", {})
    if [h["episode"] for h in hist] != [7, 15] or set(per) != set(fleets) \
            or res["pcfg"].feat_dim != 84 \
            or res["best"]["score"] != min(per.values()) \
            or not all(h["fleet"] in fleets for h in hist):
        raise AssertionError(f"train:generalist: history {hist}, best "
                             f"{res['best']}")
    print(f"  train:generalist {GEN_FLEETS} m_max=8 F=84 --churn mixed "
          f"hidden=256 [{CARD}]: round_ms="
          f"{'/'.join(f'{us / 1e3:.1f}' for us in spans.each['round'])} "
          f"fleets={[h['fleet'] for h in hist]} lstm_cell launches="
          f"{launches} eval_sla_per_fleet={per} best(min_fleet)="
          f"{res['best']['score']}", flush=True)
    return os.path.join(out, "best")


def serve_generalist_phase(serve_cli, ops, ckpt, CARD):
    """``launch/serve.py`` with the generalist checkpoint on big_little, a
    fleet it never trained on: exactly one ``lstm_seq`` launch a tick,
    each at F = 84; then the same streams with synchronised spans for
    the actor's and the engine's shares of the tick."""
    from repro_torch.core import policy
    from repro_torch.sim import engine
    args = GEN_SERVE_ARGS + ["--ckpt", ckpt]
    shapes, real = [], ops.lstm_seq

    def recording(xs, mask, *w):
        shapes.append(tuple(xs.shape))
        return real(xs, mask, *w)
    ops.lstm_seq = recording
    ops.LAUNCHES = 0
    try:
        out = serve_cli.main(args)
    finally:
        ops.lstm_seq = real
    launches = ops.LAUNCHES
    if out["policy_kind"] != "generalist" or launches != out["ticks"] \
            or set(shapes) != {(RL_T,) + GEN_SEQ_SHAPE[1:3]} \
            or not out["counted"] > 0:
        raise AssertionError(f"serve:generalist: {out}, lstm_seq launches "
                             f"{launches}, shapes {set(shapes)}")
    svc = serve_cli.build_service(serve_cli.parse_args(args))
    spans = Spans([(policy, "actor_apply", "actor"),
                   (ops, "lstm_seq", "lstm_seq"),
                   (engine, "simulate", "engine")])
    with spans:
        _, res = serve_cli.serve_batched(svc, serve_cli.parse_args(args))
    tick_us = float(np.sum(res["stats"]["tick_wall_us"]))
    print(f"  serve:generalist big_little (unseen) light, 32 streams x 60 "
          f"periods, F={GEN_SEQ_SHAPE[2]} [{CARD}]: ticks={out['ticks']} "
          f"lstm_seq launches={launches} tick_p50_ms="
          f"{out['tick_p50_us'] / 1e3:.3f} tick_p99_ms="
          f"{out['tick_p99_us'] / 1e3:.3f} sla_rate={out['sla_rate']:.4f} "
          f"counted={out['counted']}; synchronised spans: tick_total_ms="
          f"{tick_us / 1e3:.1f} "
          + " ".join(f"{k}_share={v / tick_us:.4f}"
                     for k, v in spans.us.items())
          + f" actor_ms_per_tick={spans.us['actor'] / 1e3 / out['ticks']:.3f}",
          flush=True)


def generalist_parity_phase(CARD):
    """One churned generalist round (hidden 256, 8 periods) from the same
    state, buffer and draws on the CPU (plain versions) and on the card
    (kernels), held to the train:parity criteria."""
    from repro_torch.core import ddpg as D
    from repro_torch.core import generalist as G
    from repro_torch.core.generalist import rollout as grollout
    from repro_torch.core.generalist import train as GT
    from repro_torch.core.train import round_keys
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    from repro_torch.launch import rl_train
    from repro_torch.sim import churn as C
    kw = dict(batch_episodes=8, num_updates=4, batch_size=32,
              sigma_min=0.05, sigma_decay=0.97)
    cfg = rl_train.TrainConfig(workload="light", hidden=256, periods=8,
                               max_rq=96, max_jobs=64)
    ecfg, arr = rl_train._env_cfgs(cfg)
    fleets = GEN_FLEETS.split(",")
    envs = {d: G.build_padded_envs("light", fleets, ecfg, arr, device=d)
            for d in ("cpu", "cuda")}
    spec = G.GeneralistSpec(m_max=envs["cpu"][0].num_sas)
    dcfg = D.DDPGConfig(policy=spec.pcfg(hidden=cfg.hidden))
    churn = C.churn_preset("mixed")
    state0 = D.init_ddpg(torch.Generator().manual_seed(0), dcfg, "cpu")
    draws = GT.generalist_round_draws(
        envs["cpu"], round_keys(1, 0, 1)[0], size_after=8 * cfg.periods,
        churn=churn, **{k: kw[k] for k in ("batch_episodes", "num_updates",
                                           "batch_size")})
    res, mets = {}, {}
    inner = grollout.collect_episodes

    def capture(*a, **k):
        out = inner(*a, **k)
        mets[dev] = out[3]
        return out
    grollout.collect_episodes = capture
    try:
        for dev in ("cpu", "cuda"):
            state = D.DDPGState(**{
                f.name: D.tree_map(lambda t: t.to(dev),
                                   getattr(state0, f.name))
                for f in dataclasses.fields(state0) if f.name != "step"},
                step=0)
            buf = G.generalist_replay_init(4000, envs[dev][0].seq_len, spec,
                                           dev)
            cell_ops.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[dev] = GT._generalist_round_body(envs[dev], dcfg, churn=churn,
                                                 **kw)(state, buf, draws,
                                                       0.4, True)
            torch.cuda.synchronize()
            print(f"  generalist:parity round on {dev} (fleet "
                  f"{fleets[draws['fleet']]}) [{CARD}]: "
                  f"{time.perf_counter() - t0:.2f}s lstm_cell launches="
                  f"{cell_ops.LAUNCHES}", flush=True)
    finally:
        grollout.collect_episodes = inner
    want = RL_T * (cfg.periods + 5 * kw["num_updates"])
    if cell_ops.LAUNCHES != want:
        raise AssertionError(f"generalist:parity: {cell_ops.LAUNCHES} "
                             f"lstm_cell launches on the card, expected "
                             f"{want}")
    check_round_parity("generalist:parity", res, mets, dcfg,
                       kw["num_updates"],
                       f"hidden=256 F=84 --churn mixed 8 episodes x "
                       f"{cfg.periods} periods", CARD,
                       ring_fields=("mask", "mask2", "fleet"))


# ---------------------------------------------------------------------------
# RELMAS training sharded over devices (phases 39-42)
# ---------------------------------------------------------------------------
# the rounds of the sharded phases: a warm-up round then one of
# SHARD_UPDATES updates, 8 episodes a round over the devices; the
# oracle at D = 4 on the card and the CPU, 2 ranks sharing the card over
# gloo against the oracle at D = 2
SHARD_D, SHARD_RANKS, SHARD_UPDATES = 4, 2, 4
# 12 periods: cut from 20 to hold the sharded phases to 90 s
SHARD_PERIODS, SHARD_GEN_PERIODS = 12, 10
SHARD_FLAGS = [False, True]
SHARD_GEN_FLEETS = "paper6,4simba_4eyeriss"     # m_max 8: F = 84
# the ranks' own limit: past it they are killed and the phase fails
RANK_TIMEOUT_S = 300


def shard_cfg(periods: int, fleet: str = "paper6", device: str = "cuda"):
    from repro_torch.launch import rl_train
    return rl_train.TrainConfig(
        workload="light", fleet=fleet, hidden=256, periods=periods,
        max_rq=96, max_jobs=64, batch_episodes=8, batch_size=32,
        replay_capacity=4000, device=device)


def shard_kw(cfg) -> dict:
    return dict(batch_episodes=cfg.batch_episodes, num_updates=SHARD_UPDATES,
                batch_size=cfg.batch_size, sigma_min=cfg.sigma_min,
                sigma_decay=cfg.sigma_decay)


def shard_run(cfg, kind: str, num_devices: int):
    """The run's env(s), dcfg and a fresh learner (seed 0) and the
    ``num_devices`` shards' fresh ring pairs, on ``cfg.device``."""
    from repro_torch.core import ddpg as D
    from repro_torch.core import train as TR
    from repro_torch.core.replay import replay_pair_init
    from repro_torch.launch import rl_train
    run = rl_train._build_run(cfg, kind, cfg.fleet.split(","), None)
    envs = run.envs if kind == "generalist" else run.env
    state = D.init_ddpg(torch.Generator().manual_seed(0), run.dcfg,
                        cfg.device)
    pairs = TR.replicate(replay_pair_init(
        run.replay_init(cfg.replay_capacity // num_devices),
        cfg.batch_episodes // num_devices * cfg.periods), num_devices)
    return run, envs, state, pairs


def shard_oracle(cfg, kind, num_devices, draws_fn=None,
                 update_gather: bool = True):
    """The in-process oracle over SHARD_FLAGS's rounds (seeds
    ``round_keys(1, 0, 2)``), its updates on the gathered batch or, with
    ``update_gather=False``, on each shard's own samples with the
    gradients averaged.  Returns (state, pairs, metrics, wall s,
    ``lstm_cell`` launches)."""
    from repro_torch.core import generalist as G
    from repro_torch.core import train as TR
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    run, envs, state, pairs = shard_run(cfg, kind, num_devices)
    kw = dict(shard_kw(cfg), update_gather=update_gather)
    if draws_fn is not None:
        kw["draws_fn"] = draws_fn
    keys = TR.round_keys(1, 0, len(SHARD_FLAGS))
    dkeys = TR.shard_round_keys(keys, num_devices)
    if kind == "generalist":
        fn = G.sharded_generalist_rounds_reference(
            envs, run.dcfg, num_devices=num_devices, **kw)
        call = lambda: fn(state, pairs, dkeys, keys, 0.4, SHARD_FLAGS)
    else:
        fn = TR.sharded_rounds_reference(envs, run.dcfg,
                                         num_devices=num_devices, **kw)
        call = lambda: fn(state, pairs, dkeys, 0.4, SHARD_FLAGS)
    cell_ops.LAUNCHES = 0
    if cfg.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, pairs, _, mets = call()
    if cfg.device == "cuda":
        torch.cuda.synchronize()
    return state, pairs, mets, time.perf_counter() - t0, cell_ops.LAUNCHES


def shard_launches(shard_episodes: int, periods: int,
                   update_shards: int = 1) -> int:
    """``lstm_cell`` launches of SHARD_FLAGS's rounds holding
    ``shard_episodes`` shards' episodes: T a period for each shard
    collected, 5 T an update for each of ``update_shards`` batches (one
    gathered batch, or every shard's own in the local-sample
    topology)."""
    return RL_T * (shard_episodes * periods * len(SHARD_FLAGS)
                   + 5 * SHARD_UPDATES * update_shards)


def train_sharded_phase(CARD):
    """``sharded_rounds_reference`` at D = 4 on the card (kernels) and on
    the CPU (plain versions) from the same state and draws (made on the
    CPU from the same seeds), held as train:parity holds one round; in
    the gathered-batch topology, then in the local-sample one (each
    shard's update on its own rows, the gradients averaged)."""
    from repro_torch.core import train as TR
    from repro_torch.core import rollout
    cfgs = {d: shard_cfg(SHARD_PERIODS, device=d) for d in ("cpu", "cuda")}
    run, cpu_env = shard_run(cfgs["cpu"], "specialist", 1)[:2]
    draws_fn = lambda env, seed, shared, **kw: TR.round_draws(cpu_env, seed,
                                                              **kw)
    inner = rollout.collect_episodes
    for gather in (True, False):
        res, mets = {}, {}
        label = "train:sharded" + ("" if gather else " local-sample")

        def capture(*a, **k):
            out = inner(*a, **k)
            mets.setdefault(dev, []).append({k: out[3][k].cpu()
                                             for k in ("counted", "hits")})
            return out
        rollout.collect_episodes = capture
        try:
            for dev in ("cpu", "cuda"):
                res[dev] = shard_oracle(cfgs[dev], "specialist", SHARD_D,
                                        draws_fn, update_gather=gather)
                print(f"  {label} oracle D={SHARD_D} on {dev} [{CARD}]: "
                      f"{res[dev][3]:.2f}s for {len(SHARD_FLAGS)} rounds "
                      f"lstm_cell launches={res[dev][4]}", flush=True)
        finally:
            rollout.collect_episodes = inner
        want = shard_launches(SHARD_D, SHARD_PERIODS,
                              1 if gather else SHARD_D)
        if res["cuda"][4] != want:
            raise AssertionError(f"{label}: {res['cuda'][4]} lstm_cell "
                                 f"launches on the card, expected {want}")
        (sc, pc, mc, _, _), (sg, pg, mg, _, _) = res["cpu"], res["cuda"]
        for pcpu, pgpu in zip(pc, pg):
            for ring in ("read", "write"):
                for k in ("ptr", "size"):
                    if pcpu[ring][k] != pgpu[ring][k]:
                        raise AssertionError(f"{label}: {ring} {k} "
                                             f"differs")
            if pcpu["pending_n"] != pgpu["pending_n"]:
                raise AssertionError(f"{label}: pending_n differs")
        ring = lambda pairs: {k: torch.cat([p[r][k].cpu() for p in pairs
                                            for r in ("read", "write")])
                              for k in ("s", "mask", "a", "r", "s2",
                                        "mask2")}
        cat = lambda ms: {k: torch.cat([m[k] for m in ms])
                          for k in ("counted", "hits")}
        last = lambda m: {k: float(v[-1]) for k, v in m.items()}
        check_round_parity(
            label, {"cpu": (sc, ring(pc), None, last(mc)),
                    "cuda": (sg, ring(pg), None, last(mg))},
            {d: cat(mets[d]) for d in mets}, run.dcfg, SHARD_UPDATES,
            f"D={SHARD_D} hidden={cfgs['cpu'].hidden} "
            f"{cfgs['cpu'].batch_episodes} episodes x "
            f"{SHARD_PERIODS} periods, 2 rounds", CARD, loss_rtol=1e-4)


def rank_job(cfg, kind: str) -> dict:
    from repro_torch.core import train as TR
    from repro_torch.launch import rl_train
    _, _, state, _ = shard_run(cfg, kind, 1)
    return dict(cfg=cfg, kind=kind, state=rl_train._state_to_numpy(state),
                keys=TR.round_keys(1, 0, len(SHARD_FLAGS)), sigma=0.4,
                flags=SHARD_FLAGS, kw=shard_kw(cfg))


def spawn_shard_ranks(jobs, backend: str):
    """SHARD_RANKS ranks (``spawn_ranks`` of ``sharded_rounds_rank``)
    running ``jobs`` in turn: sharing the card over gloo, or a card each
    over NCCL.  Returns (per rank, its results a job; spawn-to-join
    seconds)."""
    from repro_torch.launch import rl_train
    t0 = time.perf_counter()
    ranks = rl_train.spawn_ranks(rl_train.sharded_rounds_rank, SHARD_RANKS,
                                 jobs, device="cuda", backend=backend,
                                 timeout=RANK_TIMEOUT_S)
    return ranks, time.perf_counter() - t0


def check_ranks(label, cfg, kind, ranks, CARD, where) -> tuple[int, float]:
    """The ranks' results of one job against the oracle at D =
    SHARD_RANKS on the card (the same seeds, drawn on the card):
    replicas bit-equal to each other and to the oracle, each rank's ring
    pair the oracle's shard, each rank's ``lstm_cell`` launches what its
    episodes and updates imply.  Returns (launches of all ranks, their
    rounds' wall seconds)."""
    from repro_torch.launch import rl_train
    state, pairs, mets, oracle_s, _ = shard_oracle(cfg, kind, SHARD_RANKS)
    want_state = rl_train._state_to_numpy(state)
    want = shard_launches(1, cfg.periods)
    same = lambda a, b: (a.keys() == b.keys() and all(
        same(a[k], b[k]) for k in a) if isinstance(a, dict)
        else np.array_equal(np.asarray(a), np.asarray(b)))
    for r, out in enumerate(ranks):
        if out["launches"] != want:
            raise AssertionError(f"{label}: rank {r} launched lstm_cell "
                                 f"{out['launches']} times, expected {want}")
        if out["loaded"]:
            raise AssertionError(f"{label}: rank {r} imported "
                                 f"{out['loaded']}")
        if not same(out["state"], ranks[0]["state"]):
            raise AssertionError(f"{label}: rank {r}'s learner state "
                                 f"differs from rank 0's")
        for ring in ("read", "write"):
            host = {k: v.cpu().numpy() if torch.is_tensor(v) else v
                    for k, v in pairs[r][ring].items()}
            if not same(out["pair"][ring], host):
                raise AssertionError(f"{label}: rank {r}'s {ring} ring "
                                     f"differs from the oracle's shard")
        if not same(out["metrics"], mets):
            raise AssertionError(f"{label}: rank {r}'s metrics differ")
    if not same(ranks[0]["state"], want_state):
        raise AssertionError(f"{label}: the ranks' learner state differs "
                             f"from the oracle's at D={SHARD_RANKS}")
    secs = max(out["secs"] for out in ranks)
    eps = cfg.batch_episodes * len(SHARD_FLAGS)
    each = lambda k: "/".join(f"{o[k]:.2f}" for o in ranks)
    print(f"  {label} {kind} on {SHARD_RANKS} ranks {where} [{CARD}], "
          f"hidden={cfg.hidden} {cfg.batch_episodes} episodes x "
          f"{cfg.periods} periods, {len(SHARD_FLAGS)} rounds: replicas "
          f"bit-equal to each other and to the oracle at D={SHARD_RANKS} "
          f"(state, ring pairs, metrics); lstm_cell launches a rank="
          f"{[o['launches'] for o in ranks]} (expected {want}); rounds "
          f"wall s a rank={each('secs')} (round_ms="
          f"{secs / len(SHARD_FLAGS) * 1e3:.1f}, episodes/s="
          f"{eps / secs:.2f}), set-up s a rank={each('setup_s')}; oracle "
          f"D={SHARD_RANKS} {oracle_s:.2f}s (episodes/s="
          f"{eps / oracle_s:.2f}); sla={mets['sla'].tolist()}", flush=True)
    return sum(o["launches"] for o in ranks), secs


def train_sharded_ranks_phase(CARD) -> int:
    """The unsharded rounds for their wall time, then 2 ranks sharing
    the card over gloo, specialist then generalist (2 fleets, F = 84) in
    one spawn, each against the oracle at D = 2 on the card.  Returns
    the ranks' ``lstm_cell`` launches."""
    from repro_torch.core import train as TR
    cfg = shard_cfg(SHARD_PERIODS)
    gcfg = shard_cfg(SHARD_GEN_PERIODS, fleet=SHARD_GEN_FLEETS)
    run, env, state, _ = shard_run(cfg, "specialist", 1)
    buf = run.replay_init(cfg.replay_capacity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TR.make_train_rounds(env, run.dcfg, **shard_kw(cfg))(
        state, buf, TR.round_keys(1, 0, len(SHARD_FLAGS)), 0.4, SHARD_FLAGS)
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    ranks, spawn_s = spawn_shard_ranks(
        [rank_job(cfg, "specialist"), rank_job(gcfg, "generalist")], "gloo")
    print(f"  train:sharded_ranks spawn to join {spawn_s:.1f}s for both "
          f"jobs", flush=True)
    where = "sharing the card over gloo"
    launches, secs = check_ranks("train:sharded_ranks", cfg, "specialist",
                                 [r[0] for r in ranks], CARD, where)
    launches += check_ranks("train:sharded_ranks", gcfg, "generalist",
                            [r[1] for r in ranks], CARD, where)[0]
    eps = cfg.batch_episodes * len(SHARD_FLAGS)
    print(f"  train:sharded_ranks the unsharded rounds at the same size "
          f"[{CARD}]: {plain:.2f}s (round_ms="
          f"{plain / len(SHARD_FLAGS) * 1e3:.1f}, episodes/s="
          f"{eps / plain:.2f}); 2 ranks on one card {secs:.2f}s "
          f"({plain / secs:.2f}x)", flush=True)
    return launches


def train_sharded_nccl_phase(CARD) -> int:
    """With two or more cards, phase 40's specialist rounds on 2 NCCL
    ranks, one a card, against the oracle at D = 2 on the first card;
    with one card, a line that says so (``python chip_smoke.py`` needs one)."""
    n = torch.cuda.device_count()
    if n < SHARD_RANKS:
        print(f"  train:sharded_nccl [{CARD}]: {n} card, too few for "
              f"{SHARD_RANKS} NCCL ranks: not run", flush=True)
        return 0
    cfg = shard_cfg(SHARD_PERIODS)
    ranks, spawn_s = spawn_shard_ranks([rank_job(cfg, "specialist")],
                                       "nccl")
    print(f"  train:sharded_nccl spawn to join {spawn_s:.1f}s", flush=True)
    return check_ranks("train:sharded_nccl", cfg, "specialist",
                       [r[0] for r in ranks], CARD,
                       "on a card each over NCCL")[0]


def train_sharded_driver_phase(CARD) -> None:
    """``rl_train --devices 2``: on one card the device-count error (no
    rank starts, nothing is written); with two or more, two NCCL ranks
    with a crash at ``--fail-at 8`` and the resume at ``--devices 1``.
    Prints which of the two ran."""
    from repro_torch.launch import rl_train
    n = torch.cuda.device_count()
    out = os.path.join(ROOT, "runs", "chip_smoke_sharded_driver")
    shutil.rmtree(out, ignore_errors=True)
    args = ["--workload", "light", "--fleet", "paper6", "--hidden", "256",
            "--max-rq", "96", "--max-jobs", "64", "--periods",
            str(SHARD_GEN_PERIODS), "--batch-episodes", "8",
            "--batch-size", "32", "--episodes", "16",
            "--updates-per-episode", "1", "--warmup-episodes", "8",
            "--ckpt-every", "8", "--eval-every", "16", "--eval-seeds", "1",
            "--outdir", out]
    if n < 2:
        try:
            rl_train.main(args + ["--devices", "2"])
        except ValueError as e:
            if f"torch.cuda.device_count() = {n}" not in str(e) \
                    or os.path.exists(out):
                raise
            print(f"  train:sharded_driver [{CARD}]: {n} card, so the "
                  f"device-count check ran (NCCL across cards did not): "
                  f"--devices 2 raised {e}", flush=True)
            return
        raise AssertionError("train:sharded_driver: --devices 2 ran on "
                             f"{n} card")
    try:
        rl_train.main(args + ["--devices", "2", "--fail-at", "8"])
    except RuntimeError as e:
        if "injected failure at episode 8" not in str(e):
            raise
    else:
        raise AssertionError("train:sharded_driver: --fail-at did not "
                             "crash the ranks")
    res = rl_train.main(args + ["--devices", "1"])
    hist = res["history"]
    if [h["episode"] for h in hist] != [15] or res["state"].step != 8:
        raise AssertionError(f"train:sharded_driver: history {hist}")
    print(f"  train:sharded_driver [{CARD}]: {n} cards, so 2 NCCL ranks "
          f"ran: a crash at --fail-at 8 and the resume at --devices 1 "
          f"from episode 7: {hist}", flush=True)
    shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------------------
# the legacy per-period runners, the segment engine, the quickstart
# ---------------------------------------------------------------------------
# serve:relmas's configuration (paper6, mixed, hidden 256, 96 RQ slots,
# 64 jobs, 60 periods), one stream, its trace drawn with NumPy from seed 0
LEGACY_CFG = dict(workload="mixed", fleet="paper6", hidden=256, periods=60,
                  max_rq=96, max_jobs=64)
# the heuristics' two episodes (b), cut from 60 periods to 40 so that
# the sharded child still ends before the relmas child (a one-stream
# heuristic period is ~130-230 ms of host-bound engine loop).  A
# one-stream episode of this workload holds a few jobs and the three
# heuristics mostly agree on it; of seeds 0-127 at 40 periods, on 22
# and 58 they do not (float32 CPU runs: counted = hits, fcfs 4 and 2,
# prema 4 and 3, herald 3 and 2), so the per-period runner is held
# against the batched one on three different schedules
LEGACY_SEEDS = (22, 58)
LEGACY_HEUR_PERIODS = 40
LEGACY_UPDATES, LEGACY_BATCH = 8, 32
LEGACY_RECORDED = 4              # periods whose engine inputs are re-run
LEGACY_STREAMS = 32              # the batched arm's streams
# the batched arm (c) cut from 60 periods to 20 to make room beside the
# LM serving phases
LEGACY_SHORT_PERIODS = 20
LEGACY_TOL = 1e-5
# examples/torch_quickstart.py on the card: a 16-period episode of its
# hidden-32 actor at T = 33, then 10 updates of 16 rows, 5 T launches each
QUICKSTART_T, QUICKSTART_PERIODS, QUICKSTART_UPDATES = 33, 16, 10
QUICKSTART_HIDDEN, QUICKSTART_BATCH = 32, 16
QUICKSTART_LAUNCHES = QUICKSTART_T * (QUICKSTART_PERIODS
                                      + 5 * QUICKSTART_UPDATES)


def legacy_check(label: str, ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"legacy:runners {label}: {what}")


def legacy_transitions_err(label, trans, want, tol) -> float:
    """``run_episode``'s transitions ``trans`` (one dict a period)
    against ``want`` (``s``, ``a``, ``r``, ``s2`` stacked over the
    periods): every field within ``tol`` (atol and rtol).  Returns the
    worst error."""
    worst = 0.0
    for k in ("s", "a", "r", "s2"):
        got = np.stack([t[k] for t in trans])
        legacy_check(label, got.shape == want[k].shape,
                     f"{k} shape {got.shape} against {want[k].shape}")
        err = float(np.abs(got - want[k]).max())
        worst = max(worst, err)
        legacy_check(label, np.allclose(got, want[k], atol=tol, rtol=tol),
                     f"{k} differs by {err:.3e} (tol {tol})")
    return worst


def legacy_shapes_checked(label, shapes) -> None:
    """Every (B, F, H) a run gave ``lstm_cell`` is one that the
    kernel:lstm_cell phase holds against the plain version
    (``CELL_SHAPES``)."""
    legacy_check(label, shapes <= set(CELL_SHAPES),
                 f"lstm_cell ran at {sorted(shapes - set(CELL_SHAPES))}, "
                 f"not in CELL_SHAPES")


def legacy_runners_phase(CARD, device: str = "cuda") -> dict:
    """Phase 48: the legacy runners on one stream at serve:relmas's
    configuration (a-c), ``ddpg_update_scan`` (d), ``train_rounds_scan``
    (e) and ``examples/torch_quickstart.py`` (f, in a process of its
    own started first, beside (a)-(e)).  Returns the kernel launches of
    the main paths (a), (d) and (f) by kernel."""
    t_ex = time.perf_counter()
    argv = [] if device == "cuda" else ["--device", device]
    with tempfile.TemporaryFile("w+") as log:
        example = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples",
                                          "torch_quickstart.py")] + argv,
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        try:
            launches = legacy_checks(CARD, device)
            rc = example.wait(timeout=300)
        finally:
            if example.poll() is None:
                example.kill()
                example.wait()
        log.seek(0)
        lines = log.read().splitlines()
    legacy_check("torch_quickstart.py", rc == 0,
                 f"exited {rc}: {lines[-20:]}")
    sla = [ln for ln in lines if "SLA satisfaction" in ln]
    n_ex = [int(ln.split(":")[1]) for ln in lines
            if ln.startswith("lstm_cell launches:")]
    want = QUICKSTART_LAUNCHES if device == "cuda" else 0
    legacy_check("torch_quickstart.py", len(sla) == 4 and n_ex == [want]
                 and any(ln.startswith("after 10 updates:") for ln in lines),
                 f"printed {lines}")
    # its actor's one-stream steps and its updates' actor and critic steps
    F, G = launches.pop("feat_act")
    legacy_shapes_checked("torch_quickstart.py", {
        (1, F, QUICKSTART_HIDDEN), (QUICKSTART_BATCH, F, QUICKSTART_HIDDEN),
        (QUICKSTART_BATCH, F + G, QUICKSTART_HIDDEN)})
    launches["lstm_cell"] += n_ex[0]
    print(f"  legacy:runners (f) examples/torch_quickstart.py [{CARD}]: "
          f"exit 0, joined {time.perf_counter() - t_ex:.1f}s after its "
          f"start (beside (a)-(e)), lstm_cell launches={n_ex[0]}: "
          + "; ".join(ln.strip() for ln in sla), flush=True)
    return launches


def legacy_checks(CARD, device: str) -> dict:
    """Phase 48's (a)-(e); returns the launches of (a) and (d), and the
    fleet's feature and action widths under ``feat_act``."""
    from repro_torch.core import baselines as BL
    from repro_torch.core import ddpg as D
    from repro_torch.core import policy as P
    from repro_torch.core import rollout as RO
    from repro_torch.core import train as TR
    from repro_torch.core.replay import (replay_add, replay_init,
                                         replay_sample, sample_indices)
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    from repro_torch.kernels.lstm_seq import ops as seq_ops
    from repro_torch.launch import rl_train
    from repro_torch.sim import engine
    cfg = rl_train.TrainConfig(**LEGACY_CFG)
    envs = {d: rl_train.build_env(dataclasses.replace(cfg, device=d))
            for d in ("cpu", device)}
    env, periods = envs[device], cfg.periods
    short, heur = (rl_train.build_env(dataclasses.replace(
        cfg, device=device, periods=n))
        for n in (LEGACY_SHORT_PERIODS, LEGACY_HEUR_PERIODS))
    T = env.seq_len
    pcfg = P.PolicyConfig(feat_dim=env.feat_dim, act_dim=env.act_dim,
                          hidden=cfg.hidden)
    dcfg = D.DDPGConfig(policy=pcfg)
    state0 = D.init_ddpg(torch.Generator().manual_seed(0), dcfg, "cpu")
    actor = {d: D.tree_map(lambda t: t.to(d), state0.actor)
             for d in ("cpu", device)}
    routes = {"step": pcfg, "sequence": dataclasses.replace(
        pcfg, use_pallas=True)}

    def episode(dev, route, **kw):
        return RO.run_episode(envs[dev], RO.make_policy_period(
            envs[dev], routes[route]), np.random.default_rng(0),
            params=actor[dev], collect=True, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- (a) the policy period on both routes
    runs, secs, launches = {}, {}, {"feat_act": (env.feat_dim, env.act_dim)}
    cell_ops.SHAPES.clear()
    for route, kernel, ops_mod, want in (
            ("step", "lstm_cell", cell_ops, T * periods),
            ("sequence", "lstm_seq", seq_ops, periods)):
        cell_ops.LAUNCHES = seq_ops.LAUNCHES = 0
        runs[route], secs[route] = timed(lambda: episode(device, route))
        launches[kernel] = ops_mod.LAUNCHES
        other = seq_ops if ops_mod is cell_ops else cell_ops
        legacy_check(route, ops_mod.LAUNCHES == want and other.LAUNCHES == 0,
                     f"{ops_mod.LAUNCHES} launches of its kernel (expected "
                     f"{want}), {other.LAUNCHES} of the other")
    # both routes against one collect_episodes run of the step route on
    # the same trace (the two kernels' float32 sums differ by ~1e-6)
    traces, states = RO.stack_episodes(env, [0])
    zero = torch.zeros((1, periods, cfg.max_rq, env.act_dim),
                       device=env.device)
    legacy_shapes_checked("(a)", cell_ops.SHAPES)
    (_, ref, _, mets), secs["collect"] = timed(lambda: RO.collect_episodes(
        env, pcfg, actor[device], states, traces, None, 0.0, noise=zero))
    ref = {k: ref[k][0].cpu().numpy() for k in ("s", "a", "r", "s2")}
    for route, (m, trans) in runs.items():
        label = f"{route} vs collect_episodes"
        for k in ("counted", "hits"):
            legacy_check(label, m[k] == float(mets[k][0]),
                         f"{k} {m[k]} against {float(mets[k][0])}")
        worst = legacy_transitions_err(label, trans, ref, LEGACY_TOL)
        # the kernels against their plain versions: the same episode on
        # the CPU, decisions and transitions
        (mc, tc), secs["cpu"] = timed(lambda: episode("cpu", route))
        legacy_check(f"{route} vs the CPU", mc["counted"] == m["counted"]
                     and abs(mc["hits"] - m["hits"]) <= 0.01 * m["counted"],
                     f"counted {m['counted']} / {mc['counted']}, hits "
                     f"{m['hits']} / {mc['hits']}")
        worst_cpu = legacy_transitions_err(
            f"{route} vs the CPU", trans,
            {k: np.stack([t[k] for t in tc]) for k in ref},
            TRAIN_TOL["atol"])
        kernel = "lstm_seq" if routes[route].use_pallas else "lstm_cell"
        print(f"  legacy:runners (a) {route} route [{CARD}]: one stream x "
              f"{periods} periods in {secs[route]:.2f}s, {kernel} "
              f"launches={launches[kernel]} counted={m['counted']:.0f} "
              f"hits={m['hits']:.0f}; collect_episodes ({secs['collect']:.2f}"
              f"s): counted and hits equal, transitions max_abs_err "
              f"{worst:.3e} (tol {LEGACY_TOL}); the CPU ({secs['cpu']:.2f}"
              f"s): counted equal, hits={mc['hits']:.0f}, transitions "
              f"max_abs_err {worst_cpu:.3e} (tol {TRAIN_TOL['atol']})",
              flush=True)

    # ---- (b) the heuristics through the per-period runner
    scheds = {}
    for name in ("fcfs", "prema", "herald"):
        t0 = time.perf_counter()
        fn = BL.BASELINES[name]
        m = RO.evaluate(heur, RO.make_baseline_period(heur, fn),
                        LEGACY_SEEDS)
        mb = RO.evaluate_batch_baseline(heur, fn, LEGACY_SEEDS)
        for k in m:
            tol = 0.0 if k in ("counted", "hits", "arrived") else LEGACY_TOL
            legacy_check(name, np.isclose(m[k], mb[k], rtol=tol, atol=0.0),
                         f"{k} {m[k]} per period, {mb[k]} batched")
        scheds[name] = (m["counted"], m["hits"])
        print(f"  legacy:runners (b) {name} on seeds {LEGACY_SEEDS} x "
              f"{LEGACY_HEUR_PERIODS} periods [{CARD}]: per-period runner "
              f"= evaluate_batch_baseline: sla_rate={m['sla_rate']:.4f} "
              f"counted={m['counted']:.1f} hits={m['hits']:.1f} arrived="
              f"{m['arrived']:.1f} (means over the seeds; both runners "
              f"{time.perf_counter() - t0:.2f}s)", flush=True)
    # the seeds were picked for this: otherwise the check cannot tell a
    # heuristic's schedule from another's
    legacy_check("(b)", len(set(scheds.values())) == 3,
                 f"the heuristics' (counted, hits) {scheds} do not differ")

    # ---- (c) the segment engine swapped in at module level
    real, recorded = engine.simulate, []

    def segments(*a, **k):
        if len(recorded) < LEGACY_RECORDED:
            recorded.append((a, k))
        return engine.simulate_segments(*a, **k)
    engine.simulate = segments
    try:
        (ms, _), secs["segments"] = timed(lambda: episode(device, "step"))
    finally:
        engine.simulate = real
    m = runs["step"][0]
    legacy_check("segment engine", (ms["counted"], ms["hits"])
                 == (m["counted"], m["hits"]),
                 f"counted/hits {ms['counted']}/{ms['hits']} against "
                 f"{m['counted']}/{m['hits']}")
    legacy_check("segment engine", len(recorded) == LEGACY_RECORDED,
                 f"{len(recorded)} engine calls recorded")
    worst = 0.0
    for a, k in recorded:
        for x, y in zip(engine.simulate_segments(*a, **k),
                        engine.simulate(*a, **k)):
            fin = y < engine.INF / 2
            d = (x - y)[fin].abs()
            err = float(d.max()) if d.numel() else 0.0
            legacy_check("segment engine", torch.equal(
                fin, x < engine.INF / 2) and torch.allclose(
                    x[fin], y[fin], rtol=LEGACY_TOL, atol=0.0),
                f"start or finish apart by {err}")
            worst = max(worst, err)
    traces, states = short.new_episodes(np.random.default_rng(7),
                                        LEGACY_STREAMS)
    _, secs["batched"] = timed(lambda: RO.collect_episodes(
        short, pcfg, actor[device], states, traces, None, 0.0,
        noise=torch.zeros((LEGACY_STREAMS, LEGACY_SHORT_PERIODS, cfg.max_rq,
                           env.act_dim), device=env.device)))
    pps = {k: n / secs[k] for k, n in (
        ("segments", periods), ("step", periods),
        ("batched", LEGACY_STREAMS * LEGACY_SHORT_PERIODS))}
    print(f"  legacy:runners (c) segment engine [{CARD}]: counted and hits "
          f"equal; start/finish on {LEGACY_RECORDED} periods' engine "
          f"inputs within rtol {LEGACY_TOL} of simulate (max_abs_err "
          f"{worst:.3e} us).  Periods/s, one "
          f"run each (rollout_throughput.py's arms, sigma 0, not a "
          f"benchmark): segment-engine loop {pps['segments']:.2f}, "
          f"current-engine loop {pps['step']:.2f}, collect_episodes at "
          f"{LEGACY_STREAMS} streams x {LEGACY_SHORT_PERIODS} periods "
          f"{pps['batched']:.2f}", flush=True)

    # ---- (d) ddpg_update_scan on (a)'s transitions
    trans = runs["step"][1]
    buf = replay_init(2 * periods, env.seq_len, env.feat_dim, env.act_dim,
                      env.device)
    replay_add(buf, {k: torch.as_tensor(np.stack([t[k] for t in trans]),
                                        device=env.device)
                     for k in trans[0]})
    before = {k: v.clone() if torch.is_tensor(v) else v
              for k, v in buf.items()}
    state = D.DDPGState(**{f.name: D.tree_map(lambda t: t.to(device),
                                              getattr(state0, f.name))
                           for f in dataclasses.fields(state0)
                           if f.name != "step"}, step=0)
    cell_ops.LAUNCHES = 0
    cell_ops.SHAPES.clear()
    (new, out, infos), secs["scan"] = timed(lambda: D.ddpg_update_scan(
        state, dcfg, buf, torch.Generator(device=env.device).manual_seed(3),
        LEGACY_UPDATES, LEGACY_BATCH))
    n_scan = cell_ops.LAUNCHES
    legacy_shapes_checked("(d)", cell_ops.SHAPES)
    legacy_check("ddpg_update_scan", n_scan == 5 * T * LEGACY_UPDATES,
                 f"{n_scan} lstm_cell launches, expected "
                 f"{5 * T * LEGACY_UPDATES}")
    launches["lstm_cell"] += n_scan
    legacy_check("ddpg_update_scan", new.step == LEGACY_UPDATES
                 and out is buf and all(
                     torch.equal(buf[k], v) if torch.is_tensor(v)
                     else buf[k] == v for k, v in before.items()),
                 f"step {new.step}, the buffer returned or changed")
    legacy_check("ddpg_update_scan", all(
        bool(torch.isfinite(v).all()) for v in infos.values()),
        f"infos {infos}")
    g = torch.Generator(device=env.device).manual_seed(3)
    ref = state
    for _ in range(LEGACY_UPDATES):
        ref, _ = D.ddpg_update(ref, dcfg, replay_sample(
            buf, idx=sample_indices(buf, LEGACY_BATCH, g)))
    for name in ("actor", "critic", "target_actor", "target_critic",
                 "actor_opt", "critic_opt"):
        legacy_check("ddpg_update_scan", all(
            torch.equal(x, y) for x, y in zip(
                D.tree_leaves(getattr(new, name)),
                D.tree_leaves(getattr(ref, name)))),
            f"{name} differs from {LEGACY_UPDATES} ddpg_update calls")
    print(f"  legacy:runners (d) ddpg_update_scan [{CARD}]: "
          f"{LEGACY_UPDATES} updates of {LEGACY_BATCH} at hidden "
          f"{cfg.hidden} in {secs['scan']:.2f}s, lstm_cell launches="
          f"{n_scan}; equal to {LEGACY_UPDATES} ddpg_update calls, the "
          f"buffer the same object and unchanged; critic_loss "
          f"{float(infos['critic_loss'][-1]):.6f}", flush=True)

    # ---- (e) train_rounds_scan at smoke width
    scfg = rl_train.TrainConfig(workload="light", fleet="paper6", hidden=8,
                                periods=6, max_rq=16, max_jobs=8,
                                device=device)
    senv = rl_train.build_env(scfg)
    sdcfg = D.DDPGConfig(policy=P.PolicyConfig(
        feat_dim=senv.feat_dim, act_dim=senv.act_dim, hidden=scfg.hidden))
    kw = dict(batch_episodes=2, num_updates=3, batch_size=8, sigma_min=0.05,
              sigma_decay=0.97)
    res = {}
    cell_ops.SHAPES.clear()
    for name, fn in (("scan", TR.train_rounds_scan),
                     ("host", TR.train_rounds_host)):
        res[name] = fn(senv, sdcfg, D.init_ddpg(
            torch.Generator().manual_seed(0), sdcfg, device),
            replay_init(64, senv.seq_len, senv.feat_dim, senv.act_dim,
                        device), TR.round_keys(1, 0, 2), 0.3,
            [False, True], **kw)
    legacy_shapes_checked("(e)", cell_ops.SHAPES)
    (s1, b1, sg1, m1), (s2, b2, sg2, m2) = res["scan"], res["host"]
    legacy_check("train_rounds_scan", sg1 == sg2 and m1.keys() == m2.keys()
                 and all(np.array_equal(m1[k], m2[k]) for k in m1)
                 and list(m1["did_update"]) == [False, True]
                 and s1.step == s2.step == kw["num_updates"]
                 and all(torch.equal(x, y) for x, y in zip(
                     D.tree_leaves(s1.actor) + D.tree_leaves(s1.critic),
                     D.tree_leaves(s2.actor) + D.tree_leaves(s2.critic)))
                 and all(torch.equal(b1[k], b2[k]) for k in ("s", "a", "r")),
                 f"metrics {m1} against {m2}")
    print(f"  legacy:runners (e) train_rounds_scan [{CARD}]: 2 rounds (a "
          f"warm-up, then {kw['num_updates']} updates) at hidden "
          f"{scfg.hidden} equal to train_rounds_host: sla="
          f"{[float(x) for x in m1['sla']]}",
          flush=True)

    return launches


# ---------------------------------------------------------------------------
# telemetry: the JSONL stream, the device blocks, the profiler trace
# ---------------------------------------------------------------------------
SERVE_PROF_PERIODS = 12         # the profiled serving runs' depth (of 60)
# telemetry:train's episodes, cut from 10 periods to 5 to make room for
# the sharded phases (39-42)
TELE_PERIODS = 5
TELE_TRAIN_ARGS = ["--workload", "light", "--fleet", "paper6",
                   "--hidden", "256", "--max-rq", "96", "--max-jobs", "64",
                   "--periods", str(TELE_PERIODS), "--batch-episodes", "8",
                   "--batch-size", "32", "--episodes", "10",
                   "--updates-per-episode", "1", "--warmup-episodes", "8",
                   "--eval-every", "16", "--ckpt-every", "100",
                   "--eval-seeds", "1"]


def read_stream(path: str, kinds) -> list[dict]:
    """Every line of a telemetry stream, each validated; fails unless
    every kind of ``kinds`` appears."""
    from repro_torch.telemetry import validate_record
    with open(path) as f:
        recs = [validate_record(json.loads(line)) for line in f]
    missing = set(kinds) - {r["kind"] for r in recs}
    if missing:
        raise AssertionError(f"{path}: no {sorted(missing)} record")
    return recs


def check_header(rec: dict, CARD: str, label: str) -> None:
    """The run header names this card and its power limit."""
    name, limit = (x.strip() for x in CARD.rsplit(",", 1))
    if rec["device_name"] != name or rec["backend"] != "cuda" \
            or rec["power_limit_w"] != float(limit.split()[0]) \
            or rec["jax_version"] != "none":
        raise AssertionError(f"{label}: run_header {rec} against {CARD}")


def read_trace(trace_dir: str, label: str, CARD: str) -> list[dict]:
    """The events of the one ``torch.profiler`` trace in ``trace_dir``;
    prints its size, then deletes it."""
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
             if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"{label}: traces {files}")
    size = os.path.getsize(files[0])
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(trace_dir)
    print(f"  {label} trace [{CARD}]: {size / 1e6:.1f} MB, "
          f"{len(events)} events (deleted after reading)", flush=True)
    return events


def ranges(events, prefix: str) -> list[dict]:
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(prefix)),
                  key=lambda e: e["ts"])


def d2h_calls(events) -> list[float]:
    """Host times (trace microseconds) of the runtime calls that issued
    the trace's device-to-host copies, matched by correlation id: the
    host clock, so a copy is counted where the program asked for it."""
    ids = {e["args"]["correlation"] for e in events
           if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")}
    return sorted(e["ts"] for e in events if e.get("cat") == "cuda_runtime"
                  and e.get("args", {}).get("correlation") in ids)


def d2h_between(calls: list[float], t0: float, t1: float) -> int:
    """Device-to-host copies asked for in [t0, t1)."""
    return sum(1 for t in calls if t0 <= t < t1)


def device_busy_us(events, t0: float, t1: float) -> float:
    """Device time (kernels, copies, sets) inside [t0, t1)."""
    busy = 0.0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy += max(0.0, min(e["ts"] + e["dur"], t1) - max(e["ts"], t0))
    return busy


@contextlib.contextmanager
def marked(module, attr: str, name: str):
    """``module.attr`` runs inside a ``record_function(name)`` range while
    the block is open (a bound for the trace readers, not a program
    range)."""
    real = getattr(module, attr)

    def inside(*a, **k):
        with torch.profiler.record_function(name):
            return real(*a, **k)
    setattr(module, attr, inside)
    try:
        yield
    finally:
        setattr(module, attr, real)


def serve_trace_numbers(serve_cli, args, label, CARD) -> dict:
    """One profiled serving run (``args`` hold ``--profile-dir``): the
    device busy share of its tick loop, the host time of each
    ``serving.*`` range a tick and the device-to-host copies a tick (the
    flush's excluded: they come after the loop)."""
    from repro_torch.core import serve as core_serve
    trace = args[args.index("--profile-dir") + 1]
    real = core_serve.make_serving_flush

    def make(*a, **k):                  # mark each call of the flush
        flush = real(*a, **k)

        def marked_flush(*x):
            with torch.profiler.record_function("chip_smoke.flush"):
                return flush(*x)
        return marked_flush
    core_serve.make_serving_flush = make
    try:
        out = serve_cli.main(args)
    finally:
        core_serve.make_serving_flush = real
    events = read_trace(trace, label, CARD)
    admits = ranges(events, "serving.admit")
    flush = ranges(events, "chip_smoke.flush")
    ticks = len(admits)
    if ticks != out["ticks"] or len(flush) != 1:
        raise AssertionError(f"{label}: {ticks} serving.admit ranges, "
                             f"{len(flush)} flushes, {out['ticks']} ticks")
    t0, t1 = admits[0]["ts"], flush[0]["ts"]
    host = {}
    for e in ranges(events, "serving."):
        host[e["name"]] = host.get(e["name"], 0.0) + e["dur"]
    return dict(out=out, ticks=ticks,
                busy=device_busy_us(events, t0, t1) / (t1 - t0),
                loop_ms=(t1 - t0) / 1e3,
                d2h_per_tick=d2h_between(d2h_calls(events), t0, t1) / ticks,
                range_ms={k: v / ticks / 1e3 for k, v in sorted(
                    host.items())})


def telemetry_serve_phase(serve_cli, ops, ref_out, ref_res, CARD):
    """``serve:relmas`` again with ``--log-jsonl`` and ``--window 16``:
    a valid stream with every serving kind, the run's numbers equal to
    the telemetry-off run's, one ``lstm_seq`` launch a tick, the device
    block's counts; tick times on, then off; then two profiled runs cut
    to SERVE_PROF_PERIODS periods, off then on: the tick loop's device
    busy share, each ``serving.*`` range's host time, equal
    device-to-host copies a tick (on / off / off / on and four profiled
    runs until the dry-run phases came)."""
    tmp = os.path.join(ROOT, "runs", "chip_smoke_telemetry")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    stream = os.path.join(tmp, "serve.jsonl")
    args = SERVE_ARGS + ["--policy", "relmas", "--log-jsonl", stream,
                         "--window", "16"]
    with captured_serving(serve_cli) as results:
        ops.LAUNCHES = 0
        out = serve_cli.main(args)
        launches = ops.LAUNCHES
    res = results[0]
    recs = read_stream(stream, ("run_header", "serve_window", "tenant",
                                "serve_summary", "span", "run_end"))
    check_header(recs[0], CARD, "telemetry:serve")
    windows = [r for r in recs if r["kind"] == "serve_window"]
    tele = res["stats"]["device_tele"]
    S, T = int(SERVE_ARGS[SERVE_ARGS.index("--streams") + 1]), out["ticks"]
    if len(windows) != 4 or launches != T or tele["ticks"] != T \
            or sum(tele["depth_hist"]) != T * S:
        raise AssertionError(f"telemetry:serve: {len(windows)} windows, "
                             f"{launches} lstm_seq launches in {T} ticks, "
                             f"device block {tele}")
    for k in ("sla_rate", "counted"):
        if out[k] != ref_out[k]:
            raise AssertionError(f"telemetry:serve: {k} {out[k]} with "
                                 f"telemetry, {ref_out[k]} without")
    if res["completions"] != ref_res["completions"] \
            or res["metrics"] != ref_res["metrics"]:
        raise AssertionError("telemetry:serve: completions or per-stream "
                             "metrics differ from the telemetry-off run")
    # tick times, 60 ticks each: the checked run (on), then off
    ticks = {True: [out],
             False: [serve_cli.main(SERVE_ARGS + ["--policy", "relmas"])]}
    summ = next(r for r in recs if r["kind"] == "serve_summary")
    pq = lambda o: f"{o['tick_p50_us'] / 1e3:.3f}/{o['tick_p99_us'] / 1e3:.3f}"
    print(f"  telemetry:serve relmas, 32 streams x 60 periods [{CARD}]: "
          f"{len(recs)} valid records ({len(windows)} serve_window), "
          f"sla_rate={summ['sla_rate']:.4f} counted={summ['counted']} and "
          f"{sum(len(c) for c in res['completions'])} completions equal "
          f"to serve:relmas (telemetry off); lstm_seq launches={launches}; "
          f"device block ticks={tele['ticks']} depth_hist="
          f"{tele['depth_hist']} committed={tele['committed']}; tick "
          f"p50/p99_ms on {pq(ticks[True][0])}, then off "
          f"{pq(ticks[False][0])} (serve:relmas, off, first run of the "
          f"process: {pq(ref_out)})", flush=True)
    cut = list(SERVE_ARGS)
    cut[cut.index("--periods") + 1] = str(SERVE_PROF_PERIODS)
    nums = {True: [], False: []}
    for on in (False, True):
        label = f"telemetry:serve {'on' if on else 'off'}"
        args = cut + ["--policy", "relmas", "--profile-dir",
                      os.path.join(tmp, "trace")] + (
            ["--log-jsonl", os.path.join(tmp, "prof.jsonl")] if on else [])
        n = serve_trace_numbers(serve_cli, args, label, CARD)
        nums[on].append(n)
        print(f"  telemetry:serve profiled, {n['ticks']} ticks, telemetry "
              f"{'on' if on else 'off'} [{CARD}]: tick loop "
              f"{n['loop_ms']:.1f} ms, device busy share {n['busy']:.4f}; "
              f"host ms a tick "
              + " ".join(f"{k}={v:.3f}" for k, v in n["range_ms"].items())
              + f"; device-to-host copies a tick {n['d2h_per_tick']:.3f}",
              flush=True)
    want = {"serving.admit", "serving.period", "serving.retire"}
    runs = nums[True] + nums[False]
    if any(set(n["range_ms"]) != want | {"serving.telemetry"}
           for n in nums[True]) \
            or any(set(n["range_ms"]) != want for n in nums[False]):
        raise AssertionError("telemetry:serve: a profiled run lacks a "
                             "range or has one too many")
    if len({n["d2h_per_tick"] for n in runs}) != 1:
        raise AssertionError("telemetry:serve: telemetry changed the "
                             "device-to-host copies a tick")
    if len({n["out"]["counted"] for n in runs}) != 1:
        raise AssertionError("telemetry:serve: the profiled runs differ")


def train_trace_numbers(args, label, CARD) -> dict:
    """One profiled training run: the device-to-host copies of each
    round (from its ``relmas.trace_gen`` range to the next round's, the
    last to the end of the rounds) and the ``relmas.*`` ranges."""
    from repro_torch.launch import rl_train
    trace = args[args.index("--profile-dir") + 1]
    with marked(rl_train, "train_rounds_host", "chip_smoke.rounds"):
        res = rl_train.main(args)
    events = read_trace(trace, label, CARD)
    starts = [e["ts"] for e in ranges(events, "relmas.trace_gen")]
    last = ranges(events, "chip_smoke.rounds")[-1]
    ends = starts[1:] + [last["ts"] + last["dur"]]
    names = {e["name"] for e in ranges(events, "relmas.")}
    calls = d2h_calls(events)
    return dict(res=res, names=names,
                d2h=[d2h_between(calls, a, b) for a, b in zip(starts, ends)])


def telemetry_train_phase(CARD):
    """``rl_train`` at hidden 256, TELE_PERIODS periods an episode (depth
    cut from 60 to keep the traces small, then from 10 to make room for
    the sharded phases), two rounds (8 episodes of warm-up, then the
    tail round: 2 episodes, 2 updates), an eval on 1 seed:
    with ``--log-jsonl`` a valid stream whose rounds carry the device
    block, round metrics and final actor and critic weights equal to
    the runs without the flag, exact ``lstm_cell`` launches; then
    profiled with and without the flag: the five ``relmas.*`` ranges,
    device-to-host copies a round no more than without."""
    from repro_torch.core import ddpg as D
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    from repro_torch.launch import rl_train
    tmp = os.path.join(ROOT, "runs", "chip_smoke_telemetry_train")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    run = lambda name, *extra: rl_train.main(
        TELE_TRAIN_ARGS + ["--outdir", os.path.join(tmp, name), *extra])
    stream = os.path.join(tmp, "train.jsonl")
    spans = Spans([(rl_train, "train_rounds_host", "rounds")])
    with spans:                 # off, then on (off, on, on, off until
        off = run("off")        # the dry-run phases came)
        cell_ops.LAUNCHES = 0
        on = run("on", "--log-jsonl", stream)
        launches = cell_ops.LAUNCHES
        runs = [off, on]
    want = rl_expected_launches(rounds=2, eval_runs=1, updates=2,
                                periods=TELE_PERIODS)
    if launches != want:
        raise AssertionError(f"telemetry:train: lstm_cell launched "
                             f"{launches} times, expected {want}")
    recs = read_stream(stream, ("run_header", "train_round", "train_eval",
                                "span", "run_end"))
    check_header(recs[0], CARD, "telemetry:train")
    rounds = [r for r in recs if r["kind"] == "train_round"]
    for r in rounds:        # one SLA a episode, one reward a period
        n = r["batch_episodes"]
        if sum(r["sla_hist"]) != n \
                or sum(r["reward_hist"]) != n * TELE_PERIODS \
                or not 0 < r["replay_fill"] <= 1 or r["committed"] <= 0:
            raise AssertionError(f"telemetry:train: round record {r}")
    if [r["batch_episodes"] for r in rounds] != [8, 2]:
        raise AssertionError(f"telemetry:train: rounds {rounds}")
    # the round metrics leave out each round's wall time (secs, pps)
    clock = ("secs", "periods_per_sec")
    metrics = lambda r: [{k: v for k, v in h.items() if k not in clock}
                         for h in r["history"]]
    for r in runs[1:]:
        if metrics(r) != metrics(off):
            raise AssertionError(f"telemetry:train: history {metrics(r)} "
                                 f"against {metrics(off)}")
        for name in ("actor", "critic"):
            for a, b in zip(D.tree_leaves(getattr(r["state"], name)),
                            D.tree_leaves(getattr(off["state"], name))):
                if not torch.equal(a, b):
                    raise AssertionError(f"telemetry:train: final {name} "
                                         f"weights differ")
    each = spans.each["rounds"]           # two chunks of one round a run
    ms = [(a + b) / 1e3 for a, b in zip(each[::2], each[1::2])]
    print(f"  telemetry:train light/paper6 hidden=256 {TELE_PERIODS} "
          f"periods (cut from 10), rounds "
          f"of 8 and 2 episodes (2 updates) [{CARD}]: {len(recs)} valid "
          f"records; round metrics and actor/critic weights equal to the "
          f"run without --log-jsonl; lstm_cell launches={launches}; "
          f"sla_hist={[r['sla_hist'] for r in rounds]} replay_fill="
          f"{[r['replay_fill'] for r in rounds]} committed="
          f"{[r['committed'] for r in rounds]}; the two rounds' ms "
          f"off/on={'/'.join(f'{x:.1f}' for x in ms)}", flush=True)
    nums = {}
    for flag in (True, False):
        label = f"telemetry:train {'on' if flag else 'off'}"
        nums[flag] = train_trace_numbers(
            TELE_TRAIN_ARGS + ["--outdir", os.path.join(tmp, f"p{flag}"),
                               "--profile-dir", os.path.join(tmp, "trace")]
            + (["--log-jsonl", os.path.join(tmp, "prof.jsonl")]
               if flag else []), label, CARD)
        print(f"  {label} profiled [{CARD}]: ranges "
              f"{sorted(nums[flag]['names'])}; device-to-host copies a "
              f"round {nums[flag]['d2h']}", flush=True)
    scopes = {"relmas.trace_gen", "relmas.rollout", "relmas.ring_write",
              "relmas.ddpg_update"}
    if nums[True]["names"] != scopes | {"relmas.telemetry"} \
            or nums[False]["names"] != scopes:
        raise AssertionError(f"telemetry:train: ranges {nums}")
    if any(a > b for a, b in zip(nums[True]["d2h"], nums[False]["d2h"])) \
            or len(nums[True]["d2h"]) != 2:
        raise AssertionError("telemetry:train: telemetry added "
                             "device-to-host copies to a round")
    if metrics(nums[True]["res"]) != metrics(off):
        raise AssertionError("telemetry:train: the profiled run differs")


def read_log(outdir: str) -> list[dict]:
    with open(os.path.join(outdir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_lm_phase(CARD) -> int:
    """The LM training driver at full width with one injected failure
    (phase 36).  Returns the driver run's ``flash_attention`` launches
    (the profiled step after it is checked on its own, not counted)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch import train
    from repro_torch.models import LM, make_train_step
    cfg = get_arch(LM_ARCH)
    outdir = os.path.join(ROOT, "runs", "chip_smoke_lm_train")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    du = shutil.disk_usage(outdir)
    print(f"  train:lm disk free {du.free / 1e9:.1f} GB of "
          f"{du.total / 1e9:.1f} GB at {outdir}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        res = train.main(TR_ARGS + ["--outdir", outdir])
        torch.cuda.synchronize()
        launches = fa_ops.LAUNCHES
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        ckpt_gb = sum(os.path.getsize(os.path.join(outdir, "ckpt", f))
                      for f in os.listdir(os.path.join(outdir, "ckpt"))
                      ) / 1e9 / 2
        logs = read_log(outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    steps = [r["step"] for r in logs]
    want = list(range(TR_FAIL)) + list(range(TR_EVERY, TR_STEPS))
    if steps != want:
        raise AssertionError(f"train:lm: steps {steps}, expected {want} "
                             f"(a resume at step {TR_EVERY})")
    if res["restarts"] != 1 or len(res["restore_secs"]) != 1:
        raise AssertionError(f"train:lm: {res['restarts']} restarts, "
                             f"{len(res['restore_secs'])} restores")
    if not res["final_loss"] < res["first_loss"]:
        raise AssertionError(f"train:lm: final loss {res['final_loss']} "
                             f"not below the first {res['first_loss']}")
    if not all(np.isfinite([r["loss"], r["gnorm"]]).all() for r in logs):
        raise AssertionError("train:lm: a non-finite loss or gnorm")
    per_step = 2 * cfg.n_layers
    if launches != per_step * len(steps):
        raise AssertionError(f"train:lm: {launches} flash_attention "
                             f"launches for {len(steps)} steps, expected "
                             f"{per_step} a step")
    secs = [r["secs"] for r in logs[1:]]
    p50 = pct(secs, 50)
    TRAIN_LM_MEASURED.update(peak_gb=peak, p50_s=p50)
    t1 = time.perf_counter()
    model = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    bound_ms, by, tflop = train_bound(model, TR_B, TR_S)
    print(f"  train:lm {cfg.name} [{CARD}]: {model.param_count() / 1e9:.3f} "
          f"B parameters, {len(steps)} steps executed of {TR_STEPS} "
          f"(restart 1, resumed at {TR_EVERY}) in {wall:.1f}s; loss "
          f"{res['first_loss']:.4f} -> {res['final_loss']:.4f}; step "
          f"p50={p50 * 1e3:.1f}ms p99={pct(secs, 99) * 1e3:.1f}ms "
          f"(bound {bound_ms:.1f}ms by {by}, {tflop:.1f} TFLOP: "
          f"{bound_ms / (p50 * 1e3):.3f} of p50) tokens/s="
          f"{TR_B * TR_S / p50:.0f} peak_gb={peak:.2f} checkpoint "
          f"{ckpt_gb:.2f} GB save_s=" + "/".join(
              f"{x:.1f}" for x in res["save_secs"])
          + f" restore_s={res['restore_secs'][0]:.1f} flash launches="
          f"{launches} ({per_step} a step)", flush=True)

    # one more step, profiled, from the same weights
    step, opt = make_train_step(model, total_steps=TR_STEPS)
    params, state = model.params, opt.init(model.params)
    batch = {"tokens": torch.as_tensor(synthetic_batch(
        0, 0, TR_B, TR_S, cfg.vocab)).cuda()}
    fa_ops.LAUNCHES = 0

    def one():
        step(params, state, batch, 0)
    one()
    profile_window(one, "train:lm step", CARD, top=8,
                   share="flash_attention")
    if fa_ops.LAUNCHES != 2 * per_step:
        raise AssertionError(f"train:lm: the profiled steps launched "
                             f"{fa_ops.LAUNCHES} flash kernels")
    del params, state
    free(model)
    # the plain backward of one attention layer at the step's shape
    g = torch.Generator(device="cuda").manual_seed(5)
    q, do = (torch.randn((TR_B, cfg.n_heads, TR_S, cfg.head_dim),
                         generator=g, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((TR_B, cfg.n_kv, TR_S, cfg.head_dim), generator=g,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    bwd = cuda_ms(lambda: fa_ref.attention_chunked_vjp(q, k, v, do), 5, 1)
    print(f"  train:lm plain attention backward [{CARD}]: "
          f"{bwd:.3f} ms a layer at ({TR_B}, {cfg.n_heads}, {cfg.n_kv}, "
          f"{TR_S}, {cfg.head_dim}) bf16, x{cfg.n_layers} = "
          f"{bwd * cfg.n_layers:.1f} ms, share of the step p50 "
          f"{bwd * cfg.n_layers / (p50 * 1e3):.4f}; the profiled step and "
          f"this timing took {time.perf_counter() - t1:.1f}s", flush=True)
    return launches


def train_lm_parity_phase(CARD) -> None:
    """internlm2-1.8b cut to 2 layers in float32, 3 train steps on the
    card and on the CPU from the same weights and batches (phase 37)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic_batch
    from repro_torch.models import LM, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=2,
                              param_dtype="float32")
    gpu = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    cpu = LM(cfg, device="cpu")
    cpu.params = to_cpu(gpu.params)
    hist = {}
    for side, model in (("cuda", gpu), ("cpu", cpu)):
        step, opt = make_train_step(model, total_steps=100)
        params, state = model.params, opt.init(model.params)
        hist[side] = []
        t0 = time.perf_counter()
        for i in range(TP_STEPS):
            batch = {"tokens": torch.as_tensor(synthetic_batch(
                0, i, TP_B, TP_S, cfg.vocab)).to(model.device)}
            params, state, m = step(params, state, batch, i)
            hist[side].append(({k: float(v) for k, v in m.items()},
                               snapshot(params)))
        print(f"  train:lm_parity {side}: {TP_STEPS} steps in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    lrs, worst, pworst, pmean = 0.0, {}, 0.0, []
    for i, ((mg, pg), (mc, pc)) in enumerate(zip(hist["cuda"],
                                                 hist["cpu"])):
        for k, rtol in (("loss", 1e-4), ("gnorm", 1e-3)):
            err = abs(mg[k] - mc[k]) / abs(mc[k])
            worst[k] = max(worst.get(k, 0.0), err)
            if err > rtol:
                raise AssertionError(f"train:lm_parity: step {i} {k} "
                                     f"{mg[k]} on the card, {mc[k]} on "
                                     f"the CPU (rtol {rtol})")
        lrs += mc["lr"]
        for c, g in zip(tree_leaves(pc), tree_leaves(pg)):
            d = (c - g).abs()
            lim = 2 * lrs + 1e-5 * c.abs().max().item()
            pworst = max(pworst, d.max().item() / lim)
            pmean.append(d.mean().item())
            if d.max().item() > lim:
                raise AssertionError(f"train:lm_parity: step {i} "
                                     f"parameters {d.max().item():.3e} "
                                     f"apart (limit {lim:.3e})")
    print(f"  train:lm_parity {cfg.name} 2 layers float32, "
          f"{gpu.param_count() / 1e9:.3f} B parameters, {TP_STEPS} steps "
          f"of {TP_B} x {TP_S}, CPU vs [{CARD}]: loss "
          + " ".join(f"{h[0]['loss']:.6f}" for h in hist["cuda"])
          + f" (rel err max {worst['loss']:.2e}, rtol 1e-4) gnorm rel err "
          f"max {worst['gnorm']:.2e} (rtol 1e-3) params worst/limit="
          f"{pworst:.4f} mean |diff| {np.mean(pmean):.3e} (limit 2 lr "
          f"per update)", flush=True)
    free(gpu)


def train_lm_families_phase(CARD) -> tuple[int, int]:
    """3 train steps of four more families at full width (phase 38).
    Returns their (flash_attention, ssd_chunk) launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.models import make_train_step
    total = [0, 0]
    for arch, n_layers in TRAIN_FAMILIES:
        model = lm_from_seed(arch, n_layers)
        cfg = model.cfg
        kinds = [] if cfg.family == "encdec" else layer_kinds(cfg)
        n_attn = (cfg.enc_layers + 2 * cfg.n_layers if cfg.family ==
                  "encdec" else sum(m == "attn" for m, _ in kinds))
        n_ssm = sum(m == "ssm" for m, _ in kinds)
        S_txt = TF_S - (cfg.n_patches if cfg.family == "vlm" else 0)
        B = max(TF_B, cfg.grad_accum)          # internvl2: 4 microbatches
        gen = torch.Generator(device="cuda").manual_seed(7)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S_txt),
                                         generator=gen, device="cuda")}
        if cfg.family == "encdec":
            batch["frames"] = whisper_frames(cfg, B, 8, "cuda")
        if cfg.family == "vlm":
            batch["patches"] = vlm_patches(cfg, B, 8, "cuda")
        step, opt = make_train_step(model, total_steps=100)
        params, state = model.params, opt.init(model.params)
        torch.cuda.reset_peak_memory_stats()
        fa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
        losses, gnorms, ms = [], [], []
        for i in range(TF_STEPS):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch, i)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        got = (fa_ops.LAUNCHES, ssd_ops.LAUNCHES)
        runs = 2 * cfg.grad_accum * TF_STEPS   # forward + remat, each mb
        want = (n_attn * runs, n_ssm * runs)
        if got != want:
            raise AssertionError(f"train:lm_families {arch}: (flash, ssd) "
                                 f"launches {got}, expected {want}")
        if not np.isfinite(losses + gnorms).all():
            raise AssertionError(f"train:lm_families {arch}: losses "
                                 f"{losses}, gnorms {gnorms}")
        print(f"  train:lm_families {cfg.name} ({cfg.n_layers} layers, "
              f"{model.param_count() / 1e9:.3f} B parameters, "
              f"{cfg.param_dtype}) [{CARD}]: {TF_STEPS} steps of {B} x "
              f"{TF_S} positions in {cfg.grad_accum} microbatches: loss "
              + " ".join(
                  f"{x:.4f}" for x in losses) + " gnorm " + " ".join(
                  f"{x:.3f}" for x in gnorms) + " ms " + " ".join(
                  f"{x:.1f}" for x in ms) + f" peak_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} (flash, ssd) "
              f"launches {got}", flush=True)
        total[0] += got[0]
        total[1] += got[1]
        del params, state, batch
        free(model)
    return total[0], total[1]


def mesh_reference(cfg, ref_dir: str, steps: int, B: int, S: int,
                   serve: tuple, device: str = "cuda") -> dict:
    """The one-process run that mesh ranks are held to: ``steps`` train
    steps of B x S from seed 0 (their parameters saved to ``ref_dir``),
    then, with the trained weights, the prefill and greedy decode steps
    of ``serve`` = (batch, prompt, steps, pad_to) (whisper's frames, the
    VLM's patches drawn beside the tokens by ``train_batch``)."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.launch import train
    from repro_torch.models import (LM, make_decode_step, make_prefill_step,
                                    make_train_step)
    t0 = time.perf_counter()
    model = LM(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    step, opt = make_train_step(model, total_steps=100)
    params, state = model.params, opt.init(model.params)
    hist = []
    for i in range(steps):
        params, state, m = step(params, state, train.train_batch(
            cfg, 0, i, B, S, device), i)
        hist.append({k: float(v) for k, v in m.items()})
    if device == "cuda":
        torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    del state
    save_checkpoint(ref_dir, 0, {"params": params})
    model.params = params
    sb, ss, dec, pad = serve
    batch = train.train_batch(cfg, 1, 0, sb, ss, device)
    out = train.greedy_decode(make_prefill_step(model, pad_to=pad),
                              make_decode_step(model), batch.pop("tokens"),
                              dec, batch)
    out.pop("cache")
    n_params = model.param_count()
    free(model)
    return dict(hist=hist, serve=out, step_s=step_s, n_params=n_params,
                secs=time.perf_counter() - t0)


def lm_mesh_reference(cfg, ref_dir: str) -> dict:
    """The one-process run on the card that the mesh ranks are held to
    (:func:`mesh_reference` at LMM's sizes); also holds
    ``flash_attention`` and ``decode_gqa`` against their plain versions
    at every head-shard shape the meshes give them."""
    ref = mesh_reference(cfg, ref_dir, LMM_STEPS, LMM_B, LMM_S,
                         (LMM_B, LMM_S, LMM_DEC, LMM_PAD))
    ref["kernels"] = lm_mesh_kernel_checks(cfg)
    return ref


def lm_mesh_kernel_checks(cfg) -> list:
    """Each kernel at every (data, model) split of LMM_MESHES and
    LMM_NCCL_MESH: a rank's q heads against its kv heads (handed over by
    ``head_shards.kv_heads_for``, replicated kv too) on its batch rows,
    against the plain version on the same inputs."""
    from repro_torch.kernels import head_shards as HS
    from repro_torch.kernels.decode_gqa import ops as dec_ops
    from repro_torch.kernels.decode_gqa import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    g = torch.Generator(device="cuda").manual_seed(9)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.head_dim
    out = []
    before = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    for dp, tp in sorted(set(LMM_MESHES + (LMM_NCCL_MESH, (1, 16)))):
        B, hq = LMM_B // dp, Hq // tp
        hkv = Hkv // tp if Hkv % tp == 0 else Hkv
        for r in range(0, tp, max(1, tp // 2)):
            j0, k0 = r * hq, (r * hkv if Hkv % tp == 0 else 0)
            q = torch.randn((B, hq, LMM_S, D), generator=g, device="cuda")
            k, v = (torch.randn((B, hkv, LMM_S, D), generator=g,
                                device="cuda") for _ in range(2))
            ks, grp = HS.kv_heads_for(k, j0, hq, Hq // Hkv, k0)
            vs, _ = HS.kv_heads_for(v, j0, hq, Hq // Hkv, k0)
            got = fa_ops.flash_attention(q, ks, vs, causal=True)
            idx = (torch.arange(j0, j0 + hq, device="cuda")
                   // (Hq // Hkv)) - k0
            want = fa_ref.attention_chunked(q, k[:, idx], v[:, idx],
                                            causal=True)
            err = (got - want).abs().max().item()
            qd = torch.randn((B, hq, 1, D), generator=g, device="cuda")
            length = torch.full((B,), LMM_PAD - 3, dtype=torch.int32,
                                device="cuda")
            kc, vc = (torch.randn((B, hkv, LMM_PAD, D), generator=g,
                                  device="cuda") for _ in range(2))
            kcs, _ = HS.kv_heads_for(kc, j0, hq, Hq // Hkv, k0)
            vcs, _ = HS.kv_heads_for(vc, j0, hq, Hq // Hkv, k0)
            dgot = dec_ops.decode_attention(qd, kcs, vcs, length)
            dwant = dec_ref.decode_attention_ref(qd, kc[:, idx], vc[:, idx],
                                                 length)
            derr = (dgot - dwant).abs().max().item()
            out.append(dict(mesh=(dp, tp), rank=r, q=(B, hq), kv=hkv,
                            group=grp, flash_err=err, decode_err=derr))
            if (dp, tp) == LMM_MESHES[-1] and r == 0:
                # the head-split mesh's shard shapes, timed (the kernels'
                # own float32 route), beside the plain versions
                out[-1]["ms"] = {
                    "flash": cuda_ms(lambda: fa_ops.flash_attention(
                        q, ks, vs, causal=True), 10),
                    "flash_plain": cuda_ms(lambda: fa_ref.attention_chunked(
                        q, k[:, idx], v[:, idx], causal=True), 3),
                    "decode": cuda_ms(lambda: dec_ops.decode_attention(
                        qd, kcs, vcs, length), 20),
                    "decode_plain": cuda_ms(
                        lambda: dec_ref.decode_attention_ref(
                            qd, kc[:, idx], vc[:, idx], length), 5)}
            if err > TOL or derr > TOL:
                raise AssertionError(f"train:lm_mesh: a shard's kernel "
                                     f"differs from its plain version: "
                                     f"{out[-1]}")
    # these checks are comparisons, not the main path's launches
    fa_ops.LAUNCHES, dec_ops.LAUNCHES = before
    return out


def lm_mesh_jobs(ref_dir: str, meshes, tmp: str) -> list:
    """The rank jobs: the train steps on each mesh against the
    reference; the first mesh's state saved and restored onto the
    second (elastic); the prefill and decode on the last mesh."""
    base = dict(arch=LM_ARCH, n_layers=LMM_LAYERS, param_dtype="float32",
                seed=0, device="cuda")
    train_ = dict(steps=LMM_STEPS, batch=LMM_B, seq=LMM_S, total_steps=100,
                  ref=ref_dir)
    jobs = [dict(base, mesh=m, train=train_) for m in meshes]
    jobs[0]["elastic"] = dict(dir=os.path.join(tmp, "elastic"),
                              meshes=[meshes[-1]], state=False)
    jobs[-1]["serve"] = dict(batch=LMM_B, seq=LMM_S, steps=LMM_DEC,
                             pad_to=LMM_PAD)
    return jobs


def check_lm_mesh(label, ref, ranks, CARD,
                  serve_shape=(LMM_B, LMM_S, LMM_DEC)) -> dict:
    """The ranks' jobs against the one-process run: loss and gnorm within
    rtol 1e-4 a step, every parameter within 2 lr per step taken (plus
    1e-5 of its largest value), the elastic restore bit-equal, the
    greedy tokens equal and the logits within LM_F32_TOL.  Prints each
    leaf's local shape against its placements.  Returns the launches of
    all ranks by kernel."""
    lrs = sum(h["lr"] for h in ref["hist"])
    launches = {"flash_attention": 0, "decode_gqa": 0, "ssd_chunk": 0}
    for j, job in enumerate(ranks[0]):
        mesh = job["mesh"]
        for r, rk in enumerate(ranks):
            res = rk[j]
            if res["loaded"]:
                raise AssertionError(f"{label}: rank {r} imported "
                                     f"{res['loaded']}")
            for i, (h, w) in enumerate(zip(res["train"], ref["hist"])):
                for k in ("loss", "gnorm"):
                    if abs(h[k] - w[k]) > 1e-4 * abs(w[k]):
                        raise AssertionError(
                            f"{label} {mesh}: rank {r} step {i} {k} "
                            f"{h[k]} against {w[k]} (rtol 1e-4)")
            worst, leaf = max((v["max_diff"] / (2 * lrs + 1e-5
                                                * v["max_ref"]), k)
                              for k, v in res["params"].items())
            if worst > 1:
                raise AssertionError(f"{label} {mesh}: rank {r}'s "
                                     f"parameters {worst:.3f} of the limit")
            for kind, n in res["launches"].items():
                for k in launches:
                    launches[k] += n[k]
            print(f"  {label} {mesh} rank {r} [{CARD}]: loss "
                  + " ".join(f"{h['loss']:.6f}" for h in res["train"])
                  + " gnorm " + " ".join(f"{h['gnorm']:.4f}"
                                          for h in res["train"])
                  + f" params worst/limit={worst:.4f} ({leaf}) launches="
                  f"{res['launches']} peak_gb={res['peak_gb'] or 0:.2f} job "
                  f"{res['secs']:.1f}s (" + " ".join(
                      f"{k} {v:.1f}" for k, v in res["laps"].items())
                  + ")", flush=True)
        leaves = ranks[0][j]["params"]
        print(f"  {label} {mesh} local shapes [{CARD}]: " + "; ".join(
            f"{k} {v['shape']}->{v['local']} {v['placements']}"
            for k, v in leaves.items()), flush=True)
        for r, rk in enumerate(ranks):
            for el in rk[j].get("elastic") or ():
                if not el["equal"]:
                    raise AssertionError(f"{label}: rank {r}'s restore "
                                         f"onto {el['mesh']} differs")
        for el in ranks[0][j].get("elastic") or ():
            print(f"  {label} elastic [{CARD}]: parameters saved on "
                  f"{mesh}, reshard_restore onto {el['mesh']}: "
                  f"{el['leaves']} "
                  f"leaves bit-equal on every rank", flush=True)
        got = ranks[0][j].get("serve")
        if got is not None:
            want = ref["serve"]
            if not np.array_equal(got["tokens"], want["tokens"]):
                raise AssertionError(f"{label} {mesh}: greedy tokens "
                                     f"differ from the one-process run")
            diff = np.abs(got["logits"] - want["logits"])
            lim = LM_F32_TOL["atol"] + LM_F32_TOL["rtol"] * np.abs(
                want["logits"])
            if (diff > lim).any() or diff.mean() > LM_F32_TOL["mean"]:
                at = np.unravel_index(np.argmax(diff / lim), diff.shape)
                raise AssertionError(
                    f"{label} {mesh}: logits {diff.max():.3e} apart (mean "
                    f"{diff.mean():.3e}; the worst against its limit at "
                    f"step {at[0]}, row {at[1]}, column {at[2]}: "
                    f"{got['logits'][at]:.6f} for {want['logits'][at]:.6f}"
                    f"; max a step "
                    + " ".join(f"{d:.2e}" for d in diff.max(axis=(1, 2)))
                    + "; max |logit| a step " + " ".join(
                        f"{m:.2f}" for m in np.abs(want["logits"]).max(
                            axis=(1, 2))) + ")")
            cache = ranks[0][j]["cache"]
            print(f"  {label} {mesh} prefill {serve_shape[0]} x "
                  f"{serve_shape[1]} + {serve_shape[2]} "
                  f"greedy steps [{CARD}]: tokens equal to the one-process "
                  f"run, logits max_abs_err {diff.max():.3e} mean "
                  f"{diff.mean():.3e} (tol {LM_F32_TOL}; max a step, the "
                  f"prefill's first: " + " ".join(
                      f"{d:.2e}" for d in diff.max(axis=(1, 2)))
                  + f"; max |logit| {np.abs(want['logits']).max():.2f}); "
                  f"cache " + "; ".join(
                      f"{k} {v['shape']}->{v['local']} {v['placements']}"
                      for k, v in cache.items()), flush=True)
    return launches


def lm_mesh_run(label: str, meshes, backend: str, CARD) -> dict:
    """The one-process reference, then one spawn of ranks (gloo sharing
    the card, or NCCL a card each) running the jobs of ``meshes``, held
    to it.  Returns the ranks' launches by kernel."""
    from repro_torch.launch import rl_train
    from repro_torch.launch import train
    cfg = train.mesh_config(LM_ARCH, n_layers=LMM_LAYERS,
                            param_dtype="float32")
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lm_mesh-", dir=os.path.join(ROOT, "runs"))
    ref_dir = os.path.join(tmp, "ref")
    try:
        ref = lm_mesh_reference(cfg, ref_dir)
        print(f"  {label} one process [{CARD}]: {cfg.name} "
              f"{cfg.n_layers} layers float32, {LMM_STEPS} steps of {LMM_B} "
              f"x {LMM_S}: loss " + " ".join(
                  f"{h['loss']:.6f}" for h in ref["hist"])
              + f"; step {ref['step_s'] * 1e3:.1f} ms; with the serve "
              f"steps and the saves {ref['secs']:.1f}s; shard kernels: "
              + "; ".join(f"{k['mesh']} r{k['rank']} q{k['q']} kv{k['kv']} "
                          f"g{k['group']} flash {k['flash_err']:.2e} decode "
                          f"{k['decode_err']:.2e}" + "".join(
                              f" {n}_ms {v:.4f}" for n, v in
                              k.get("ms", {}).items())
                          for k in ref["kernels"]), flush=True)
        n = meshes[0][0] * meshes[0][1]
        t0 = time.perf_counter()
        ranks = rl_train.spawn_ranks(train.mesh_steps_rank, n,
                                     lm_mesh_jobs(ref_dir, meshes, tmp),
                                     device="cuda", backend=backend,
                                     timeout=RANK_TIMEOUT_S)
        print(f"  {label} {n} ranks over {backend}: spawn to join "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        return check_lm_mesh(label, ref, ranks, CARD)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_lm_mesh_phase(CARD) -> dict:
    """internlm2-1.8b (full width, 2 layers, float32) on 2 ranks sharing
    the card over gloo (phase 43): train steps on a (2, 1) and a (1, 2)
    mesh, the elastic restore between them, prefill and decode on (1, 2),
    against the one-process run on the card.  Returns the ranks'
    launches by kernel."""
    return lm_mesh_run("train:lm_mesh", LMM_MESHES, "gloo", CARD)


def train_lm_mesh_nccl_phase(CARD) -> dict:
    """With four cards, the same on a (2, 2) mesh over NCCL, a card a
    rank, restored onto (4, 1) (phase 44); with fewer, a line that says
    so."""
    n = torch.cuda.device_count()
    need = LMM_NCCL_MESH[0] * LMM_NCCL_MESH[1]
    if n < need:
        print(f"  train:lm_mesh_nccl [{CARD}]: {n} card, too few for "
              f"{need} NCCL ranks: not run", flush=True)
        return {"flash_attention": 0, "decode_gqa": 0, "ssd_chunk": 0}
    return lm_mesh_run("train:lm_mesh_nccl", (LMM_NCCL_MESH, (need, 1)),
                       "nccl", CARD)

def families_shard_shapes(cfgs) -> dict:
    """The shapes phase 47 gives each kernel, drawn from its configs
    (the configs of FAMILIES_MESH) and sizes (FM_*): on every (data,
    model) split of FM_MESHES and in the one-process run, a rank's rows
    and heads in the train steps (FM_B x FM_S), the prefill (FM_SB x
    FM_SS, after the VLM's patches) and the decode steps (the cache
    padded to FM_PAD; whisper's cross cache of its frames).  By kernel:
    flash_attention (B, Hq, Hkv, Sq, Sk, D, causal, window, dtype),
    decode_gqa (B, Hq, Hkv, S, D, dtype), ssd_chunk (BC, C, N, H, P),
    as the wrappers record their launches (``ops.SHAPES``)."""
    import math

    from repro_torch.models.ssm import ssm_dims
    out = {"flash_attention": set(), "decode_gqa": set(), "ssd_chunk": set()}
    for cfg in cfgs:
        dt = str(getattr(torch, cfg.param_dtype))[6:]
        attn = cfg.family != "ssm"
        ssm = cfg.family in ("ssm", "hybrid")
        for dp, tp in ((1, 1),) + FM_MESHES:
            if attn:
                if cfg.n_heads % tp or cfg.n_kv % tp:
                    raise ValueError(f"{cfg.name}: heads {cfg.n_heads} / "
                                     f"{cfg.n_kv} do not split over {tp}")
                hq, hkv, D = cfg.n_heads // tp, cfg.n_kv // tp, cfg.head_dim
            for b, S in ((FM_B // dp, FM_S), (FM_SB // dp, FM_SS)):
                S += cfg.n_patches
                if attn:
                    out["flash_attention"].add(
                        (b, hq, hkv, S, S, D, True, cfg.window, dt))
                if cfg.family == "encdec":
                    F_ = cfg.n_frames
                    out["flash_attention"] |= {
                        (b, hq, hq, F_, F_, D, False, 0, dt),
                        (b, hq, hq, S, F_, D, False, 0, dt)}
                if ssm:
                    _, H, _ = ssm_dims(cfg.d_model, cfg.ssm_expand,
                                       cfg.ssm_headdim, cfg.ssm_state)
                    out["ssd_chunk"].add(
                        (b * math.ceil(S / cfg.ssd_chunk), cfg.ssd_chunk,
                         cfg.ssm_state, H // tp, cfg.ssm_headdim))
            if attn:
                out["decode_gqa"].add((FM_SB // dp, hq, hkv, FM_PAD, D, dt))
                if cfg.family == "encdec":
                    out["decode_gqa"].add((FM_SB // dp, hq, hq, cfg.n_frames,
                                           D, dt))
    return {k: sorted(v) for k, v in out.items()}


def families_kernel_checks(shapes: dict, CARD) -> None:
    """``check_flash``, ``check_decode`` (at full and ragged lengths)
    and ``check_ssd`` at every shape of :func:`families_shard_shapes`.
    These launches are comparisons, not the main path's: the counters
    and shape records are put back after."""
    from repro_torch.kernels.decode_gqa import ops as dec_ops
    from repro_torch.kernels.decode_gqa import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.ssd_chunk import ref as ssd_ref
    mods = (fa_ops, dec_ops, ssd_ops)
    saved = [(m.LAUNCHES, set(m.SHAPES)) for m in mods]
    check_flash(fa_ops, fa_ref, CARD, [
        x[:8] + (getattr(torch, x[8]),) for x in shapes["flash_attention"]])
    check_decode(dec_ops, dec_ref, CARD, [
        x[:5] + (n, getattr(torch, x[5])) for x in shapes["decode_gqa"]
        for n in ("full", "ragged")])
    check_ssd(ssd_ops, ssd_ref, CARD, shapes["ssd_chunk"])
    for m, (n, sh) in zip(mods, saved):
        m.LAUNCHES, m.SHAPES = n, sh


def uncovered(seen: dict, checked: dict) -> dict:
    """The launch shapes in ``seen`` (by kernel) that ``checked`` does not
    hold."""
    out = {}
    for k, v in seen.items():
        miss = sorted(set(map(tuple, v)) - set(map(tuple, checked[k])))
        if miss:
            out[k] = miss
    return out


def train_families_mesh_phase(CARD, device: str = "cuda") -> dict:
    """Every family's steps on a (data, model) mesh (phase 47): each
    kernel at every shape the phase gives it (:func:`families_shard_shapes`)
    against its plain version first (on the card), then each family of
    FAMILIES_MESH one process on the card, then one spawn of 2
    ranks sharing the card over gloo running every family on (2, 1) and
    on (1, 2) (``launch.train.mesh_steps_rank``: DTensor parameters,
    moments, batch and caches; the loss on each rank's vocab block, the
    MoE dispatch on its rows, the SSD and the attention on its heads),
    each held to its family's one-process run as train:lm_mesh holds
    internlm2, and every shape the one-process runs and the ranks
    launched a kernel at must be one of those checked (``device`` "cpu"
    rehearses it without a card, gloo ranks on the CPU, no kernel).
    Returns the ranks' launches by kernel."""
    from repro_torch.launch import rl_train
    from repro_torch.launch import train
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="families_mesh-",
                           dir=os.path.join(ROOT, "runs"))
    try:
        cfgs = [train.mesh_config(arch, **cut) for arch, cut in FAMILIES_MESH]
        shapes = families_shard_shapes(cfgs)
        print(f"  train:families_mesh shard shapes: " + "; ".join(
            f"{k} {len(v)}: {v}" for k, v in shapes.items()), flush=True)
        if device == "cuda":
            families_kernel_checks(shapes, CARD)
        train._launch_shapes(clear=True)
        refs, jobs = {}, []
        for (arch, cut), cfg in zip(FAMILIES_MESH, cfgs):
            ref_dir = os.path.join(tmp, arch)
            ref = refs[arch] = mesh_reference(
                cfg, ref_dir, FM_STEPS, FM_B, FM_S,
                (FM_SB, FM_SS, FM_DEC, FM_PAD), device)
            print(f"  train:families_mesh {arch} one process [{CARD}]: "
                  f"{cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
                  f"{cfg.param_dtype} ({ref['n_params'] / 1e9:.3f} B "
                  f"parameters), {FM_STEPS} steps of {FM_B} x {FM_S}: loss "
                  + " ".join(f"{h['loss']:.6f}" for h in ref["hist"])
                  + " gnorm " + " ".join(f"{h['gnorm']:.4f}"
                                          for h in ref["hist"])
                  + f"; step {ref['step_s'] * 1e3:.1f} ms (the first "
                  f"included); with the serve steps and the save "
                  f"{ref['secs']:.1f}s", flush=True)
            jobs += [dict(arch=arch, seed=0, device=device, mesh=m, **cut,
                          train=dict(steps=FM_STEPS, batch=FM_B, seq=FM_S,
                                     total_steps=100, ref=ref_dir),
                          serve=dict(batch=FM_SB, seq=FM_SS, steps=FM_DEC,
                                     pad_to=FM_PAD))
                     for m in FM_MESHES]
        seen = {k: set(v) for k, v in train._launch_shapes(clear=True).items()}
        t0 = time.perf_counter()
        ranks = rl_train.spawn_ranks(train.mesh_steps_rank, 2, jobs,
                                     device=device, backend="gloo",
                                     timeout=FM_RANK_TIMEOUT_S)
        print(f"  train:families_mesh 2 ranks over gloo: {len(jobs)} jobs, "
              f"spawn to join {time.perf_counter() - t0:.1f}s", flush=True)
        for rk in ranks:
            for res in rk:
                for k, v in res["shapes"].items():
                    seen[k] |= set(map(tuple, v))
        miss = uncovered(seen, shapes)
        print(f"  train:families_mesh launch shapes (one process and "
              f"ranks): " + ", ".join(f"{k} {len(v)}" for k, v in
                                      seen.items())
              + f"; not among the checked: {miss or 'none'}", flush=True)
        if miss:
            raise AssertionError(f"train:families_mesh: kernels launched at "
                                 f"shapes not held to their plain versions:"
                                 f" {miss}")
        launches = {"flash_attention": 0, "decode_gqa": 0, "ssd_chunk": 0}
        n = len(FM_MESHES)
        for i, (arch, _) in enumerate(FAMILIES_MESH):
            got = check_lm_mesh(f"train:families_mesh {arch}", refs[arch],
                                [rk[i * n:(i + 1) * n] for rk in ranks],
                                CARD, serve_shape=(FM_SB, FM_SS, FM_DEC))
            for k in launches:
                launches[k] += got[k]
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the dry run's drivers, each in a process of its own (the fake process
# group is process-global): the argv lists come as JSON in argv[1]; the
# last line is a JSON object of the kernels' launches and the card's
# allocations after FakeTensorMode's CUDA context (dryrun.settle_fake_cuda)
DRY_DRIVER = """
import json, sys, time
t_start = time.perf_counter()
import torch
from repro_torch.launch import dryrun as D
D.init_fake_group(512)
context = D.settle_fake_cuda()
rc = 0
for argv in json.loads(sys.argv[1]):
    rc |= D.main(argv + ["--device", "cuda", "--out", sys.argv[2]])
print(json.dumps({"launches": D._launches(), "context": context,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "secs": time.perf_counter() - t_start}))
sys.exit(rc)
"""
DRY_CHECK_DRIVER = """
import json, sys, time
t_start = time.perf_counter()
import torch
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as HA
D.init_fake_group(1)
context = D.settle_fake_cuda()
mesh = D._mesh_from_shape("1x1", "cuda")
B, S = int(sys.argv[2]), int(sys.argv[3])
t0 = time.perf_counter()
tr = D.trace_cfg_cell(get_arch(sys.argv[1]), ShapeSpec("train_lm", "train",
                      S, B), mesh, device="cuda")
print(json.dumps({"cost": tr.cost, "mem": tr.mem,
                  "terms": HA.roofline_terms(tr.cost, tr.coll, 1),
                  "flops_by_op": tr.aux["flops_by_op"],
                  "trace_s": time.perf_counter() - t0,
                  "launches": D._launches(), "context": context,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "secs": time.perf_counter() - t_start}))
"""
# the dry-run subprocesses running, by label: (process, start time)
DRY_PROCS: dict = {}


# phase 45's JSONL files, one a group of DRY_PRODUCTION, in order
DRY_OUTS: list = []


def dry_start(label: str, code: str, args: list) -> None:
    """Start ``code`` (a dry-run driver) in a process of its own with the
    repo's ``src`` on the path, at a lower priority than this one (it
    runs beside the phases on the card)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    DRY_PROCS[label] = (subprocess.Popen(
        [sys.executable, "-c", code, *args], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=lambda: os.nice(10)), time.perf_counter())


def dry_start_all() -> None:
    """Start phase 46's subprocess and phase 45's, side by side."""
    tmp = tempfile.mkdtemp()
    dry_start("dryrun:check", DRY_CHECK_DRIVER,
              [LM_ARCH, str(TR_B), str(TR_S)])
    for i, group in enumerate(DRY_PRODUCTION):
        DRY_OUTS.append(os.path.join(tmp, f"dryrun{i}.jsonl"))
        dry_start(f"dryrun:production[{i}]", DRY_DRIVER,
                  [json.dumps(group), DRY_OUTS[-1]])


def dry_finish(label: str) -> tuple[str, dict]:
    """Wait for the subprocess ``label`` (its timeout counted from its
    start); -> (its output, its last line as JSON).  A non-zero exit, an
    allocation on the card or a kernel launch fails."""
    proc, t0 = DRY_PROCS.pop(label)
    left = DRY_TIMEOUT_S - (time.perf_counter() - t0)
    try:
        out, err = proc.communicate(timeout=max(left, 1))
    except subprocess.TimeoutExpired as e:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{label}: the dry run took over "
                             f"{DRY_TIMEOUT_S}s") from e
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    last = json.loads(out.strip().splitlines()[-1])
    if any(last["launches"].values()) or last["max_memory_allocated"]:
        raise AssertionError(f"{label}: the dry run launched "
                             f"{last['launches']} and allocated "
                             f"{last['max_memory_allocated']} B")
    print(f"  {label}: subprocess ran {last['secs']:.1f}s (read "
          f"{time.perf_counter() - t0:.1f}s after its start), kernel "
          f"launches {last['launches']}, max_memory_allocated "
          f"{last['max_memory_allocated']} B (FakeTensorMode's CUDA "
          f"context before it: {last['context']} B, freed)", flush=True)
    return out, last


def dry_kill() -> None:
    """Stop every dry-run subprocess still running."""
    while DRY_PROCS:
        proc, _ = DRY_PROCS.pop(next(iter(DRY_PROCS)))
        proc.kill()
        proc.communicate()


def dry_print(rec: dict, CARD) -> None:
    terms = rec.get("roofline", rec.get("roofline_raw", {}))
    coll = terms.get("coll_by_op", terms.get("collectives", {}).get("by_op"))
    print(f"  dryrun {rec['arch']} x {rec['shape']} mesh={rec['mesh']} "
          f"[{CARD}]: ok={rec['ok']} trace {rec.get('trace_s')}s"
          f" roofline {rec.get('roofline_s', '-')}s", flush=True)
    if not rec["ok"]:
        print(f"    error: {rec['error']}", flush=True)
        return
    print(f"    memory {json.dumps(rec['mem'])}", flush=True)
    print(f"    terms ({'cost modules' if 'roofline' in rec else 'traced'})"
          f": compute {terms['t_compute_s']:.6g}s memory "
          f"{terms['t_memory_s']:.6g}s collective "
          f"{terms['t_collective_s']:.6g}s dominant={terms['dominant']}; "
          f"flops/chip {terms['flops_per_chip']:.6g} bytes/chip "
          f"{terms['bytes_per_chip']:.6g}; collectives {json.dumps(coll)} "
          f"counts {json.dumps(rec['roofline_raw']['collectives']['counts'])}"
          + (f"; n_params {rec['n_params']} n_active {rec['n_active']} "
             f"model_flops {rec['model_flops']:.6g} useful_flop_ratio "
             f"{rec['useful_flop_ratio']:.4f}" if "n_params" in rec else ""),
          flush=True)


def dryrun_production_phase(CARD) -> None:
    """The dry run of the production meshes (phase 45): each group of
    cells in a subprocess of its own, side by side (and phase 46's,
    started with them; ``main`` starts them all before phase 36); every
    cell ok, nothing allocated on the card, no kernel launched."""
    if not DRY_OUTS:
        dry_start_all()
    try:
        recs = []
        for i, out in enumerate(DRY_OUTS):
            dry_finish(f"dryrun:production[{i}]")
            with open(out) as f:
                recs += [json.loads(line) for line in f]
    except BaseException:
        dry_kill()
        raise
    finally:
        shutil.rmtree(os.path.dirname(DRY_OUTS[0]), ignore_errors=True)
    for rec in recs:
        dry_print(rec, CARD)
    want = sum(len(group) for group in DRY_PRODUCTION)
    failed = [(r["arch"], r["shape"], r.get("error")) for r in recs
              if not r["ok"]]
    if len(recs) != want or failed:
        dry_kill()
        raise AssertionError(f"dryrun:production: {len(recs)} records of "
                             f"{want}, failed: {failed}")
    # the loss on each rank's vocab block (C1's repair) against the
    # records of the loss that held the global batch's logits gradient
    cell = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    il = cell[LM_ARCH, "train_4k", "16x16"]["mem"]
    gb = il["per_chip_total_bytes"] / 1e9
    fall = DRY_GLOBAL_LOSS["internlm2_gb"] - gb
    llama = cell["llama3-405b", "train_4k", "16x16"]["mem"]
    print(f"  dryrun:production C1 [{CARD}]: {LM_ARCH} train_4k 16x16 "
          f"per_chip_total {gb:.3f} GB (temp "
          f"{il['temp_size_in_bytes'] / 1e9:.3f} GB) fits_80GB_hbm="
          f"{il['fits_80GB_hbm']}, {fall:.1f} GB below the "
          f"{DRY_GLOBAL_LOSS['internlm2_gb']} GB of the loss on global "
          f"rows (its buffer {DRY_GLOBAL_LOSS['loss_buffer_gb']} GB); "
          f"llama3-405b train_4k 16x16 "
          f"{llama['per_chip_total_bytes'] / 1e9:.3f} GB (then "
          f"{DRY_GLOBAL_LOSS['llama3_gb']} GB) fits_80GB_hbm="
          f"{llama['fits_80GB_hbm']}", flush=True)
    if not il["fits_80GB_hbm"] or \
            fall < DRY_GLOBAL_LOSS["loss_buffer_gb"]:
        raise AssertionError(f"dryrun:production: {LM_ARCH} train_4k "
                             f"needs {gb:.3f} GB a chip")


def dryrun_check_phase(CARD) -> None:
    """The dry run held against the card (phase 46): train:lm's step on
    a 1x1 mesh; its memory within DRY_MEM_TOL of train:lm's measured
    peak, its FLOPs and compute term beside train:lm's bound and p50."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import param_specs
    from repro_torch.models import LM
    if "dryrun:check" not in DRY_PROCS:         # run without phase 45
        dry_start("dryrun:check", DRY_CHECK_DRIVER,
                  [LM_ARCH, str(TR_B), str(TR_S)])
    _, got = dry_finish("dryrun:check")
    model = LM(get_arch(LM_ARCH), device="cpu")
    model.params = param_specs(model.cfg)       # fake: shapes only
    bound_ms, _, bound_tflop = train_bound(model, TR_B, TR_S)
    flops = got["cost"]["flops"]
    est = got["mem"]["per_chip_total_bytes"] / 1e9
    top = sorted(got["flops_by_op"].items(), key=lambda kv: -kv[1])[:6]
    t_compute = got["terms"]["t_compute_s"]
    print(f"  dryrun:check {LM_ARCH} train {TR_B} x {TR_S} mesh=1x1 "
          f"[{CARD}]: traced in {got['trace_s']:.1f}s; flops {flops / 1e12:.3f} TFLOP ("
          + ", ".join(f"{k} {v / 1e12:.3f}" for k, v in top)
          + f"); train_bound's {bound_tflop:.1f} TFLOP ({bound_ms:.1f} "
          f"ms): ratio {flops / 1e12 / bound_tflop:.4f}; bytes "
          f"{got['cost']['bytes accessed'] / 1e9:.3f} GB; memory "
          f"{json.dumps(got['mem'])}; t_compute {t_compute * 1e3:.2f} ms, "
          f"t_memory {got['terms']['t_memory_s'] * 1e3:.2f} ms", flush=True)
    if not TRAIN_LM_MEASURED:
        print("  dryrun:check: train:lm did not run here; no peak to hold "
              "the memory to", flush=True)
        return
    peak, p50 = TRAIN_LM_MEASURED["peak_gb"], TRAIN_LM_MEASURED["p50_s"]
    print(f"  dryrun:check [{CARD}]: per_chip_total {est:.3f} GB against "
          f"train:lm's peak {peak:.3f} GB (ratio {est / peak:.4f}); "
          f"t_compute {t_compute * 1e3:.2f} ms against "
          f"train:lm's step p50 {p50 * 1e3:.1f} ms", flush=True)
    if abs(est / peak - 1) > DRY_MEM_TOL:
        raise AssertionError(f"dryrun:check: the estimate {est:.3f} GB is "
                             f"not within {DRY_MEM_TOL:.0%} of the "
                             f"measured peak {peak:.3f} GB")



# the RELMAS training phases run in two child processes of this script
# (``chip_smoke.py --rl-group NAME FILE``) beside the LM serving phases
# (8-14, 25-35): "relmas" runs phases 16-22 and 24, "sharded" phases
# 39-42 and 48.  All three are mostly host-bound, and the card and the host's
# cores have room for them side by side.  A third child, "families",
# runs phase 47 beside the LM training tail (36-37, 43-44), whose card
# memory leaves it room once phase 38 (71 GB) has run.  Each child's
# console goes to a file, printed when it ends
RL_GROUP_TIMEOUT_S = 600
RL_GROUPS: dict = {}


def rl_group(name: str, out_path: str) -> int:
    """A child's entry: the group ``name``'s phases in order.  Writes the
    kernel launches of their main paths (``lstm_cell``: train:rl_train's
    driver, the sharded ranks, legacy:runners' episode, updates and
    quickstart; ``lstm_seq``: legacy:runners' sequence route; the
    attention and SSD kernels: the families' mesh ranks) and its seconds
    to ``out_path`` as JSON."""
    t0 = time.perf_counter()
    from repro_torch.kernels.lstm_seq import ops
    from repro_torch.launch import serve as serve_cli
    CARD = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name == "relmas":
        with phase("train:rl_train"):
            launches = rl_train_phase(CARD)
        with phase("train:parity"):
            train_parity_phase(CARD)
        with phase("telemetry:train"):
            telemetry_train_phase(CARD)
        with phase("baseline:magma"):
            magma_phase(CARD)
        with phase("train:churn"):
            train_churn_phase(CARD)
        with phase("train:generalist"):
            gen_ckpt = train_generalist_phase(CARD)
        with phase("serve:generalist"):
            serve_generalist_phase(serve_cli, ops, gen_ckpt, CARD)
        with phase("generalist:parity"):
            generalist_parity_phase(CARD)
    elif name == "sharded":
        with phase("train:sharded"):
            train_sharded_phase(CARD)
        with phase("train:sharded_ranks"):
            launches = train_sharded_ranks_phase(CARD)
        with phase("train:sharded_nccl"):
            launches += train_sharded_nccl_phase(CARD)
        with phase("train:sharded_driver"):
            train_sharded_driver_phase(CARD)
        with phase("legacy:runners"):
            legacy = legacy_runners_phase(CARD)
        launches = {"lstm_cell": launches + legacy["lstm_cell"],
                    "lstm_seq": legacy["lstm_seq"]}
    elif name == "families":
        with phase("train:families_mesh"):
            launches = train_families_mesh_phase(CARD)
    else:
        raise ValueError(f"no group {name!r}")
    if not isinstance(launches, dict):
        launches = {"lstm_cell": launches}
    with open(out_path, "w") as f:
        json.dump({"launches": launches,
                   "secs": time.perf_counter() - t0}, f)
    return 0


def rl_group_start(name: str, beside: str = "the LM serving phases"
                   ) -> None:
    """Start the child of group ``name`` in a session of its own (so
    its ranks stop with it)."""
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"rl_group_{name}-",
                           dir=os.path.join(ROOT, "runs"))
    log = open(os.path.join(tmp, "console.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rl-group", name,
         os.path.join(tmp, "launches.json")], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    RL_GROUPS[name] = dict(proc=proc, tmp=tmp, log=log,
                           t0=time.perf_counter())
    print(f"  train:rl_group {name}: started in a child process (pid "
          f"{proc.pid}) beside {beside}", flush=True)


def rl_group_kill() -> None:
    """Stop every child still running and every process of its
    session."""
    for group in RL_GROUPS.values():
        if group["proc"].poll() is None:
            os.killpg(group["proc"].pid, 9)
            group["proc"].wait()


def rl_group_finish(name: str) -> dict:
    """Wait for the child of group ``name`` (its timeout counted from
    its start), print its console, and fail if it failed.  Returns its
    launches by kernel."""
    group = RL_GROUPS[name]
    proc, tmp = group["proc"], group["tmp"]
    left = RL_GROUP_TIMEOUT_S - (time.perf_counter() - group["t0"])
    try:
        rc = proc.wait(timeout=max(left, 1))
    except subprocess.TimeoutExpired:
        rl_group_kill()
        rc = None
    group["log"].close()
    with open(os.path.join(tmp, "console.txt")) as f:
        print(f.read(), end="", flush=True)
    secs = time.perf_counter() - group["t0"]
    if rc != 0:
        raise AssertionError(
            f"train:rl_group {name}: the child " + (
                f"took over {RL_GROUP_TIMEOUT_S}s" if rc is None
                else f"exited {rc}") + f" after {secs:.1f}s")
    with open(os.path.join(tmp, "launches.json")) as f:
        got = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"  train:rl_group {name}: the child's phases ran "
          f"{got['secs']:.1f}s (joined {secs:.1f}s after its start)",
          flush=True)
    return got["launches"]


def free(model) -> None:
    """Drop the model's weights from the card before the next model:
    the phases' closures and profiler windows can hold it in reference
    cycles, which only the cycle collector frees."""
    model.params = None
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one GPU", file=sys.stderr)
        return 1
    if argv[:1] == ["--rl-group"]:
        return rl_group(argv[1], argv[2])
    try:
        return run_all()
    finally:
        rl_group_kill()
        dry_kill()


def run_all() -> int:
    from repro_torch.kernels.decode_gqa import ops as dec_ops
    from repro_torch.kernels.decode_gqa import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    from repro_torch.kernels.lstm_cell import ref as cell_ref
    from repro_torch.kernels.lstm_seq import ops, ref
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.ssd_chunk import ref as ssd_ref
    from repro_torch.launch import serve as serve_cli

    CARD = card()
    print(f"card: {CARD}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("build"):
        build_all(["lstm_seq", "flash_attention", "decode_gqa", "ssd_chunk",
                   "lstm_cell"])
    with phase("kernel:lstm_seq"):
        kinfo = check_kernel(ops, ref, CARD)
    with phase("kernel:flash_attention"):
        fa_info = check_flash(fa_ops, fa_ref, CARD)
    with phase("kernel:decode_gqa"):
        dec_info = check_decode(dec_ops, dec_ref, CARD)
    with phase("kernel:ssd_chunk"):
        ssd_info = check_ssd(ssd_ops, ssd_ref, CARD)
    with phase("kernel:lstm_cell"):
        cell_info = check_cell(cell_ops, cell_ref, CARD)
    with phase("serve:relmas"):
        launches, relmas_out, relmas_res = serve_phase(serve_cli, ops,
                                                       "relmas", CARD)
    with phase("serve:fcfs"):
        serve_phase(serve_cli, ops, "fcfs", CARD)
    with phase("parity"):
        for policy in ("relmas", "fcfs"):
            parity_phase(serve_cli, policy, CARD)
    with phase("telemetry:serve"):
        telemetry_serve_phase(serve_cli, ops, relmas_out, relmas_res, CARD)
    for name in ("relmas", "sharded"):
        rl_group_start(name)
    with phase("lm:prefill_decode"):
        model = lm_from_seed(LM_ARCH)
        lm_launches = lm_prefill_decode_phase(model, CARD)
    with phase("lm:batcher"):
        lm_batcher_phase(model, CARD)
    with phase("lm:parity"):
        lm_parity_phase(model, CARD)
    free(model)
    with phase("lm:mamba2_prefill_decode"):
        model = lm_from_seed(MAMBA_ARCH)
        ssd_launches = mamba_prefill_decode_phase(model, CARD)
    with phase("lm:mamba2_batcher"):
        mamba_batcher_phase(model, CARD)
    with phase("lm:mamba2_parity"):
        mamba_parity_phase(model, CARD)
    free(model)
    with phase("lm:whisper_prefill_decode"):
        model = lm_from_seed(WH_ARCH)
        wh_launches = whisper_prefill_decode_phase(model, CARD)
    with phase("lm:whisper_parity"):
        whisper_parity_phase(model, CARD)
    free(model)
    with phase("lm:olmoe_prefill_decode"):
        model = lm_from_seed(OLMOE_ARCH)
        moe_launches = olmoe_prefill_decode_phase(model, CARD)
    with phase("lm:olmoe_batcher"):
        olmoe_batcher_phase(model, CARD)
    with phase("lm:olmoe_parity"):
        olmoe_parity_phase(model, CARD)
    free(model)
    with phase("lm:jamba_prefill_decode"):
        model = lm_from_seed(JAMBA_ARCH, JAMBA_LAYERS)
        jb_launches = jamba_prefill_decode_phase(model, CARD)
    with phase("lm:jamba_batcher"):
        jamba_batcher_phase(model, CARD)
    with phase("lm:jamba_parity"):
        jamba_parity_phase(model, CARD)
    free(model)
    with phase("lm:vlm_prefill_decode"):
        model = lm_from_seed(VLM_ARCH, VLM_LAYERS)
        vl_launches = vlm_prefill_decode_phase(model, CARD)
    with phase("lm:vlm_batcher"):
        vlm_batcher_phase(model, CARD)
    with phase("lm:vlm_parity"):
        vlm_parity_phase(model, CARD)
    free(model)
    with phase("train:rl_group"):
        groups = [rl_group_finish(name) for name in ("relmas", "sharded")]
        cell_launches = sum(g["lstm_cell"] for g in groups)
        launches += sum(g.get("lstm_seq", 0) for g in groups)
    with phase("train:lm_families"):
        tf_launches = train_lm_families_phase(CARD)
    dry_start_all()
    rl_group_start("families", "the LM training phases")
    with phase("train:lm"):
        tr_launches = train_lm_phase(CARD)
    with phase("train:lm_parity"):
        train_lm_parity_phase(CARD)
    with phase("train:lm_mesh"):
        mesh_launches = train_lm_mesh_phase(CARD)
    with phase("train:lm_mesh_nccl"):
        for k, n in train_lm_mesh_nccl_phase(CARD).items():
            mesh_launches[k] += n
    with phase("train:families_mesh"):
        for k, n in rl_group_finish("families").items():
            mesh_launches[k] += n
    with phase("dryrun:production"):
        dryrun_production_phase(CARD)
    with phase("dryrun:check"):
        dryrun_check_phase(CARD)

    kernels = [
        dict(name="lstm_seq", route="cuda",
             source="src/repro_torch/csrc/lstm_seq.cu",
             replaces="src/repro/kernels/lstm_seq/lstm_seq.py:70",
             launches=launches, **kinfo),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:87",
             launches=lm_launches[0] + wh_launches[0] + moe_launches[0]
             + jb_launches[0] + vl_launches[0] + tr_launches
             + tf_launches[0] + mesh_launches["flash_attention"], **fa_info),
        dict(name="decode_gqa", route="cuda",
             source="src/repro_torch/csrc/decode_gqa.cu",
             replaces="src/repro/kernels/decode_gqa/decode_gqa.py:65",
             launches=lm_launches[1] + wh_launches[1] + moe_launches[1]
             + jb_launches[1] + vl_launches[1]
             + mesh_launches["decode_gqa"], **dec_info),
        dict(name="ssd_chunk", route="cuda",
             source="src/repro_torch/csrc/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_chunk/ssd_chunk.py:45",
             launches=ssd_launches + jb_launches[2] + tf_launches[1]
             + mesh_launches["ssd_chunk"], **ssd_info),
        dict(name="lstm_cell", route="cuda",
             source="src/repro_torch/csrc/lstm_cell.cu",
             replaces="src/repro/kernels/lstm_cell/lstm_cell.py:51",
             launches=cell_launches, **cell_info)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
