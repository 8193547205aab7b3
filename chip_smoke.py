#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``distributedmnist_tpu_torch/
csrc`` and drives the port's two paths at the full width of the widest
transformer the repository runs (d_model 2048, 16 heads of 128, 4
layers, seq_len 1024, vocab 1024, bf16 compute, float32 params), with
random weights from a seed:

* training — ``python -m distributedmnist_tpu_torch.launch train``'s
  Trainer, built in process by the CLI's ``build_trainer`` (global batch
  16, ``synthetic_lm``, sync, sgd, constant learning rate), and a short
  run at seq_len 64, where the backward takes the fused kernel K4;
* decode serving — ``launch serve --decode``'s replica (8 decode slots,
  16-token blocks, 320 blocks, prompts up to 512, up to 64 new tokens)
  serving the checkpoint the training phase wrote;

the same training configuration over 8 simulated replicas in quorum
k = 5 (one flash launch a layer for every replica) and
``bench.py bench_flash_long_context``'s model at S = 8192 under each
remat policy; a sweep of two of the repository's configs with its
report and the port's invariant checkers; and the MNIST CNN's sync SGD
(the source paper's path) at its published widths, on one process and across worker processes; the
transformer split over 4 worker processes by tensor, sequence, expert
and pipeline parallelism (Megatron TP, ring and Ulysses attention, a
mixture-of-experts transformer over an expert axis, GPipe and
interleaved 1F1B over a stage axis); ResNet-20 on
CIFAR-10 (``configs/cifar10_resnet20_sync.json`` on a fixture written
at the archive's size) with the rest of the data-parallel step's knobs
— LARS/LAMB, gradient accumulation, bf16 params with and without
float32 masters, ZeRO-1 and the cross-world restore; then the training
path's durable checkpoints, the continuous evaluator that follows them,
and the serving tier that hot-follows training (``launch serve``); the
compile layer: each path's step captured as CUDA graphs against its
eager step, and the kernel build cache across processes; and the local
process cluster: a seeded chaos campaign on ``launch train`` workers
under the supervisor, and the restart latency of a worker; last, the
serving chaos trial: decode replicas on the card under live load and
seeded network faults, then two tensor-parallel decode groups of two
processes each through a hot swap and the SIGKILL of one rank; and the resource broker trading a donor trainer's
slot for a decode replica at a load peak and back in the trough. The
flagship campaign (``launch campaign``) runs its evaluated group and its
other model families after the evaluator.

One JSON line per phase:

1. ``env``      — the card, torch and CUDA versions; fails without CUDA
                or without the port package beside this script.
2. ``build``    — seconds to compile every kernel (one nvcc per source,
                all at once); per kernel instantiation its registers,
                stack and spill bytes (``ptxas -v``) and its count of
                ``HGMMA`` (wgmma) instructions in the SASS (the toolkit's
                ``cuobjdump``, names through its ``cu++filt``): the bf16
                K1, K1-lse, K2, K3 and K4 instantiations of the main
                paths must have them, and the phase fails if the count
                cannot be made; per kernel on the main path, at its
                main-path shape, the bf16 instantiation it launches with its
                registers and spills (``ptxas``), dynamic shared memory
                and blocks per SM (CUDA runtime; for K5 also its
                cluster size and the clusters resident at once).
3. ``kernels``  — each kernel against its plain PyTorch version on the
                card at the main paths' shapes, float32 and bfloat16:
                K1 flash-attention forward and K5 paged attention at
                the decode shapes, K1 also at the evaluator's batch
                (``eval``'s shape); K1-lse (forward with log-sum-exp),
                K2 (dq), K3 (dk, dv) at the training shape and K4
                (fused backward) at the short run's, and K1-lse, K2 and
                K3 at the long-context shape [2, 8192, 8, 128] (checked,
                not timed); K1 at ``[1, s, 8, 128]`` for the TP arm's
                prefill buckets and K5 over 8 heads, a 2-rank TP serving
                group's share of the 16 (bf16, the largest bucket and K5
                timed; ``tp_serving_cases``); max abs error
                beside the stated tolerance, the relative error of the
                whole output beside its own, the mean |plain output|,
                kernel / plain / library times (CUDA events, device
                time: see ``time_ms``), and the bound; K5 also
                bitwise equal over two calls, and its time over a
                rotation of input sets whose live K/V exceed twice the
                L2 (``ms_cold``).
4. ``train``    — one step through the kernels against one step through
                their plain versions from the same params and batch;
                then 20 steps of the Trainer with every launch counter
                set to 0 just before and read just after: finite losses,
                the last below the first, K1-lse, K2 and K3 launched 4
                times a step (K4 never); the final checkpoint read back;
                a test-split eval through K1; ms per step (CUDA events),
                tokens/s, peak memory and a ``torch.profiler`` split of
                one step into GEMMs, attention kernels, other kernels
                and device idle. ``lamb_arm``: the same configuration
                under LAMB with bf16 params over float32 masters, 5
                steps: K1-lse, K2 and K3 4 times a step, ms a step,
                peak memory, params and both slots float32.
5. ``train_k4`` — at seq_len 64 (one tile): one step through the
                kernels against one through their plain versions, as in
                ``train``; 5 steps of the Trainer with K4 launched 4 times
                a step, K2 and K3 never; ms per step and tokens/s.
6. ``train_replicas`` — the training configuration at 8 simulated
                replicas (global batch 16, 2 sequences a replica),
                quorum k = 5 over lognormal stragglers, 10 steps of the
                Trainer with its profile window over steps [4, 6)
                (``train.profile_steps``): one step through the kernels
                against one through their plain versions (``train``'s
                tolerances); losses finite and falling,
                ``num_contributors`` 5 every step; K1-lse, K2 and K3
                launched 4 times a step (the Functions' vmap rules fold
                the replicas into one launch a layer); the window's
                Chrome trace read back: device ms by class, idle share,
                the flash kernels' names (K1-lse, K2, K3 checked); ms a
                step by CUDA events beside the one-replica ``train``
                step and beside the same step with the replicas looped
                (32 launches each a step), peak memory.
7. ``long_context`` — ``bench_flash_long_context``'s model (d 1024, 2
                layers, 8 heads of 128, S = 8192, batch 2, bf16,
                flash) under remat ``full``, ``save_attn`` and off: one
                Trainer step each with the counters read (K1-lse 4, 2,
                2; K2 and K3 2), losses and params after it against the
                arm without remat (``train``'s tolerances; whether
                bitwise printed), then ``LONG_TIMED`` steps by CUDA
                events: tokens/s, model TFLOP/s (bench.py's count: 3 ×
                the forward's matmul and attention FLOPs), peak memory
                (checked: lower under ``full`` than without remat).
8. ``report``   — ``configs/quorum_k4_of_8.json`` and
                ``configs/interval_3000ms.json`` copied with
                ``max_steps`` ``SWEEP_STEPS``, the port's MNIST idx
                fixture as ``data_dir`` and 8 simulated replicas;
                ``launch sweep`` on them (in process, on the card),
                ``launch report`` on one run (``stats.json``), the
                port's ``check_metrics_log``, ``check_checkpoint_dir``
                and ``check_discipline`` on every run (no violation),
                ``launch devices`` naming the card; K1-K5 0.
9. ``cnn``      — the MNIST CNN sync-SGD path (the source paper's), no
                flash or paged kernel in it (its convolutions and GEMMs
                are cuDNN/cuBLAS calls, as the reference's are XLA ops;
                the line carries the K1-K5 counters, all 0): the
                Trainer's step at ``bench.py bench_cnn_sync``'s shape
                (synthetic, global batch 4096, bf16, sync, 1 replica,
                sgd, lr 8e-4), 20 timed steps by CUDA events, images/s,
                model TFLOP/s, the bound (FLOP time against byte time,
                bytes counted in ``_cnn_bytes``), a ``torch.profiler``
                split (cuDNN convolution, GEMM, other kernels, idle)
                and peak memory, with cuDNN's deterministic algorithms
                on (the port's setting); 8 simulated replicas
                on ``cuda:0`` at global batch 1024, 10 steps each:
                quorum k=4 (4 flags every step), timeout with the
                deadline swapped to 0 on one step (params bitwise
                unchanged there), interval (1000 ms window, lognormal
                300 ms: ``applied`` exactly when the modeled clock
                crosses the window); 3 float32 quorum steps on the card
                against the same steps on the CPU (params within
                ``CNN_CARD_VS_CPU_TOL``; the flags, drawn on the host
                from the same keys on both sides, equal); two seeded
                5-step runs bitwise equal with cuDNN's deterministic
                algorithms, each convolution's setting read as it
                runs; cuDNN's
                process-wide settings the same after the phase as
                before it.
10. ``dist``    — the CNN's sync SGD across worker processes, each a
                ``python -c`` child with ``torchrun``'s environment
                (free localhost port) that imports only the port, builds
                the Trainer through the CLI's ``build_trainer`` and is
                killed when a sibling fails or the group outlives
                ``DIST_CHILD_TIMEOUT_S``: one NCCL process with 8
                replicas at global batch 4096, bf16, sync, 5 steps —
                params digest equal to the same run on the simulated
                topology in a fresh process with no group (the two
                processes side by side, untimed, beside the gloo pair
                and the refusal); two gloo processes on ``cuda:0`` — quorum
                k=4 over the measured host times with rank 1 sleeping
                250 ms a batch (flags ``[1,1,1,1,0,0,0,0]`` from step 2
                on both ranks, digests equal), sync at batch 4096
                (digests equal; untimed: gloo stages through host
                memory), 3 float32 full-batch steps within ``DIST_F32_TOL``
                of each leaf's norm of the simulated 8-replica run; two
                NCCL ranks on one card refused (their processes run
                beside the gloo pair); two NCCL processes on two
                cards where there are two (else null with the card
                count); in this process, the adaptive discipline
                (tests/test_discipline.py's spike case, 14 steps) on the
                card against the CPU (equal records and flags, a change
                at least) and the device-skew probe (a float32
                ``a@a@a`` on [640, 640] queued for replica 3 after every
                step: quorum k=7 leaves it out); ``zero1``: ZeRO-1 (4
                buckets) at 8 replicas over two gloo processes on one
                card, float32 full-batch steps under momentum (3) and
                LAMB (1), against the one-process run fed the two
                processes' batches concatenated: each leaf within
                ``ZERO_DIST_TOL`` of its norm (momentum; LAMB after one
                step within ``ZERO_DIST_LAMB_TOL``), each rank's slot
                bytes half
                the sharded slots' plus the fallback leaves, the
                momentum run's per-host checkpoint (two shard files and
                a manifest) resumed in one process to that run's params
                and slots bit for bit; ``nccl_cards``: the momentum run
                over one NCCL process a card on up to 4 cards (the
                same bound and slot bytes; null with one card); the
                K1-K5 counters 0 in this process and every child. The
                multi-card case alone, on a host with 4 cards:
                ``python3 -c "import json, tempfile, chip_smoke as cs;
                d = tempfile.mkdtemp(); print(json.dumps(
                cs._dist_zero1_nccl(d)))"``.
10b. ``model_parallel`` — tensor, sequence, expert and pipeline
                parallelism and ZeRO-1 over them (Queue A items 8a–8d)
                in one launch of 4 worker
                processes (gloo, all on
                ``cuda:0``; the dist phase's launcher, each child
                joining the group and building its Trainer through
                ``launch train``'s ``build_trainer``), bf16, flash,
                ``MP_STEPS`` steps an arm: A, TP 4 and B, TP 2 × SP 2
                (Ulysses over flash) at the training path's widths cut
                to 2 layers, global batch 8; C, SP 4 on
                ``bench_flash_long_context``'s model at S = 8192, batch
                2, by ring under remat ``full`` and by Ulysses over
                flash; D, EP 4 and E, TP 2 × EP 2 on the training
                path's MoE transformer (8 experts, GShard top-2, 4
                token groups a row, capacity factor 1.25, so tokens
                drop; 2 layers, batch 8); F, PP 2 × EP 2 under GPipe
                with 2 microbatches on D's model (step 1 alone); G, PP
                2 × TP 2 under interleaved 1F1B (2 chunks a stage, 4
                microbatches) on the training model at its 4 layers,
                batch 8; H, DP 2 × TP 2 with ZeRO-1 (2 buckets, resident
                params) under heavy-ball momentum on A's model (its
                first update is lr·g, so its step 1 is gated as SGD's;
                its one-process reference runs 2 local replicas with
                ZeRO-1 on, and each replica-process is fed its rows of
                the reference's global batch); and as float32 controls,
                A, the ring, D and H again at
                ``compute_dtype=float32``, step 1 alone (C's
                ring takes step 1 alone; the one-step arms run first,
                beside the references). Each arm's
                step 1 against the same config's one-process step in
                this process (same seed, same batch; made while the
                workers boot, which time no step before it is done):
                the loss within
                ``MP_LOSS_TOL``; each leaf's update within
                ``MP_UPDATE_TOL_F32`` of its norm in the float32
                controls, and in the bf16 arms within
                ``MP_NOISE_RATIO`` × the one-process bf16 step's own
                distance from the float32 step in that leaf; the loss
                equal on every rank; every process on a card; K1-lse,
                K2 and K3 launched by every process of a flash arm (K1
                in the test eval of A, B, D and E), F's and G's at the
                counts their schedules predict (``_pp_launches``), and
                their step 1 read in the stacked layout
                (``_stacked_gaps``); H's optimizer-slot bytes on every
                rank those of its plan (``_zero1_slot_bytes``: half the
                ZeRO-1 leaves' slots, the rank's TP shard of the
                fallback leaves'). Printed: ms a step by
                CUDA events (step 2), tokens/s, peak GB, seconds
                in collectives and slot bytes a process, the exchanges
                staged through host memory (gloo carries no CUDA
                point-to-point or all-to-all), each arm's seconds. With
                4 cards arms B, D, G and H again over NCCL, one card a
                process; else null with the card count.
11. ``resnet``  — the CIFAR-10 fixture written at the archive's size
                (50,000 / 10,000) by the port's ``data/fixtures.py``, in
                a process started with ``train`` and waited for before
                ``campaign``; the phase runs beside ``cluster``, in a
                thread of its own (its times are taken there);
                ``launch train`` on ``configs/cifar10_resnet20_sync.json``
                through ``build_trainer`` with only ``data.data_dir``
                and ``train.train_dir`` overridden (ResNet-20, batch
                1024, bf16, sync, the config's one replica): 10 steps of
                ``run`` with the K1-K5 counters set to 0 before and read
                after (all 0: convolutions and GroupNorm are cuDNN and
                ATen calls, as the reference's are XLA ops), the test
                split's eval, then 20 steps timed by CUDA events (ms,
                host issue ms, images/s, model TFLOP/s from the layer
                shapes' multiply-adds, the FLOP bound), peak memory and
                a ``torch.profiler`` split (convolution, GroupNorm, GEMM,
                other, idle); 3 float32 steps at batch 64 on the card
                and on the CPU against the same steps in float64 on the
                CPU (the card's error no more than
                ``RESNET_CARD_VS_CPU_FACTOR`` × the CPU's; the two
                float32 runs' gap printed); the knobs over 8 simulated
                replicas at batch 1024, each arm on the same 3 batches
                with its ms a step: momentum replicated against ZeRO-1
                monolithic, 4 buckets and resident (params and slots
                bitwise), LARS and LAMB replicated against ZeRO-1
                (within ``KNOB_RTOL``/``KNOB_ATOL`` after one step),
                accumulation 2 × 512 against 1 × 1024 (params'
                relative error), bf16 params with and
                without masters (storage dtypes, loss beside float32's),
                an all-masked timeout step under LAMB and ZeRO-1
                (bitwise no-op); a ZeRO-1 LAMB run at 8 replicas saved
                at step 5 and resumed at 4 (``cross_world_restore``
                journaled with both worlds, slots equal to the saved
                ones, the cursor at 5 batches, one more step) and a
                resume under momentum refused with
                ``OptimizerStateMismatchError``.
12. ``e2e``     — boots the decode replica on the training phase's
                checkpoint through the CLI's ``build_replica``,
                streams 8 concurrent greedy requests over its socket,
                and checks:
                an ``ok`` terminal with exactly ``max_tokens`` tokens
                for each; each first token equal to the argmax of an
                offline prefill of its prompt; the K1 and K5 launch
                counters grown by 4 per prefill and 4 per decode
                iteration; one prefill plus 3 decode steps through the
                kernels within a stated tolerance of the plain versions.
                Prints tokens/s, TTFT p50 and inter-token p50.
13. ``ckpt``    — the training configuration, 15 steps with a save every
                5 (keep 2) in two arms: the host fetch on the loop and
                the write on the writer thread (``async_snapshot=
                false``), and the device snapshot. Per
                arm the journaled ``save_stall_ms`` (each and the
                median), ms a step (each step timed to the end of its
                compute stream) with a write in flight and with none,
                per save the loop's cost (its stall plus the excess,
                over the quiet steps' medians, of each following step's
                host issue, stream wait and gap) and the overlap of
                those steps with each writer stage (``CKPT_STAGES``,
                timed on the writer thread), the run's total with the
                final drain and per write made,
                ``max_memory_allocated``, the pinned host allocator's
                peak and the final drain's wall; checked: the snapshot
                arm's median stall at most ``CKPT_STALL_GATE`` × the host
                fetch's (``bench.py bench_save_stall``'s gate); a race
                probe (a snapshot, then at once an in-place add of 1.0
                on every param: the artifact holds the values from
                before the add); the CNN's saved digests equal across
                three arms, the two and saves on the step loop
                (``train.async_checkpoint=false``) (the transformer's
                reported). Then
                ``bench_checkpoint_durability``'s save (24 [256, 256]
                float32 arrays, 5 interleaved repeats × 3 saves) under
                ``none``, ``data`` and ``full``: median walls printed,
                fsyncs a save checked against the reference's count.
14. ``eval``    — ``launch eval``'s Evaluator in process on the ``ckpt``
                phase's transformer checkpoint: K1 launched 4 times a
                batch, precision equal to and loss within
                ``EVAL_LOSS_TOL`` of the Trainer's ``evaluate`` of the
                same state; then co-located, a ``launch train``
                subprocess on ``configs/quorum_k4_of_8.json`` (paced,
                a save every 5 steps) and a ``launch eval
                --single_device`` subprocess following it on the same
                card: at least 2 increasing steps evaluated, every
                printed line the source paper's format, each result
                equal to an in-process eval of that step (loss within
                ``COLOC_LOSS_RTOL``), ``follow_skip`` records printed.
15. ``campaign`` — ``launch campaign`` in process on the card (≙ the
                reference's ``run_campaign.py``), on a copy of
                ``configs/`` (``mnist_99`` at its 4000 steps) with the
                report and resnet phases' fixtures as its data cache: ``--groups
                repro_mnist99`` (the MNIST CNN at its published widths,
                global batch 512 over 8 simulated replicas) with its
                ``launch eval --single_device`` child live on ``cuda:0``:
                the record's replicas and steps, its keys the
                reference's (``CAMPAIGN_RECORD_KEYS``), the final
                checkpoint's step journaled by the evaluator at the
                record's ``test_accuracy``, and the seconds
                ``stop_evaluator`` waited and what ended the wait
                (checked: the final evaluation); then ``--groups extras
                --quick`` (fashion-MNIST timeout, ResNet-20 on the
                CIFAR-10 fixture, the synthetic-LM transformer, 20 steps
                each, with the launch counters set to 0 before and read
                after: finite records; K1-lse, K2 and K3 in training and
                K1 in evaluation above 0, K4 and K5 0); then
                ``--finalize-only`` twice: ``campaign_summary.json``
                holds both groups, the same bytes both times, and no
                ``ckpt-*.msgpack`` or ``CHECKPOINT`` is left. These runs
                take the configs' own ``compile.precompile`` (on): a
                captured step launches through its graph's replays, so
                the training counts are the captures' launches.
16. ``serve``   — one line a part, then the phase's seconds. ``cnn``:
                ``launch train`` on the MNIST CNN at its published widths
                (``SERVE_CNN``: float32, 60 steps, a save every 10,
                ``quant.publish_tiers=int8,bf16``, 128 calibration
                examples; every sidecar's source digest the artifact's,
                calibrated on the card), published in the trainer's write
                order into a dir that ``launch serve``'s replica follows
                (``poll_secs`` 0.1); every bucket warmed untimed; 200
                one-image requests at concurrency 4 (deadline 5 s)
                steady, and again with a publish every 300 ms: no drop
                or error, at least 2 steps served, swap p99 within
                max(5 ×, + 250 ms) of steady's; p50/p99, requests/s, the
                batch-size histogram, swaps and ``swap_ms``; every
                answer of the swap sweep and 64 fixed images against the
                port's CPU forward of the step that served them (within
                ``SERVE_CARD_VS_CPU_TOL``); int8 and bf16 replicas on the
                newest step: int8 resident weight bytes ≤ 0.35 × fp32,
                top-1 agreement ≥ 0.98 with fp32 on the 1,000 test
                images, rates and p99 over 2 interleaved sweep pairs of
                120 (reported, and the reference's accelerator gate
                beside them); a torn int8 sidecar journaled once as
                ``follow_quant_sidecar_fallback``, that step served fp32
                and the next int8. ``decode_pin`` / ``decode_restart``:
                the ``ckpt`` phase's two kept steps at full width, 8
                clients generating 64 greedy tokens a request back to
                back while the newer is published: every request ok; one
                swap mid-generation; the journal replayed (no pinned
                sequence changes step, every ``seq_restart`` follows its
                ``weight_swap``); K1 = 4 × (prefills + restarts), K5 = 4
                × the decode steps (one a live version an iteration);
                under ``pin`` two versions live at once, peak memory,
                and the first pinned step with a masked slot against the
                plain paged attention: live rows' logits within
                ``E2E_LOGIT_TOL``, masked rows bitwise, and K5's output
                for every masked slot exactly zero; under
                ``restart`` one ``seq_restart`` a sequence in flight.
                ``lm_one_shot``: 4 requests of 1,024 tokens through the
                classification replica on the transformer: K1 = 4 a
                batch, each served answer's probabilities against the
                plain path's softmax for its prompt at batch 1, within
                ``LM_PREDICT_PROB_REL`` × p + ``LM_PREDICT_PROB_ABS``.

17. ``graphs``  — the compile layer. Phases 4–14 and 16 run the eager step
                (``compile.precompile`` off: their launch counters count
                wrapper calls, which a replayed graph makes none of);
                here each arm runs its configuration twice from the same
                start, captured (``Trainer.precompile``: the train step's
                stages as CUDA graphs, replayed every step) and eager:
                ``cnn`` (batch 4096), ``resnet`` (the CIFAR-10 config,
                batch 1024), ``train`` (seq 1024, one replica),
                ``train_k4`` (seq 64) and ``train_replicas`` (8 replicas,
                quorum k = 5), each ``GRAPH_STEPS`` steps of ``run`` with
                a profile window over ``GRAPH_WINDOW``: the ``compile``
                record (``source`` ``cuda_graph``, checked, journaled
                before the first step), params and losses after the run
                (bitwise for the CNN and ResNet-20, checked; for the
                flash arms bitwise printed and held to ``train``'s
                tolerances), the flash kernels' launches a step read from
                the window's trace by kernel name (K1-lse/K2/K3 or
                K1-lse/K4 4 a step both ways, checked), the replayed ms
                a step by CUDA events over ``GRAPH_TIMED`` steps,
                the window's idle share and peak memory; ``decode``: the
                e2e replica's configuration on the ``train`` checkpoint
                with each version's decode step captured and eager, the
                8 e2e requests (greedy tokens equal both ways, checked),
                ms a decode iteration, and the decode step with every
                slot live by CUDA events, by the host clock and under the
                profiler (idle share, K5 4 a step both ways, checked);
                ``kernel_cache``: three processes side by side, each
                building and loading every library in its own
                ``DMT_COMPILE_CACHE_DIR`` — cold on a fresh one (3
                misses, 3 new entries; then one captured step at seq
                64, its ``compile`` record ``cuda_graph``), warm on
                build's libraries (0 misses, no new entry), and healed
                on build's libraries with one truncated (one rebuild, a
                warning) — each one's seconds from its start to its
                libraries loaded (``ready_s``, with the other two
                running), the cold one's to its first step. The three
                run beside the arms (their checks are counts; the arms'
                are counts and bits, and their times a record).
18. ``cluster`` — the chaos campaign (``launch/chaos.py``) on the port's
                ``launch train`` workers on the card: the train payload
                (the MNIST CNN, 2 simulated replicas, momentum 0.9,
                ZeRO-1 in 2 buckets, float32; ``CLUSTER_CNN``), 2 seeded
                trials and the fault-free reference run, 40 steps paced
                ``CLUSTER_CNN_PACE_MS`` (each campaign's reference run
                unpaced); beside it, in a campaign of its own, one
                flash-transformer trial (``CLUSTER_FLASH``: the training path's widths at
                ``FLASH_LAYERS`` layers, plain sgd so the step is
                captured, 20 steps, a save every 5, one warm standby; its
                schedule's kill checked; its kernel cache seeded from
                ``build``, so no worker compiles) whose workers' profile window
                (``FLASH_PROFILE``) counts the flash kernels a step by
                name. Checked: every trial ``all_green``, determinism
                ``pass`` in CNN trial 0 (kill + corrupt + stall) and the
                flash trial (``pass`` or ``skipped`` elsewhere), their
                faults fired, every worker's ``compile`` record on
                ``cuda:0`` (the flash workers' ``cuda_graph``), K1-lse,
                K2 and K3 ``FLASH_LAYERS`` a step in every flash worker's
                trace and no kernel launched by this process. Printed:
                every invariant's counts, each trial's schedule, outcome,
                seconds, MTTR and boot, the fired faults, and each flash
                worker's kernel-cache hits and misses.
19. ``restart`` — ``bench.py bench_restart_latency`` on the port:
                spawn (or promotion) to the first moved step of the
                chaos train payload, ``RESTART_SAMPLES`` each cold (an
                empty kernel directory a spawn), warm (the shared cache
                a prime spawn filled; skipped, with its reason, when the
                prime persisted nothing) and standby (a parked,
                precompiled spare promoted into the killed worker's
                train_dir); the reference's gates against the cold
                median (standby ≤ 0.3×, warm ≤ 0.6×). What a kernel
                build costs a process is ``graphs``' ``kernel_cache``.
20. ``serving_chaos`` — the serving chaos trial on the card (≙ the
                reference's network scenario, ``tests/test_servesvc.py
                :783``; ``SERVING_CHAOS``): ``cluster chaos --payload
                serving --serve-decode --network`` with 2 decode replicas
                (``launch serve --decode``) following a publisher that
                trains the flash transformer (the training path's widths
                at ``FLASH_LAYERS`` layers, ``decode.attention_kernel=
                paged``), paced by the reference's rule on the measured
                boot (its reference run unpaced), the shared kernel
                cache seeded from ``build``;
                seeded chaos proxies cut one token stream mid-generation
                and partition one link under live load. Checked:
                ``all_green``; ``net_faults``, ``serve_outcomes``,
                ``serve_digest``, ``serve_monotone`` and ``decode_swap``
                pass; requests issued, none dropped, every fault fired;
                one ``net_reset`` mid-stream after bytes flowed and one
                ``net_partition``; each replica on ``cuda:0`` by its meta
                answer and by its boot log's ``compile`` records, every
                decode step ``cuda_graph``, no kernel-cache miss; the
                replicas' K1 and K5 launches (each process's
                ``kernel_launches.jsonl``) above 0, none by this process.
                Then its TP arm, a ``serving_chaos_tp`` line (≙
                ``bench.py bench_tp_serving``; ``TP_SERVING``): two
                tensor-parallel decode groups of 2 ranks (``launch serve
                --decode --tp-ranks 2``: the four ranks on ``cuda:0``
                over gloo with one card, a card a rank over NCCL with
                more) following a publish dir fed the trial publisher's
                two kept steps, a failover client over both, the newer
                step published mid-sweep and rank 1 of group 1
                SIGKILLed mid-generation. Checked: no request dropped or
                errored in either sweep; group 1's journal ``rank_exit``
                → ``group_down`` → ``group_restart`` and a second
                ``group_start``, the ``serve_group`` and serving
                invariants clean, the restarted group serving; a swap
                on the surviving group; every follower's
                ``shard_verify``; every rank that stopped gracefully on
                ``cuda:(rank mod cards)`` with K1 and K5 launched and no
                kernel-cache miss; each decode step eager with the gloo
                reason, or over NCCL captured and bitwise equal to its
                eager step. Printed: tokens/s of both sweeps, each
                rank's boot by stage, and the transfers a decode step
                staged through the host (all-reduces of CUDA tensors
                over gloo, work broadcasts).
21. ``broker``  — the resource broker's trial (``launch/broker.py``;
                ``cluster chaos --payload serving --serve-decode`` with
                ``broker=true``; ``BROKER``): ``serving_chaos``'s flash
                publisher (its fault-free reference run taken as this
                campaign's), one decode replica, one donor trainer, one
                serving spare parked on the card (CUDA context and
                kernel libraries loaded), no faults; a seeded trace of
                a trough at concurrency 1, a peak at twice the replica's
                slots and a final trough. A ``broker_plan`` line first:
                the publisher's pace that makes the trial outlast the
                trace, the cooldown, two windows and a trainer's boot by
                ``BROKER_MARGIN``. Checked: ``all_green`` with
                ``autoscale``, the serving invariants and determinism
                passing; requests issued, none dropped; every
                ``decide`` call the broker made replayed bitwise from
                its recorded arguments; exactly one
                ``scale_up_serving`` licensed by ``kv_free_frac`` while
                the peak's requests were in flight and one
                ``scale_down_serving`` in the final trough, each
                completed; the scale-up slot promoted from the spare
                (``reaction_s`` printed), its decode steps captured on
                ``cuda:0`` with no kernel-cache miss and its requests
                answered; the grown trainer resumed from a seeded
                checkpoint; the brokered replicas' K1 and K5 launches
                above 0, none by this process.

Then a ``kernels`` summary line (per kernel also its ``variant`` —
``wgmma``, ``cuda_cores`` or ``cluster_split``, the compiled kernel the
bf16 call takes — and the build phase's instantiation, registers,
spills, shared memory and blocks per SM at the timed shape; for K1 also
``launches_eval``, the eval phase's count, and ``launches_serve``, the
serve phase's by path; for K1, K1-lse, K2 and K3 ``launches_campaign``,
the campaign phase's ``extras`` run's; for K1 and K5 ``launches_serving_chaos``, the
serving_chaos replicas' launches (each replica process's count, K5's
taken from its decode graphs' replays), ``launches_tp_serving``, each
rank's of the TP arm's groups that stopped gracefully,
``tp_serving_shapes``, the ``kernels`` phase's cases at a TP rank's
heads, and ``launches_broker``, the
broker trial's replicas' launches counted the same way; for K1-lse, K2 and K3 also
``launches_replicas`` (the ``train_replicas`` run), ``launches_long_context``
by remat arm, ``long_context``, the kernel's errors at that shape, and
``launches_cluster_a_step``, each flash worker's count a step from its
trace in the ``cluster`` phase; for
K5 also ``launches_serve`` and
``ms_cold``, and ``ms_in_place``, its share of the decode-step profile
a launch, beside ``bound_ms_in_place`` for the profile's lengths), the
card's name and power limit
as ``nvidia-smi`` reports them, and, last, the result line
``{"ok": true, "device": {...}}``. Any failure prints the failing
phase and exits nonzero before the result line.

Every process the script starts ends before it does: on its way out,
by any path, it stops what is still running below it (the workers of
the cluster phases run in sessions of their own, so a signal to the
script's process group would not reach them). So does a SIGTERM, a
SIGHUP or a SIGINT, and so does the script's own limit of
``SCRIPT_LIMIT_S`` seconds, past which the running phase fails.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

SEED = 0
DEVICE = "cuda"
MODEL = {"name": "transformer", "model_dim": 2048, "num_heads": 16,
         "num_layers": 4, "seq_len": 1024, "vocab_size": 1024,
         "num_experts": 0, "compute_dtype": "bfloat16",
         "attention_impl": "flash"}
DECODE = {"decode_slots": 8, "block_size": 16, "max_prompt_len": 512,
          "max_new_tokens": 64, "num_blocks": 320,
          "attention_kernel": "paged", "swap_policy": "pin"}
# prompt length → max_tokens of the 8 concurrent requests
REQUESTS = [(5, 32), (17, 40), (100, 48), (257, 56), (512, 64), (33, 36),
            (64, 44), (200, 60)]

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and FLOP/s by
# input type (bf16 on the tensor cores; float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain on the same inputs: float32 differs by summation
# order only; bfloat16 outputs (K1) differ by at most ~1 ulp (2^-7
# relative) where the two round differently; K5 always outputs float32
TOL = {("K1", "float32"): 1e-4, ("K1", "bfloat16"): 3e-2,
       ("K5", "float32"): 1e-4, ("K5", "bfloat16"): 1e-4}
# K1-lse, K2, K3, K4 at the training shapes, elementwise
# |kernel - plain| <= atol + rtol * |plain| (numpy's allclose): float32
# differs by summation order; bfloat16 outputs by one bf16 ulp where
# the two round differently (the gradients reach ~10 here, an ulp of
# 2^-4, hence the relative term); lse is float32 from the same inputs
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 1e-2),
           "lse": (1e-4, 1e-4)}
# every output as a whole, ||kernel - plain|| / ||plain||, by the dtype
# of the output. Where attention averages over hundreds of keys the
# outputs are a few hundredths (each case prints its mean |plain|), the
# order of the elementwise atol, which alone would pass one key tile
# weighted 10% off; this would not. float32 differs by summation order;
# bfloat16 by one rounding of each output and of p and ds (below 3e-3
# in every case here; the inputs are seeded and the kernels
# deterministic, so it repeats run to run)
REL_TOL = {"float32": 1e-5, "bfloat16": 5e-3}

# the training path (bench.py bench_transformer_flash's model and batch)
TRAIN_STEPS = 20
TRAIN = {"name": "chip_smoke_train", "model": MODEL, "decode": DECODE,
         "serve": {"default_deadline_ms": 300000.0},
         "data": {"dataset": "synthetic_lm", "batch_size": 16,
                  "synthetic_train_size": 512, "synthetic_test_size": 32,
                  "use_native_pipeline": False},
         "optim": {"name": "sgd", "initial_learning_rate": 0.1,
                   "learning_rate_decay_factor": 1.0},
         "sync": {"mode": "sync"},
         "eval": {"eval_batch_size": 16},
         "train": {"max_steps": TRAIN_STEPS, "log_every_steps": 5,
                   "save_interval_steps": 0, "save_results_period": 0,
                   "summary_every_steps": 0, "seed": SEED},
         # the phases before ``graphs`` time and count the eager step:
         # their launch counters count wrapper calls, which a replayed
         # graph makes none of
         "compile": {"precompile": False}}
# the short run: the same model at a sequence that fits one tile (K4)
K4_SEQ, K4_BATCH, K4_STEPS = 64, 64, 5
# the training configuration over 8 simulated replicas, in the
# reference's quorum run (tests/test_transformer_train.py
# test_transformer_quorum_mode: k = 5 of 8, lognormal stragglers); the
# Trainer's profile window over steps [4, 6)
REPLICAS, REPLICA_K, REPLICA_STEPS, REPLICA_WINDOW = 8, 5, 10, (4, 6)
# bench.py bench_flash_long_context's model and batch, a few timed
# steps in each remat arm (K1-lse launches a step: twice a layer under
# full remat, which reruns the block's forward in the backward)
LONG = {"model_dim": 1024, "num_layers": 2, "num_heads": 8,
        "seq_len": 8192, "batch": 2}
LONG_TIMED = 3
REMAT_ARMS = {"full": ("model.remat=true", "model.remat_policy=full"),
              "save_attn": ("model.remat=true",
                            "model.remat_policy=save_attn"),
              "off": ("model.remat=false",)}
LONG_K1_LSE_PER_LAYER = {"full": 2, "save_attn": 1, "off": 1}
# the report phase: two of the repository's sweep configs, cut to
# SWEEP_STEPS steps, on the port's MNIST idx fixture and 8 simulated
# replicas (the reference's runs had 8 chips)
SWEEP_CONFIGS = ("configs/quorum_k4_of_8.json",
                 "configs/interval_3000ms.json")
SWEEP_STEPS = 20
# one train step through the kernels vs through their plain versions
# from the same params and batch (bf16 compute): attention outputs and
# gradients differ by a bf16 ulp here and there, which moves the loss
# (~6.9) by well under 2e-2 and each float32 param, through lr 0.1
# times a gradient difference, by well under 1e-3
STEP_LOSS_TOL = 2e-2
STEP_PARAM_TOL = 1e-3
# end to end, bf16 logits of one prefill + 3 decode steps, kernels vs
# plain: per-layer attention rounding differences (one bf16 ulp here
# and there) compound through 4 layers and the 2048-wide projections;
# 0.1 is ~3 bf16 ulps at the logits' magnitude
E2E_LOGIT_TOL = 0.1
# the CNN path (bench.py bench_cnn_sync's shape: one replica, batch 4096)
CNN_BATCH, CNN_TIMED, CNN_DISC_BATCH, CNN_DISC_STEPS = 4096, 20, 1024, 10
CNN = {"name": "chip_smoke_cnn",
       "data": {"dataset": "synthetic", "batch_size": CNN_BATCH,
                "synthetic_train_size": CNN_BATCH,
                "synthetic_test_size": 256, "use_native_pipeline": False},
       "model": {"name": "mnist_cnn", "compute_dtype": "bfloat16"},
       "optim": {"name": "sgd", "initial_learning_rate": 8e-4,
                 "learning_rate_decay_factor": 1.0},
       "sync": {"mode": "sync"}, "mesh": {"num_replicas": 1},
       "eval": {"eval_batch_size": 256},
       "train": {"max_steps": CNN_TIMED, "log_every_steps": 10,
                 "save_interval_steps": 0, "save_results_period": 0,
                 "summary_every_steps": 0, "seed": SEED},
       "compile": {"precompile": False}}
# card against CPU, 3 float32 quorum steps: ||Δ|| / ||cpu|| per param
# leaf. Both sum in float32 in other orders (~1e-7 a step); a max-pool
# window whose top two values lie closer than that routes one gradient
# entry elsewhere, up to ~2e-4 of the smallest leaf's norm on the CPU
# (tests/test_torch_sync_modes.py)
CNN_CARD_VS_CPU_TOL = 1e-3
# the dist phase: worker processes in a process group (torchrun's
# environment), each killed if the group outlives DIST_CHILD_TIMEOUT_S
DIST_STEPS, DIST_TIMED, DIST_SLEEP_MS = 5, 5, 250.0
DIST_CHILD_TIMEOUT_S = 150
# two ranks against the simulated run, 3 float32 full-batch steps:
# ||Δ|| / ||simulated|| per param leaf (the replicas' sums reassociate)
DIST_F32_TOL = 1e-4
# the ckpt phase: the training configuration, 15 steps with a save every
# 5 (keep 2) in three arms — saves on the step loop, the host fetch on
# the loop and the write on the writer thread, and the device snapshot
CKPT_STEPS, CKPT_EVERY, CKPT_KEEP = 15, 5, 2
CKPT_ARMS = {"sync": ("train.async_checkpoint=false",),
             "host_fetch": ("train.async_checkpoint=true",
                            "train.async_snapshot=false"),
             "snapshot": ("train.async_checkpoint=true",
                          "train.async_snapshot=true")}
# the arms the transformer runs (the CNN runs all three): the two the
# stall gate reads
CKPT_TIMED = ("host_fetch", "snapshot")
# the reference's accelerator gate (bench.py bench_save_stall): the
# snapshot arm's median save stall at most half the host fetch's
CKPT_STALL_GATE = 0.5
# bench.py bench_checkpoint_durability: 5 interleaved repeats x 3 saves
DUR_POLICIES, DUR_REPEATS, DUR_SAVES = ("none", "data", "full"), 5, 3
# fsyncs of one save by policy (the reference's count, pinned against it
# in tests/test_torch_storage.py): data = the payload; full = payload,
# sidecar and pointer, each with its directory after the rename
FSYNCS_PER_SAVE = {"none": 0, "data": 1, "full": 6}
# the eval phase: the evaluator against the Trainer's evaluate on the
# same checkpoint, same batches and kernels (bf16 forward): equal up to
# the order the two sum the batches in
EVAL_LOSS_TOL = 1e-5
# co-located: launch train on configs/quorum_k4_of_8.json (8 simulated
# replicas) paced so the evaluator sees several saves, and launch eval
# --single_device following it
COLOC_STEPS, COLOC_EVERY, COLOC_PACE_MS, COLOC_TEST = 40, 5, 150.0, 1000
COLOC_MAX_EVALS, COLOC_TIMEOUT_S, COLOC_EVAL_GRACE_S = 3, 240, 30
# an eval of the same checkpoint in another process: the same kernels
# on the same inputs
COLOC_LOSS_RTOL = 1e-6


def emit(obj) -> None:
    # one write, so that a line from another thread cannot split it
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


class PhaseError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def nvidia_smi() -> str | None:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 else None


# the script's own limit on its wall time, 60 s under the 1200 s a run
# of it is given: past it the running phase fails, every process below
# the script is stopped, and it exits 1
SCRIPT_LIMIT_S = 1140


# directories whose processes are the script's own wherever their parent
# is (a worker whose parent died is re-parented away from the script):
# a process working under one of them
OWN_DIRS: list = []


def descendants() -> list:
    """Every live (not zombie) process below this one, from ``/proc``'s
    parent links, parents before their children, and every other one
    working under one of ``OWN_DIRS``."""
    kids, cwds = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state != "Z":
            kids.setdefault(int(ppid), []).append(int(d))
            with contextlib.suppress(OSError):
                cwds[int(d)] = os.readlink(f"/proc/{d}/cwd").removesuffix(
                    " (deleted)")
    out, todo = [], [os.getpid()]
    while todo:
        for pid in kids.get(todo.pop(), ()):
            out.append(pid)
            todo.append(pid)
    out += [pid for pid, cwd in cwds.items() if pid not in out and any(
        cwd == d or cwd.startswith(d + "/") for d in OWN_DIRS)]
    return out


def stop_descendants() -> list:
    """Stop every process :func:`descendants` finds: each is frozen
    (SIGSTOP) until a walk finds none it has not frozen, so none forks
    out of reach, then all are killed, and this process, made their
    subreaper, reaps them for up to 5 s. Returns their command lines."""
    import ctypes
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # subreaper
    frozen: dict = {}
    for _ in range(50):
        new = [pid for pid in descendants() if pid not in frozen]
        if not new:
            break
        for pid in new:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    frozen[pid] = f.read().replace(b"\0", b" ").decode(
                        errors="replace").strip()[:200]
                os.kill(pid, signal.SIGSTOP)
            except OSError:
                frozen[pid] = None
    for pid in frozen:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    deadline = time.time() + 5
    while frozen and time.time() < deadline:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                time.sleep(0.05)
        except ChildProcessError:
            break
    return [cmd for cmd in frozen.values() if cmd is not None]


def guard_processes(phase) -> threading.Timer:
    """Make every way out of the script stop the processes below it:
    SIGTERM, SIGHUP and SIGINT, and a timer at ``SCRIPT_LIMIT_S`` that
    fails the phase ``phase()`` names. The caller stops them on its own
    way out, and cancels the timer."""
    def leave(error: str, code: int) -> None:
        emit({"phase": phase(), "ok": False, "error": error,
              "stopped": stop_descendants()})
        os._exit(code)

    owner = os.getpid()

    def on_signal(signum, frame):
        if os.getpid() != owner:  # a forked child's copy: die as before
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        leave(f"ended by signal {signum}", 128 + signum)

    for sig in (signal.SIGTERM, signal.SIGHUP, signal.SIGINT):
        signal.signal(sig, on_signal)
    timer = threading.Timer(SCRIPT_LIMIT_S, leave, args=(
        f"the script passed its limit of {SCRIPT_LIMIT_S} s", 1))
    timer.daemon = True
    timer.start()
    return timer


@functools.cache
def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on the card."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 1e7 / a.elapsed_time(b)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters``
    calls. The calls are queued behind a device-side sleep, so a call
    shorter than its own host-side launch cost is timed by the device,
    not by the host. The reading counts only if the start event is still
    pending once the host has issued every call; otherwise it is taken
    again behind a four times longer sleep."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sleep_ms = 2 * (time.perf_counter() - t0) * 1e3 + 1
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(_sleep_cycles_per_ms() * sleep_ms))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / iters
        sleep_ms *= 4
    raise PhaseError(f"the host could not queue {iters} calls within a "
                     f"{sleep_ms / 4:.0f} ms device sleep")


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


# -- phase 1 ----------------------------------------------------------------

def phase_env() -> dict:
    import torch
    rec = {"phase": "env", "nvidia_smi": nvidia_smi(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "cuda_available": torch.cuda.is_available()}
    emit(rec)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    try:
        import distributedmnist_tpu_torch  # noqa: F401
    except ImportError as e:
        raise PhaseError(f"the port package is not beside this script: {e}")
    rec["device"] = torch.cuda.get_device_name(0)
    return rec


# -- phase 2 ----------------------------------------------------------------

def _hgmma_counts(lib_path) -> dict:
    """HGMMA instructions per kernel instantiation in a built library's
    SASS (the toolkit's ``cuobjdump``)."""
    from distributedmnist_tpu_torch.ops import _build
    out = subprocess.run([_build.toolkit_tool("cuobjdump"), "-sass",
                          str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib_path} failed (rc "
          f"{out.returncode}): {out.stderr.strip()[-1000:]}")
    mangled, counts = [], []
    for line in out.stdout.splitlines():
        if "Function :" in line:
            mangled.append(line.split("Function :")[1].strip())
            counts.append(0)
        elif counts and "HGMMA" in line:
            counts[-1] += 1
    check(bool(mangled), f"cuobjdump found no kernel in {lib_path}")
    return dict(zip(_build.demangle(mangled), counts))


# the bf16 kernel instantiation each kernel launches on the main paths
# (head_dim 128; K5 with bf16 pages)
MAIN_PATH_KERNEL = {
    "K1": "flash_fwd_tc_kernel<128>", "K1-lse": "flash_fwd_tc_kernel<128>",
    "K2": "bwd_dq_tc_kernel<128>",
    "K3": "bwd_dkv_tc_kernel<128>",
    "K4": "bwd_fused_tc_kernel<128>",
    "K5": "paged_split_kernel<__nv_bfloat16, __nv_bfloat16, 128>"}
# those that run on the tensor cores: their SASS must hold HGMMA
TC_KEYS = ("K1", "K1-lse", "K2", "K3", "K4")


def _resources(key: str, shape, ptxas: dict) -> dict:
    """The bf16 kernel ``key`` takes at ``shape``: its variant, its
    registers and spill bytes (``ptxas -v``), and the dynamic shared
    memory and blocks per SM the CUDA runtime gives its launch."""
    import torch

    from distributedmnist_tpu_torch.ops import flash_attention as fa
    from distributedmnist_tpu_torch.ops import paged_attention as pa
    kernel = MAIN_PATH_KERNEL[key]
    row = ptxas.get(kernel)
    check(row is not None, f"{key}: {kernel} is not in the ptxas report")
    rec = {"instantiation": kernel, "registers": row["registers"],
           "spill_store_bytes": row["spill_store_bytes"],
           "spill_load_bytes": row["spill_load_bytes"]}
    if key == "K5":
        slots, _, heads, d = shape
        occ = pa.kernel_occupancy(torch.bfloat16, torch.bfloat16, slots,
                                  heads, d, DECODE["block_size"], _k5_width())
        return {"variant": pa.kernel_route(torch.bfloat16, d), **rec,
                "smem_bytes": occ["smem_bytes"], "threads": occ["threads"],
                "blocks_per_sm": occ["blocks_per_sm"],
                "warps_per_sm": occ["blocks_per_sm"] * occ["threads"] // 32,
                "cluster_size": occ["cluster_size"],
                "clusters_resident": occ["clusters_resident"]}
    occ = fa.kernel_occupancy(key, torch.bfloat16, tuple(shape))
    return {"variant": fa.kernel_route(key, torch.bfloat16, shape[-1]),
            **rec, "smem_bytes": occ["smem_bytes"],
            "blocks_per_sm": occ["blocks_per_sm"],
            "warps_per_sm": occ["blocks_per_sm"] * occ["threads"] // 32}


def _main_path_shapes() -> dict:
    """Each kernel's [b, s, h, d] on the main paths: the largest prefill
    bucket (K1), the training step (K1-lse, K2, K3), the seq-64 run
    (K4), one decode iteration (K5: slots, 1, heads, d)."""
    h, d = MODEL["num_heads"], MODEL["model_dim"] // MODEL["num_heads"]
    train = [TRAIN["data"]["batch_size"], MODEL["seq_len"], h, d]
    return {"K1": [1, DECODE["max_prompt_len"], h, d], "K1-lse": train,
            "K2": train, "K3": train, "K4": [K4_BATCH, K4_SEQ, h, d],
            "K5": [DECODE["decode_slots"], 1, h, d]}


def phase_build() -> dict:
    from distributedmnist_tpu_torch.ops import _build
    t0 = time.time()
    compiled = _build.build()
    for name in _build.SOURCES:
        _build.load_library(name)
    seconds = round(time.time() - t0, 3)
    ptxas = {name: _build.ptxas_report(name) for name in _build.SOURCES}
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        hgmma = dict(zip(_build.SOURCES, pool.map(
            lambda n: _hgmma_counts(_build.library_path(n)),
            _build.SOURCES)))
    by_kernel = {row["kernel"]: row for rows in ptxas.values()
                 for row in rows}
    resources = {key: _resources(key, shape, by_kernel)
                 for key, shape in _main_path_shapes().items()}
    emit({"phase": "build", "seconds": seconds, "compiled": compiled,
          "ptxas": ptxas, "hgmma": hgmma, "main_path": resources})
    counts = {k: n for per_lib in hgmma.values() for k, n in per_lib.items()}
    for key in TC_KEYS:
        kernel = MAIN_PATH_KERNEL[key]
        check(counts.get(kernel, 0) > 0,
              f"{key}: {kernel} has no HGMMA instruction in its SASS")
    return resources


# -- phase 3 ----------------------------------------------------------------

def _k1_case(b: int, s: int, dtype, gen, timed: bool,
             h: int = MODEL["num_heads"]) -> dict:
    import torch
    import torch.nn.functional as F

    from distributedmnist_tpu_torch.ops.flash_attention import (
        flash_attention_bshd, flash_attention_bshd_plain)
    d = MODEL["model_dim"] // MODEL["num_heads"]
    # the model's inputs: strided q/k/v views of one [b, s, 3, h·d]
    # product
    qkv = torch.randn(b, s, 3, h * d, device=DEVICE, generator=gen).to(dtype)
    q, k, v = (qkv[:, :, i].view(b, s, h, d) for i in range(3))
    got = flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    want = flash_attention_bshd_plain(q, k, v)
    name = str(dtype).split(".")[-1]
    agree = _agreement(got, want, (TOL[("K1", name)], 0.0))
    rec = {"kernel": "K1", "dtype": name, "shape": [b, s, h, d],
           "max_abs_err": agree["max_abs_err"], "tol": TOL[("K1", name)],
           "rel_err": agree["rel_err"], "rel_tol": REL_TOL[name],
           "mean_abs_plain": agree["mean_abs_plain"]}
    if timed:
        item = qkv.element_size()
        nbytes = 4 * b * s * h * d * item
        flops = 4 * b * h * d * s * (s + 1) / 2  # causal pairs only
        t, by = bound(nbytes, flops, name)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec.update(
            ms=time_ms(lambda: flash_attention_bshd(q, k, v)),
            plain_ms=time_ms(lambda: flash_attention_bshd_plain(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            bound_ms=t * 1e3, bound_by=by)
    return rec


def _k5_width() -> int:
    """Table entries a slot has on the decode path."""
    return -(-(DECODE["max_prompt_len"] + DECODE["max_new_tokens"])
             // DECODE["block_size"])


def _k5_bound(lengths, q_item: int, kv_item: int,
              h: int = MODEL["num_heads"]) -> tuple[float, str]:
    """K5's least time for one call over ``lengths`` at ``h`` heads: q,
    the live K/V rows, the tables and lengths read once, the float32
    output written once; 4 FLOP per live K/V element."""
    S, H = len(lengths), h
    D = MODEL["model_dim"] // MODEL["num_heads"]
    ctx = sum(lengths)
    nbytes = (S * H * D * q_item + 2 * ctx * H * D * kv_item
              + S * _k5_width() * 4 + S * 4 + S * H * D * 4)
    return bound(nbytes, 4 * ctx * H * D, "bfloat16" if kv_item == 2
                 else "float32")


def _k5_lengths() -> list:
    """Mid-generation contexts of the e2e requests, one slot idle."""
    S = DECODE["decode_slots"]
    return [p + m // 2 for p, m in REQUESTS[:S - 1]] + [0]


def _k5_tables(lengths, first_block: int):
    """Block tables giving each slot its own blocks, in order from
    ``first_block``."""
    import torch
    B = DECODE["block_size"]
    tables = torch.zeros(len(lengths), _k5_width(), dtype=torch.int32)
    used = first_block
    for i, n in enumerate(lengths):
        nb = -(-n // B)
        tables[i, :nb] = torch.arange(used, used + nb, dtype=torch.int32)
        used += nb
    return tables, used


def _k5_cold_ms(dtype, gen, l2_bytes: float = 50e6) -> tuple[float, float]:
    """K5's device ms over a rotation of input sets, each with its own
    live blocks of one page pool, whose live K/V together exceed twice
    the L2: each call finds its pages in device memory. Returns (ms, the
    live K/V bytes of the rotation)."""
    import itertools

    import torch

    from distributedmnist_tpu_torch.ops.paged_attention import \
        paged_attention
    S, H = DECODE["decode_slots"], MODEL["num_heads"]
    D, B = MODEL["model_dim"] // H, DECODE["block_size"]
    lengths = _k5_lengths()
    live = 2 * sum(lengths) * H * D * torch.tensor([], dtype=dtype
                                                   ).element_size()
    n_sets = 16
    check(n_sets * live > 2 * l2_bytes, "the rotation fits the L2")
    tabs, used = [], 1
    for _ in range(n_sets):
        t, used = _k5_tables(lengths, used)
        tabs.append(t.to(DEVICE))
    kp = torch.randn(used, B, H, D, device=DEVICE, generator=gen).to(dtype)
    vp = torch.randn(used, B, H, D, device=DEVICE, generator=gen).to(dtype)
    qkv = torch.randn(S, 3, H * D, device=DEVICE, generator=gen).to(dtype)
    q = qkv[:, 0].view(S, H, D)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    turn = itertools.cycle(tabs)
    ms = time_ms(lambda: paged_attention(q, kp, vp, next(turn), lens),
                 iters=2 * n_sets)
    return ms, n_sets * live


def _k5_inputs(dtype, gen, h: int = MODEL["num_heads"]):
    import torch
    S, H = DECODE["decode_slots"], h
    D = MODEL["model_dim"] // MODEL["num_heads"]
    B, N = DECODE["block_size"], DECODE["num_blocks"]
    P = _k5_width()
    kp = torch.randn(N, B, H, D, device=DEVICE, generator=gen).to(dtype)
    vp = torch.randn(N, B, H, D, device=DEVICE, generator=gen).to(dtype)
    kp[0], vp[0] = 37.0, -53.0   # poisoned null block: never read
    lengths = _k5_lengths()
    tables = torch.zeros(S, P, dtype=torch.int32)
    order = torch.randperm(N - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    used = 0
    for i, n in enumerate(lengths):
        nb = -(-n // B)
        tables[i, :nb] = order[used:used + nb].int()
        used += nb
    qkv = torch.randn(S, 3, H * D, device=DEVICE, generator=gen).to(dtype)
    q = qkv[:, 0].view(S, H, D)
    return (q, kp, vp, tables.to(DEVICE),
            torch.tensor(lengths, dtype=torch.int32, device=DEVICE))


def _k5_case(dtype, gen, timed: bool, h: int = MODEL["num_heads"],
             cold: bool = True) -> dict:
    """K5 at ``h`` heads (a tensor-parallel rank's share with ``h <
    num_heads``) against its plain version; ``timed``: with its device
    ms, the plain version's and its bound (``cold``: also over a
    rotation of page sets larger than the L2)."""
    import torch

    from distributedmnist_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_dense)
    q, kp, vp, tables, lengths = _k5_inputs(dtype, gen, h)
    got = paged_attention(q, kp, vp, tables, lengths)
    again = paged_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    want = paged_attention_dense(q, kp, vp, tables, lengths)
    name = str(dtype).split(".")[-1]
    idle = lengths == 0
    check(torch.count_nonzero(got[idle]).item() == 0,
          "K5: an idle slot's output is not exactly zero")
    check(torch.equal(got, again), "K5: two calls differ")
    agree = _agreement(got, want, (TOL[("K5", name)], 0.0))
    rec = {"kernel": "K5", "dtype": name, "slots": q.shape[0],
           "heads": h, "lengths": lengths.tolist(), "pages": list(kp.shape),
           "max_abs_err": agree["max_abs_err"], "tol": TOL[("K5", name)],
           # K5 outputs float32 for either input dtype
           "rel_err": agree["rel_err"], "rel_tol": REL_TOL["float32"],
           "mean_abs_plain": agree["mean_abs_plain"]}
    if timed:
        t, by = _k5_bound(lengths.tolist(), q.element_size(),
                          kp.element_size(), h)
        if cold:
            ms_cold, rotation_bytes = _k5_cold_ms(dtype, gen)
            rec.update(ms_cold=ms_cold, cold_rotation_bytes=rotation_bytes)
        rec.update(
            ms=time_ms(lambda: paged_attention(q, kp, vp, tables, lengths)),
            plain_ms=time_ms(lambda: paged_attention_dense(
                q, kp, vp, tables, lengths)),
            library_ms=None, bound_ms=t * 1e3, bound_by=by)
    return rec


def _agreement(got, want, tol) -> dict:
    """``got`` against ``want``: the max abs error, its largest share of
    ``atol + rtol |want|``, the relative error of the whole tensor
    ``||got - want|| / ||want||``, and the mean ``|want|`` that atol is
    held against."""
    atol, rtol = tol
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return {"max_abs_err": diff.max().item(),
            "tol_ratio": (diff / (atol + rtol * w.abs())).max().item(),
            "rel_err": (diff.norm() / w.norm().clamp_min(1e-30)).item(),
            "mean_abs_plain": w.abs().mean().item()}


def _train_attn_inputs(b: int, s: int, dtype, gen,
                       h: int = MODEL["num_heads"], packed: bool = True):
    """The training path's attention inputs: strided q/k/v views of one
    [b, s, 3, h·d] qkv product (head_dim 128), or with ``packed`` False
    three contiguous [b, s, h, d] tensors (what Ulysses' all-to-all
    gives), and a cotangent."""
    import torch
    d = MODEL["model_dim"] // MODEL["num_heads"]
    qkv = torch.randn(b, s, 3, h * d, device=DEVICE, generator=gen).to(dtype)
    q, k, v = (qkv[:, :, i].view(b, s, h, d) for i in range(3))
    if not packed:
        q, k, v = (x.contiguous() for x in (q, k, v))
    do = torch.randn(b, s, h, d, device=DEVICE, generator=gen).to(dtype)
    return q, k, v, do


def _attn_pairs(b: int, s: int, h: int) -> float:
    """Causal (query, key) pairs of one call, over every head."""
    return b * h * s * (s + 1) / 2


def _sdpa_ms(q, k, v, do) -> tuple[float, float]:
    """Library yardstick: forward and backward ms of
    ``F.scaled_dot_product_attention(is_causal=True)`` under autograd
    (backward = forward+backward - forward), on [b, h, s, d] copies."""
    import torch
    import torch.nn.functional as F
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    fwd = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    fwd_ms = time_ms(fwd, iters=10)
    total_ms = time_ms(lambda: torch.autograd.grad(fwd(), (qs, ks, vs), dos),
                       iters=10)
    return fwd_ms, total_ms - fwd_ms


def _k1_lse_case(b: int, s: int, dtype, gen, timed: bool,
                 h: int = MODEL["num_heads"], packed: bool = True) -> dict:
    import torch

    from distributedmnist_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _train_attn_inputs(b, s, dtype, gen, h, packed)
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_fwd_lse_plain(q, k, v)
    name = str(dtype).split(".")[-1]
    agree = _agreement(o, want_o, BWD_TOL[name])
    lse_agree = _agreement(lse, want_lse, BWD_TOL["lse"])
    rec = {"kernel": "K1-lse", "dtype": name, "shape": list(q.shape),
           "packed": packed,
           "max_abs_err": agree["max_abs_err"],
           "lse_max_abs_err": lse_agree["max_abs_err"],
           "tol_ratio": max(agree["tol_ratio"], lse_agree["tol_ratio"]),
           "tol": {"o": BWD_TOL[name], "lse": BWD_TOL["lse"]},
           "rel_err": agree["rel_err"], "rel_tol": REL_TOL[name],
           "mean_abs_plain": agree["mean_abs_plain"]}
    if timed:
        bb, ss, h, d = q.shape
        nbytes = 4 * bb * ss * h * d * q.element_size() + bb * h * ss * 4
        t, by = bound(nbytes, 4 * d * _attn_pairs(bb, ss, h), name)
        fwd_ms, bwd_ms = _sdpa_ms(q, k, v, do)
        rec.update(ms=time_ms(lambda: fa.flash_attention_fwd_lse(q, k, v)),
                   plain_ms=time_ms(
                       lambda: fa.flash_attention_fwd_lse_plain(q, k, v),
                       iters=10),
                   library_ms=fwd_ms, library_bwd_ms=bwd_ms,
                   bound_ms=t * 1e3, bound_by=by)
    return rec


# per kernel: the plain-backward outputs it computes, the [b, s, h, d]
# tensors it reads and writes, and its score-sized products (each
# 2·d FLOP a causal pair: q·kᵀ and do·vᵀ recomputed, then dq = ds·k /
# dv = pᵀ·do and dk = dsᵀ·q)
_BWD = {"K2": ((0,), 5, 1, 3), "K3": ((1, 2), 5, 2, 4),
        "K4": ((0, 1, 2), 5, 3, 5)}


def _bwd_case(kernel: str, b: int, s: int, dtype, gen,
              timed: bool, h: int = MODEL["num_heads"],
              packed: bool = True) -> dict:
    import torch

    from distributedmnist_tpu_torch.ops import flash_attention as fa
    fn = {"K2": fa.flash_attention_bwd_dq, "K3": fa.flash_attention_bwd_dkv,
          "K4": fa.flash_attention_bwd_fused}[kernel]
    outs, n_in, n_out, products = _BWD[kernel]
    q, k, v, do = _train_attn_inputs(b, s, dtype, gen, h, packed)
    o, lse = fa.flash_attention_fwd_lse_plain(q, k, v)
    got = fn(q, k, v, o, lse, do)
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    name = str(dtype).split(".")[-1]
    agree = [_agreement(g, want[i], BWD_TOL[name])
             for g, i in zip(got, outs)]
    worst = lambda key: max(a[key] for a in agree)
    rec = {"kernel": kernel, "dtype": name, "shape": list(q.shape),
           "packed": packed, "route": fa.backward_route(s),
           "max_abs_err": worst("max_abs_err"),
           "tol_ratio": worst("tol_ratio"), "tol": BWD_TOL[name],
           "rel_err": worst("rel_err"), "rel_tol": REL_TOL[name],
           "mean_abs_plain": min(a["mean_abs_plain"] for a in agree)}
    if timed:
        bb, ss, h, d = q.shape
        nbytes = ((n_in + n_out) * bb * ss * h * d * q.element_size()
                  + bb * h * ss * 4)
        t, by = bound(nbytes, products * 2 * d * _attn_pairs(bb, ss, h),
                      name)
        _, bwd_ms = _sdpa_ms(q, k, v, do)
        rec.update(ms=time_ms(lambda: fn(q, k, v, o, lse, do)),
                   # the plain backward computes dq, dk and dv at once
                   plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
                       q, k, v, o, lse, do), iters=10),
                   library_ms=bwd_ms, bound_ms=t * 1e3, bound_by=by)
    return rec


def phase_kernels() -> dict:
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        # the prefill buckets the e2e prompts fall into
        for s in (8, 32, 64, 128, 256, 512):
            cases.append(_k1_case(1, s, dtype, gen,
                                  timed=(dtype == torch.bfloat16
                                         and s == 512)))
        cases.append(_k5_case(dtype, gen, timed=dtype == torch.bfloat16))
    # the evaluator's shape (launch eval on the training configuration)
    cases.append(_k1_case(TRAIN["eval"]["eval_batch_size"], MODEL["seq_len"],
                          torch.bfloat16, gen, timed=False))
    emit({"phase": "kernels", "cases": cases})
    for c in cases:
        check(c["max_abs_err"] <= c["tol"],
              f"{c['kernel']} {c['dtype']} disagrees with its plain "
              f"version: max abs err {c['max_abs_err']} > {c['tol']}")
    # the training kernels: bfloat16 (the path's dtype) at the full
    # training batch, timed; float32 at a batch of 2
    seq, batch = MODEL["seq_len"], TRAIN["data"]["batch_size"]
    train_cases = []
    for dtype, b, k4_b in ((torch.float32, 2, 4),
                           (torch.bfloat16, batch, K4_BATCH)):
        timed = dtype == torch.bfloat16
        train_cases.append(_k1_lse_case(b, seq, dtype, gen, timed))
        train_cases.append(_bwd_case("K2", b, seq, dtype, gen, timed))
        train_cases.append(_bwd_case("K3", b, seq, dtype, gen, timed))
        train_cases.append(_bwd_case("K4", k4_b, K4_SEQ, dtype, gen, timed))
        torch.cuda.empty_cache()
    # the long-context path's shape (bench.py bench_flash_long_context)
    lc_b, lc_s, lc_h = LONG["batch"], LONG["seq_len"], LONG["num_heads"]
    long_cases = [_k1_lse_case(lc_b, lc_s, torch.bfloat16, gen, False,
                               lc_h)]
    for kernel in ("K2", "K3"):
        torch.cuda.empty_cache()
        long_cases.append(_bwd_case(kernel, lc_b, lc_s, torch.bfloat16, gen,
                                    False, lc_h))
    torch.cuda.empty_cache()
    mp_k1, mp_train = _mp_kernel_cases(gen)
    tp_cases = _tp_kernel_cases(gen)
    emit({"phase": "kernels", "tp_serving_cases": tp_cases})
    for c in tp_cases:
        check(c["max_abs_err"] <= c["tol"]
              and c["rel_err"] <= c["rel_tol"],
              f"{c['kernel']} at a TP rank's heads disagrees with its plain "
              f"version: max abs err {c['max_abs_err']} (tol {c['tol']}), "
              f"relative {c['rel_err']} (tol {c['rel_tol']})")
    emit({"phase": "kernels", "cases": train_cases + long_cases})
    emit({"phase": "kernels", "model_parallel_cases": mp_k1 + mp_train})
    for c in mp_k1:
        check(c["max_abs_err"] <= c["tol"],
              f"K1 {c['shape']} disagrees with its plain version: max abs "
              f"err {c['max_abs_err']} > {c['tol']}")
    for c in train_cases + long_cases + mp_train:
        check(c["tol_ratio"] <= 1.0,
              f"{c['kernel']} {c['dtype']} {c['shape']} disagrees with its "
              f"plain version beyond atol + rtol |plain| {c['tol']}: "
              f"max abs err {c['max_abs_err']}")
    for c in cases + train_cases + long_cases + mp_k1 + mp_train:
        check(c["rel_err"] <= c["rel_tol"],
              f"{c['kernel']} {c['dtype']} {c.get('shape', '')} disagrees "
              f"with its plain version: relative error {c['rel_err']} > "
              f"{c['rel_tol']}")
    timed = {c["kernel"]: c for c in cases + train_cases if "ms" in c}
    for c in long_cases:
        timed[c["kernel"]]["long_context"] = {
            k: c[k] for k in ("shape", "max_abs_err", "rel_err", "bound_ms",
                              "bound_by") if k in c}
    for c in mp_k1 + mp_train:
        timed[c["kernel"]].setdefault("model_parallel_shapes", []).append(
            {k: c[k] for k in ("shape", "packed", "max_abs_err", "rel_err")
             if k in c})
    for c in tp_cases:
        timed[c["kernel"]].setdefault("tp_serving_shapes", []).append(
            {k: c[k] for k in ("shape", "heads", "slots", "max_abs_err",
                               "rel_err", "ms", "plain_ms", "bound_ms",
                               "bound_by") if k in c})
    return timed


def _tp_kernel_cases(gen) -> list:
    """K1 and K5 at a rank's share of a 2-rank TP serving group (the
    ``serving_chaos`` TP arm): K1 at ``[1, s, h/2, hd]`` for the arm's
    prefill buckets (strided views of the rank's qkv product), K5 over
    ``h/2`` heads; bfloat16 (the publisher's compute dtype), the largest
    bucket and K5 timed."""
    import torch
    bf, h = torch.bfloat16, MODEL["num_heads"] // TP_SERVING["ranks"]
    buckets = [2 ** i for i in range(TP_SERVING["max_prompt_len"]
                                     .bit_length())]
    cases = [_k1_case(1, s, bf, gen, timed=s == buckets[-1], h=h)
             for s in buckets]
    cases.append(_k5_case(bf, gen, timed=True, h=h, cold=False))
    return cases


def _mp_kernel_cases(gen) -> tuple[list, list]:
    """K1, K1-lse, K2 and K3 at the ``model_parallel`` phase's shapes,
    each against its plain version (untimed): K1 at A's and B's TP eval
    (4 and 8 heads a rank, strided views of the rank's qkv product; 8
    is E's too), D's (16 heads, every head on every expert rank) and G's
    microbatch of 2 rows at TP 2 (its eval's and its forward works');
    K1-lse/K2/K3 at A's TP 4 (strided), at B's Ulysses after TP 2, at
    C's Ulysses at S = 8192 (contiguous, from the all-to-all), at D's
    16 heads and E's TP 2 (strided), at F's microbatch of 4 rows (16
    heads), G's of 2 rows (TP 2, strided) and H's replica of 4 rows
    (TP 2, strided)."""
    import torch
    bf, b, s, h = torch.bfloat16, MP_BATCH, MODEL["seq_len"], \
        MODEL["num_heads"]
    k1 = [_k1_case(b, s, bf, gen, False, h=h // MP_WORLD),
          _k1_case(b, s, bf, gen, False, h=h // 2),
          _k1_case(b, s, bf, gen, False, h=h),
          _k1_case(b // 4, s, bf, gen, False, h=h // 2)]
    train = []
    for bb, ss, hh, packed in ((b, s, h // MP_WORLD, True),
                               (b, s, h // 2 // 2, False),
                               (LONG["batch"], LONG["seq_len"],
                                LONG["num_heads"] // MP_WORLD, False),
                               (b, s, h, True), (b, s, h // 2, True),
                               (b // 2, s, h, True),
                               (b // 4, s, h // 2, True),
                               (b // 2, s, h // 2, True)):
        train.append(_k1_lse_case(bb, ss, bf, gen, False, hh, packed))
        for kernel in ("K2", "K3"):
            train.append(_bwd_case(kernel, bb, ss, bf, gen, False, hh,
                                   packed))
        torch.cuda.empty_cache()
    return k1, train


# -- phase 4 ----------------------------------------------------------------

def _drive(port: int, prompts, tag: str) -> tuple[list, list, float]:
    from distributedmnist_tpu_torch.servesvc import ServeClient
    client = ServeClient([("127.0.0.1", port)], deadline_s=300.0)
    check(client.meta() is not None, "the replica answers no meta probe")
    outs: list = [None] * len(prompts)
    times: list = [[] for _ in prompts]

    def go(i):
        prompt, max_tokens = prompts[i]
        outs[i] = client.generate(
            prompt, request_id=f"{tag}-{i}", max_tokens=max_tokens,
            on_token=lambda rec: times[i].append(time.time()))

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return outs, times, time.time() - t0


def _kernels_vs_plain(rep, prompt) -> float:
    """One prefill + 3 decode steps through the kernels and through
    their plain versions on the card; returns the max abs logit
    difference."""
    import torch

    from distributedmnist_tpu_torch.models import transformer
    from distributedmnist_tpu_torch.ops.flash_attention import (
        flash_attention_bshd, flash_attention_bshd_plain)
    from distributedmnist_tpu_torch.servesvc.kv_cache import PagedKVCache
    L, H, D = rep.model.decode_cache_shape
    bs, slots = DECODE["block_size"], DECODE["decode_slots"]
    plen = len(prompt)
    bucket = rep._bucket(plen, DECODE["max_prompt_len"])
    toks = torch.zeros(1, bucket, dtype=torch.int64, device=DEVICE)
    toks[0, :plen] = torch.tensor(prompt)
    runs = {}
    for kind, attn, kern in (("kernel", flash_attention_bshd, "paged"),
                             ("plain", flash_attention_bshd_plain, "dense")):
        cache = PagedKVCache(L, 16, bs, H, D, rep.cache.max_blocks_per_seq,
                             dtype=torch.bfloat16, device=DEVICE)
        logits, ks, vs = transformer.prefill_with_kv(
            rep._params, toks, num_heads=H, attention_fn=attn,
            compute_dtype=torch.bfloat16)
        table = cache.alloc_sequence(plen + 3)
        cache.write_prompt(table, ks[:, 0], vs[:, 0], plen)
        runs[kind] = dict(cache=cache, table=table,
                          logits=[logits[0, :plen]], kern=kern)
    tables = torch.zeros(slots, rep.cache.max_blocks_per_seq,
                         dtype=torch.int32, device=DEVICE)
    check((runs["kernel"]["table"] == runs["plain"]["table"]).all(),
          "the two fresh caches allocated different blocks")
    tables[0] = torch.from_numpy(runs["kernel"]["table"])
    nxt = int(torch.argmax(runs["kernel"]["logits"][0][-1]))
    for step in range(3):
        z = lambda dt: torch.zeros(slots, dtype=dt, device=DEVICE)
        tokens, positions, lengths = z(torch.int64), z(torch.int64), \
            z(torch.int32)
        tokens[0], positions[0], lengths[0] = nxt, plen + step, \
            plen + step + 1
        for r in runs.values():
            lg, _, _ = transformer.decode_step(
                rep._params, tokens, positions, r["cache"].k, r["cache"].v,
                tables, lengths, num_heads=H, block_size=bs,
                compute_dtype=torch.bfloat16, attention_kernel=r["kern"])
            r["logits"].append(lg[:1])
        nxt = int(torch.argmax(runs["kernel"]["logits"][-1][0]))
    return max(float((a - b).abs().max()) for a, b in
               zip(runs["kernel"]["logits"], runs["plain"]["logits"]))


def _profile_decode_step(rep, steps: int = 10) -> dict:
    """Where a decode iteration's time goes: ``torch.profiler`` over
    ``steps`` calls of the replica's ``decode_step`` with all slots live
    at the e2e requests' mid-generation lengths. Device busy time is
    the sum of kernel times (one stream, so kernels do not overlap);
    the idle share is 1 - busy / wall, with the wall timed over the same
    steps without the profiler (whose host overhead inflates it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    slots, bs = DECODE["decode_slots"], DECODE["block_size"]
    lengths = [p + m // 2 for p, m in REQUESTS][:slots]
    tables = [rep.cache.alloc_sequence(n) for n in lengths]
    check(all(t is not None for t in tables), "no free blocks to profile")
    dev = lambda a, dt: torch.tensor(a, dtype=dt, device=DEVICE)
    args = (dev([1] * slots, torch.int64),
            dev([n - 1 for n in lengths], torch.int64))
    tab = dev([t.tolist() for t in tables], torch.int32)
    lens = dev(lengths, torch.int32)

    def step():
        rep.model.decode_step(rep._params, *args, rep.cache.k, rep.cache.v,
                              tab, lens, block_size=bs,
                              attention_kernel=DECODE["attention_kernel"])

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.time() - t0) * 1e3 / steps
    for t in tables:
        rep.cache.free_sequence(t)
    by_class = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        cls = ("paged_attention" if "paged_split_kernel" in name else
               "gemm" if any(k in name for k in ("gemm", "gemv", "xmma",
                                                 "cutlass", "nvjet"))
               else "other")
        by_class[cls] += us / 1e3 / steps
        launches += e.count
    busy = sum(by_class.values())
    return {"lengths": lengths,
            "wall_ms": wall_ms, "wall_ms_under_profiler": profiled_ms,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy > 0
            else "not measured",
            "busy_ms_by_class": by_class,
            "kernels_per_step": launches / steps}


# -- phases 4 and 5 ---------------------------------------------------------

def _counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel."""
    from distributedmnist_tpu_torch.ops import flash_attention as fa
    from distributedmnist_tpu_torch.ops.paged_attention import \
        paged_attention
    return {"K1": fa.flash_attention_bshd,
            "K1-lse": fa.flash_attention_fwd_lse,
            "K2": fa.flash_attention_bwd_dq,
            "K3": fa.flash_attention_bwd_dkv,
            "K4": fa.flash_attention_bwd_fused, "K5": paged_attention}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def _build_trainer(tmp: str, name: str, *overrides: str):
    """The Trainer ``launch train`` runs, built through its own CLI
    ``build_trainer`` from a config file."""
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    path = f"{tmp}/{name}.json"
    with open(path, "w") as f:
        json.dump(TRAIN, f)
    return build_trainer(["train", "--config", path,
                          f"train.train_dir={tmp}/{name}", *overrides,
                          "--device", DEVICE])


def _copy_state(state):
    from distributedmnist_tpu_torch.parallel.api import tree_map
    clone = lambda t: t.clone()
    return dataclasses.replace(state, params=tree_map(clone, state.params),
                               momentum=tree_map(clone, state.momentum))


def _plain_attention():
    """The model's attention through the plain versions of K1-lse and
    K2/K3 on the card: the same forward-with-lse and FlashAttention-2
    backward the kernels compute, written in PyTorch."""
    import torch

    from distributedmnist_tpu_torch.ops import flash_attention as fa

    class Plain(torch.autograd.Function):
        generate_vmap_rule = True  # the 8-replica step vmaps it

        @staticmethod
        def forward(q, k, v):
            return fa.flash_attention_fwd_lse_plain(q, k, v)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.mark_non_differentiable(output[1])
            ctx.save_for_backward(*inputs, *output)

        @staticmethod
        def backward(ctx, do, _dlse):
            return fa.flash_attention_bwd_plain(*ctx.saved_tensors, do)

    def attn(q, k, v):
        return Plain.apply(q, k, v)[0]

    attn.layout = "bshd"
    return attn


def _step_vs_plain(trainer, batch) -> tuple[float, float]:
    """One train step through the kernels and one through their plain
    versions, from copies of the same state on the same batch: (|loss
    difference|, max |param difference| after the update)."""
    import torch

    from distributedmnist_tpu_torch.models import transformer
    from distributedmnist_tpu_torch.parallel.api import (build_train_step,
                                                         tree_leaves)
    attn = _plain_attention()
    cfg = trainer.model

    def plain_apply(params, tokens, positions=None, *, train=False,
                    dropout_keep=None):
        return transformer.apply(params, tokens, num_heads=MODEL["num_heads"],
                                 attention_fn=attn, positions=positions,
                                 compute_dtype=cfg.compute_dtype)

    plain_step = build_train_step(dataclasses.replace(cfg, apply=plain_apply),
                                  trainer.cfg, trainer.schedule)
    out = []
    for step_fn in (trainer.step_fn, plain_step):
        state, m = step_fn(_copy_state(trainer.state), batch)
        out.append((m["loss"].item(), tree_leaves(state.params)))
        torch.cuda.synchronize()
    (l1, p1), (l2, p2) = out
    return abs(l1 - l2), max((a - b).abs().max().item()
                             for a, b in zip(p1, p2))


def _time_steps(trainer, batch, steps: int = 5, step_fn=None) -> float:
    """Device ms of one train step (CUDA events around ``steps``) of
    ``step_fn`` (the trainer's own by default) on the trainer's state."""
    import torch
    step_fn = step_fn or trainer.step_fn
    state = trainer.state
    state, _ = step_fn(state, batch)  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(steps):
        state, _ = step_fn(state, batch)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / steps


def _kernel_class(name: str) -> str:
    """A transformer step's kernel by class: the flash kernels
    (K1-lse/K2/K3/K4, either variant), GEMMs, or other."""
    name = name.lower()
    if any(k in name for k in ("flash_fwd_", "bwd_dq_", "bwd_dkv_",
                               "bwd_fused_")):
        return "attention"
    if any(k in name for k in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "gemm"
    return "other"


def _profile_train_step(trainer, batch, wall_ms: float,
                        steps: int = 3) -> dict:
    """``torch.profiler`` over ``steps`` train steps: device time by
    class (GEMMs, the attention kernels K1-lse/K2/K3/K4 in either
    variant, every other kernel) and the idle share 1 - busy / wall,
    with the wall the unprofiled CUDA-event step time (one stream:
    kernels do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = trainer.state
        for _ in range(steps):
            state, _ = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
    by_class = {"gemm": 0.0, "attention": 0.0, "other": 0.0}
    launches = 0
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_class[_kernel_class(e.key)] += us / 1e3 / steps
        launches += e.count
        top.append((us / 1e3 / steps, e.key[:60]))
    busy = sum(by_class.values())
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy > 0
            else "not measured",
            "busy_ms_by_class": by_class,
            "kernels_per_step": launches / steps,
            "top_kernels_ms": [[round(t, 3), k] for t, k in
                               sorted(top, reverse=True)[:8]]}


LAMB_STEPS = 5


def _train_lamb_arm(tmp: str, batch, layers: int) -> dict:
    """The training configuration under LAMB with bf16 params over
    float32 masters, ``LAMB_STEPS`` steps: K1-lse, K2 and K3 launched
    ``layers`` times a step, ms a step, peak memory, the storage dtypes."""
    import torch

    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _build_trainer(tmp, "train_lamb", "optim.name=lamb",
                        "precision.param_dtype=bfloat16",
                        "precision.master_weights=true",
                        f"train.max_steps={LAMB_STEPS}")
    losses = []
    reset_counts()
    tr.run(step_callback=lambda step, rec: losses.append(rec["loss"]))
    torch.cuda.synchronize()
    counts = read_counts()
    rec = {"steps": LAMB_STEPS, "launches": counts,
           "per_step": {k: counts[k] / LAMB_STEPS
                        for k in ("K1-lse", "K2", "K3")},
           "first_loss": losses[0], "last_loss": losses[-1],
           "ms_per_step": _time_steps(tr, batch),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "param_dtypes": sorted({str(x.dtype)
                                   for x in tree_leaves(tr.state.params)}),
           "slot_dtypes": sorted({str(x.dtype)
                                  for x in tree_leaves(tr.state.momentum)}),
           "slot_trees": sorted(tr.state.momentum)}
    check(all(rec["per_step"][k] == layers for k in rec["per_step"])
          and counts["K4"] == counts["K1"] == counts["K5"] == 0
          and all(map(math.isfinite, losses))
          and rec["param_dtypes"] == ["torch.float32"]
          and rec["slot_dtypes"] == ["torch.float32"]
          and rec["slot_trees"] == ["m", "v"], f"LAMB arm: {rec}")
    return rec


def _train_flops(batch: int) -> float:
    """bench.py's count for one training step of ``MODEL`` at
    ``batch`` sequences: the forward's matmul and attention FLOPs a
    token, × 3 for forward and backward."""
    d, V, S = MODEL["model_dim"], MODEL["vocab_size"], MODEL["seq_len"]
    per_token = MODEL["num_layers"] * (24 * d * d + 2 * S * d) + 2 * d * V
    return 3 * per_token * batch * S


def phase_train(tmp: str) -> dict:
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.models.convert import params_to_reference
    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    trainer = _build_trainer(tmp, "train")
    check(trainer.device.type == DEVICE, f"trainer on {trainer.device}")
    B, S = TRAIN["data"]["batch_size"], MODEL["seq_len"]
    tr = trainer.datasets.train
    batch = to_device({"image": tr.images[:B], "label": tr.labels[:B]},
                      trainer.device)
    loss_diff, param_diff = _step_vs_plain(trainer, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    reset_counts()
    t0 = time.time()
    summary = trainer.run(
        step_callback=lambda step, rec: losses.append(rec["loss"]))
    torch.cuda.synchronize()
    run_s = time.time() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = MODEL["num_layers"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k in ("K1-lse", "K2", "K3"):
        check(counts[k] == layers * TRAIN_STEPS,
              f"{k} launched {counts[k]} times in {TRAIN_STEPS} steps")
    check(counts["K4"] == counts["K1"] == counts["K5"] == 0,
          f"unexpected launches {counts}")
    saved, _, step = ckpt.restore_state(trainer.train_dir)
    check(step == TRAIN_STEPS and ckpt.params_digest(saved["params"])
          == summary["params_digest"]
          == ckpt.params_digest(params_to_reference(trainer.state.params)),
          "the checkpoint read back is not the trained params")
    reset_counts()
    ev = trainer.evaluate("test")
    eval_counts = read_counts()
    n_eval = -(-trainer.datasets.test.num_examples
               // TRAIN["eval"]["eval_batch_size"])
    check(eval_counts["K1"] == layers * n_eval
          and eval_counts["K1-lse"] == 0 and math.isfinite(ev["loss"]),
          f"eval: {ev}, launches {eval_counts}")
    ms = _time_steps(trainer, batch)
    profile = _profile_train_step(trainer, batch, ms)
    lamb = _train_lamb_arm(tmp, batch, layers)
    flops = _train_flops(B)
    rec = {"phase": "train", "steps": TRAIN_STEPS, "batch": B, "seq": S,
           "first_loss": losses[0], "last_loss": losses[-1],
           "launches": counts, "per_step": {
               k: counts[k] / TRAIN_STEPS for k in ("K1-lse", "K2", "K3")},
           "step_vs_plain": {"loss_abs_diff": loss_diff,
                             "loss_tol": STEP_LOSS_TOL,
                             "param_max_abs_diff": param_diff,
                             "param_tol": STEP_PARAM_TOL},
           "checkpoint_step": step, "eval": ev, "eval_launches": eval_counts,
           "run_s": run_s, "ms_per_step": ms,
           "tokens_per_s": B * S / (ms / 1e3),
           "model_tflops_per_s": flops / (ms / 1e3) / 1e12,
           "peak_mem_gb": peak_gb, "profile": profile, "lamb_arm": lamb,
           "train_dir": str(trainer.train_dir)}
    emit(rec)
    check(loss_diff <= STEP_LOSS_TOL and param_diff <= STEP_PARAM_TOL,
          f"kernel step vs plain step: loss diff {loss_diff}, param diff "
          f"{param_diff}")
    return rec


def phase_train_k4(tmp: str) -> dict:
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.ops.flash_attention import backward_route
    check(backward_route(K4_SEQ) == "fused", f"seq {K4_SEQ} is not one tile")
    trainer = _build_trainer(tmp, "train_k4", f"model.seq_len={K4_SEQ}",
                             f"data.batch_size={K4_BATCH}",
                             f"train.max_steps={K4_STEPS}")
    tr = trainer.datasets.train
    batch = to_device({"image": tr.images[:K4_BATCH],
                       "label": tr.labels[:K4_BATCH]}, trainer.device)
    loss_diff, param_diff = _step_vs_plain(trainer, batch)
    losses = []
    reset_counts()
    trainer.run(step_callback=lambda step, rec: losses.append(rec["loss"]))
    torch.cuda.synchronize()
    counts = read_counts()
    ms = _time_steps(trainer, batch)
    layers = MODEL["num_layers"]
    rec = {"phase": "train_k4", "steps": K4_STEPS, "seq": K4_SEQ,
           "batch": K4_BATCH, "losses": losses, "launches": counts,
           "per_step": {k: counts[k] / K4_STEPS for k in ("K1-lse", "K4")},
           "step_vs_plain": {"loss_abs_diff": loss_diff,
                             "loss_tol": STEP_LOSS_TOL,
                             "param_max_abs_diff": param_diff,
                             "param_tol": STEP_PARAM_TOL},
           "ms_per_step": ms, "tokens_per_s": K4_BATCH * K4_SEQ / (ms / 1e3)}
    emit(rec)
    check(len(losses) == K4_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    check(counts["K4"] == counts["K1-lse"] == layers * K4_STEPS
          and counts["K2"] == counts["K3"] == 0,
          f"launches {counts}")
    check(loss_diff <= STEP_LOSS_TOL and param_diff <= STEP_PARAM_TOL,
          f"kernel step vs plain step at seq {K4_SEQ}: loss diff "
          f"{loss_diff}, param diff {param_diff}")
    return rec


# -- the transformer over replicas, long context, the report --------------

def _trace_breakdown(path, steps: int) -> dict:
    """A Trainer profile window's Chrome trace (``trace.json``) read
    back: device ms a step by class (:func:`_kernel_class`), the window's
    device span a step (first kernel start to last kernel end) and the
    idle share 1 - busy / span, kernels a step, the largest kernels, and
    the flash kernels' names found."""
    events = [e for e in json.loads(open(path).read())["traceEvents"]
              if e.get("cat") == "kernel"]
    check(bool(events), f"{path} holds no device kernel")
    by_class = {"gemm": 0.0, "attention": 0.0, "other": 0.0}
    by_name: dict = {}
    for e in events:
        ms = e["dur"] / 1e3 / steps
        by_class[_kernel_class(e["name"])] += ms
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + ms
    busy = sum(by_class.values())
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) / 1e3 / steps
    flash = sorted({n for n in by_name if _kernel_class(n) == "attention"})
    return {"steps": steps, "device_busy_ms": busy, "span_ms": span,
            "device_idle_share": 1 - busy / span,
            "busy_ms_by_class": by_class,
            "kernels_per_step": len(events) / steps,
            "top_kernels_ms": [[round(t, 3), n[:60]] for t, n in sorted(
                ((t, n) for n, t in by_name.items()), reverse=True)[:8]],
            "flash_kernels": [n[:60] for n in flash]}


def phase_train_replicas(tmp: str, one_replica_ms: float) -> dict:
    """The training configuration over 8 simulated replicas in quorum
    k = 5 through the Trainer (the flash Functions' vmap rules fold the
    replicas into one launch a layer), with its profile window."""
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.parallel.api import build_train_step
    trainer = _build_trainer(
        tmp, "train_replicas", f"mesh.num_replicas={REPLICAS}",
        "sync.mode=quorum", f"sync.num_replicas_to_aggregate={REPLICA_K}",
        "sync.straggler_profile=lognormal",
        f"train.max_steps={REPLICA_STEPS}",
        f"train.profile_steps={list(REPLICA_WINDOW)}")
    check(trainer.topo.num_replicas == REPLICAS
          and trainer.topo.local_replica_count == REPLICAS
          and trainer.model.vmap_replicas, "not 8 vmapped local replicas")
    B = TRAIN["data"]["batch_size"]
    tr = trainer.datasets.train
    batch = to_device({"image": tr.images[:B], "label": tr.labels[:B]},
                      trainer.device)
    loss_diff, param_diff = _step_vs_plain(trainer, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, contributors = [], []

    def on_step(step, rec):
        losses.append(rec["loss"])
        contributors.append(rec["num_contributors"])

    reset_counts()
    trainer.run(step_callback=on_step)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = MODEL["num_layers"]
    trace = trainer.train_dir / "profile" / "trace.json"
    check(trace.is_file(), f"no profile window trace at {trace}")
    window = _trace_breakdown(trace, REPLICA_WINDOW[1] - REPLICA_WINDOW[0])
    ms = _time_steps(trainer, batch)
    # the same step with the replicas one at a time (plain autograd):
    # 8 launches a layer of batch 2 instead of one of batch 16
    loop_step = build_train_step(
        dataclasses.replace(trainer.model, vmap_replicas=False),
        trainer.cfg, trainer.schedule, trainer.topo)
    reset_counts()
    loop_step(trainer.state, batch)
    torch.cuda.synchronize()
    loop_counts = read_counts()
    loop_ms = _time_steps(trainer, batch, step_fn=loop_step)
    rec = {"phase": "train_replicas", "replicas": REPLICAS, "k": REPLICA_K,
           "steps": REPLICA_STEPS, "batch": B, "losses": losses,
           "num_contributors": contributors, "launches": counts,
           "per_step": {k: counts[k] / REPLICA_STEPS
                        for k in ("K1-lse", "K2", "K3")},
           "step_vs_plain": {"loss_abs_diff": loss_diff,
                             "loss_tol": STEP_LOSS_TOL,
                             "param_max_abs_diff": param_diff,
                             "param_tol": STEP_PARAM_TOL},
           "ms_per_step": ms, "one_replica_ms_per_step": one_replica_ms,
           "vs_one_replica": ms / one_replica_ms,
           "tokens_per_s": B * MODEL["seq_len"] / (ms / 1e3),
           "model_tflops_per_s": _train_flops(B) / (ms / 1e3) / 1e12,
           "loop": {"ms_per_step": loop_ms, "per_step": {
               k: loop_counts[k] for k in ("K1-lse", "K2", "K3")}},
           "peak_mem_gb": peak_gb, "profile_window": window}
    emit(rec)
    check(len(losses) == REPLICA_STEPS and all(map(math.isfinite, losses))
          and losses[-1] < losses[0], f"losses {losses}")
    check(all(c == REPLICA_K for c in contributors),
          f"num_contributors {contributors}")
    for k in ("K1-lse", "K2", "K3"):
        check(counts[k] == layers * REPLICA_STEPS
              and loop_counts[k] == layers * REPLICAS,
              f"{k}: {counts[k]} launches in {REPLICA_STEPS} steps "
              f"(folded), {loop_counts[k]} in one looped step")
    check(counts["K1"] == counts["K4"] == counts["K5"] == 0,
          f"unexpected launches {counts}")
    check(loss_diff <= STEP_LOSS_TOL and param_diff <= STEP_PARAM_TOL,
          f"8-replica kernel step vs plain step: loss diff {loss_diff}, "
          f"param diff {param_diff}")
    names = " ".join(window["flash_kernels"])
    check(all(k in names for k in ("flash_fwd", "bwd_dq", "bwd_dkv")),
          f"the profile window shows no K1-lse/K2/K3: {names}")
    return rec


def _long_trainer(tmp: str, arm: str):
    return _build_trainer(
        tmp, f"long_{arm}", *REMAT_ARMS[arm],
        f"model.model_dim={LONG['model_dim']}",
        f"model.num_layers={LONG['num_layers']}",
        f"model.num_heads={LONG['num_heads']}",
        f"model.seq_len={LONG['seq_len']}",
        f"data.batch_size={LONG['batch']}", "data.synthetic_train_size=8",
        "data.synthetic_test_size=2", "train.max_steps=1")


def phase_long_context(tmp: str) -> dict:
    """``bench.py bench_flash_long_context``'s model at S = 8192 in
    three arms — remat ``full``, ``save_attn`` and off: one step
    through the Trainer each (launch counts; losses and params held
    against the arm without remat), then timed steps and peak memory."""
    import gc

    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    B, S, L = LONG["batch"], LONG["seq_len"], LONG["num_layers"]
    d, V = LONG["model_dim"], MODEL["vocab_size"]
    fwd_per_token = L * (24 * d * d + 2 * S * d) + 2 * d * V
    arms, params = {}, {}
    for arm in ("off", "full", "save_attn"):
        trainer = _long_trainer(tmp, arm)
        tr = trainer.datasets.train
        batch = to_device({"image": tr.images[:B], "label": tr.labels[:B]},
                          trainer.device)
        losses = []
        reset_counts()
        trainer.run(step_callback=lambda step, r: losses.append(r["loss"]))
        torch.cuda.synchronize()
        counts = read_counts()
        params[arm] = [p.cpu() for p in tree_leaves(trainer.state.params)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = _time_steps(trainer, batch, LONG_TIMED)
        arms[arm] = {"launches": counts, "loss": losses[0],
                     "ms_per_step": ms,
                     "tokens_per_s": B * S / (ms / 1e3),
                     "model_tflops_per_s":
                         3 * fwd_per_token * B * S / (ms / 1e3) / 1e12,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
    for arm in ("full", "save_attn"):
        a = arms[arm]
        a["loss_abs_diff_vs_off"] = abs(a["loss"] - arms["off"]["loss"])
        a["param_max_abs_diff_vs_off"] = max(
            (x - y).abs().max().item()
            for x, y in zip(params[arm], params["off"]))
        a["bitwise_vs_off"] = (a["loss"] == arms["off"]["loss"] and all(
            torch.equal(x, y) for x, y in zip(params[arm], params["off"])))
    rec = {"phase": "long_context", **LONG, "vocab_size": V,
           "flops_per_step": 3 * fwd_per_token * B * S, "arms": arms}
    emit(rec)
    for arm, a in arms.items():
        c = a["launches"]
        check(c["K1-lse"] == LONG_K1_LSE_PER_LAYER[arm] * L
              and c["K2"] == c["K3"] == L
              and c["K1"] == c["K4"] == c["K5"] == 0,
              f"remat {arm}: launches {c}")
        check(math.isfinite(a["loss"]), f"remat {arm}: loss {a['loss']}")
    for arm in ("full", "save_attn"):
        a = arms[arm]
        check(a["loss_abs_diff_vs_off"] <= STEP_LOSS_TOL
              and a["param_max_abs_diff_vs_off"] <= STEP_PARAM_TOL,
              f"remat {arm} vs off after one step: {a}")
    check(arms["full"]["peak_mem_gb"] < arms["off"]["peak_mem_gb"],
          f"full remat peak {arms['full']['peak_mem_gb']} GB is not below "
          f"the {arms['off']['peak_mem_gb']} GB without remat")
    return rec


def _launch_verb(argv: list) -> str:
    """``python -m distributedmnist_tpu_torch.launch <argv>`` in this
    process (the CLI's ``main``); returns what it printed."""
    from distributedmnist_tpu_torch.launch.__main__ import main as launch
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch(list(argv))
    return out.getvalue()


def phase_report(tmp: str) -> dict:
    """``launch sweep`` on two of the repository's sweep configs (cut to
    ``SWEEP_STEPS`` steps) on the card, ``launch report`` on one run,
    the port's single-run invariants on every run's artifacts, and
    ``launch devices``."""
    from pathlib import Path

    import torch

    from distributedmnist_tpu_torch.data.fixtures import \
        materialize_idx_fixture
    from distributedmnist_tpu_torch.obsv import invariants as inv
    t0 = time.time()
    data_dir = materialize_idx_fixture(f"{tmp}/mnist")
    cfg_dir, results = Path(tmp) / "sweep_cfgs", Path(tmp) / "sweep"
    cfg_dir.mkdir()
    for path in SWEEP_CONFIGS:
        cfg = json.loads(Path(path).read_text())
        cfg["train"]["max_steps"] = SWEEP_STEPS
        cfg["compile"] = {**cfg.get("compile", {}), "precompile": False}
        cfg["data"]["data_dir"] = str(data_dir)
        cfg["mesh"] = {"simulate_devices": REPLICAS}
        (cfg_dir / Path(path).name).write_text(json.dumps(cfg))
    reset_counts()
    printed = json.loads(_launch_verb(
        ["sweep", "--configs", str(cfg_dir), "--results", str(results)]
    ).strip().splitlines()[-1])
    counts = read_counts()
    rows = [json.loads(x) for x in
            (results / "sweep_results.jsonl").read_text().splitlines()]
    first = rows[0]["name"]
    _launch_verb(["report", "--train_dir", str(results / first / "train"),
                  "--out", str(results / "report")])
    stats = json.loads((results / "report" / "stats.json").read_text())
    verdicts = {}
    for r in rows:
        w = results / r["name"] / "train"
        log = inv.load_jsonl(w / "train_log.jsonl")
        steps = [x for x in log if x.get("event") == "step"]
        disc, applicable = inv.check_discipline(steps, log)
        verdicts[r["name"]] = {
            "metrics_log": [v.to_dict() for v in
                            inv.check_metrics_log(steps, 0)],
            "checkpoint_integrity": [v.to_dict() for v in
                                     inv.check_checkpoint_dir(w)],
            "discipline": [v.to_dict() for v in disc],
            "discipline_applicable": applicable}
    devices = json.loads(_launch_verb(["devices"]))
    rec = {"phase": "report", "seconds": time.time() - t0,
           "sweep": printed,
           "runs": [{k: r[k] for k in ("name", "mode", "num_replicas",
                                       "steps", "updates_applied",
                                       "wall_seconds", "final_loss",
                                       "test_accuracy")} for r in rows],
           "stats": {k: stats.get(k) for k in ("num_steps", "final_loss",
                                               "barrier")},
           "invariants": verdicts, "devices": devices,
           "flash_paged_kernel_launches": counts}
    emit(rec)
    names = sorted(Path(p).stem for p in SWEEP_CONFIGS)
    check(sorted(r["name"] for r in rows) == names
          and [p["name"] for p in printed] == [r["name"] for r in rows],
          f"sweep rows {[r['name'] for r in rows]}")
    check(all(r["steps"] == SWEEP_STEPS and r["num_replicas"] == REPLICAS
              and math.isfinite(r["final_loss"]) for r in rows),
          f"sweep runs {rec['runs']}")
    check(stats.get("num_steps") == SWEEP_STEPS
          and len(stats.get("per_replica", [])) == REPLICAS,
          f"stats.json {stats}")
    for name, v in verdicts.items():
        check(not (v["metrics_log"] or v["checkpoint_integrity"]
                   or v["discipline"]), f"invariants of {name}: {v}")
    check(any(d["kind"] == torch.cuda.get_device_name(0)
              for d in devices["devices"]), f"launch devices: {devices}")
    check(not any(counts.values()), f"flash/paged launches {counts}")
    return rec


def _cnn_trainer(tmp: str, name: str, *overrides: str, device=DEVICE,
                 **trainer_kwargs):
    """The CNN Trainer ``launch train`` runs, from its
    ``build_trainer``."""
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    path = f"{tmp}/{name}.json"
    with open(path, "w") as f:
        json.dump(CNN, f)
    return build_trainer(["train", "--config", path,
                          f"train.train_dir={tmp}/{name}", *overrides,
                          "--device", device], **trainer_kwargs)


def _cnn_flops(batch: int, size: int = 28) -> float:
    """Model FLOPs of one step: 3 × the forward's multiply-adds × 2
    (conv1 5x5x1x32 and conv2 5x5x32x64 at full and half resolution,
    fc1 (size/4)²·64 x 512, fc2 512 x 10): 24.55 MFLOP an image at 28."""
    h = size // 2
    fwd = 2 * (size * size * 32 * 25 + h * h * 64 * 25 * 32
               + (size // 4) ** 2 * 64 * 512 + 512 * 10)
    return 3.0 * fwd * batch


def _cnn_bytes(batch: int, size: int = 28) -> float:
    """The least bytes a step moves: the bf16 input, every activation
    tensor (conv1 and conv2 outputs, both pooled maps, fc1, logits)
    written once and read once forward and its gradient written once and
    read once backward (4 × 2 bytes an element), and the float32 params
    read, their gradients written and read, and the params written by
    the update (4 × 4 bytes)."""
    h, q = size // 2, size // 4
    act = size * size * 32 + h * h * 32 + h * h * 64 + q * q * 64 + 512 + 10
    params = 25 * 32 + 32 + 25 * 32 * 64 + 64 + q * q * 64 * 512 + 512 \
        + 512 * 10 + 10
    return batch * (size * size * 2 + act * 4 * 2) + params * 4 * 4


def _cnn_profile(step, batch, wall_ms: float, steps: int = 3) -> dict:
    """``torch.profiler`` over ``steps`` CNN steps: device ms by class
    (cuDNN convolutions, GEMMs, every other kernel) and the idle share
    1 - busy / wall (one stream)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
    by_class = {"conv": 0.0, "gemm": 0.0, "other": 0.0}
    top, launches = [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        cls = ("conv" if any(k in name for k in (
                   "conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit"))
               else "gemm" if any(k in name for k in (
                   "gemm", "gemv", "xmma", "cutlass", "nvjet"))
               else "other")
        by_class[cls] += us / 1e3 / steps
        launches += e.count
        top.append((us / 1e3 / steps, e.key[:60]))
    busy = sum(by_class.values())
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy > 0
            else "not measured",
            "busy_ms_by_class": by_class,
            "kernels_per_step": launches / steps,
            "top_kernels_ms": [[round(t, 4), k] for t, k in
                               sorted(top, reverse=True)[:10]]}


def _cnn_throughput(trainer, batch) -> dict:
    """Device ms of one step over ``CNN_TIMED`` steps after 3 warm-up
    steps (CUDA events; the batch stays on the card, as bench.py's
    scanned chunks do), the host's ms to issue a step (its clock around
    the same steps, before the final wait: equal to the device ms when
    the host waits on the card every step), images/s, model TFLOP/s,
    peak memory and the profile."""
    import torch
    state = trainer.state

    def step(b):
        nonlocal state
        state, _ = trainer.step_fn(state, b)

    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(CNN_TIMED):
        step(batch)
    host_ms = (time.perf_counter() - t0) * 1e3 / CNN_TIMED
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / CNN_TIMED
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = _cnn_flops(CNN_BATCH)
    return {"ms_per_step": ms, "host_issue_ms_per_step": host_ms,
            "images_per_s": CNN_BATCH / (ms / 1e3),
            "model_tflops_per_s": flops / (ms / 1e3) / 1e12,
            "peak_mem_gb": peak,
            "profile": _cnn_profile(step, batch, ms)}


def _cnn_disciplines(tmp: str) -> dict:
    """8 simulated replicas on the card, global batch 1024, 10 steps of
    quorum (k=4), timeout (deadline 0 on step 5) and interval."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.parallel.api import (
        _f32_sum, make_discipline_vector, tree_leaves)
    common = ("mesh.num_replicas=8", f"data.batch_size={CNN_DISC_BATCH}",
              f"data.synthetic_train_size={2 * CNN_DISC_BATCH}",
              f"train.max_steps={CNN_DISC_STEPS}")
    out = {}
    tr = _cnn_trainer(tmp, "cnn_quorum", *common, "sync.mode=quorum",
                      "sync.num_replicas_to_aggregate=4",
                      "sync.straggler_profile=lognormal",
                      "sync.straggler_mean_ms=50")
    recs = []
    tr.run(step_callback=lambda s, r: recs.append(r))
    sums = [sum(r["flags"]) for r in recs]
    out["quorum"] = {"flag_sums": sums,
                     "updates_applied": tr.state.updates_applied}
    check(len(recs) == CNN_DISC_STEPS and all(x == 4 for x in sums)
          and tr.state.updates_applied == CNN_DISC_STEPS,
          f"quorum k=4 on the card: {out['quorum']}")
    # timeout: the step function driven by hand, deadline 0 on step 5
    tr = _cnn_trainer(tmp, "cnn_timeout", *common, "sync.mode=timeout",
                      "sync.timeout_ms=60", "optim.momentum=0.9",
                      "sync.straggler_profile=lognormal",
                      "sync.straggler_mean_ms=50")
    state, applied, unchanged = tr.state, [], None
    for i in range(CNN_DISC_STEPS):
        b = to_device(next(tr.train_iter), tr.device)
        disc = make_discipline_vector(8, 0.0 if i == 5 else 60.0, 1000.0)
        before = [p.clone() for p in tree_leaves(state.params)
                  + tree_leaves(state.momentum)]
        state, m = tr.step_fn(state, b, None, disc)
        applied.append(m["applied"])
        if i == 5:
            unchanged = all(torch.equal(x, y) for x, y in zip(
                tree_leaves(state.params) + tree_leaves(state.momentum),
                before))
    out["timeout"] = {"applied": applied, "masked_step_bitwise": unchanged}
    check(applied[5] == 0 and unchanged and sum(applied) >= 1,
          f"timeout on the card: {out['timeout']}")
    # interval: applied exactly when the modeled clock crosses the window
    tr = _cnn_trainer(tmp, "cnn_interval", *common, "sync.mode=interval",
                      "sync.interval_ms=1000",
                      "sync.straggler_profile=lognormal",
                      "sync.straggler_mean_ms=300")
    state = tr.state
    wall, nxt, expect, got = np.float32(0), np.float32(1000), [], []
    for i in range(CNN_DISC_STEPS):
        b = to_device(next(tr.train_iter), tr.device)
        state, m = tr.step_fn(state, b)
        wall = np.float32(wall + np.float32(_f32_sum(m["step_times_ms"])
                                            / np.float32(8)))
        fire = bool(wall >= nxt)
        if fire:
            nxt = np.float32(wall + np.float32(1000))
        expect.append(int(fire))
        got.append(m["applied"])
    out["interval"] = {"applied": got, "modeled": expect,
                       "wall_ms": float(wall)}
    check(got == expect and sum(got) >= 2, f"interval: {out['interval']}")
    return out


def _cnn_card_vs_cpu(tmp: str) -> dict:
    """3 float32 quorum steps from one seed on the card and on the CPU."""
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    args = ("mesh.num_replicas=8", f"data.batch_size={CNN_DISC_BATCH}",
            f"data.synthetic_train_size={2 * CNN_DISC_BATCH}",
            "model.compute_dtype=float32", "sync.mode=quorum",
            "sync.num_replicas_to_aggregate=4",
            "sync.straggler_profile=lognormal", "sync.straggler_mean_ms=50")
    runs = {}
    for dev in (DEVICE, "cpu"):
        tr = _cnn_trainer(tmp, f"cnn_f32_{dev}", *args, device=dev)
        init = [p.detach().cpu().clone() for p in tree_leaves(tr.state.params)]
        state, flags = tr.state, []
        for _ in range(3):
            state, m = tr.step_fn(state, to_device(next(tr.train_iter),
                                                   tr.device))
            flags.append(m["flags"].tolist())
        runs[dev] = (init, flags, [p.detach().cpu()
                                   for p in tree_leaves(state.params)])
    (i_gpu, f_gpu, p_gpu), (i_cpu, f_cpu, p_cpu) = runs[DEVICE], runs["cpu"]
    init_bitwise = all(torch.equal(a, b) for a, b in zip(i_gpu, i_cpu))
    rel = max(float((a - b).norm() / b.norm()) for a, b in zip(p_gpu, p_cpu))
    # the flags are drawn on the host from the same keys on both sides:
    # their equality is a host-side check of the device-independent path
    rec = {"init_params_bitwise": init_bitwise,
           "flags_equal_host_side": f_gpu == f_cpu,
           "param_rel_err": rel, "tol": CNN_CARD_VS_CPU_TOL}
    check(f_gpu == f_cpu and rel <= CNN_CARD_VS_CPU_TOL,
          f"card vs CPU: {rec}")
    return rec


def _cudnn_flags_at_conv(step, batch) -> list:
    """Run ``step(batch)`` and return cuDNN's (deterministic, allow_tf32)
    as each convolution of the step saw them."""
    import torch
    cudnn, conv2d, seen = torch.backends.cudnn, torch.nn.functional.conv2d, []

    def probe(*args, **kwargs):
        seen.append([cudnn.deterministic, cudnn.allow_tf32])
        return conv2d(*args, **kwargs)

    torch.nn.functional.conv2d = probe
    try:
        step(batch)
    finally:
        torch.nn.functional.conv2d = conv2d
    return seen


def _cnn_determinism(tmp: str, batch, deterministic: bool) -> dict:
    """Two seeded 5-step runs at the throughput shape, with cuDNN's
    deterministic algorithms or without: bitwise params, and the
    setting each convolution of the first step ran under."""
    import torch

    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    finals, seen = [], []
    for i in range(2):
        tr = _cnn_trainer(tmp, f"cnn_det_{int(deterministic)}_{i}",
                          cudnn_deterministic=deterministic)
        state = tr.state

        def step(b):
            nonlocal state
            state, _ = tr.step_fn(state, b)

        seen += _cudnn_flags_at_conv(step, batch)
        for _ in range(4):
            step(batch)
        finals.append(tree_leaves(state.params))
    torch.cuda.synchronize()
    check(seen and all(d == deterministic for d, _ in seen),
          f"cudnn_deterministic={deterministic} but the convolutions ran "
          f"under {seen}")
    return {"bitwise": all(torch.equal(a, b) for a, b in zip(*finals)),
            "deterministic_at_conv": seen[0][0]}


def phase_cnn(tmp: str) -> dict:
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    cudnn_before = (torch.backends.cudnn.deterministic,
                    torch.backends.cudnn.allow_tf32)
    trainer = _cnn_trainer(tmp, "cnn")
    check(trainer.device.type == DEVICE, f"trainer on {trainer.device}")
    tr = trainer.datasets.train
    batch = to_device({"image": tr.images[:CNN_BATCH],
                       "label": tr.labels[:CNN_BATCH]}, trainer.device)
    reset_counts()
    throughput = {"deterministic": _cnn_throughput(trainer, batch)}
    det = {"deterministic": _cnn_determinism(tmp, batch, True)}
    counts = read_counts()
    losses = []
    summary = trainer.run(
        step_callback=lambda step, rec: losses.append(rec["loss"]))
    flops, nbytes = _cnn_flops(CNN_BATCH), _cnn_bytes(CNN_BATCH)
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    disciplines = _cnn_disciplines(tmp)
    card_vs_cpu = _cnn_card_vs_cpu(tmp)
    cudnn_after = (torch.backends.cudnn.deterministic,
                   torch.backends.cudnn.allow_tf32)
    rec = {"phase": "cnn", "batch": CNN_BATCH, "dtype": "bfloat16",
           **throughput["deterministic"],
           "flops_per_step": flops, "bytes_per_step": nbytes,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flop_ms": t_ops, "byte_ms": t_bytes,
           "run": {"steps": len(losses), "first_loss": losses[0],
                   "last_loss": losses[-1],
                   "updates_applied": summary["updates_applied"]},
           "disciplines": disciplines, "card_vs_cpu": card_vs_cpu,
           "seeded_runs_bitwise": det,
           "cudnn_flags_outside_steps": {"before": cudnn_before,
                                         "after": cudnn_after},
           "flash_paged_kernel_launches": counts,
           "kernel_note": "no flash or paged kernel runs in the CNN path: "
                          "its convolutions and GEMMs are cuDNN and "
                          "cuBLAS calls"}
    emit(rec)
    check(all(v == 0 for v in counts.values()), f"launches {counts}")
    check(len(losses) == CNN_TIMED and all(map(math.isfinite, losses)),
          f"losses {losses}")
    check(det["deterministic"]["bitwise"], "two seeded runs differ with "
                                           "cuDNN's deterministic algorithms")
    check(cudnn_after == cudnn_before, "the CNN path left cuDNN's settings "
                                       f"changed: {cudnn_before} -> "
                                       f"{cudnn_after}")
    return rec


# -- phase 7: sync SGD across worker processes --------------------------------

_DIST_CHILD = r"""
import json, os, sys, time
import torch
from distributedmnist_tpu_torch.core.mesh import (initialize_distributed,
                                                  shutdown_distributed)
spec = json.loads(os.environ["DMT_SPEC"])
rank = int(os.environ.get("RANK", 0))
if spec["backend"]:
    initialize_distributed(spec["backend"], spec["device"], timeout_s=120)
try:
    import torch.distributed as dist
    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    from distributedmnist_tpu_torch.ops import flash_attention as fa
    from distributedmnist_tpu_torch.ops.paged_attention import paged_attention
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    grouped = dist.is_initialized()
    out = {"backend": dist.get_backend() if grouped else None,
           "world": dist.get_world_size() if grouped else 1, "runs": {}}
    for run in spec["runs"]:
        t = build_trainer(["train", "--config", spec["config"],
                           *run["overrides"], "--device", spec["device"]])
        if run.get("sleep_ms") and rank == 1:
            # a real slowdown of this process's host loop
            base, secs = t.train_iter, run["sleep_ms"] / 1e3
            def slow(base=base, secs=secs):
                while True:
                    time.sleep(secs)
                    yield next(base)
            t.train_iter = slow()
        flags = []
        summary = t.run(step_callback=lambda s, r: flags.append(r["flags"]))
        res = {"flags": flags, "digest": summary["params_digest"],
               "device": str(t.device), "times": t.collector.matrix().tolist(),
               "first_replica": t.topo.first_replica,
               "slot_bytes": sum(x.numel() * x.element_size()
                                 for x in tree_leaves(t.state.momentum))}
        if run.get("timed"):
            b = to_device(next(t.train_iter), t.device)
            state = t.state
            for _ in range(2):
                state, _ = t.step_fn(state, b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(run["timed"]):
                state, m = t.step_fn(state, b)
            torch.cuda.synchronize()
            res["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / run["timed"]
        if run.get("save_params"):
            torch.save([p.detach().cpu() for p in
                        tree_leaves(t.logical_params())],
                       f"{run['save_params']}.{rank}.pt")
            torch.save([x.detach().cpu() for x in
                        tree_leaves(t.state.momentum)],
                       f"{run['save_params']}.slots.{rank}.pt")
        out["runs"][run["name"]] = res
    out["kernel_launches"] = sum(
        f.launches for f in (fa.flash_attention_bshd,
                             fa.flash_attention_fwd_lse,
                             fa.flash_attention_bwd_dq,
                             fa.flash_attention_bwd_dkv,
                             fa.flash_attention_bwd_fused, paged_attention))
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(out, f)
finally:
    shutdown_distributed()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dist_launch(tmp: str, name: str, backend: str, devices: list,
                 runs: list, kill_on_failure: bool = True,
                 child: str | None = None,
                 timeout_s: float = DIST_CHILD_TIMEOUT_S
                 ) -> tuple[list, list, list]:
    """Start one worker process a device in ``devices`` (torchrun's
    environment, a free port on localhost; no group and no such
    environment when ``backend`` is None), each in its own session,
    running ``child`` (default ``_DIST_CHILD``); wait for all of them,
    killing every one when one fails (unless ``kill_on_failure`` is
    False) or the group outlives ``timeout_s`` (default
    ``DIST_CHILD_TIMEOUT_S``). Returns (exit
    codes, results, log tails)."""
    with open(f"{tmp}/dist_cnn.json.{name}", "w") as f:
        json.dump(CNN, f)
    os.replace(f"{tmp}/dist_cnn.json.{name}", f"{tmp}/dist_cnn.json")
    port, world, procs = _free_port(), len(devices), []
    for rank, dev in enumerate(devices):
        spec = {"backend": backend, "device": dev, "runs": runs,
                "config": f"{tmp}/dist_cnn.json", "out": f"{tmp}/{name}"}
        env = dict(os.environ, DMT_SPEC=json.dumps(spec))
        if backend:
            env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        with open(f"{tmp}/{name}.{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", child or _DIST_CHILD], env=env,
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if (failed and kill_on_failure) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    results, tails = [], []
    for rank, p in enumerate(procs):
        path = f"{tmp}/{name}.{rank}.json"
        if p.returncode == 0 and os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
        else:
            results.append(None)
        with open(f"{tmp}/{name}.{rank}.log") as f:
            tails.append(f.read()[-2000:])
    return [p.returncode for p in procs], results, tails


def _dist_group(tmp: str, name: str, backend: str, devices: list,
                runs: list, child: str | None = None,
                timeout_s: float = DIST_CHILD_TIMEOUT_S) -> list:
    """:func:`_dist_launch` that must succeed, on the backend (None: no
    group) and devices asked for."""
    rcs, results, tails = _dist_launch(tmp, name, backend, devices, runs,
                                       child=child, timeout_s=timeout_s)
    check(all(rc == 0 for rc in rcs), f"{name}: exit codes {rcs}, logs "
                                      f"{tails}")
    for res, dev in zip(results, devices):
        check(res["backend"] == backend and res["world"] == len(devices)
              and all(r["device"] == dev for r in res["runs"].values()),
              f"{name}: ran on {res['backend']}, world {res['world']}, "
              f"devices {[r['device'] for r in res['runs'].values()]}")
    return results


def _discipline_records(train_dir: str) -> tuple[list, list]:
    """The discipline records of a train log without the clock's fields,
    and its step records' flags."""
    with open(f"{train_dir}/train_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    disc = [{k: v for k, v in r.items()
             if k not in ("time", "reaction_s", "ts")}
            for r in log if r.get("event") == "discipline"]
    return disc, [r["flags"] for r in log if r.get("event") == "step"]


def _dist_adaptive(tmp: str) -> dict:
    """tests/test_discipline.py's end-to-end case (quorum, adaptive,
    window 4, cooldown 4, spike p=0.25 ×8, 14 steps, 8 simulated
    replicas) on the card and on the CPU."""
    args = ("mesh.num_replicas=8", "data.batch_size=64",
            "data.synthetic_train_size=1024", "model.compute_dtype=float32",
            "sync.mode=quorum", "sync.adaptive=true",
            "sync.adaptive_window_steps=4", "sync.adaptive_cooldown_steps=4",
            "sync.straggler_profile=spike", "sync.straggler_spike_prob=0.25",
            "sync.straggler_spike_scale=8.0", "train.max_steps=14",
            "train.log_every_steps=1")
    out = {}
    for dev in (DEVICE, "cpu"):
        tr = _cnn_trainer(tmp, f"adaptive_{dev}", *args, device=dev)
        summary = tr.run()
        out[dev] = (summary["discipline"],
                    *_discipline_records(f"{tmp}/adaptive_{dev}"))
    (s_gpu, d_gpu, f_gpu), (s_cpu, d_cpu, f_cpu) = out[DEVICE], out["cpu"]
    rec = {"changes": s_gpu["changes"], "trace": s_gpu["trace"],
           "records_equal_cpu": d_gpu == d_cpu,
           "flags_equal_cpu": f_gpu == f_cpu}
    check(s_gpu["changes"] >= 1 and d_gpu == d_cpu and f_gpu == f_cpu
          and s_gpu == s_cpu, f"adaptive on the card: {rec}")
    return rec


def _dist_device_skew(tmp: str) -> dict:
    """tests/test_train_smoke.py's injection: a float32 a@a@a on
    [640, 640] queued for replica 3 after every step, quorum k=7,
    sync.measure_device_skew."""
    import torch
    tr = _cnn_trainer(tmp, "device_skew", "mesh.num_replicas=8",
                      f"data.batch_size={CNN_DISC_BATCH}",
                      f"data.synthetic_train_size={2 * CNN_DISC_BATCH}",
                      "sync.mode=quorum", "sync.num_replicas_to_aggregate=7",
                      "sync.straggler_profile=none",
                      "sync.measure_device_skew=true", "train.max_steps=6")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    a = torch.randn(640, 640, device=tr.device, generator=gen)
    tr.device_work_injection = {3: (lambda x: x @ x @ x, a)}
    flags = tr.run()["last_metrics"]["flags"]
    rec = {"flags": flags, "last_skew_ms": tr._last_device_skew.tolist()}
    check(flags[3] == 0 and sum(flags) == 7, f"device skew: {rec}")
    return rec


# the dist phase's runs: bench_cnn_sync's shape over 8 replicas; a
# quorum over measured host times; float32 full-batch steps, dropout 0
DIST_BIG = ["mesh.num_replicas=8", f"train.max_steps={DIST_STEPS}"]
DIST_QUORUM = ["mesh.num_replicas=8", f"data.batch_size={CNN_DISC_BATCH}",
               f"data.synthetic_train_size={2 * CNN_DISC_BATCH}",
               "sync.mode=quorum", "sync.num_replicas_to_aggregate=4",
               "sync.straggler_profile=none", f"train.max_steps={DIST_STEPS}"]
DIST_F32 = ["mesh.num_replicas=8", f"data.batch_size={CNN_DISC_BATCH}",
            f"data.synthetic_train_size={CNN_DISC_BATCH}",
            "model.compute_dtype=float32", "model.dropout_rate=0.0",
            "train.max_steps=3"]
# from step 2 on (the first ranked on a measured time) rank 1's
# replicas, slowed by its sleep, are out of the k=4 quorum
DIST_QUORUM_FLAGS = [1, 1, 1, 1, 0, 0, 0, 0]


def _dist_world1(tmp: str) -> tuple[dict, int]:
    """One NCCL process against the simulated topology (a fresh process
    with no group), the two side by side: the same sums, so the same
    params. Returns (record, the children's K1-K5 launches)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        w1, sim = [f.result()[0] for f in [
            pool.submit(_dist_group, tmp, name, backend, ["cuda:0"], [
                {"name": "sync",
                 "overrides": DIST_BIG + [f"train.train_dir={tmp}/{name}"]}])
            for name, backend in (("nccl_world1", "nccl"),
                                  ("simulated", None))]]
    rec = {"digest_equal": w1["runs"]["sync"]["digest"]
           == sim["runs"]["sync"]["digest"]}
    check(rec["digest_equal"], f"nccl world 1 vs simulated: {rec}")
    return rec, w1["kernel_launches"] + sim["kernel_launches"]


def _dist_gloo_one_card(tmp: str, more: list) -> tuple[dict, int, list]:
    """Two gloo processes on ``cuda:0``: the measured-time quorum with
    rank 1 sleeping, sync at batch 4096, and 3 float32 steps against
    the simulated 8-replica run in this process; the same launch runs
    the runs ``more`` after them (one process boot for all). Returns
    (record, the children's K1-K5 launches, every rank's results)."""
    import torch

    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    two = _dist_group(tmp, "gloo_one_card", "gloo", ["cuda:0", "cuda:0"], [
        {"name": "quorum", "sleep_ms": DIST_SLEEP_MS,
         "overrides": DIST_QUORUM + [f"train.train_dir={tmp}/g_q"]},
        {"name": "sync",
         "overrides": DIST_BIG + [f"train.train_dir={tmp}/g_s"]},
        {"name": "f32", "save_params": f"{tmp}/g_f32",
         "overrides": DIST_F32 + [f"train.train_dir={tmp}/g_f"]}, *more])
    q0, q1 = two[0]["runs"]["quorum"], two[1]["runs"]["quorum"]
    sim = _cnn_trainer(tmp, "dist_sim_f32", *DIST_F32)
    sim.run()
    ref = [p.detach().cpu() for p in tree_leaves(sim.state.params)]
    f32_err = max(
        max(float((a - b).norm() / b.norm()) for a, b in zip(
            torch.load(f"{tmp}/g_f32.{r}.pt"), ref)) for r in range(2))
    rec = {"quorum_flags": q0["flags"],
           "quorum_flags_equal_ranks": q0["flags"] == q1["flags"],
           "quorum_digests_equal": q0["digest"] == q1["digest"],
           "measured_ms_last_step": q0["times"][-1],
           "sync_digests_equal": two[0]["runs"]["sync"]["digest"]
           == two[1]["runs"]["sync"]["digest"],
           "f32_param_rel_err": f32_err, "f32_tol": DIST_F32_TOL}
    check(all(f == DIST_QUORUM_FLAGS for f in q0["flags"][1:])
          and rec["quorum_flags_equal_ranks"]
          and rec["quorum_digests_equal"] and rec["sync_digests_equal"],
          f"gloo two ranks on one card: {rec}")
    check(f32_err <= DIST_F32_TOL, f"two ranks vs simulated, float32: "
                                   f"{f32_err} > {DIST_F32_TOL}")
    return rec, sum(r["kernel_launches"] for r in two), two


def _dist_nccl_shared_refused(tmp: str) -> bool:
    """Two NCCL ranks on one card are refused before the group is
    made."""
    rcs, _, tails = _dist_launch(tmp, "nccl_shared", "nccl",
                                 ["cuda:0", "cuda:0"], [],
                                 kill_on_failure=False)
    refused = all(rc != 0 for rc in rcs) and all(
        "one card per rank" in t for t in tails)
    check(refused, f"two NCCL ranks on one card: exit codes {rcs}, {tails}")
    return refused


def _dist_nccl_two(tmp: str) -> tuple[dict, int]:
    """Two NCCL processes, one card each, where there are two cards (the
    gloo quorum case and ms a step at batch 4096); null with one."""
    import torch
    cards = torch.cuda.device_count()
    rec = {"cards": cards, "ms_per_step": None}
    if cards < 2:
        return rec, 0
    pair = _dist_group(tmp, "nccl_two", "nccl", ["cuda:0", "cuda:1"], [
        {"name": "quorum", "sleep_ms": DIST_SLEEP_MS,
         "overrides": DIST_QUORUM + [f"train.train_dir={tmp}/n_q"]},
        {"name": "sync", "timed": DIST_TIMED,
         "overrides": DIST_BIG + [f"train.train_dir={tmp}/n_s"]}])
    n0, n1 = pair[0]["runs"]["quorum"], pair[1]["runs"]["quorum"]
    rec.update(quorum_flags=n0["flags"],
               measured_ms_last_step=n0["times"][-1],
               ms_per_step=pair[0]["runs"]["sync"]["ms_per_step"])
    check(all(f == DIST_QUORUM_FLAGS for f in n0["flags"][1:])
          and n0["flags"] == n1["flags"] and n0["digest"] == n1["digest"]
          and pair[0]["runs"]["sync"]["digest"]
          == pair[1]["runs"]["sync"]["digest"], f"nccl two ranks: {rec}")
    return rec, sum(r["kernel_launches"] for r in pair)


# ZeRO-1 over two gloo processes on one card: the float32 full-batch
# steps with the weight update sharded (4 buckets); each one-process run
# in this process is fed the two processes' batches concatenated, so the
# replicas hold the same rows and only the collectives' sum order differs
ZERO_DIST = DIST_F32 + ["parallel.shard_weight_update=true",
                        "parallel.comm_buckets=4"]
ZERO_DIST_OPTIM = {"momentum": ["optim.name=momentum", "optim.momentum=0.9"],
                   "lamb": ["optim.name=lamb"]}
ZERO_DIST_TOL = 3e-7
# LAMB after one step: its update m̂/(sqrt(v̂) + eps) is sign-like where a
# summed gradient is near eps, so the reassociated sums move whole
# elements (tests/test_torch_zero1.py: 1.0e-6 on the CPU; 3.9e-6 on
# conv2's kernel on an H100)
ZERO_DIST_LAMB_TOL = 1e-5


def _zero1_one_process(tmp: str, name: str, overrides: list,
                       hosts: int = 2):
    """The one-process run of a ``hosts``-process ZeRO-1 config (8
    simulated replicas), fed each step the processes' batches
    concatenated."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.data.pipeline import (BatchIterator,
                                                          to_device)
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    tr = _cnn_trainer(tmp, name, *overrides)
    its = [BatchIterator(tr.datasets.train, tr.cfg.data.batch_size,
                         seed=tr.cfg.train.seed, host_id=p, num_hosts=hosts)
           for p in range(hosts)]
    state = tr.state
    for _ in range(tr.cfg.train.max_steps):
        parts = [next(it) for it in its]
        state, _ = tr.step_fn(state, to_device(
            {k: np.concatenate([b[k] for b in parts])
             for k in ("image", "label")}, tr.device))
    tr.state = state
    return tr, [p.detach().cpu() for p in tree_leaves(tr.logical_params())]


def _zero1_gap(got: list, want: list) -> list:
    return [float((a - b).norm() / b.norm().clamp_min(1e-30))
            for a, b in zip(got, want)]


def _zero1_run(tmp: str, opt: str, steps: int) -> dict:
    """A ``_DIST_CHILD`` run of ``ZERO_DIST`` under ``opt`` for ``steps``,
    saving its logical params and local slots."""
    name = f"{opt}_{steps}"
    return {"name": name, "save_params": f"{tmp}/zd_{name}",
            "overrides": ZERO_DIST + ZERO_DIST_OPTIM[opt] + [
                f"train.max_steps={steps}", f"train.train_dir={tmp}/zd_{name}"]}


def _dist_zero1_nccl(tmp: str) -> tuple[dict | None, int]:
    """ZeRO-1 momentum (3 steps) over one NCCL process a card, on up to 4
    cards where there are two or more (null with one): each rank within
    ``ZERO_DIST_TOL`` of each leaf's norm of the one-process run fed the
    processes' batches, its slot bytes the sharded slots' share plus the
    fallback leaves. Returns (record, the children's K1-K5 launches)."""
    import torch
    cards = min(torch.cuda.device_count(), 4)
    if cards < 2:
        return None, 0
    run = dict(_zero1_run(tmp, "momentum", 3), save_params=f"{tmp}/zn",
               name="momentum_3")
    group = _dist_group(tmp, "zero1_nccl", "nccl",
                        [f"cuda:{i}" for i in range(cards)], [run])
    sim, want = _zero1_one_process(
        tmp, "zn_sim", run["overrides"][:-1]
        + [f"train.train_dir={tmp}/zn_sim"], hosts=cards)
    gaps = [_zero1_gap(torch.load(f"{tmp}/zn.{r}.pt"), want)
            for r in range(cards)]
    expected = sum(lp.pad * 4 // cards if lp.sharded else lp.size * 4
                   for lp in sim._zero1_plan.leaves())
    rec = {"processes": cards, "max_leaf_rel_gap": max(map(max, gaps)),
           "slot_bytes_ranks": [r["runs"]["momentum_3"]["slot_bytes"]
                                for r in group],
           "slot_bytes_rank_expected": expected}
    check(rec["max_leaf_rel_gap"] <= ZERO_DIST_TOL
          and all(b == expected for b in rec["slot_bytes_ranks"]),
          f"ZeRO-1 over {cards} NCCL processes vs one: {rec}")
    return rec, sum(r["kernel_launches"] for r in group)


# the ZeRO-1 runs over two gloo processes (in the gloo_one_card launch)
ZERO_GLOO_RUNS = (("momentum", 3), ("lamb", 1))


def _dist_zero1(tmp: str, two: list) -> tuple[dict, int]:
    """ZeRO-1 at 8 replicas over two gloo processes on one card, under
    momentum (3 steps) and LAMB (1 step; ``two``: the launch's results
    for ``ZERO_GLOO_RUNS``), against the one-process run; each rank's
    slot bytes; the per-host checkpoint (two shard files and a
    manifest) resumed in one process to the run's logical state; NCCL
    processes on up to 4 cards where there are two or more (their K1-K5
    launches returned)."""
    import torch

    from distributedmnist_tpu_torch.parallel.api import (tree_leaves,
                                                         tree_unflatten)
    from distributedmnist_tpu_torch.parallel.partition_rules import (
        zero1_unpack)
    runs = [_zero1_run(tmp, opt, steps) for opt, steps in ZERO_GLOO_RUNS]
    rec = {}
    for run in runs:
        name = run["name"]
        sim, want = _zero1_one_process(tmp, f"zd_sim_{name}",
                                       run["overrides"][:-1] + [
                                           f"train.train_dir={tmp}/zs_{name}"])
        gaps = [_zero1_gap(torch.load(f"{run['save_params']}.{r}.pt"), want)
                for r in range(2)]
        lps = sim._zero1_plan.leaves()
        slots = 2 if name.startswith("lamb") else 1
        rec[name] = {"max_leaf_rel_gap": max(map(max, gaps)),
                     "gap_by_leaf": gaps[0],
                     "leaf_ndim": [len(lp.shape) for lp in lps],
                     "slot_bytes_ranks": [r["runs"][name]["slot_bytes"]
                                          for r in two],
                     "slot_bytes_one_process": sum(
                         x.numel() * x.element_size()
                         for x in tree_leaves(sim.state.momentum)),
                     # half the sharded slots, the fallback leaves whole
                     "slot_bytes_rank_expected": slots * sum(
                         lp.pad * 4 // 2 if lp.sharded else lp.size * 4
                         for lp in lps),
                     "sharded_leaves": sum(lp.sharded for lp in lps)}
    # the per-host layout of the momentum run, resumed in one process
    d = f"{tmp}/zd_momentum_3"
    files = sorted(f for f in os.listdir(d) if f.startswith("ckpt-00000003"))
    resumed = _cnn_trainer(tmp, "zd_resume", *ZERO_DIST,
                           *ZERO_DIST_OPTIM["momentum"], "train.max_steps=3",
                           f"train.train_dir={d}")
    got_p, got_s = _canonical_leaves(resumed)
    plan = resumed._zero1_plan
    lps = plan.leaves()
    ranks_s = [torch.load(f"{d}.slots.{r}.pt") for r in range(2)]
    whole = [torch.cat([ranks_s[0][i], ranks_s[1][i]]) if lp.sharded
             else ranks_s[0][i] for i, lp in enumerate(lps)]
    want_s = tree_leaves(zero1_unpack(tree_unflatten(plan.leaf_plans, whole),
                                      plan))
    rec["per_host_checkpoint"] = {
        "files": files,
        "resumed_params_bitwise": _bitwise(got_p, torch.load(f"{d}.0.pt")),
        "resumed_slots_bitwise": _bitwise(got_s, [x.float() for x in want_s])}
    rec["nccl_cards"], launches = _dist_zero1_nccl(tmp)
    m, l1 = rec["momentum_3"], rec["lamb_1"]
    check(m["max_leaf_rel_gap"] <= ZERO_DIST_TOL,
          f"ZeRO-1 momentum, two processes vs one: {m}")
    check(l1["max_leaf_rel_gap"] <= ZERO_DIST_LAMB_TOL,
          f"ZeRO-1 LAMB after one step, two processes vs one: {l1}")
    for name in ("momentum_3", "lamb_1"):
        r = rec[name]
        check(all(b == r["slot_bytes_rank_expected"]
                  for b in r["slot_bytes_ranks"]),
              f"ZeRO-1 slot bytes a rank: {r}")
    ph = rec["per_host_checkpoint"]
    check(ph["files"] == ["ckpt-00000003.manifest.json",
                          "ckpt-00000003.shard000-of-002.msgpack",
                          "ckpt-00000003.shard000-of-002.msgpack.sha256",
                          "ckpt-00000003.shard001-of-002.msgpack",
                          "ckpt-00000003.shard001-of-002.msgpack.sha256"]
          and ph["resumed_params_bitwise"] and ph["resumed_slots_bitwise"],
          f"per-host checkpoint: {ph}")
    return rec, launches


def phase_dist(tmp: str) -> dict:
    """The CNN's sync SGD across worker processes, at its published
    widths: one NCCL process against the simulated replicas, two gloo
    processes on one card, two NCCL processes when there are two cards;
    then the adaptive discipline and the device-skew probe in process."""
    t_phase = time.time()
    reset_counts()
    # the world-1 pair and the refusal (two processes that exit before a
    # group is made) run beside the two gloo processes: their checks are
    # digests and exit codes, and the gloo quorum's straggler sleeps
    # 250 ms a batch
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        side = pool.submit(_dist_world1, tmp)
        refusal = pool.submit(_dist_nccl_shared_refused, tmp)
        gloo, l2, two = _dist_gloo_one_card(
            tmp, [_zero1_run(tmp, opt, steps)
                  for opt, steps in ZERO_GLOO_RUNS])
        world1, l1 = side.result()
        refused = refusal.result()
    nccl2, l3 = _dist_nccl_two(tmp)
    adaptive = _dist_adaptive(tmp)
    skew = _dist_device_skew(tmp)
    zero1, l4 = _dist_zero1(tmp, two)
    counts = read_counts()
    rec = {"phase": "dist", "batch": CNN_BATCH, "dtype": "bfloat16",
           "nccl_world1": world1, "gloo_two_ranks_one_card": gloo,
           "nccl_shared_card_refused": refused, "nccl_two_ranks": nccl2,
           "adaptive": adaptive, "device_skew": skew, "zero1": zero1,
           "flash_paged_kernel_launches": counts,
           "child_flash_paged_kernel_launches": l1 + l2 + l3 + l4,
           "seconds": time.time() - t_phase}
    emit(rec)
    check(all(v == 0 for v in counts.values()) and l1 + l2 + l3 + l4 == 0,
          f"launches {counts}, children {l1 + l2 + l3 + l4}")
    return rec


# -- phase 10b: tensor, sequence, expert and pipeline parallelism ------------

# the model_parallel phase: 4 worker processes, one launch, each building
# its Trainer through `launch train`'s build_trainer for every arm in
# turn (flash; depth cut, widths never): A = TP 4 and B = TP 2 × SP 2
# (Ulysses over flash) on the training path's widths (d 2048, 16 heads
# of 128, seq 1024, vocab 1024) at 2 layers and global batch 8; C = SP 4
# on bench_flash_long_context's model at S = 8192, batch 2, by ring
# (remat full) and by Ulysses over flash; D = EP 4 and E = TP 2 × EP 2
# on the same widths with every FFN a mixture of 8 experts (w1 and w2
# [8, 2048, 8192] a layer, 2 experts a rank under EP 4), GShard top-2,
# 4 token groups a row (so routing is the same on every mesh) at the
# default capacity factor 1.25 (so tokens drop) and aux weight 0.01.
# The bf16 arms take MP_STEPS steps (C's ring 1: its step 2 was timing
# only): step 1 is held against the same config's one-process step
# here, step 2 timed by CUDA events (a third step, timed too, went to
# pay for the MoE arms). The float32 controls (A, the ring and D again,
# at model.compute_dtype=float32) take step 1 alone. The pipeline arms:
# F = PP 2 × EP 2 under GPipe with 2 microbatches on D's model (1 layer
# a stage; step 1 alone, gated against D's own references, the experts'
# all-to-alls inside each stage), G = PP 2 × TP 2 under interleaved
# 1F1B with 2 chunks a stage and 4 microbatches on the training model at
# its full 4 layers (1 layer a chunk, so the ring wraps: chunk 2 is on
# stage 0), step 2 timed, eval on. Their params are the stacked layout,
# so step 1 is held against the one-process step read in that layout.
# H = DP 2 × TP 2 with ZeRO-1 on A's model: 2 replica-processes of 2
# model shards, each process fed its replica-process's rows of the
# one-process reference's global batch (2 local replicas, ZeRO-1 on).
MP_WORLD, MP_STEPS, MP_BATCH = 4, 2, 8
# the launch's own limit: its 11 arms took 105.6 s on an H100 80GB HBM3
# at 700 W (PERF.md §6), over DIST_CHILD_TIMEOUT_S on a host a third
# slower
MP_CHILD_TIMEOUT_S = 240
MP_TRAIN = {**TRAIN, "name": "chip_smoke_mp",
            "model": {**MODEL, "num_layers": 2},
            "data": {"dataset": "synthetic_lm", "batch_size": MP_BATCH,
                     "synthetic_train_size": 32, "synthetic_test_size": 8,
                     "use_native_pipeline": False},
            "eval": {"eval_batch_size": 8},
            "train": {**TRAIN["train"], "max_steps": MP_STEPS}}
MP_LONG = {**MP_TRAIN,
           "model": {**MODEL, "model_dim": LONG["model_dim"],
                     "num_layers": LONG["num_layers"],
                     "num_heads": LONG["num_heads"],
                     "seq_len": LONG["seq_len"]},
           "data": {**MP_TRAIN["data"], "batch_size": LONG["batch"],
                    "synthetic_train_size": 8}}
MP_MOE = {**MP_TRAIN,
          "model": {**MP_TRAIN["model"], "num_experts": 8,
                    "moe_num_groups": 4, "moe_router_top_k": 2}}
# G's kind: the training model at its full depth, batch 8
MP_TRAIN4 = {**MP_TRAIN, "model": MODEL}
# H's kind: A's and B's model over 2 replicas under heavy-ball momentum
# (its first update is lr·g, so step 1 is gated as SGD's is) with
# ZeRO-1's bucketed layout and resident params
MP_ZERO1 = {**MP_TRAIN,
            "optim": {**MP_TRAIN["optim"], "name": "momentum",
                      "momentum": 0.9},
            "parallel": {"shard_weight_update": True, "comm_buckets": 2,
                         "resident_sharded": True}}
_F32 = lambda c: {**c, "model": {**c["model"],  # noqa: E731
                                 "compute_dtype": "float32"}}
MP_KINDS = {"train": MP_TRAIN, "long": MP_LONG, "moe": MP_MOE,
            "train4": MP_TRAIN4, "zero1": MP_ZERO1,
            "train_f32": _F32(MP_TRAIN), "long_f32": _F32(MP_LONG),
            "moe_f32": _F32(MP_MOE), "train4_f32": _F32(MP_TRAIN4),
            "zero1_f32": _F32(MP_ZERO1)}
# the replicas of a kind's one-process reference (and of its arms): H's
# 2, every other kind's 1
MP_REPLICAS = {"zero1": 2, "zero1_f32": 2}
_H_MESH = ("mesh.num_replicas=2", "mesh.model_parallelism=2")
_RING = ("mesh.seq_parallelism=4", "model.sp_attention=ring",
         "model.remat=true", "model.remat_policy=full")
# each arm: its kind, its overrides, whether it runs the flash kernels
# and its steps. The one-step arms come first: the workers run them
# while the parent makes the one-process references, which the first
# timed step waits for (so that no reference shares the card with a
# timed step)
MP_ARMS = {
    "C_sp4_ring": ("long", _RING, False, 1),
    "A_tp4_f32": ("train_f32", ("mesh.model_parallelism=4",), True, 1),
    "C_sp4_ring_f32": ("long_f32", _RING, False, 1),
    "D_ep4_f32": ("moe_f32", ("mesh.expert_parallelism=4",), True, 1),
    "F_pp2_ep2_gpipe": ("moe", ("mesh.pipeline_parallelism=2",
                                "mesh.expert_parallelism=2",
                                "mesh.pipeline_microbatches=2"), True, 1),
    "H_dp2_tp2_zero1_f32": ("zero1_f32", _H_MESH, True, 1),
    "A_tp4": ("train", ("mesh.model_parallelism=4",), True, MP_STEPS),
    "B_tp2_sp2_ulysses": ("train", ("mesh.model_parallelism=2",
                                    "mesh.seq_parallelism=2",
                                    "model.sp_attention=ulysses"), True,
                          MP_STEPS),
    "C_sp4_ulysses": ("long", ("mesh.seq_parallelism=4",
                               "model.sp_attention=ulysses"), True,
                      MP_STEPS),
    "D_ep4": ("moe", ("mesh.expert_parallelism=4",), True, MP_STEPS),
    "E_tp2_ep2": ("moe", ("mesh.model_parallelism=2",
                          "mesh.expert_parallelism=2"), True, MP_STEPS),
    "G_pp2_tp2_1f1b": ("train4", ("mesh.pipeline_parallelism=2",
                                  "mesh.model_parallelism=2",
                                  "mesh.pipeline_schedule=1f1b",
                                  "mesh.pipeline_chunks=2",
                                  "mesh.pipeline_microbatches=4"), True,
                       MP_STEPS),
    "H_dp2_tp2_zero1": ("zero1", _H_MESH, True, MP_STEPS)}
# the pipeline arms' (schedule, stages, chunks a stage, microbatches):
# their stacked layout, and the flash launches their schedule predicts
MP_PP = {"F_pp2_ep2_gpipe": ("gpipe", 2, 1, 2),
         "G_pp2_tp2_1f1b": ("1f1b", 2, 2, 4)}
# arms without an eval (F's gate is its step; G evaluates the pipeline)
MP_NO_EVAL = ("F_pp2_ep2_gpipe",)
# the arms that run again over NCCL, a card a process, on a 4-card host
MP_NCCL_ARMS = ("B_tp2_sp2_ulysses", "D_ep4", "G_pp2_tp2_1f1b",
                "H_dp2_tp2_zero1")
# step 1 against the one-process step from the same params and batch.
# The loss (~6.9) within MP_LOSS_TOL. Each leaf's update (lr ·
# gradient, SGD) as ||sharded − one process|| / ||one-process update||.
# The two steps sum in other orders (the row-parallel partial products
# over the model group, the ring's online softmax against the flash
# kernel), and a rounding-sized difference in a pre-activation flips
# ReLU's mask where it is near 0, an O(1) change in that term: every
# leaf behind a ReLU moves far more than its rounding (float32, on the
# H100: 2e-4–1.6e-3 in those leaves, 7e-6–2.4e-5 in the last w2 and
# final_norm, which no ReLU precedes). A shard left out of a sum, or
# one summed twice, moves a leaf by 0.25 or more. So the float32
# controls hold every leaf within MP_UPDATE_TOL_F32, and each bf16 arm
# holds each leaf within MP_NOISE_RATIO × the one-process bf16 step's
# own distance from the float32 step in that leaf (its bf16 noise,
# measured in the same run; sound arms read 0.59–0.92 of it)
MP_LOSS_TOL = 2e-2
MP_UPDATE_TOL_F32 = 1e-2
MP_NOISE_RATIO = 2.0

_MP_CHILD = r"""
import json, os, time
import torch
import torch.distributed as dist
from distributedmnist_tpu_torch.core.mesh import (initialize_distributed,
                                                  shutdown_distributed)
spec = json.loads(os.environ["DMT_SPEC"])
rank = int(os.environ["RANK"])
initialize_distributed(spec["backend"], spec["device"], timeout_s=120)
try:
    from distributedmnist_tpu_torch.data.pipeline import (
        make_train_iterator, to_device)
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    from distributedmnist_tpu_torch.ops import flash_attention as fa
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    kernels = {"K1": fa.flash_attention_bshd,
               "K1-lse": fa.flash_attention_fwd_lse,
               "K2": fa.flash_attention_bwd_dq,
               "K3": fa.flash_attention_bwd_dkv,
               "K4": fa.flash_attention_bwd_fused}
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "runs": {}}
    for run in spec["runs"]:
        t_run = time.perf_counter()
        for f in kernels.values():
            f.launches = 0
        t = build_trainer(["train", "--config", run["config"],
                           *run["overrides"], "--device", spec["device"]])
        topo = t.topo
        if topo.process_count == 1:
            feed = [to_device(next(t.train_iter), t.device)
                    for _ in range(run["steps"])]
        else:
            # over several replica-processes: each one's rows of the
            # global batches the one-process reference reads
            whole = make_train_iterator(t.datasets.train, t.cfg.data,
                                        seed=t.cfg.train.seed)
            rows = t.cfg.data.batch_size // topo.process_count
            lo = topo.process_index * rows
            feed = [to_device({k: v[lo:lo + rows]
                               for k, v in next(whole).items()}, t.device)
                    for _ in range(run["steps"])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        blocked0 = t.topo.blocked_s
        state, m = t.step_fn(t.state, feed[0])
        loss1 = m["loss"].item()
        full = t.logical_params()
        if t.topo.rank == 0:
            torch.save([p.detach().float().cpu() for p in tree_leaves(full)],
                       run["save"])
        del full
        res = {"device": str(t.device), "loss1": loss1,
               "last_loss": loss1, "ms_per_step": None,
               "collective_s_a_timed_step": None,
               "coords": [t.topo.process_index, t.topo.model_index,
                          t.topo.seq_index, t.topo.stage_index,
                          t.topo.expert_index]}
        if len(feed) > 1:
            # every rank starts the timed steps together (rank 0 wrote
            # the params meanwhile), once the parent's one-process
            # references are done
            while not os.path.exists(run["hold"]):
                time.sleep(0.05)
            dist.barrier()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            blocked1 = t.topo.blocked_s
            a.record()
            for batch in feed[1:]:
                state, m = t.step_fn(state, batch)
            b.record()
            b.synchronize()
            res.update(last_loss=m["loss"].item(),
                       ms_per_step=a.elapsed_time(b) / (len(feed) - 1),
                       collective_s_a_timed_step=(t.topo.blocked_s
                                                  - blocked1)
                       / (len(feed) - 1))
        res.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   collective_s=t.topo.blocked_s - blocked0,
                   staged=t.topo.comm.staged,
                   slot_bytes=sum(x.numel() * x.element_size()
                                  for x in tree_leaves(t.state.momentum)))
        if run.get("eval"):
            res["eval_loss"] = t.evaluate()["loss"]
        res["launches"] = {k: f.launches for k, f in kernels.items()}
        res["seconds"] = time.perf_counter() - t_run
        out["runs"][run["name"]] = res
        del t, state, feed
        torch.cuda.empty_cache()
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(out, f)
finally:
    shutdown_distributed()
"""


def _mp_config(tmp: str, kind: str) -> str:
    path = f"{tmp}/mp_{kind}.json"
    with open(f"{path}.part", "w") as f:
        json.dump(MP_KINDS[kind], f)
    os.replace(f"{path}.part", path)  # the workers may be reading it
    return path


def _mp_reference(tmp: str, kind: str, refs: dict) -> dict:
    """The one-process step of an arm's model from the same seed and
    batch: its loss, the params before and after it (float32 on the
    host), each leaf's update norm and, for a bf16 kind, each leaf's
    bf16 noise against the float32 kind's step in ``refs``."""
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    from distributedmnist_tpu_torch.parallel.partition_rules import \
        tree_path_names
    t = build_trainer(["train", "--config", _mp_config(tmp, kind),
                       f"train.train_dir={tmp}/mp_ref_{kind}",
                       f"mesh.num_replicas={MP_REPLICAS.get(kind, 1)}",
                       "--device", DEVICE])
    # the logical params (H's reference keeps its ZeRO-1 leaves as
    # resident chunks)
    before = [p.detach().float().cpu()
              for p in tree_leaves(t.logical_params())]
    state, m = t.step_fn(t.state, to_device(next(t.train_iter), t.device))
    logical = t.logical_params()
    after = [p.detach().float().cpu() for p in tree_leaves(logical)]
    rec = {"loss1": m["loss"].item(), "after": after,
           "update_norm": [float((a - b).norm())
                           for a, b in zip(after, before)],
           "names": tree_path_names(logical)}
    if not kind.endswith("_f32"):
        # each leaf's bf16 noise: this step's distance from the float32
        # step (the float32 kind's reference is made first)
        rec["noise"] = _update_gaps(after, refs[f"{kind}_f32"])
    del t, state
    torch.cuda.empty_cache()
    return rec


def _update_gaps(got: list, ref: dict) -> list:
    """Each leaf's ``||got − ref after|| / ||ref update||``."""
    return [float((g - a).norm()) / max(u, 1e-30)
            for g, a, u in zip(got, ref["after"], ref["update_norm"])]


def _mp_runs(tmp: str, name: str, arms: list) -> list:
    runs = []
    for arm in arms:
        kind, overrides, _, steps = MP_ARMS[arm]
        runs.append({"name": arm, "config": _mp_config(tmp, kind),
                     "steps": steps,
                     "eval": (kind in ("train", "moe", "train4", "zero1")
                              and arm not in MP_NO_EVAL),
                     "save": f"{tmp}/{name}_{arm}.pt",
                     "hold": f"{tmp}/mp_references_done",
                     "overrides": ["mesh.num_replicas=1",
                                   f"train.train_dir={tmp}/{name}_{arm}",
                                   *overrides]})
    return runs


def _stacked_rows(ref: dict, stages: int, chunks: int) -> tuple[list, list]:
    """The stacked layout's leaf names (in its ``tree_leaves`` order) and,
    for each, the indices of the one-process reference's per-layer
    leaves its rows hold (``pp_layer_order``: the 1F1B layout permutes
    the layers); a leaf outside the blocks holds its own."""
    from distributedmnist_tpu_torch.models.transformer import pp_layer_order
    idx = {n: i for i, n in enumerate(ref["names"])}
    layers = 1 + max(int(n.split("/")[1]) for n in ref["names"]
                     if n.startswith("blocks/"))
    order = pp_layer_order(layers, stages, chunks)
    names, rows = [], []
    for n in ref["names"]:
        parts = n.split("/")
        sn = "/".join(["blocks"] + parts[2:]) if parts[0] == "blocks" else n
        if sn in names:
            continue
        names.append(sn)
        rows.append([idx[f"blocks/{layer}/{'/'.join(parts[2:])}"]
                     for layer in order] if parts[0] == "blocks"
                    else [idx[n]])
    return names, rows


def _stacked_gaps(got: list, ref: dict, f32: dict | None, stages: int,
                  chunks: int) -> tuple[list, list, list]:
    """:func:`_update_gaps` of a pipeline arm's stacked leaves against
    the one-process reference's per-layer ones: each stacked leaf's
    ``||got − ref after||`` over its rows, over the norm of the
    reference's update of those rows; with ``f32`` (the float32 kind's
    reference) each stacked leaf's bf16 noise, the bf16 step's distance
    from the float32 step over the float32 update, over the same rows.
    Returns (names, gaps, noise or None)."""
    names, rows = _stacked_rows(ref, stages, chunks)
    gaps, noise = [], []
    for g, rs in zip(got, rows):
        parts = g.unbind(0) if ref["names"][rs[0]].startswith("blocks/") \
            else [g]
        num = sum(float((p - ref["after"][r]).norm()) ** 2
                  for p, r in zip(parts, rs))
        den = sum(ref["update_norm"][r] ** 2 for r in rs)
        gaps.append(math.sqrt(num) / max(math.sqrt(den), 1e-30))
        if f32 is not None:
            n2 = sum((ref["noise"][r] * f32["update_norm"][r]) ** 2
                     for r in rs)
            d2 = sum(f32["update_norm"][r] ** 2 for r in rs)
            noise.append(math.sqrt(n2) / max(math.sqrt(d2), 1e-30))
    return names, gaps, (noise if f32 is not None else None)


def _pp_launches(arm: str, steps: int, evaluate: bool) -> dict:
    """The flash launches a process of a pipeline arm makes, from its
    schedule's table (every stage does as many works): under 1F1B a
    forward work runs without autograd (K1) and its backward recomputes
    the chunk (K1-lse, then K2 and K3); under GPipe a forward keeps its
    graph (K1-lse). An eval pipelines the eval batch at the largest
    microbatch count up to the training one that divides it (K1 a
    forward)."""
    from distributedmnist_tpu_torch.ops.pipeline import (make_1f1b_schedule,
                                                         make_gpipe_schedule)
    schedule, S, v, M = MP_PP[arm]
    kind = MP_KINDS[MP_ARMS[arm][0]]
    per = kind["model"]["num_layers"] // (S * v)
    one_f = schedule == "1f1b"
    tbl = (make_1f1b_schedule(S, v, M) if one_f
           else make_gpipe_schedule(S, M))
    f = int(((tbl["kind"] == 1) | (tbl["kind"] == 2)).sum()) // S
    b = int((tbl["kind"] == 3).sum()) // S
    out = {"K1": steps * f * per if one_f else 0,
           "K1-lse": steps * (b if one_f else f) * per,
           "K2": steps * b * per, "K3": steps * b * per, "K4": 0}
    if evaluate:
        rows = kind["eval"]["eval_batch_size"]
        m_eval = max(m for m in range(1, M + 1) if rows % m == 0)
        ev = (make_1f1b_schedule(S, v, m_eval, forward_only=True) if one_f
              else make_gpipe_schedule(S, m_eval, forward_only=True))
        out["K1"] += int((ev["kind"] > 0).sum()) // S * per
    return out


def _zero1_slot_bytes(kind: str, overrides: tuple) -> int:
    """A rank's optimizer-slot bytes under a ZeRO-1 arm's plan, from the
    model's shapes alone: its replicas' chunks of every leaf the plan
    shards over the replica group, its model shard of every fallback
    leaf, in the slots' dtype, for each slot tree."""
    import torch

    from distributedmnist_tpu_torch.core.config import (
        ExperimentConfig, effective_model_config, parse_cli_overrides)
    from distributedmnist_tpu_torch.core.mesh import Topology
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.parallel import api
    from distributedmnist_tpu_torch.parallel.partition_rules import \
        tree_leaves
    from distributedmnist_tpu_torch.train import optim as optim_lib
    cfg = ExperimentConfig.from_dict(MP_KINDS[kind]).override(
        parse_cli_overrides(list(overrides)))
    n, m = cfg.mesh.num_replicas, cfg.mesh.model_parallelism
    topo = Topology(num_replicas=n, process_count=MP_WORLD // m,
                    distributed=True, model_parallelism=m)
    model = get_model(effective_model_config(cfg))
    plan = api.zero1_plan_for(model, cfg, topo)
    shards = tree_leaves(api.tp_shard(api.build_params(
        model, cfg, topo, torch.device("meta")), model, topo))
    size = torch.empty((), dtype=optim_lib.slot_dtype(
        api.resolved_param_dtype(cfg))).element_size()
    per_tree = sum(topo.local_replica_count * lp.chunk if lp.sharded
                   else x.numel() for lp, x in zip(plan.leaves(), shards))
    return optim_lib.make_optimizer(cfg.optim).num_slots * per_tree * size


def _mp_arm(results: list, run: dict, refs: dict) -> tuple[dict, list]:
    """One arm's record from every process's result, and what fails its
    checks: step 1 against the one-process step (a pipeline arm's in the
    stacked layout), the same loss on every rank, a card a process, the
    flash kernels launched by every process (a pipeline arm's at the
    counts its schedule predicts), a ZeRO-1 arm's slot bytes on every
    rank those of its plan."""
    import torch
    kind, overrides, flash, steps = MP_ARMS[run["name"]]
    ref, f32 = refs[kind], kind.endswith("_f32")
    procs = [r["runs"][run["name"]] for r in results]
    pp = MP_PP.get(run["name"])
    names, noise = ref["names"], ref.get("noise")
    if pp is not None:
        names, errs, noise = _stacked_gaps(
            torch.load(run["save"]), ref, None if f32 else
            refs[f"{kind}_f32"], pp[1], pp[2])
    else:
        errs = _update_gaps(torch.load(run["save"]), ref)
    if f32:
        bound = [MP_UPDATE_TOL_F32] * len(errs)
    else:
        bound = [MP_NOISE_RATIO * z for z in noise]
    worst = max(range(len(errs)), key=lambda i: errs[i] / max(bound[i],
                                                              1e-30))
    ms = procs[0]["ms_per_step"]
    tokens = (LONG["batch"] * LONG["seq_len"] if kind.startswith("long")
              else MP_BATCH * MODEL["seq_len"])
    rec = {"dtype": "float32" if f32 else "bfloat16",
           "loss1": procs[0]["loss1"], "loss1_one_process": ref["loss1"],
           "loss1_abs_diff": abs(procs[0]["loss1"] - ref["loss1"]),
           "update_rel_err_max": max(errs),
           "update_worst_leaf": names[worst],
           "update_worst_gap_over_bound": errs[worst] / max(bound[worst],
                                                            1e-30),
           "update_gap_by_leaf": dict(zip(names, errs)),
           "last_loss": procs[0]["last_loss"],
           "ms_per_step": ms, "ms_per_step_by_rank": [p["ms_per_step"]
                                                      for p in procs],
           "tokens_per_s": None if ms is None else tokens / (ms / 1e3),
           "peak_gb_by_rank": [p["peak_gb"] for p in procs],
           "collective_s_by_rank": [p["collective_s"] for p in procs],
           "collective_s_a_timed_step_by_rank": [
               p["collective_s_a_timed_step"] for p in procs],
           "staged_by_rank": [p["staged"] for p in procs],
           "coords_by_rank": [p["coords"] for p in procs],
           "launches_by_rank": [p["launches"] for p in procs],
           "devices": [p["device"] for p in procs],
           "eval_loss": procs[0].get("eval_loss"),
           "slot_bytes_by_rank": [p["slot_bytes"] for p in procs],
           "seconds_by_rank": [p["seconds"] for p in procs]}
    if not f32:
        # each leaf: the one-process bf16 step's own distance from the
        # float32 step, over the float32 update's norm
        rec["bf16_noise_by_leaf"] = dict(zip(names, noise))
    name = run["name"]
    want = None
    if pp is not None:
        want = _pp_launches(name, steps, run["eval"])
        rec["pipeline"] = {"schedule": pp[0], "stages": pp[1],
                           "chunks": pp[2], "microbatches": pp[3],
                           "launches_expected": want}
    slots = None
    if MP_KINDS[kind].get("parallel", {}).get("shard_weight_update"):
        slots = rec["slot_bytes_expected"] = _zero1_slot_bytes(kind,
                                                               overrides)
    fails = [msg for ok, msg in (
        (all(d.startswith("cuda") for d in rec["devices"]),
         f"{name}: devices {rec['devices']}"),
        (len({p["loss1"] for p in procs}) == 1,
         f"{name}: step-1 losses differ across ranks: "
         f"{[p['loss1'] for p in procs]}"),
        (rec["loss1_abs_diff"] <= MP_LOSS_TOL,
         f"{name}: step-1 loss {rec['loss1']} against one process's "
         f"{ref['loss1']}"),
        (all(e <= b for e, b in zip(errs, bound)),
         f"{name}: update of {rec['update_worst_leaf']} "
         f"{errs[worst]} of its norm from one process's, over its bound "
         f"{bound[worst]}"),
        (not flash or all(p["launches"][k] > 0 for p in procs
                          for k in ("K1-lse", "K2", "K3")),
         f"{name}: flash launches {rec['launches_by_rank']}"),
        (want is None or all(p["launches"] == want for p in procs),
         f"{name}: flash launches {rec['launches_by_rank']}, the schedule "
         f"predicts {want} a process"),
        (slots is None or all(p["slot_bytes"] == slots for p in procs),
         f"{name}: slot bytes {rec['slot_bytes_by_rank']}, the plan's "
         f"{slots} a rank")) if not ok]
    return rec, fails


def phase_model_parallel(tmp: str) -> dict:
    """Tensor, sequence, expert and pipeline parallelism and ZeRO-1 over
    them (Queue A items 8a–8d): the arms of ``MP_ARMS`` in one launch of
    ``MP_WORLD`` gloo processes sharing ``cuda:0``, each arm's step 1
    against the one-process step of its model here; with 4 cards, arms
    B, D, G and H again over NCCL, one card a process (else null with
    the card count)."""
    import torch
    t_phase = time.time()
    ref_s, refs = {}, {}

    def references():
        # the float32 kinds first: each bf16 kind's noise reads its own
        try:
            for kind in sorted(MP_KINDS,
                               key=lambda k: not k.endswith("_f32")):
                t0 = time.time()
                refs[kind] = _mp_reference(tmp, kind, refs)
                ref_s[kind] = time.time() - t0
        finally:
            open(runs[0]["hold"], "w").close()

    runs = _mp_runs(tmp, "mp_gloo", list(MP_ARMS))
    # the references are made here while the workers boot and build;
    # the workers time no step before they are done
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        made = pool.submit(references)
        res = _dist_group(tmp, "mp_gloo", "gloo", ["cuda:0"] * MP_WORLD,
                          runs, child=_MP_CHILD,
                          timeout_s=MP_CHILD_TIMEOUT_S)
        made.result()
    reset_counts()
    arms, fails = {}, []
    for run in runs:
        arms[run["name"]], f = _mp_arm(res, run, refs)
        fails += f
    t_gloo = time.time() - t_phase
    cards = torch.cuda.device_count()
    nccl = {"cards": cards, **dict.fromkeys(MP_NCCL_ARMS)}
    if cards >= MP_WORLD:
        runs = _mp_runs(tmp, "mp_nccl", list(MP_NCCL_ARMS))
        res = _dist_group(tmp, "mp_nccl", "nccl",
                          [f"cuda:{i}" for i in range(MP_WORLD)], runs,
                          child=_MP_CHILD, timeout_s=MP_CHILD_TIMEOUT_S)
        for run in runs:
            nccl[run["name"]], f = _mp_arm(res, run, refs)
            fails += f
    counts = read_counts()
    rec = {"phase": "model_parallel", "card": nvidia_smi(),
           "world": MP_WORLD, "steps": MP_STEPS,
           "arms": arms, "nccl": nccl, "loss_tol": MP_LOSS_TOL,
           "update_tol_f32": MP_UPDATE_TOL_F32,
           "noise_ratio": MP_NOISE_RATIO,
           "launches_here": counts, "reference_seconds": ref_s,
           "gloo_launch_seconds": t_gloo,
           "seconds": time.time() - t_phase}
    emit(rec)
    check(not fails, "; ".join(fails))
    return rec


# -- phase 8: the rest of the data-parallel step on ResNet-20 -----------------

RESNET_CONFIG = "configs/cifar10_resnet20_sync.json"
RESNET_RUN_STEPS, RESNET_TIMED = 10, 20
# card against CPU: 3 float32 steps at batch 64 from one seed, each
# leaf's ||Δ|| / ||·||, the card's and the CPU's against a float64 run
# on the CPU. ResNet-20's float32 training is ill-conditioned there:
# after 3 steps each float32 run is ~1e-2 of a leaf's norm from the
# float64 one (the card's and the CPU's alike, as measured in PERF.md), so the
# two float32 runs cannot agree to 1e-4; the check is that the card is
# as close to float64 as the CPU is (within RESNET_CARD_VS_CPU_FACTOR of
# the CPU's error)
RESNET_CPU_BATCH, RESNET_CARD_VS_CPU_FACTOR = 64, 2.0
# the knobs on 8 simulated replicas at the config's batch, 3 steps an arm
KNOB_REPLICAS, KNOB_STEPS = 8, 3
KNOB_RTOL, KNOB_ATOL = 1e-5, 1e-6
ZERO_KNOBS = {"zero1": ("parallel.shard_weight_update=true",),
              "zero1_buckets4": ("parallel.shard_weight_update=true",
                                 "parallel.comm_buckets=4"),
              "zero1_resident": ("parallel.shard_weight_update=true",
                                 "parallel.comm_buckets=4",
                                 "parallel.resident_sharded=true")}
MOMENTUM_ARGS = ("optim.name=momentum", "optim.momentum=0.9")
# cross-world restore: a ZeRO-1 LAMB run at 8 replicas saved at step
# RESTORE_STEPS, resumed at 4
RESTORE_STEPS, RESTORE_BATCH = 5, 256


def _resnet_macs(size: int = 32, channels: int = 3,
                 classes: int = 10) -> int:
    """Multiply-adds of one image's forward, from the layer shapes: the
    3x3 stem, each block's two 3x3 convolutions (the first of stages 2
    and 3 at stride 2) and 1x1 projection, the head; 40.8 M at 32x32x3."""
    from distributedmnist_tpu_torch.models import resnet
    hw, cin = size, resnet.WIDTHS[0]
    macs = hw * hw * channels * cin * 9
    for si, w in enumerate(resnet.WIDTHS):
        for bi in range(resnet.BLOCKS_PER_STAGE):
            if si > 0 and bi == 0:
                hw //= 2
            macs += hw * hw * (cin + w) * w * 9
            if cin != w:
                macs += hw * hw * cin * w
            cin = w
    return macs + cin * classes


def _resnet_flops(batch: int) -> float:
    """Model FLOPs of a train step: 3 × 2 × the forward's multiply-adds."""
    return 3.0 * 2 * _resnet_macs() * batch


def _classify_resnet_kernel(name: str) -> str:
    name = name.lower()
    if any(k in name for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                               "implicit")):
        return "conv"
    if any(k in name for k in ("group_norm", "groupnorm", "rowwisemoments",
                               "computefusedparams", "compute_internal",
                               "gamma_beta", "gammabeta")):
        return "groupnorm"
    if any(k in name for k in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "gemm"
    return "other"


def _resnet_profile(step, batch, wall_ms: float, steps: int = 3) -> dict:
    """``torch.profiler`` over ``steps`` steps: device ms by class
    (cuDNN convolutions, GroupNorm, GEMMs, every other kernel) and the
    idle share 1 - busy / wall (one stream)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
    by_class = {"conv": 0.0, "groupnorm": 0.0, "gemm": 0.0, "other": 0.0}
    top, launches = [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_class[_classify_resnet_kernel(e.key)] += us / 1e3 / steps
        launches += e.count
        top.append((us / 1e3 / steps, e.key[:60]))
    busy = sum(by_class.values())
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy > 0
            else "not measured",
            "busy_ms_by_class": by_class,
            "kernels_per_step": launches / steps,
            "top_kernels_ms": [[round(t, 4), k] for t, k in
                               sorted(top, reverse=True)[:10]]}


def _timed_steps(trainer, feed: list, warm: int = 1) -> tuple:
    """Run ``trainer.step_fn`` over ``feed`` (device batches); CUDA
    events around all but the first ``warm`` steps and the host's clock
    around the same issue. Returns (state, metrics list, device ms a
    step, host issue ms a step)."""
    import torch
    state, hist = trainer.state, []
    for b in feed[:warm]:
        state, m = trainer.step_fn(state, b)
        hist.append(m)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for b in feed[warm:]:
        state, m = trainer.step_fn(state, b)
        hist.append(m)
    host = (time.perf_counter() - t0) * 1e3 / max(len(feed) - warm, 1)
    e.record()
    e.synchronize()
    return state, hist, a.elapsed_time(e) / max(len(feed) - warm, 1), host


def _canonical_leaves(trainer, state=None) -> tuple[list, list]:
    """(params, slots) of a trainer's state in logical shapes, as CPU
    copies (LAMB's m then v)."""
    from distributedmnist_tpu_torch.parallel.api import (
        canonical_save_state, tree_leaves)
    c = canonical_save_state(state or trainer.state, trainer._zero1_plan)
    cpu = lambda tree: [x.detach().float().cpu().clone()  # noqa: E731
                        for x in tree_leaves(tree)]
    return cpu(c.params), cpu(c.momentum)


def _leaf_gap(got: list, want: list) -> dict:
    """The largest |Δ| and ||Δ|| / ||want|| over leaves, and whether
    every element is within ``KNOB_RTOL``·|want| + ``KNOB_ATOL``."""
    import torch
    return {"max_abs": max(float((a - b).abs().max()) for a, b in
                           zip(got, want)),
            "max_leaf_rel": max(float((a - b).norm() / b.norm().clamp_min(
                1e-30)) for a, b in zip(got, want)),
            "within_tol": all(bool(torch.allclose(a, b, rtol=KNOB_RTOL,
                                                  atol=KNOB_ATOL))
                              for a, b in zip(got, want))}


def _bitwise(a: list, b: list) -> bool:
    import torch
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _resnet_main(tmp: str, data_dir: str) -> tuple[dict, "object"]:
    """The slice's main path: ``launch train`` on the ResNet config, only
    ``data.data_dir`` and ``train.train_dir`` overridden (and
    ``compile.precompile`` off: this phase times the eager step; the
    ``graphs`` phase the captured one), built by the CLI's
    ``build_trainer`` (the Trainer loads the fixture itself)."""
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    tr = build_trainer(["train", "--config", RESNET_CONFIG,
                        "compile.precompile=false",
                        f"data.data_dir={data_dir}",
                        f"train.train_dir={tmp}/resnet", "--device", DEVICE])
    cfg, n = tr.cfg, tr.topo.num_replicas
    check(tr.device.type == DEVICE and cfg.model.name == "resnet20"
          and cfg.data.dataset == "cifar10" and tr.model.compute_dtype
          == torch.bfloat16 and tr.datasets.train.num_examples == 45000,
          f"resnet trainer: {cfg.model.name} on {tr.device}, "
          f"{tr.datasets.train.num_examples} train examples")
    B = cfg.data.batch_size
    losses = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    summary = tr.run(max_steps=RESNET_RUN_STEPS,
                     step_callback=lambda s, r: losses.append(r["loss"]))
    torch.cuda.synchronize()
    counts = read_counts()
    run_s = time.time() - t0
    ev = tr.evaluate("test")
    feed = [to_device(next(tr.train_iter), tr.device)
            for _ in range(RESNET_TIMED + 3)]
    torch.cuda.reset_peak_memory_stats()
    state, _, ms, host_ms = _timed_steps(tr, feed, warm=3)
    tr.state = state
    peak = torch.cuda.max_memory_allocated() / 1e9

    def step(b):
        tr.state, _ = tr.step_fn(tr.state, b)

    profile = _resnet_profile(step, feed[0], ms)
    flops = _resnet_flops(B)
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    rec = {"batch": B, "replicas": n, "dtype": "bfloat16",
           "params": sum(p.numel() for p in tree_leaves(tr.state.params)),
           "run": {"steps": len(losses), "first_loss": losses[0],
                   "last_loss": losses[-1], "seconds": run_s,
                   "updates_applied": summary["updates_applied"]},
           "eval": ev, "ms_per_step": ms, "host_issue_ms_per_step": host_ms,
           "images_per_s": B / (ms / 1e3),
           "forward_macs_per_image": _resnet_macs(),
           "flops_per_step": flops,
           "model_tflops_per_s": flops / (ms / 1e3) / 1e12,
           "flop_bound_ms": t_ops, "peak_mem_gb": peak, "profile": profile,
           "flash_paged_kernel_launches": counts}
    check(len(losses) == RESNET_RUN_STEPS and all(map(math.isfinite, losses))
          and math.isfinite(ev["loss"]) and ev["num_examples"] == 10000,
          f"resnet run: losses {losses}, eval {ev}")
    check(all(v == 0 for v in counts.values()), f"launches {counts}")
    return rec, tr


def _resnet_card_vs_cpu(tmp: str, ds) -> dict:
    """3 float32 steps at batch 64 from one seed on the card and on the
    CPU, and the same steps computed in float64 on the CPU: each leaf's
    relative error, card against CPU and each against float64."""
    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    runs = {}
    for name, dev, dtype in ((DEVICE, DEVICE, "float32"),
                             ("cpu", "cpu", "float32"),
                             ("cpu_f64", "cpu", "float64")):
        tr = build_trainer(["train", "--config", RESNET_CONFIG,
                            "compile.precompile=false",
                            f"train.train_dir={tmp}/rn_{name}",
                            f"data.batch_size={RESNET_CPU_BATCH}",
                            f"model.compute_dtype={dtype}",
                            f"precision.param_dtype={dtype}", "--device",
                            dev], datasets=ds)
        state = tr.state
        for _ in range(3):
            state, _ = tr.step_fn(state, to_device(next(tr.train_iter),
                                                   tr.device))
        runs[name] = [p.detach().cpu().double()
                      for p in tree_leaves(state.params)]

    def rel(a, b):
        return max(float((x - y).norm() / y.norm()) for x, y in zip(a, b))

    oracle = runs["cpu_f64"]
    rec = {"batch": RESNET_CPU_BATCH, "steps": 3, "dtype": "float32",
           "param_rel_err": rel(runs[DEVICE], runs["cpu"]),
           "card_vs_float64": rel(runs[DEVICE], oracle),
           "cpu_vs_float64": rel(runs["cpu"], oracle),
           "factor": RESNET_CARD_VS_CPU_FACTOR}
    check(rec["card_vs_float64"]
          <= RESNET_CARD_VS_CPU_FACTOR * rec["cpu_vs_float64"] + 1e-6,
          f"resnet card vs CPU: {rec}")
    return rec


def _resnet_knobs(tmp: str, ds) -> dict:
    """The slice's knobs on ResNet-20 over 8 simulated replicas at the
    config's batch, each arm fed the same 3 batches: ZeRO-1 against the
    replicated update (momentum bitwise; LARS and LAMB within the
    tolerance after one step), accumulation,
    bf16 params with and without masters, and an all-masked LAMB step."""
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    from distributedmnist_tpu_torch.parallel.api import tree_leaves

    def arm(name, *over):
        return build_trainer(["train", "--config", RESNET_CONFIG,
                              "compile.precompile=false",
                              f"train.train_dir={tmp}/knob_{name}",
                              f"mesh.num_replicas={KNOB_REPLICAS}", *over,
                              "--device", DEVICE], datasets=ds)

    first = arm("feed")
    feed = [to_device(next(first.train_iter), first.device)
            for _ in range(KNOB_STEPS)]
    del first
    out, ms = {}, {}

    def run(name, *over, steps=KNOB_STEPS):
        tr = arm(name, *over)
        state, hist, t, _ = _timed_steps(tr, feed[:steps])
        if steps > 1:
            ms[name] = t
        return tr, state, hist

    # momentum: the ZeRO-1 layouts bitwise with the replicated update
    tr, st, hist = run("momentum_replicated", *MOMENTUM_ARGS)
    want = _canonical_leaves(tr, st)
    f32_loss = float(hist[-1]["loss"])
    zero = {}
    for knob, args in ZERO_KNOBS.items():
        tz, sz, _ = run(f"momentum_{knob}", *MOMENTUM_ARGS, *args)
        got = _canonical_leaves(tz, sz)
        zero[knob] = {"params_bitwise": _bitwise(got[0], want[0]),
                      "slots_bitwise": _bitwise(got[1], want[1]),
                      "slot_layout": sorted({tuple(x.shape) == (lp.pad,)
                                             for x, lp in zip(
                                                 tree_leaves(sz.momentum),
                                                 tz._zero1_plan.leaves())
                                             if lp.sharded})}
        zero[knob]["digest_equal"] = (zero[knob]["params_bitwise"]
                                      and zero[knob]["slots_bitwise"])
    out["momentum"] = zero
    # LARS and LAMB: replicated against ZeRO-1 (4 buckets)
    for opt in ("lars", "lamb"):
        tr, st, _ = run(f"{opt}_replicated_1", f"optim.name={opt}", steps=1)
        tz, sz, _ = run(f"{opt}_zero1_1", f"optim.name={opt}",
                        *ZERO_KNOBS["zero1_buckets4"], steps=1)
        w, g = _canonical_leaves(tr, st), _canonical_leaves(tz, sz)
        out[opt] = {"after_1": {"params": _leaf_gap(g[0], w[0]),
                                "slots": _leaf_gap(g[1], w[1])}}
    # accumulation: 2 × B/2 against 1 × B on the same rows
    B = tr.cfg.data.batch_size
    ta, sa, ha = run("accum2", *MOMENTUM_ARGS, "train.grad_accum_steps=2",
                     f"data.batch_size={B // 2}")
    got = _canonical_leaves(ta, sa)
    out["grad_accum"] = {
        "effective_batch": ta.effective_batch,
        "param_rel_err": max(float((a - b).norm() / b.norm())
                             for a, b in zip(got[0], want[0])),
        "loss": float(ha[-1]["loss"]), "loss_accum1": f32_loss}
    # bf16 params with and without float32 masters
    prec = {}
    for masters in ("true", "false"):
        tp, sp, hp = run(f"bf16_masters_{masters}", *MOMENTUM_ARGS,
                         "precision.param_dtype=bfloat16",
                         f"precision.master_weights={masters}")
        prec[f"master_weights_{masters}"] = {
            "param_dtypes": sorted({str(x.dtype) for x in
                                    tree_leaves(sp.params)}),
            "slot_dtypes": sorted({str(x.dtype) for x in
                                   tree_leaves(sp.momentum)}),
            "loss": float(hp[-1]["loss"]), "loss_float32_params": f32_loss}
    out["precision"] = prec
    # an all-masked timeout step under LAMB with ZeRO-1: a bitwise no-op
    tm = arm("masked", "optim.name=lamb", *ZERO_KNOBS["zero1_buckets4"],
             "sync.mode=timeout", "sync.timeout_ms=0")
    before = [x.clone() for x in tree_leaves((tm.state.params,
                                              tm.state.momentum))]
    sm, mm = tm.step_fn(tm.state, feed[0])
    out["all_masked_lamb_zero1"] = {
        "num_contributors": mm["num_contributors"],
        "bitwise_noop": _bitwise([x for x in tree_leaves(
            (sm.params, sm.momentum))], before)}
    out["ms_per_step"] = ms
    check(all(r["digest_equal"] and r["slot_layout"] == [True]
              for r in zero.values()), f"momentum ZeRO-1 arms: {zero}")
    for opt in ("lars", "lamb"):
        a1 = out[opt]["after_1"]
        check(a1["params"]["within_tol"] and a1["slots"]["within_tol"],
              f"{opt} ZeRO-1 vs replicated after one step: {a1}")
    check(prec["master_weights_true"]["param_dtypes"] == ["torch.float32"]
          and prec["master_weights_false"]["param_dtypes"]
          == ["torch.bfloat16"]
          and all(p["slot_dtypes"] == ["torch.float32"]
                  for p in prec.values())
          and all(math.isfinite(p["loss"]) for p in prec.values()),
          f"precision arms: {prec}")
    check(out["grad_accum"]["effective_batch"] == B
          and math.isfinite(out["grad_accum"]["param_rel_err"]),
          f"accumulation arm: {out['grad_accum']}")
    check(out["all_masked_lamb_zero1"]["num_contributors"] == 0.0
          and out["all_masked_lamb_zero1"]["bitwise_noop"],
          f"all-masked step: {out['all_masked_lamb_zero1']}")
    return out


def _resnet_restore(tmp: str, ds) -> dict:
    """A ZeRO-1 LAMB run at 8 replicas saved at step 5 and resumed at 4:
    the journaled world change, the restored slots against the saved
    ones, the data cursor; a resume under momentum refused."""
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    from distributedmnist_tpu_torch.models.convert import params_from_reference
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    d = f"{tmp}/restore"

    def trainer(n, *over):
        return build_trainer(["train", "--config", RESNET_CONFIG,
                              "compile.precompile=false",
                              f"train.train_dir={d}", f"mesh.num_replicas={n}",
                              f"data.batch_size={RESTORE_BATCH}",
                              "optim.name=lamb",
                              *ZERO_KNOBS["zero1_buckets4"],
                              f"train.max_steps={RESTORE_STEPS}",
                              f"train.save_interval_steps={RESTORE_STEPS}",
                              *over, "--device", DEVICE], datasets=ds)

    trainer(8).run()
    saved, extra, step = ckpt.restore_state(d)
    resumed = trainer(4)
    with open(f"{d}/recovery_journal.jsonl") as f:
        records = [json.loads(line) for line in f]
    cross = [r for r in records if r.get("action") == "cross_world_restore"]
    _, slots = _canonical_leaves(resumed)
    want = tree_leaves(params_from_reference(saved["momentum"], device="cpu"))
    # the lockstep batch count of either order's cursor (the config
    # batches in the native loader's order on a host with a spare core)
    cursor = resumed.train_iter.batches_consumed
    more = resumed.run(max_steps=RESTORE_STEPS + 1)
    refused = None
    try:
        trainer(4, "optim.name=momentum", "optim.momentum=0.9")
    except ckpt.OptimizerStateMismatchError as e:
        refused = f"{type(e).__name__}: {str(e)[:120]}"
    rec = {"saved_step": step, "cross_world_restore": cross[-1] if cross
           else None, "slots_equal_saved": _bitwise(slots, want),
           "cursor_batches": cursor,
           "continued_loss": more["last_metrics"]["loss"],
           "momentum_resume_refused": refused}
    check(step == RESTORE_STEPS and cross and cross[-1]["saved_world"][
        "num_replicas"] == 8 and cross[-1]["new_world"]["num_replicas"] == 4
          and rec["slots_equal_saved"] and cursor == RESTORE_STEPS
          and math.isfinite(rec["continued_loss"]) and refused is not None,
          f"cross-world restore: {rec}")
    return rec


def start_cifar_fixture(tmp: str) -> subprocess.Popen:
    """A process writing the CIFAR-10 fixture under ``tmp`` (seconds of
    numpy and pickling), started phases before the first reads it."""
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys\n"
         "from distributedmnist_tpu_torch.data.fixtures import (\n"
         "    materialize_cifar10_fixture)\n"
         "materialize_cifar10_fixture(sys.argv[1])", f"{tmp}/cifar10"],
        cwd=os.path.dirname(os.path.abspath(__file__)))


def wait_cifar_fixture(fixture: subprocess.Popen) -> dict:
    check(fixture.wait() == 0,
          f"the CIFAR-10 fixture's process exited {fixture.returncode}")
    return {"returncode": fixture.returncode}


def phase_resnet(tmp: str) -> dict:
    """ResNet-20 on the CIFAR-10 fixture (50,000 / 10,000, written by the
    port's ``data/fixtures.py``): the main path, card against CPU, the
    slice's knobs and the cross-world restore."""
    from distributedmnist_tpu_torch.data.datasets import load_cifar10
    from distributedmnist_tpu_torch.data.fixtures import (
        materialize_cifar10_fixture)
    t_phase = time.time()
    data_dir = str(materialize_cifar10_fixture(f"{tmp}/cifar10"))
    fixture_s = time.time() - t_phase
    main, _ = _resnet_main(tmp, data_dir)
    ds = load_cifar10(data_dir)
    reset_counts()
    rec = {"phase": "resnet", "fixture_s": fixture_s, **main,
           "card_vs_cpu": _resnet_card_vs_cpu(tmp, ds),
           "knobs": _resnet_knobs(tmp, ds),
           "restore": _resnet_restore(tmp, ds)}
    counts = read_counts()
    rec["knob_flash_paged_kernel_launches"] = counts
    rec["seconds"] = time.time() - t_phase
    emit(rec)
    check(all(v == 0 for v in counts.values()), f"launches {counts}")
    return rec


def phase_e2e(train_dir: str, tmp: str) -> dict:
    """Serve the checkpoint the training phase published."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.launch.__main__ import \
        build_replica
    from distributedmnist_tpu_torch.train.checkpoint import \
        latest_checkpoint_step

    rng = np.random.default_rng(SEED)
    prompts = [(rng.integers(0, MODEL["vocab_size"], p).tolist(), m)
               for p, m in REQUESTS]
    served_step = latest_checkpoint_step(train_dir)
    check(served_step == TRAIN_STEPS,
          f"the training checkpoint is at step {served_step}")
    torch.cuda.empty_cache()
    t0 = time.time()
    rep = build_replica(["serve", "--decode", "--train-dir",
                                train_dir, "--serve-dir",
                                f"{tmp}/serve", "--device", DEVICE])
    rep.start()
    boot_s = time.time() - t0
    try:
        check(rep.device.type == DEVICE, f"replica on {rep.device}")
        # warm-up: every prompt bucket once (cuBLAS picks its
        # kernels per shape on first use), so the measured run is
        # the replica's steady state
        _drive(rep.bound_port, prompts, "warmup")
        reset_counts()
        pre0, it0 = rep.prefills, rep.decode_iterations
        outs, times, wall = _drive(rep.bound_port, prompts, "smoke")
        counts = read_counts()
        k1, k5 = counts["K1"], counts["K5"]
        prefills = rep.prefills - pre0
        iters = rep.decode_iterations - it0
        for (prompt, m), out in zip(prompts, outs):
            check(out is not None and out.get("status") == "ok",
                  f"request did not end ok: {out}")
            check(out["finish_reason"] == "max_tokens"
                  and len(out["tokens"]) == m,
                  f"expected {m} tokens, got {len(out['tokens'])} "
                  f"({out['finish_reason']})")
        layers = MODEL["num_layers"]
        check(prefills == len(prompts) and iters > 0,
              f"{prefills} prefills, {iters} decode iterations")
        check(k1 == layers * prefills,
              f"K1 launched {k1} times for {prefills} prefills")
        check(k5 == layers * iters,
              f"K5 launched {k5} times for {iters} decode iterations")
        check(counts["K1-lse"] == counts["K2"] == counts["K3"]
              == counts["K4"] == 0, f"training kernels ran: {counts}")
        firsts = []
        for (prompt, _), out in zip(prompts, outs):
            bucket = rep._bucket(len(prompt), DECODE["max_prompt_len"])
            toks = torch.zeros(1, bucket, dtype=torch.int64,
                               device=DEVICE)
            toks[0, :len(prompt)] = torch.tensor(prompt)
            logits, _, _ = rep.model.decode_prefill(rep._params, toks)
            firsts.append(int(torch.argmax(logits[0, len(prompt) - 1])))
        check(firsts == [o["tokens"][0] for o in outs],
              f"first tokens {[o['tokens'][0] for o in outs]} != "
              f"offline prefill argmax {firsts}")
        logit_err = _kernels_vs_plain(rep, prompts[2][0])
        profile = _profile_decode_step(rep)
    finally:
        rep.stop()
    check(logit_err <= E2E_LOGIT_TOL,
          f"kernels vs plain logits differ by {logit_err} > "
          f"{E2E_LOGIT_TOL}")
    tokens = sum(len(o["tokens"]) for o in outs)
    gaps = [b - a for ts in times for a, b in zip(ts, ts[1:])]
    rec = {"phase": "e2e", "requests": len(outs),
           "ok": sum(o["status"] == "ok" for o in outs), "tokens": tokens,
           "prefills": prefills, "decode_iterations": iters,
           "k1_launches": k1, "k5_launches": k5,
           "tokens_per_s": tokens / wall, "wall_s": wall,
           "ttft_p50_ms": statistics.median(o["ttft_ms"] for o in outs),
           "itl_p50_ms": statistics.median(gaps) * 1e3,
           "logits_max_abs_diff_kernels_vs_plain": logit_err,
           "logits_tol": E2E_LOGIT_TOL, "served_step": served_step,
           "boot_s": boot_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_step_profile": profile}
    emit(rec)
    return rec


def _sync() -> None:
    """Wait for the compute stream alone: a checkpoint writer's copy on
    its own stream is not the step's work."""
    import torch
    if DEVICE.startswith("cuda"):
        torch.cuda.current_stream().synchronize()


def _save_records(train_dir: str, kind: str = "save") -> list:
    path = os.path.join(train_dir, "train_log.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r.get("event") == kind]


def _pinned_host_peak():
    """The peak bytes of PyTorch's pinned host allocator, where this
    torch reports them."""
    import torch
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None or not DEVICE.startswith("cuda"):
        return "not measured"
    got = {k: v for k, v in stats().items() if "bytes" in k and "peak" in k}
    return got or "not measured"


# the writer's stages, timed on whichever thread runs them (module,
# function, label): ``fetch`` is the snapshot's copy to pinned memory and
# its ``convert``; ``pack`` is msgpack with each leaf's ``tobytes``;
# ``write`` is the hash, the file writes and the renames
CKPT_STAGES = (("loop", "snapshot_to_host", "fetch"),
               ("loop", "state_to_reference", "convert"),
               ("ckpt", "to_state_dict", "to_state_dict"),
               ("ckpt", "msgpack_serialize", "pack"),
               ("ckpt", "_write_atomic", "write"))


def _overlap_ms(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0)) * 1e3


def _ckpt_run(trainer) -> dict:
    """Run ``trainer`` with each step timed (host clock: the host's issue
    and the wait for the compute stream apart), marked by whether a
    checkpoint write was queued or running around it, and each writer
    stage timed on its thread. Per save, the loop's cost: its journaled
    stall plus the excess, over the medians with no write, of every
    step's issue, stream wait and gap before it until the next save (or
    the run's end), with the writer stages' overlap of that window. Also
    peak device memory and the wall time of the writer's final drain."""
    import threading

    import torch

    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    from distributedmnist_tpu_torch.train import loop
    modules = {"loop": loop, "ckpt": ckpt}
    steps, saves, stages, drain = [], [], [], {}
    inner, close, save = trainer.step_fn, trainer._close_writer, trainer._save
    originals = [(modules[m], f, getattr(modules[m], f))
                 for m, f, _ in CKPT_STAGES]

    def in_flight() -> bool:
        cp = trainer._checkpointer
        return cp is not None and (cp._busy or cp._pending is not None)

    def timed_step(state, batch, *args):
        busy = in_flight()
        t0 = time.perf_counter()
        out = inner(state, batch, *args)
        t_issued = time.perf_counter()
        _sync()
        steps.append({"busy": busy or in_flight(), "t0": t0,
                      "t_issued": t_issued, "t1": time.perf_counter()})
        return out

    def timed_save():
        t0 = time.perf_counter()
        save()
        saves.append((t0, time.perf_counter()))

    def timed_close():
        t0 = time.perf_counter()
        close()
        drain["ms"] = (time.perf_counter() - t0) * 1e3

    depth = threading.local()  # the outermost call of a recursive stage

    def timed_stage(fn, label):
        def wrapped(*args, **kwargs):
            outer = not getattr(depth, label, 0)
            setattr(depth, label, getattr(depth, label, 0) + 1)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                setattr(depth, label, getattr(depth, label) - 1)
                if outer:
                    stages.append((label, threading.current_thread().name,
                                   t0, time.perf_counter()))
        return wrapped

    trainer.step_fn, trainer._close_writer = timed_step, timed_close
    trainer._save = timed_save
    for (mod, f, fn), (_, _, label) in zip(originals, CKPT_STAGES):
        setattr(mod, f, timed_stage(fn, label))
    if DEVICE.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_host = getattr(torch.cuda, "reset_peak_host_memory_stats",
                             None)
        if reset_host is not None:
            reset_host()
    t0 = time.time()
    try:
        summary = trainer.run()
    finally:
        for mod, f, fn in originals:
            setattr(mod, f, fn)
        trainer.step_fn, trainer._close_writer = inner, close
        trainer._save = save
    run_s = time.time() - t0
    records = _save_records(str(trainer.train_dir))
    stalls = [r["save_stall_ms"] for r in records]
    ms = lambda a, b: (b - a) * 1e3  # noqa: E731
    median = lambda v: statistics.median(v) if v else None  # noqa: E731
    for j, st in enumerate(steps):
        st["ms"] = ms(st["t0"], st["t1"])
        st["issue"] = ms(st["t0"], st["t_issued"])
        st["wait"] = ms(st["t_issued"], st["t1"])
        # from the previous step's end, less the saves made in between
        if j:
            prev = steps[j - 1]["t1"]
            st["gap"] = ms(prev, st["t0"]) - sum(
                ms(s0, s1) for s0, s1 in saves if prev <= s0 < st["t0"])
        else:
            st["gap"] = None
    with_write = [st["ms"] for st in steps if st["busy"]]
    without = [st["ms"] for st in steps if not st["busy"]]
    quiet = [st for st in steps[1:] if not st["busy"]]
    base = {part: median([st[part] for st in quiet])
            for part in ("issue", "wait", "gap")}
    writer = [x for x in stages if x[1] == "ckpt-writer"]
    per_save = []
    for i, (rec, (s0, s1)) in enumerate(zip(records, saves)):
        nxt = saves[i + 1][0] if i + 1 < len(saves) else float("inf")
        mine = [st for st in steps if s1 <= st["t0"] < nxt]
        excess = {part: sum(st[part] - base[part] for st in mine)
                  for part in base} if mine and quiet else {}
        row = {"at_step": rec["at_step"], "stall_ms": rec["save_stall_ms"],
               "steps_after": len(mine),
               "steps_in_flight": sum(st["busy"] for st in mine),
               "excess_ms": excess,
               "loop_cost_ms": rec["save_stall_ms"] + sum(excess.values())}
        if mine:
            w1 = mine[-1]["t1"]
            overlap = {}
            for label, _, a0, a1 in writer:
                overlap[label] = overlap.get(label, 0.0) + _overlap_ms(
                    s1, w1, a0, a1)
            row["window_ms"] = ms(s1, w1)
            row["writer_overlap_ms"] = overlap
        per_save.append(row)
    writes = sum(label == "write" for label, *_ in stages)
    total = sum(r["loop_cost_ms"] for r in per_save) + drain.get("ms", 0.0)
    stage_ms = {}
    for label, thread, a0, a1 in stages:
        where = "writer" if thread == "ckpt-writer" else "loop"
        stage_ms.setdefault(f"{where}.{label}", []).append(
            round((a1 - a0) * 1e3, 3))
    return {"save_stall_ms": stalls, "save_stall_ms_median": median(stalls),
            "ms_per_step_write_in_flight": median(with_write),
            "ms_per_step_no_write": median(without),
            "quiet_step_medians_ms": base,
            "steps_write_in_flight": len(with_write),
            "steps_no_write": len(without),
            # [in flight, ms, issue ms, gap ms before it]
            "step_ms": [[int(st["busy"]), round(st["ms"], 3),
                         round(st["issue"], 3),
                         None if st["gap"] is None else round(st["gap"], 3)]
                        for st in steps],
            "per_save": per_save,
            # latest wins: a save queued behind a running write can be
            # replaced, so the run's cost is set against the writes made
            "loop_cost_total_ms": total, "writes": writes,
            "loop_cost_per_write_ms": total / writes if writes else None,
            "stage_ms": stage_ms,
            "final_drain_ms": drain.get("ms"),
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if DEVICE.startswith("cuda") else None),
            "pinned_host_peak": _pinned_host_peak(),
            "run_s": run_s, "final_step": summary["final_step"],
            "params_digest": summary["params_digest"]}


def _race_probe(trainer, tmp: str) -> dict:
    """Snapshot a copy of the trained state, then at once add 1.0 in
    place to every param on the compute stream; the writer's artifact
    must hold the values from before the add."""
    from distributedmnist_tpu_torch.models.convert import params_to_reference
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    from distributedmnist_tpu_torch.train import loop
    state = _copy_state(trainer.state)
    before = ckpt.params_digest(params_to_reference(state.params))
    writer = ckpt.AsyncCheckpointer()
    snap = loop.device_snapshot(state)
    for p in tree_leaves(state.params):
        p.add_(1.0)
    writer.save(f"{tmp}/race_probe", snap, state.step, keep=0,
                prepare=loop.snapshot_to_host)
    del snap
    writer.close()
    written, _ = ckpt.checkpoint_params_digest(f"{tmp}/race_probe")
    after = ckpt.params_digest(params_to_reference(state.params))
    return {"digest_before_add": before, "digest_written": written,
            "digest_after_add": after}


def _durability(tmp: str) -> dict:
    """``bench.py bench_checkpoint_durability``'s save (24 [256, 256]
    float32 arrays) under each policy: save wall medians over interleaved
    repeats, and the fsyncs each save makes."""
    import numpy as np

    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    from distributedmnist_tpu_torch.train import storage
    rng = np.random.default_rng(SEED)
    state = {"params": {f"layer{i}": rng.standard_normal(
                 (256, 256)).astype(np.float32) for i in range(12)},
             "momentum": {f"layer{i}": rng.standard_normal(
                 (256, 256)).astype(np.float32) for i in range(12)},
             "step": np.int32(0)}
    fsyncs = [0]
    real = os.fsync

    def counting_fsync(fd):
        fsyncs[0] += 1
        return real(fd)

    wall = {p: [] for p in DUR_POLICIES}
    per_save = {p: set() for p in DUR_POLICIES}
    step = 0
    os.fsync = counting_fsync
    try:
        for _ in range(DUR_REPEATS):
            for policy in DUR_POLICIES:
                storage.set_durability(policy)
                for _ in range(DUR_SAVES):
                    step += 1
                    n0, t0 = fsyncs[0], time.perf_counter()
                    ckpt.save_state(f"{tmp}/durability_{policy}", state,
                                    step, keep=5)
                    wall[policy].append((time.perf_counter() - t0) * 1e3)
                    per_save[policy].add(fsyncs[0] - n0)
    finally:
        os.fsync = real
        storage.set_durability("none")
    med = {p: statistics.median(v) for p, v in wall.items()}
    return {"state_bytes": 24 * 256 * 256 * 4,
            "save_wall_ms_median": med,
            "full_over_none": med["full"] / med["none"],
            "fsyncs_per_save": {p: sorted(v) for p, v in per_save.items()},
            "fsyncs_per_save_expected": FSYNCS_PER_SAVE}


def _cnn_arm_digests(tmp: str) -> dict:
    """The CNN (bitwise repeatable on the card) in the three arms: the
    params digest of every step each arm saved."""
    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    out = {}
    for arm, over in CKPT_ARMS.items():
        tr = _cnn_trainer(tmp, f"ckpt_cnn_{arm}", *over,
                          f"train.max_steps={CKPT_STEPS}",
                          f"train.save_interval_steps={CKPT_EVERY}",
                          "train.keep_checkpoints=0", device=DEVICE)
        tr.run()
        out[arm] = {s: ckpt.checkpoint_params_digest(tr.train_dir, s)[0]
                    for s in ckpt.loadable_steps(tr.train_dir)}
    return out


def phase_ckpt(tmp: str) -> dict:
    """Durable checkpoints on the training configuration: the three save
    arms, the race probe, the CNN's digests across arms, durability."""
    import gc

    import torch
    t_phase = time.time()
    arms, transformer_digests = {}, {}
    trainer = None
    for arm in CKPT_TIMED:
        over = CKPT_ARMS[arm]
        trainer = None
        gc.collect()
        trainer = _build_trainer(tmp, f"ckpt_{arm}", *over,
                                 f"train.max_steps={CKPT_STEPS}",
                                 f"train.save_interval_steps={CKPT_EVERY}",
                                 f"train.keep_checkpoints={CKPT_KEEP}")
        arms[arm] = _ckpt_run(trainer)
        check(arms[arm]["final_step"] == CKPT_STEPS,
              f"{arm}: ended at {arms[arm]['final_step']}")
        transformer_digests[arm] = arms[arm].pop("params_digest")
    # the snapshot arm's trainer stays: its state is its final checkpoint
    race = _race_probe(trainer, tmp)
    trainer_eval = trainer.evaluate("test")
    train_dir = str(trainer.train_dir)
    trainer = None
    gc.collect()
    if DEVICE.startswith("cuda"):
        torch.cuda.empty_cache()
    cnn = _cnn_arm_digests(tmp)
    durability = _durability(tmp)
    fetch_med = arms["host_fetch"]["save_stall_ms_median"]
    snap_med = arms["snapshot"]["save_stall_ms_median"]
    peak = {a: arms[a]["peak_mem_gb"] for a in arms}
    rec = {"phase": "ckpt", "steps": CKPT_STEPS, "save_every": CKPT_EVERY,
           "keep": CKPT_KEEP, "arms": arms,
           "snapshot_extra_device_gb": (
               peak["snapshot"] - peak["host_fetch"]
               if peak["host_fetch"] is not None else None),
           "stall_ratio_snapshot_over_host_fetch": snap_med / fetch_med,
           "stall_gate": CKPT_STALL_GATE, "race_probe": race,
           "transformer_final_digests": transformer_digests,
           "cnn_digests": cnn, "durability": durability,
           "trainer_eval": trainer_eval, "train_dir": train_dir,
           "seconds": time.time() - t_phase}
    emit(rec)
    check(snap_med <= CKPT_STALL_GATE * fetch_med,
          f"snapshot stall median {snap_med} ms > {CKPT_STALL_GATE} x the "
          f"host fetch's {fetch_med} ms")
    check(race["digest_written"] == race["digest_before_add"]
          != race["digest_after_add"],
          f"race probe: the writer saw the add ({race})")
    common = set.intersection(*(set(d) for d in cnn.values()))
    check(CKPT_STEPS in common, f"CNN arms saved steps "
                                f"{ {a: sorted(d) for a, d in cnn.items()} }")
    for s in sorted(set().union(*cnn.values())):
        got = {cnn[a][s] for a in cnn if s in cnn[a]}
        check(len(got) == 1, f"CNN step {s}: digests differ across arms")
    for policy, counts in durability["fsyncs_per_save"].items():
        check(counts == [FSYNCS_PER_SAVE[policy]],
              f"durability {policy}: {counts} fsyncs a save, expected "
              f"{FSYNCS_PER_SAVE[policy]}")
    return rec


EVAL_LINE = re.compile(r"^Num examples: (\d+) Precision @ 1: ([0-9.]+) "
                       r"Loss: ([0-9.]+) Time: ([0-9.]+)$")


def _colocated(tmp: str) -> dict:
    """``launch train`` on the quorum CNN config and ``launch eval
    --single_device`` following it, two processes on the same card."""
    from distributedmnist_tpu_torch.core.config import EvalConfig
    from distributedmnist_tpu_torch.evalsvc import Evaluator
    train_dir, eval_dir = f"{tmp}/coloc_train", f"{tmp}/coloc_eval"
    train = [sys.executable, "-m", "distributedmnist_tpu_torch.launch",
             "train", "--config", "configs/quorum_k4_of_8.json",
             "mesh.simulate_devices=8", "data.dataset=synthetic",
             "data.synthetic_train_size=4096",
             f"data.synthetic_test_size={COLOC_TEST}",
             f"train.max_steps={COLOC_STEPS}",
             f"train.save_interval_steps={COLOC_EVERY}",
             "train.keep_checkpoints=0",
             f"train.step_pace_ms={COLOC_PACE_MS}",
             "compile.precompile=false",
             f"train.train_dir={train_dir}", "--device", DEVICE]
    evaluate = [sys.executable, "-m", "distributedmnist_tpu_torch.launch",
                "eval", "--train_dir", train_dir, "--eval_dir", eval_dir,
                "--single_device", "--max_evals", str(COLOC_MAX_EVALS),
                "--eval_interval_secs", "0.2"]
    if DEVICE != "cuda":
        evaluate += ["--device", DEVICE]
    t0 = time.time()
    procs = {}
    logs = {name: open(f"{tmp}/coloc_{name}.err", "w")
            for name in ("train", "eval")}
    try:
        for name, cmd in (("train", train), ("eval", evaluate)):
            procs[name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=logs[name], text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                start_new_session=True)
        outs = {}
        outs["train"] = procs["train"].communicate(
            timeout=COLOC_TIMEOUT_S)[0]
        try:
            outs["eval"] = procs["eval"].communicate(
                timeout=COLOC_EVAL_GRACE_S)[0]
        except subprocess.TimeoutExpired:
            # fewer than max_evals new steps before the trainer ended
            os.killpg(procs["eval"].pid, signal.SIGKILL)
            outs["eval"] = procs["eval"].communicate()[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for f in logs.values():
            f.close()
    wall = time.time() - t0
    tails = {}
    for name in logs:
        with open(f"{tmp}/coloc_{name}.err") as f:
            tails[name] = f.read()[-2000:]
    check(procs["train"].returncode == 0,
          f"launch train exited {procs['train'].returncode}: "
          f"{tails['train']}")
    check(procs["eval"].returncode in (0, -signal.SIGKILL),
          f"launch eval exited {procs['eval'].returncode}: {tails['eval']}")
    printed = [x for x in outs["eval"].splitlines() if x.strip()]
    bad = [x for x in printed if not EVAL_LINE.match(x)]
    check(printed and not bad, f"eval printed {printed}")
    with open(f"{eval_dir}/eval_log.jsonl") as f:
        results = [json.loads(line) for line in f]
    steps = [r["step"] for r in results]
    check(len(results) == len(printed) and len(set(steps)) >= 2
          and steps == sorted(set(steps)),
          f"evaluated steps {steps} ({len(printed)} lines printed)")
    checker = Evaluator(train_dir, EvalConfig(eval_dir=f"{tmp}/coloc_check"),
                        single_device=True, device=DEVICE)
    agree = []
    for r in results:
        want = checker.evaluate_checkpoint(r["step"])
        agree.append({"step": r["step"],
                      "precision_at_1": r["precision_at_1"],
                      "loss": r["loss"],
                      "in_process_precision_at_1": want["precision_at_1"],
                      "in_process_loss": want["loss"],
                      "seconds": r["seconds"]})
    skips = []
    path = f"{eval_dir}/recovery_journal.jsonl"
    if os.path.exists(path):
        with open(path) as f:
            skips = [json.loads(line) for line in f]
    return {"steps_evaluated": steps, "lines": len(printed),
            "agreement": agree, "follow_skip": skips, "wall_s": wall,
            "eval_exit": procs["eval"].returncode,
            "train_summary": json.loads(
                outs["train"].strip().splitlines()[-1])["test"]}


def phase_eval(tmp: str, ckpt_rec: dict) -> dict:
    """The continuous evaluator: in process on the ``ckpt`` phase's
    transformer checkpoint (K1 on every layer of every batch), then
    co-located with a live CNN trainer on the same card."""
    from distributedmnist_tpu_torch.core.config import EvalConfig
    from distributedmnist_tpu_torch.evalsvc import Evaluator
    t_phase = time.time()
    batch = TRAIN["eval"]["eval_batch_size"]
    reset_counts()
    t0 = time.time()
    ev = Evaluator(ckpt_rec["train_dir"],
                   EvalConfig(eval_dir=f"{tmp}/eval_inproc",
                              eval_batch_size=batch), device=DEVICE)
    res = ev.evaluate_checkpoint()
    eval_s = time.time() - t0
    counts = read_counts()
    n_batches = -(-ev.datasets.test.num_examples // batch)
    want = ckpt_rec["trainer_eval"]
    coloc = _colocated(tmp)
    rec = {"phase": "eval", "step": res["step"],
           "num_examples": res["num_examples"],
           "precision_at_1": res["precision_at_1"], "loss": res["loss"],
           "trainer_precision_at_1": want["accuracy"],
           "trainer_loss": want["loss"], "loss_tol": EVAL_LOSS_TOL,
           "eval_batches": n_batches, "launches": counts,
           "k1_launches": counts["K1"], "eval_s": eval_s,
           "eval_step_s": res["seconds"], "colocated": coloc,
           "seconds": time.time() - t_phase}
    emit(rec)
    check(res["step"] == CKPT_STEPS, f"evaluated step {res['step']}")
    check(counts["K1"] == MODEL["num_layers"] * n_batches
          and all(counts[k] == 0 for k in counts if k != "K1"),
          f"launches {counts} for {n_batches} eval batches")
    check(res["precision_at_1"] == want["accuracy"]
          and abs(res["loss"] - want["loss"]) <= EVAL_LOSS_TOL,
          f"evaluator {res} against the Trainer's evaluate {want}")
    for a in coloc["agreement"]:
        check(a["precision_at_1"] == a["in_process_precision_at_1"]
              and abs(a["loss"] - a["in_process_loss"])
              <= COLOC_LOSS_RTOL * abs(a["in_process_loss"]),
              f"co-located eval of step {a['step']}: {a}")
    return rec


# -- the campaign -----------------------------------------------------------

# the keys of a campaign record as sweep_results.jsonl holds it: the
# reference's run_experiment record (distributedmnist_tpu/launch/
# sweep.py), run_group's two, and the sink's time stamp
CAMPAIGN_RECORD_KEYS = frozenset({
    "name", "mode", "num_replicas", "aggregate_k", "interval_ms",
    "straggler_profile", "steps", "updates_applied", "wall_seconds",
    "examples_per_sec", "final_loss", "final_train_acc", "test_accuracy",
    "test_loss", "timing", "overrides", "group", "ts"})


def _campaign_records(results, group: str) -> list:
    with open(results / group / "sweep_results.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_campaign(tmp: str) -> dict:
    """``launch campaign`` on the card, in process: ``repro_mnist99``
    with the ``launch eval`` child live on ``cuda:0``, then ``extras
    --quick`` with the counters set to 0 before and read after, then
    ``--finalize-only`` twice."""
    import shutil
    from pathlib import Path

    from distributedmnist_tpu_torch.launch import campaign
    t_phase = time.time()
    cfgs, results = Path(tmp) / "campaign_cfgs", Path(tmp) / "campaign"
    shutil.copytree("configs", cfgs)
    steps = json.loads((cfgs / "repro" / "mnist_99.json").read_text()
                       )["train"]["max_steps"]
    # the report and resnet phases wrote mnist and cifar10 under tmp
    common = ["--configs", str(cfgs), "--results", str(results),
              "--data-cache", tmp]
    stops = []
    stop = campaign.stop_evaluator

    def recording_stop(proc, run_dir, bound_s=None):
        stops.append(stop(proc, run_dir, bound_s))
        return stops[-1]

    campaign.stop_evaluator = recording_stop
    groups_s = {}
    try:
        t0 = time.time()
        reset_counts()
        _launch_verb(["campaign", "--groups", "repro_mnist99", *common])
        repro_counts = read_counts()
        groups_s["repro_mnist99"] = time.time() - t0
    finally:
        campaign.stop_evaluator = stop
    t0 = time.time()
    reset_counts()
    _launch_verb(["campaign", "--groups", "extras", "--quick", *common])
    extras_counts = read_counts()
    groups_s["extras"] = time.time() - t0
    summaries = []
    for _ in range(2):
        _launch_verb(["campaign", "--finalize-only", "--results",
                      str(results)])
        summaries.append((results / "campaign_summary.json").read_bytes())
    left = sorted(str(p.relative_to(results)) for pattern in
                  ("ckpt-*.msgpack", "CHECKPOINT")
                  for p in results.rglob(pattern))
    rec99, = _campaign_records(results, "repro_mnist99")
    extras = _campaign_records(results, "extras")
    run = results / "repro_mnist99" / "mnist_99"
    with open(run / "eval" / "eval_log.jsonl") as f:
        evals = [json.loads(line) for line in f if line.strip()]
    final = [e for e in evals if e.get("step") == rec99["steps"]]
    summary = json.loads(summaries[0])
    numbers = ("final_loss", "test_accuracy", "test_loss",
               "examples_per_sec")
    rec = {"phase": "campaign", "groups_s": groups_s,
           "repro_mnist99": {k: rec99[k] for k in (
               "num_replicas", "steps", "updates_applied", "wall_seconds",
               "examples_per_sec", "final_loss", "test_accuracy",
               "overrides")},
           "evaluated_steps": [e["step"] for e in evals],
           "final_eval": final[-1] if final else None,
           "stop_evaluator": stops,
           "extras": [{k: r[k] for k in ("name", "num_replicas", "steps",
                                         "wall_seconds", *numbers)}
                      for r in extras],
           "launches_repro": repro_counts, "launches_extras": extras_counts,
           "summary_groups": sorted(summary["groups"]),
           "finalize_same_bytes": summaries[0] == summaries[1],
           "checkpoints_left": left, "seconds": time.time() - t_phase}
    emit(rec)
    check(rec99["num_replicas"] == REPLICAS
          and rec99["steps"] == steps,
          f"mnist_99 record {rec['repro_mnist99']}")
    for r in [rec99, *extras]:
        check(set(r) == CAMPAIGN_RECORD_KEYS,
              f"{r['name']}: record keys {sorted(set(r))}")
    check(bool(final) and final[-1]["precision_at_1"]
          == rec99["test_accuracy"],
          f"the evaluator's final step {final} against the record's "
          f"test_accuracy {rec99['test_accuracy']}")
    check(len(stops) == 1 and stops[0]["ended_by"] == "evaluated"
          and stops[0]["step"] == rec99["steps"],
          f"stop_evaluator {stops}")
    check([r["name"] for r in extras] == campaign.GROUPS["extras"]
          and all(r["steps"] == 20 and all(math.isfinite(r[k])
                                           for k in numbers)
                  for r in extras), f"extras {rec['extras']}")
    check(not any(repro_counts.values()), f"mnist_99 launched "
                                          f"{repro_counts}")
    check(all(extras_counts[k] > 0 for k in ("K1", "K1-lse", "K2", "K3"))
          and extras_counts["K4"] == extras_counts["K5"] == 0,
          f"extras launches {extras_counts}")
    check(rec["summary_groups"] == ["extras", "repro_mnist99"]
          and rec["finalize_same_bytes"] and not left,
          f"finalize: groups {rec['summary_groups']}, same bytes "
          f"{rec['finalize_same_bytes']}, left {left}")
    return rec


# -- phase 11 ---------------------------------------------------------------

# the serving tier (bench.py bench_serving_latency and
# bench_quantized_serving): the MNIST CNN at its published widths, float32
# compute, 60 steps with a save every 10 and the int8 and bf16 sidecars
SERVE_CNN = {"name": "chip_smoke_serve",
             "data": {"dataset": "synthetic", "batch_size": 32,
                      "synthetic_train_size": 2048,
                      "synthetic_test_size": 1000,
                      "use_native_pipeline": False},
             "model": {"name": "mnist_cnn", "compute_dtype": "float32"},
             "mesh": {"num_replicas": 1},
             "quant": {"publish_tiers": "int8,bf16",
                       "calibration_examples": 128},
             "train": {"max_steps": 60, "log_every_steps": 20,
                       "save_interval_steps": 10, "save_results_period": 0,
                       "summary_every_steps": 0, "keep_checkpoints": 0,
                       "seed": SEED},
             # the eager step, as every phase before graphs: the
             # asynchronous writer keeps only the latest of the saves
             # queued behind a write, so a faster step publishes fewer
             "compile": {"precompile": False}}
SERVE_POLL_S, SERVE_CONC, SERVE_REQS, SERVE_DEADLINE_S = 0.1, 4, 200, 5.0
SERVE_PUBLISH_EVERY_S = 0.3
# the reference's gate (bench_serving_latency): p99 across swaps at most
# max(5 x, + 250 ms) of the steady sweep's
SERVE_P99_FACTOR, SERVE_P99_SLACK_MS = 5.0, 250.0
# bench_quantized_serving: int8 resident weight bytes at most 0.35 x
# fp32; top-1 agreement of each tier with fp32 at least 1 - 0.02 on the
# test split; 2 interleaved sweep pairs of 120 requests a tier
TIER_BYTES_GATE, TIER_AGREEMENT_GATE = 0.35, 0.98
TIER_REQS, TIER_PAIRS = 120, 2
# the replica on the card against the port's CPU forward of the same
# checkpoint, float32 with TF32 off: the two sum in other orders (~1e-6
# of logits up to ~20, through a softmax) and the replica rounds its wire
# probabilities to 6 decimals
SERVE_CARD_VS_CPU_TOL = 1e-4
# decode swaps: 8 clients generating 64 greedy tokens a request back to
# back while the ckpt phase's newest step follows the one it kept before
SWAP_NEW_TOKENS, SWAP_TIMEOUT_S = 64, 300
# one-shot LM predict through the classification replica, kernels vs
# plain, bf16, each served answer against the plain softmax of its
# prompt: log-probabilities differ by the logits' difference and the
# log-sum-exp's, each within E2E_LOGIT_TOL, so |dp| <= p (e^0.2 - 1);
# the wire rounds each probability to 6 decimals (5e-7)
LM_PREDICT_PROB_REL = math.expm1(2 * E2E_LOGIT_TOL)
LM_PREDICT_PROB_ABS = 5e-7


def _publish(src: str, dst: str, step: int, sidecar: bool = False,
             tear_sidecar: bool = False) -> None:
    """Publish a staged step in the trainer's write order: the quant
    sidecar (torn after the copy when asked: its digest kept), the
    artifact and its digest, then the pointer."""
    import shutil
    os.makedirs(dst, exist_ok=True)
    names = ([f"ckpt-{step:08d}.quant.msgpack"] if sidecar else []) + \
        [f"ckpt-{step:08d}.msgpack"]
    for name in names:
        for sfx in ("", ".sha256"):
            shutil.copy2(os.path.join(src, name + sfx),
                         os.path.join(dst, name + sfx))
    if tear_sidecar:
        path = os.path.join(dst, names[0])
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
    tmp = os.path.join(dst, "checkpoint.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"latest_step": step, "latest_path": names[-1],
                   "written_at": time.time()}, f)
    os.replace(tmp, os.path.join(dst, "checkpoint.json"))


def _serve_records(serve_dir: str) -> list:
    with open(os.path.join(serve_dir, "serve_log.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _warm_buckets(rep) -> None:
    """The untimed sweep: every power-of-2 bucket up to serve.max_batch
    once through the replica's predict (cuDNN's first call at a shape
    takes ~1 s), then synchronize."""
    import numpy as np
    import torch
    b = 1
    while b <= rep.scfg.max_batch:
        rep._predict(rep._params, np.zeros((b, *rep.model.input_shape),
                                           np.dtype(rep.model.input_dtype)))
        b *= 2
    torch.cuda.synchronize()


class _Sweep:
    """A ServeClient for one sweep: request ids carry the sweep's tag
    (``run_load`` numbers every sweep from 0, and a repeated id is a
    dedup hit, answered from the replica's cache), and each ok answer's
    inputs, step and probabilities are kept for the card-against-CPU
    check of every served step."""

    def __init__(self, client, tag: str):
        self.client, self.tag, self.answers = client, tag, []
        self._lock = threading.Lock()

    def request(self, inputs, request_id=None, deadline_s=None):
        out = self.client.request(inputs,
                                  request_id=f"{self.tag}-{request_id}",
                                  deadline_s=deadline_s)
        if out.get("status") == "ok":
            with self._lock:
                self.answers.append((inputs, out["model_step"],
                                     out["probs"]))
        return out


class _GcPauses:
    """The interpreter's generation-2 collections inside a ``with``
    block: how many, and each one's milliseconds (the host pauses every
    thread of the process, the replica's too)."""

    def __enter__(self):
        import gc
        self.ms, self._t0 = [], None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms.append((time.perf_counter() - self._t0) * 1e3)

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._note)


def _cpu_probs(publish: str, step: int, images) -> "np.ndarray":
    """The port's CPU forward of ``step``'s checkpoint: probabilities."""
    from distributedmnist_tpu_torch.models.convert import \
        params_from_reference
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.core.config import ExperimentConfig
    from distributedmnist_tpu_torch.quant.ptq import build_tier_predict
    from distributedmnist_tpu_torch.train.checkpoint import restore_params
    tree, extra, _ = restore_params(publish, step)
    model = get_model(ExperimentConfig.from_dict(extra["config"]).model)
    params = params_from_reference(tree, device="cpu")
    return build_tier_predict(model, "fp32", "cpu")(params, images).numpy()


def _serve_cnn(tmp: str) -> dict:
    """Publish the CNN with its tiers, then the steady and swap sweeps,
    the card against the CPU, the tiers and the torn sidecar."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.launch.__main__ import build_replica
    from distributedmnist_tpu_torch.quant.ptq import (parity_report,
                                                      tier_param_bytes)
    from distributedmnist_tpu_torch.servesvc import ServeClient
    from distributedmnist_tpu_torch.servesvc.loadgen import (make_input_fn,
                                                             run_load)
    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    root = f"{tmp}/serve_cnn"
    os.makedirs(root, exist_ok=True)
    cudnn = torch.backends.cudnn
    flags_before = (cudnn.deterministic, cudnn.allow_tf32)
    path = f"{root}/config.json"
    with open(path, "w") as f:
        json.dump(SERVE_CNN, f)
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    t0 = time.time()
    trainer = build_trainer(["train", "--config", path,
                             f"train.train_dir={root}/staging",
                             "--device", DEVICE])
    trainer.run()
    train_s = time.time() - t0
    staging = str(trainer.train_dir)
    steps = ckpt.loadable_steps(staging)
    check(steps == list(range(10, 61, 10)), f"staged steps {steps}")
    sidecars = {}
    for s in steps:
        meta = ckpt.read_quant_sidecar(staging, s)["meta"]
        digest, _ = ckpt.checkpoint_params_digest(staging, s)
        check(meta["source_params_digest"] == digest,
              f"step {s}: the sidecar's source digest is not the "
              "artifact's")
        sidecars[s] = {"tiers": meta["tiers"],
                       "publish_ms": meta["publish_ms"],
                       "agreement": {t: meta["calibration"][t]["agreement"]
                                     for t in ("int8", "bf16")}}
    check(trainer._quant_publisher.device.type == DEVICE,
          "calibration ran off the card")
    test = trainer.datasets.test
    trainer = None

    publish = f"{root}/publish"
    _publish(staging, publish, steps[0], sidecar=True)
    replicas: list = []  # every replica booted, stopped on every exit

    def boot(tier: str, src: str = publish):
        rep = build_replica(["serve", "--train-dir", src, "--serve-dir",
                             f"{root}/replica_{len(replicas)}_{tier}",
                             "--device", DEVICE, "--poll-secs",
                             str(SERVE_POLL_S), "--precision-tier", tier])
        replicas.append(rep)
        rep.start()
        return rep, ServeClient([("127.0.0.1", rep.bound_port)],
                                deadline_s=SERVE_DEADLINE_S)

    try:
        rep, client = boot("fp32")
        check(rep.device.type == DEVICE, f"replica on {rep.device}")
        make_input = make_input_fn(list(rep.model.input_shape),
                                   str(np.dtype(rep.model.input_dtype)))
        _warm_buckets(rep)
        run_load(_Sweep(client, "warm"), 8 * SERVE_CONC, SERVE_CONC,
                 make_input)
        rep.batch_sizes.clear()
        with _GcPauses() as gc_steady:
            steady = run_load(_Sweep(client, "steady"), SERVE_REQS,
                              SERVE_CONC, make_input,
                              journal_path=f"{root}/loadgen_steady.jsonl")
        steady_batches = dict(sorted(rep.batch_sizes.items()))
        rep.batch_sizes.clear()
        stop_pub = threading.Event()

        def publisher():
            # the first publish as the sweep starts, then every 300 ms:
            # the sweep may take well under a second on the card
            for s in steps[1:]:
                _publish(staging, publish, s, sidecar=True)
                if stop_pub.wait(SERVE_PUBLISH_EVERY_S):
                    return

        recorder = _Sweep(client, "swap")
        swaps0 = rep.swaps
        pub = threading.Thread(target=publisher, daemon=True)
        pub.start()
        with _GcPauses() as gc_swap:
            swap = run_load(recorder, SERVE_REQS, SERVE_CONC, make_input,
                            journal_path=f"{root}/loadgen_swap.jsonl")
        stop_pub.set()
        pub.join(timeout=30)
        swap_batches = dict(sorted(rep.batch_sizes.items()))
        swaps = rep.swaps - swaps0
        # the newest step, for the tiers below
        _publish(staging, publish, steps[-1], sidecar=True)
        deadline = time.time() + 60
        while rep.model_step < steps[-1] and time.time() < deadline:
            time.sleep(0.02)
        # every served step's answers against that step's CPU forward
        by_step: dict = {}
        for inputs, s, probs in recorder.answers:
            by_step.setdefault(s, []).append((inputs, probs))
        swap_err = 0.0
        for s, got in by_step.items():
            x = np.asarray([g[0] for g in got], np.float32)
            want = _cpu_probs(publish, s, x)
            swap_err = max(swap_err, float(np.abs(
                np.asarray([g[1] for g in got]) - want).max()))
        # 64 fixed images on the replica's step, card against CPU
        x64 = test.images[:64]
        card = rep._predict(rep._params, x64).cpu().numpy()
        card_err = float(np.abs(card - _cpu_probs(
            publish, rep.model_step, x64)).max())
        recs = _serve_records(str(rep.serve_dir))
        swap_ms = [r["swap_ms"] for r in recs
                   if r["action"] == "weight_swap" and not r.get("initial")]
        # the replica's own admit-to-respond latency, beside the client's
        server_ms = {}
        for tag in ("steady", "swap"):
            lat = sorted(r["latency_ms"] for r in recs
                         if r["action"] == "respond"
                         and str(r["id"]).startswith(f"{tag}-"))
            server_ms[tag] = {"p50": lat[len(lat) // 2],
                              "p99": lat[int(0.99 * (len(lat) - 1))]}
        # the tiers, on the newest step
        tier_reps, tier_clients = {"fp32": rep}, {"fp32": client}
        for tier in ("int8", "bf16"):
            trep, tier_clients[tier] = boot(tier)
            tier_reps[tier] = trep
            check(trep.model_tier == tier and trep.model_step == steps[-1],
                  f"{tier} replica installed {trep.model_tier} at step "
                  f"{trep.model_step}")
            _warm_buckets(trep)
            run_load(_Sweep(tier_clients[tier], "warm"), 8 * SERVE_CONC,
                     SERVE_CONC, make_input)
        resident = {t: tier_param_bytes(r._params)
                    for t, r in tier_reps.items()}
        probs = {t: r._predict(r._params, test.images).cpu().numpy()
                 for t, r in tier_reps.items()}
        parity = {t: parity_report(probs["fp32"], probs[t], test.labels)
                  for t in ("int8", "bf16")}
        sweeps = {t: [] for t in tier_clients}
        for i in range(TIER_PAIRS):
            for t, c in tier_clients.items():
                sweeps[t].append(run_load(_Sweep(c, f"pair{i}"), TIER_REQS,
                                          SERVE_CONC, make_input))
        tiers = {t: {"rps": statistics.median(s["throughput_rps"]
                                               for s in v),
                     "p99_ms": statistics.median(s["latency_ms"]["p99"]
                                                 for s in v),
                     "p50_ms": statistics.median(s["latency_ms"]["p50"]
                                                 for s in v),
                     "tiers_served": sorted({x for s in v
                                             for x in s["tiers_served"]}),
                     "dropped_or_errors": sum(s["dropped"] + s["errors"]
                                              for s in v)}
                 for t, v in sweeps.items()}
        for r in tier_reps.values():
            r.stop()
        # a torn int8 sidecar: that step serves fp32, the next int8
        torn_pub = f"{root}/publish_torn"
        _publish(staging, torn_pub, steps[-2], sidecar=True,
                 tear_sidecar=True)
        trep, tclient = boot("int8", torn_pub)
        torn_first = tclient.request(make_input(0), request_id="torn-0")
        time.sleep(5 * SERVE_POLL_S)  # several polls at the torn step
        _publish(staging, torn_pub, steps[-1], sidecar=True)
        deadline = time.time() + 60
        while trep.model_step < steps[-1] and time.time() < deadline:
            time.sleep(0.05)
        torn_next = tclient.request(make_input(1), request_id="torn-1")
        trep.stop()
        torn_recs = _serve_records(str(trep.serve_dir))
    finally:
        for r in replicas:
            r.stop()  # a second stop is a no-op
    fallbacks = [r for r in torn_recs
                 if r["action"] == "follow_quant_sidecar_fallback"]
    torn = {"fallbacks": [(r["step"], r["reason"].split(":")[0])
                          for r in fallbacks],
            "first": (torn_first.get("model_step"), torn_first.get("tier")),
            "next": (torn_next.get("model_step"), torn_next.get("tier"))}
    p99_steady = steady["latency_ms"]["p99"]
    p99_bound = max(SERVE_P99_FACTOR * p99_steady,
                    p99_steady + SERVE_P99_SLACK_MS)
    bytes_ratio = resident["int8"] / resident["fp32"]
    rec = {"train_s": train_s, "staged_steps": steps,
           "sidecars": sidecars,
           "steady": {k: steady[k] for k in ("latency_ms", "throughput_rps",
                                             "dropped", "errors",
                                             "model_steps_served")},
           "swap": {k: swap[k] for k in ("latency_ms", "throughput_rps",
                                         "dropped", "errors",
                                         "model_steps_served")},
           "batch_sizes_steady": steady_batches,
           "batch_sizes_swap": swap_batches, "swaps": swaps,
           "swap_ms": swap_ms, "p99_bound_ms": p99_bound,
           "server_latency_ms": server_ms,
           "gc_gen2_pauses_ms": {"steady": gc_steady.ms,
                                 "swap": gc_swap.ms},
           "swap_answers_vs_cpu_max_abs": swap_err,
           "card_vs_cpu_max_abs": card_err,
           "card_vs_cpu_tol": SERVE_CARD_VS_CPU_TOL,
           "resident_weight_bytes": resident,
           "int8_bytes_ratio": bytes_ratio, "parity": parity,
           "tiers": tiers,
           "reference_accelerator_gate_int8_ge_fp32": (
               tiers["int8"]["rps"] >= tiers["fp32"]["rps"]
               and tiers["int8"]["p99_ms"] <= tiers["fp32"]["p99_ms"]),
           "torn_sidecar": torn,
           "cudnn_flags_before_after": [flags_before, (
               cudnn.deterministic, cudnn.allow_tf32)]}
    emit({"phase": "serve", "part": "cnn", **rec})
    for name, sweep in (("steady", steady), ("swap", swap)):
        check(sweep["dropped"] == 0 and sweep["errors"] == 0
              and sweep["responses"] == SERVE_REQS,
              f"{name} sweep: {sweep}")
    check(len(swap["model_steps_served"]) >= 2 and swaps >= 1,
          f"the swap sweep served steps {swap['model_steps_served']} "
          f"({swaps} swaps)")
    check(swap["latency_ms"]["p99"] <= p99_bound,
          f"swap p99 {swap['latency_ms']['p99']} ms > {p99_bound} ms")
    check(swap_err <= SERVE_CARD_VS_CPU_TOL and card_err
          <= SERVE_CARD_VS_CPU_TOL,
          f"card against CPU: {swap_err} (served answers), {card_err} "
          f"(64 images) > {SERVE_CARD_VS_CPU_TOL}")
    check(bytes_ratio <= TIER_BYTES_GATE,
          f"int8 resident bytes {bytes_ratio} x fp32 > {TIER_BYTES_GATE}")
    for t in ("int8", "bf16"):
        check(parity[t]["agreement"] >= TIER_AGREEMENT_GATE,
              f"{t} top-1 agreement {parity[t]['agreement']}")
        check(tiers[t]["tiers_served"] == [t]
              and tiers[t]["dropped_or_errors"] == 0,
              f"{t} sweeps: {tiers[t]}")
    check(flags_before == (cudnn.deterministic, cudnn.allow_tf32),
          "cuDNN's process-wide settings changed")
    check(torn["fallbacks"] == [(steps[-2], "CheckpointCorruptError")]
          and torn["first"] == (steps[-2], "fp32")
          and torn["next"] == (steps[-1], "int8"),
          f"torn sidecar: {torn}")
    return rec


def _swap_journal_ok(recs: list, policy: str) -> str | None:
    """The decode_swap invariant, replayed here: under pin no sequence
    changes step; every seq_restart follows a weight_swap to its step,
    and a sequence that changed step holds one."""
    swapped_to, licensed = set(), {}
    for r in recs:
        if r["action"] == "weight_swap":
            swapped_to.add(r["step"])
        elif r["action"] == "seq_restart":
            if r["to_step"] not in swapped_to:
                return f"seq_restart before its weight_swap: {r}"
            licensed[r["id"]] = r["to_step"]
        elif r["action"] == "decode_finish":
            if r["model_step"] != r["started_step"]:
                if policy == "pin":
                    return f"pinned sequence changed step: {r}"
                if licensed.get(r["id"]) != r["model_step"]:
                    return f"unlicensed step change: {r}"
    return None


def _decode_swap(tmp: str, ckpt_dir: str, policy: str) -> dict:
    """8 clients generating 64-token greedy requests back to back while
    the ckpt phase's newest step is published behind its older kept one:
    the follower restores it, the loop swaps under ``policy``
    mid-generation."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.launch.__main__ import build_replica
    from distributedmnist_tpu_torch.models import transformer
    from distributedmnist_tpu_torch.servesvc import ServeClient
    root = f"{tmp}/serve_decode_{policy}"
    old, new = ckpt_dir_steps(ckpt_dir)
    _publish(ckpt_dir, f"{root}/publish", old)
    rep = build_replica(["serve", "--decode", "--train-dir",
                         f"{root}/publish", "--serve-dir", f"{root}/replica",
                         "--device", DEVICE, "--swap-policy", policy,
                         "--poll-secs", str(SERVE_POLL_S)])
    rep.start()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, MODEL["vocab_size"], p).tolist()
               for p, _ in REQUESTS]
    captured: dict = {}
    try:
        _drive(rep.bound_port, [(p, m) for p, (_, m) in
                                zip(prompts, REQUESTS)], f"{policy}-warm")
        real = rep.model.decode_step

        def compared(params, tokens, positions, k, v, tables, lengths,
                     **kw):
            """The first decode step while an older version is pinned
            and some slot is masked (another version's, or idle: null
            table, length 0), also through the plain paged attention on
            copies of the caches (the plain run launches no kernel)."""
            if ("max_abs" in captured or not rep._versions
                    or not bool((lengths == 0).any())):
                return real(params, tokens, positions, k, v, tables,
                            lengths, **kw)
            k5 = transformer.paged_attention
            try:
                live = lengths > 0
                # the peak before the comparison's own copies; the stats
                # restart after them, so peak_mem_gb is pin's alone
                torch.cuda.synchronize()
                captured["peak_before_compare_gb"] = (
                    torch.cuda.max_memory_allocated() / 1e9)
                kc, vc = k.clone(), v.clone()
                nonzero = []

                def watched(q, *a, **kw5):
                    o = k5(q, *a, **kw5)
                    nonzero.append(int(torch.count_nonzero(o[~live])))
                    return o
                transformer.paged_attention = watched
                try:
                    out = real(params, tokens, positions, k, v, tables,
                               lengths, **kw)
                finally:
                    transformer.paged_attention = k5
                plain, _, _ = real(params, tokens, positions, kc, vc,
                                   tables, lengths,
                                   block_size=kw["block_size"],
                                   attention_kernel="dense")
                captured["max_abs"] = float((out[0][live]
                                             - plain[live]).abs().max())
                captured["live_slots"] = int(live.sum())
                captured["masked_slots"] = int((~live).sum())
                captured["masked_rows_equal_plain"] = bool(
                    (out[0][~live] == plain[~live]).all())
                captured["masked_k5_nonzero"] = nonzero
                del kc, vc, plain
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            except Exception as e:  # fail the phase, not the loop
                captured["error"] = f"{type(e).__name__}: {e}"
                captured.setdefault("max_abs", math.inf)
                transformer.paged_attention = k5
                # the step again: it rewrites the same K/V entries
                return real(params, tokens, positions, k, v, tables,
                            lengths, **kw)
            return out

        rep.model = dataclasses.replace(rep.model, decode_step=compared)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = (rep.prefills, rep.restarts, rep.version_steps,
                  rep.decode_iterations, rep.swaps)
        streamed = [threading.Event() for _ in prompts]
        stop = threading.Event()
        outs: list = [[] for _ in prompts]

        def client_loop(i):
            c = ServeClient([("127.0.0.1", rep.bound_port)],
                            deadline_s=SWAP_TIMEOUT_S)
            j = 0
            while not stop.is_set():
                outs[i].append(c.generate(
                    prompts[i], request_id=f"{policy}-{i}-{j}",
                    max_tokens=SWAP_NEW_TOKENS,
                    on_token=lambda rec: streamed[i].set()))
                j += 1

        reset_counts()
        t0 = time.time()
        threads = [threading.Thread(target=client_loop, args=(i,),
                                    daemon=True) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for e in streamed:
            e.wait(timeout=SWAP_TIMEOUT_S)
        _publish(ckpt_dir, f"{root}/publish", new)
        deadline = t0 + SWAP_TIMEOUT_S
        # every client ends one request that started on the new step
        while time.time() < deadline and not all(
                any(o.get("started_step") == new for o in outs[i])
                for i in range(len(prompts))):
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=SWAP_TIMEOUT_S)
        wall = time.time() - t0
        counts = read_counts()
        peak_gb = max(torch.cuda.max_memory_allocated() / 1e9,
                      captured.get("peak_before_compare_gb", 0.0))
        after = (rep.prefills, rep.restarts, rep.version_steps,
                 rep.decode_iterations, rep.swaps)
    finally:
        rep.stop()
    prefills, restarts, version_steps, iters, swaps = (
        a - b for a, b in zip(after, before))
    recs = _serve_records(f"{root}/replica")
    swap_rec = next((r for r in recs if r["action"] == "weight_swap"
                     and r["step"] == new), None)
    restart_recs = [r for r in recs if r["action"] == "seq_restart"]
    done = [o for os_ in outs for o in os_]
    layers = MODEL["num_layers"]
    rec = {"policy": policy, "from_step": old, "to_step": new,
           "requests": len(done), "ok": sum(o.get("status") == "ok"
                                            for o in done),
           "swaps": swaps, "swap_record": swap_rec,
           "seq_restarts": len(restart_recs), "prefills": prefills,
           "restarts": restarts, "decode_iterations": iters,
           "version_steps": version_steps, "launches": counts,
           "k1_launches": counts["K1"], "k5_launches": counts["K5"],
           "wall_s": wall, "peak_mem_gb": peak_gb,
           "pinned_step_vs_plain": captured or None}
    emit({"phase": "serve", "part": f"decode_{policy}", **rec})
    check(all(t is not None and not t.is_alive() for t in threads),
          "a client never finished")
    check(all(o.get("status") == "ok" and len(o["tokens"])
              == SWAP_NEW_TOKENS for o in done),
          f"{policy}: a request did not end ok with {SWAP_NEW_TOKENS} "
          f"tokens: {[o for o in done if o.get('status') != 'ok'][:2]}")
    check(swaps == 1 and swap_rec is not None,
          f"{policy}: {swaps} swaps to step {new}")
    bad = _swap_journal_ok(recs, policy)
    check(bad is None, f"{policy}: {bad}")
    check(counts["K1"] == layers * (prefills + restarts)
          and counts["K5"] == layers * version_steps
          and counts["K1-lse"] == counts["K2"] == counts["K3"]
          == counts["K4"] == 0,
          f"{policy}: launches {counts} for {prefills} prefills, "
          f"{restarts} restarts, {version_steps} version steps")
    if policy == "pin":
        check(swap_rec["sequences_pinned"] >= 1
              and swap_rec["sequences_restarted"] == 0 and not restart_recs,
              f"pin: swap record {swap_rec}, {len(restart_recs)} restarts")
        check(all(o["model_step"] == o["started_step"] for o in done),
              "pin: a sequence finished on another step")
        check(version_steps > iters, "pin: never two live versions")
        check(captured.get("max_abs", math.inf) <= E2E_LOGIT_TOL
              and "error" not in captured
              and captured["masked_rows_equal_plain"]
              and len(captured["masked_k5_nonzero"]) == layers
              and not any(captured["masked_k5_nonzero"]),
              f"pinned step against plain: {captured}")
    else:
        check(swap_rec["sequences_restarted"] >= 1
              and swap_rec["sequences_restarted"] == len(restart_recs)
              == restarts
              and all(r["from_step"] == old and r["to_step"] == new
                      for r in restart_recs),
              f"restart: swap record {swap_rec}, {len(restart_recs)} "
              f"seq_restart records, {restarts} re-prefills")
    return rec


def ckpt_dir_steps(ckpt_dir: str) -> tuple[int, int]:
    """The two newest steps of the ckpt phase's run (keep 2)."""
    from distributedmnist_tpu_torch.train.checkpoint import loadable_steps
    steps = loadable_steps(ckpt_dir)
    check(len(steps) >= 2, f"the ckpt phase kept steps {steps}")
    return steps[-2], steps[-1]


def _lm_one_shot(tmp: str, ckpt_dir: str) -> dict:
    """4 one-shot requests of a full 1024-token context through the
    classification replica (the transformer's next-token distribution,
    K1 on every layer), each answer then held against the plain path's
    softmax for its prompt at batch 1."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.launch.__main__ import build_replica
    from distributedmnist_tpu_torch.models import transformer
    from distributedmnist_tpu_torch.ops.flash_attention import \
        flash_attention_bshd_plain
    from distributedmnist_tpu_torch.servesvc import ServeClient
    root = f"{tmp}/serve_lm"
    _, step = ckpt_dir_steps(ckpt_dir)
    _publish(ckpt_dir, f"{root}/publish", step)
    rep = build_replica(["serve", "--train-dir", f"{root}/publish",
                         "--serve-dir", f"{root}/replica", "--device",
                         DEVICE])
    rep.start()
    rng = np.random.default_rng(SEED + 1)
    toks = rng.integers(0, MODEL["vocab_size"],
                        (4, MODEL["seq_len"])).astype(np.int32)
    try:
        client = ServeClient([("127.0.0.1", rep.bound_port)],
                             deadline_s=120.0)
        check(client.request(toks[0].tolist(), request_id="warm")
              ["status"] == "ok", "the warm-up request failed")
        reset_counts()
        b0 = rep.batches
        outs = [client.request(t.tolist(), request_id=i)
                for i, t in enumerate(toks)]
        counts = read_counts()
        batches = rep.batches - b0
        check(all(o["status"] == "ok"
                  and len(o["probs"]) == MODEL["vocab_size"] for o in outs),
              f"one-shot LM requests: {[o['status'] for o in outs]}")
        # each served answer against the plain path's softmax for the
        # same prompt at batch 1, the shape the serve path gave K1
        served = np.asarray([o["probs"] for o in outs], np.float64)
        want = []
        with torch.no_grad():
            for t in toks:
                logits = transformer.apply(
                    rep._params,
                    torch.from_numpy(t[None]).long().to(DEVICE),
                    num_heads=MODEL["num_heads"],
                    attention_fn=flash_attention_bshd_plain,
                    compute_dtype=torch.bfloat16)
                want.append(torch.softmax(logits[0, -1].float(), dim=-1)
                            .double().cpu().numpy())
        want = np.stack(want)
    finally:
        rep.stop()
    delta = np.abs(served - want)
    limit = want * LM_PREDICT_PROB_REL + LM_PREDICT_PROB_ABS
    rec = {"requests": len(outs),
           "ok": sum(o["status"] == "ok" for o in outs),
           "batches": batches, "launches": counts,
           "k1_launches": counts["K1"],
           "prob_max_abs_vs_plain": float(delta.max()),
           "prob_max_over_limit": float((delta / limit).max()),
           "prob_tol": {"rel": LM_PREDICT_PROB_REL,
                        "abs": LM_PREDICT_PROB_ABS}}
    emit({"phase": "serve", "part": "lm_one_shot", **rec})
    check(counts["K1"] == MODEL["num_layers"] * batches
          and all(counts[k] == 0 for k in counts if k != "K1"),
          f"one-shot LM: launches {counts} for {batches} batches")
    check(bool((delta <= limit).all()),
          f"one-shot LM against plain: |dp| reaches "
          f"{rec['prob_max_over_limit']:.3f} x its limit")
    return rec


def phase_serve(tmp: str, ckpt_rec: dict) -> dict:
    """The serving tier on the card: classification that hot-follows
    training, its quantized tiers, decode swaps under both policies and
    the one-shot LM predict."""
    import gc

    import torch
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "serve", "cnn": _serve_cnn(tmp)}
    ckpt_dir = ckpt_rec["train_dir"]
    rec["decode_swaps"] = {p: _decode_swap(tmp, ckpt_dir, p)
                           for p in ("pin", "restart")}
    rec["lm_one_shot"] = _lm_one_shot(tmp, ckpt_dir)
    rec["seconds"] = time.time() - t_phase
    emit({"phase": "serve", "seconds": rec["seconds"]})
    return rec


# (kernel, name, source, replaces, the phase whose launches it reports)
# -- phase 16: the compile layer --------------------------------------------

# each training arm: GRAPH_STEPS steps of the Trainer, its profile window
# over GRAPH_WINDOW, then GRAPH_TIMED steps timed on one batch, once with
# the step captured (compile.precompile=true) and once eager
GRAPH_STEPS, GRAPH_WINDOW, GRAPH_TIMED = 8, (4, 7), 5
# kernel names in a trace by launch counter
TRACE_NAMES = {"K1-lse": "flash_fwd", "K2": "bwd_dq", "K3": "bwd_dkv",
               "K4": "bwd_fused", "K5": "paged_split"}
GRAPH_CHILD_TIMEOUT_S = 300

_CACHE_CHILD = r"""
import json, sys, time
t0 = time.time()
import torch
from distributedmnist_tpu_torch.core.compile_cache import (
    cache_stats, enable_persistent_cache)
from distributedmnist_tpu_torch.launch.__main__ import build_trainer
from distributedmnist_tpu_torch.ops import _build
enable_persistent_cache()
before = cache_stats()
_build.build()  # every library, as phase_build does: all at once
for name in _build.SOURCES:
    _build.load_library(name)
ready = time.time() - t0
first, compile_rec = [None], None
if sys.argv[3] == "step":
    t = build_trainer(["train", "--config", sys.argv[1], "train.max_steps=1",
                       "compile.precompile=true",
                       f"train.train_dir={sys.argv[2]}", "--device", "cuda"])
    first = []
    compile_rec = t.run(step_callback=lambda s, r: first.append(
        time.time() - t0))["compile"]
after = cache_stats()
print(json.dumps({"ready_s": ready, "first_step_s": first[0],
                  "compile": compile_rec,
                  "entries_before": before["entries"],
                  "entries": after["entries"],
                  "new_entries": after["entries"] - before["entries"],
                  "hits": after["hits"], "misses": after["misses"],
                  "rebuilds": _build.cache_counters()["rebuilds"]}))
"""


def _trace_counts(path, steps: int) -> dict:
    """Launches a step of each flash/paged kernel in a Chrome trace, by
    kernel name (a replay calls no wrapper, so its counter stays)."""
    events = [e["name"] for e in json.loads(open(path).read())["traceEvents"]
              if e.get("cat") == "kernel"]
    return {k: sum(frag in n for n in events) / steps
            for k, frag in TRACE_NAMES.items()}


def _step_kernel_names(path) -> list:
    """A scheduled profile's Chrome trace read back step by step: for each
    ``ProfilerStep#`` range on the host, the names of the kernels whose
    launch (the CUDA API call with the kernel's correlation id; a graph
    replay's kernels share their ``cudaGraphLaunch``'s) lies in
    it. The tracer can drop a kernel record, never add one."""
    ev = json.loads(open(path).read())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                    if str(e.get("name", "")).startswith("ProfilerStep#")
                    and e.get("cat") != "gpu_user_annotation"
                    and "dur" in e)
    launched = {e["args"]["correlation"]: e["ts"] for e in ev
                if str(e.get("cat", "")).startswith("cuda_")
                and "correlation" in e.get("args", {})}
    out = [[] for _ in ranges]
    for e in ev:
        t = (launched.get(e.get("args", {}).get("correlation"))
             if e.get("cat") == "kernel" else None)
        i = next((i for i, (a, b) in enumerate(ranges) if a <= (t or -1) < b),
                 None)
        if i is not None:
            out[i].append(e["name"])
    return out


def _wall_ms(fn, steps: int) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _graph_train_arm(name: str, build, per_step: dict,
                     bitwise: bool) -> dict:
    """One training arm, captured and eager: the compile record, params
    and losses after ``GRAPH_STEPS`` steps from the same start, ms a step
    by CUDA events, the profile window's idle share
    and kernel counts a step, peak memory."""
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    out, finals = {}, {}
    for mode in ("cuda_graph", "eager"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = build(f"graphs_{name}_{mode}",
                   f"compile.precompile={str(mode == 'cuda_graph').lower()}",
                   f"train.max_steps={GRAPH_STEPS}",
                   f"train.profile_steps={list(GRAPH_WINDOW)}")
        losses = []
        reset_counts()
        summary = tr.run(step_callback=lambda s, r: losses.append(r["loss"]))
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        log = [json.loads(line) for line in
               (tr.train_dir / "train_log.jsonl").read_text().splitlines()]
        compiles = [r for r in log if r["event"] == "compile"]
        steps = GRAPH_WINDOW[1] - GRAPH_WINDOW[0]
        trace = tr.train_dir / "profile" / "trace.json"
        window = _trace_breakdown(trace, steps)
        finals[mode] = ([t.clone() for t in tree_leaves(tr.state.params)],
                        losses)
        data, rows = tr.datasets.train, (tr.cfg.data.batch_size
                                         * tr.cfg.train.grad_accum_steps)
        batch = to_device({"image": data.images[:rows],
                           "label": data.labels[:rows]}, tr.device)
        state = tr.state
        out[mode] = {
            "compile": (compiles[0] if mode == "cuda_graph" else
                        summary["compile"]),
            "first_loss": losses[0], "last_loss": losses[-1],
            # the replay's time only (the eager step's: PERF.md §5)
            "ms_per_step": (_time_steps(tr, batch, steps=GRAPH_TIMED)
                            if mode == "cuda_graph" else None),
            "device_idle_share": window["device_idle_share"],
            "device_busy_ms": window["device_busy_ms"],
            "kernels_per_step": window["kernels_per_step"],
            "flash_kernels": window["flash_kernels"],
            "trace_launches_per_step": _trace_counts(trace, steps),
            "wrapper_launches": counts, "peak_mem_gb": peak}
        if mode == "cuda_graph":
            check(len(compiles) == 1 and log[0]["event"] == "compile"
                  and compiles[0]["source"] == "cuda_graph",
                  f"{name}: compile records {compiles}")
            check(tr._train_step.captured
                  and tr._train_step._prepared.replay.replays
                  >= GRAPH_STEPS, f"{name}: the steps did not replay")
        del tr, state, batch
    (gp, gl), (ep, el) = finals["cuda_graph"], finals["eager"]
    del finals
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(gp, ep))
    rec = {"phase": "graphs", "arm": name, **out,
           "params_bitwise": all(torch.equal(a, b) for a, b in zip(gp, ep)),
           "losses_equal": gl == el, "param_max_abs_diff": diff,
           "loss_max_abs_diff": max(abs(a - b) for a, b in zip(gl, el))}
    emit(rec)
    check(out["cuda_graph"]["flash_kernels"] == out["eager"]["flash_kernels"],
          f"{name}: the capture changed the flash kernels that run: {out}")
    for mode in out:
        got = out[mode]["trace_launches_per_step"]
        check(all(got[k] == v for k, v in per_step.items()),
              f"{name} {mode}: kernels a step from the trace {got}, "
              f"want {per_step}")
    if bitwise:
        check(rec["params_bitwise"] and rec["losses_equal"],
              f"{name}: replay differs from eager: {rec}")
    else:
        check(rec["loss_max_abs_diff"] <= STEP_LOSS_TOL
              and diff <= STEP_PARAM_TOL,
              f"{name}: replay vs eager loss diff "
              f"{rec['loss_max_abs_diff']}, param diff {diff}")
    return rec


def _decode_step_timing(rep, steps: int = 20) -> dict:
    """The replica's current version's decode step with every slot live
    at the e2e requests' mid-generation lengths: ms by CUDA events around
    ``steps`` graph replays (or eager bodies), ms by the host clock for
    the whole call (inputs staged, logits read back), and a
    ``torch.profiler`` window over ``steps`` calls after 3 untraced ones
    under the profiler (the first replays under a fresh profiler can lose
    a kernel record; idle share against the unprofiled wall; K5 launches
    a step by kernel name, step by step: the tracer still drops a record
    now and then, so the step with the most records is the one read)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    dstep = rep._params.decode
    slots = DECODE["decode_slots"]
    lengths = [p + m // 2 for p, m in REQUESTS][:slots]
    tables = [rep.cache.alloc_sequence(n) for n in lengths]
    check(all(t is not None for t in tables), "no free blocks to time")
    tab = torch.tensor(np.stack(tables), dtype=torch.int32, device=DEVICE)
    toks = np.ones(slots, np.int64)
    pos = np.asarray(lengths, np.int64) - 1
    lens = np.asarray(lengths, np.int64)
    call = lambda: dstep(toks, pos, lens, tab, "timing")  # noqa: E731
    body = ((lambda: dstep.replay.replay("decode"))
            if dstep.replay is not None else dstep.body)
    for _ in range(3):
        call()
    wall = _wall_ms(call, steps)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(steps):
        body()
    b.record()
    b.synchronize()
    events_ms = a.elapsed_time(b) / steps
    path = f"{rep.serve_dir}/decode_trace.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=2, active=steps),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        for _ in range(3 + steps):
            call()  # ends in the logits' read-back: the step is done
            prof.step()
    for t in tables:
        rep.cache.free_sequence(t)
    kernels = [e for e in json.loads(open(path).read())["traceEvents"]
               if e.get("cat") == "kernel"]
    busy = sum(e["dur"] for e in kernels) / 1e3 / steps
    by_step = _step_kernel_names(path)
    check(len(by_step) == steps, f"decode trace: {len(by_step)} steps")
    k5 = [sum("paged_split" in n for n in names) for names in by_step]
    fullest = max(range(steps), key=lambda i: len(by_step[i]))
    return {"ms_per_step": events_ms, "wall_ms_per_step": wall,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall,
            "kernels_per_step": len(kernels) / steps,
            "kernel_records_by_step": [len(n) for n in by_step],
            "trace_records_lost": (len(by_step[fullest]) * steps
                                   - sum(len(n) for n in by_step)),
            "k5_by_step": k5, "k5_per_step": k5[fullest],
            "k5_per_step_mean": sum(k5) / steps}


def _graph_decode_arm(tmp: str, train_dir: str) -> dict:
    """The e2e replica's configuration on the training phase's checkpoint,
    each version's decode step captured and eager: the capture records,
    the 8 e2e requests' tokens (greedy: equal both ways), ms a decode
    iteration by the host clock, and :func:`_decode_step_timing`."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.servesvc.decode import DecodeReplica
    from distributedmnist_tpu_torch.servesvc.server import wait_for_run_config
    cfg = wait_for_run_config(train_dir)
    rng = np.random.default_rng(SEED)
    prompts = [(rng.integers(0, MODEL["vocab_size"], p).tolist(), m)
               for p, m in REQUESTS]
    out, tokens = {}, {}
    for mode in ("cuda_graph", "eager"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rep = DecodeReplica(
            train_dir, serve_dir=f"{tmp}/graphs_decode_{mode}",
            scfg=cfg.serve, dcfg=cfg.decode, device=DEVICE,
            cfg=cfg.override({"compile.precompile": mode == "cuda_graph"}))
        rep.start()
        try:
            _drive(rep.bound_port, prompts, "warm")
            it0 = rep.decode_iterations
            outs, _, wall = _drive(rep.bound_port, prompts, mode)
            iters = rep.decode_iterations - it0
            timing = _decode_step_timing(rep)
        finally:
            rep.stop()
        check(all(o is not None and o.get("status") == "ok" for o in outs),
              f"decode {mode}: {outs}")
        tokens[mode] = [o["tokens"] for o in outs]
        out[mode] = {"compiles": rep.decode_compiles,
                     "decode_iterations": iters,
                     "wall_ms_per_iteration": wall * 1e3 / iters,
                     **timing,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    rec = {"phase": "graphs", "arm": "decode", **out,
           "tokens_equal": tokens["cuda_graph"] == tokens["eager"],
           "replay_over_eager_wall": (out["cuda_graph"]["wall_ms_per_step"]
                                      / out["eager"]["wall_ms_per_step"])}
    emit(rec)
    check(all(c["source"] == "cuda_graph"
              for c in out["cuda_graph"]["compiles"]),
          f"decode: a version was not captured: {out['cuda_graph']}")
    for mode in out:
        # the step with the most kernel records holds them all (a trace
        # only drops records); no step may hold more K5 than layers
        check(out[mode]["k5_per_step"] == MODEL["num_layers"]
              and max(out[mode]["k5_by_step"]) == MODEL["num_layers"],
              f"decode {mode}: K5 a step {out[mode]['k5_by_step']}")
    check(rec["tokens_equal"], "decode: replayed tokens differ from eager")
    return rec


def _graph_cache_children(tmp: str) -> dict:
    """The kernel build cache across processes, three at once: a cold
    process on a fresh ``DMT_COMPILE_CACHE_DIR`` (every library a miss),
    a warm one on a cache of build's libraries (none, no new entry) and
    one on such a cache with one library truncated (it heals it with one
    rebuild); each process's time from its start to every library
    loaded (``ready_s``, each with the other two running), and the cold
    one's to the end of its first step (the training configuration at
    seq 64, one step, captured)."""
    from pathlib import Path
    cache = f"{tmp}/graphs_kernel_cache"
    path = f"{tmp}/graphs_cache.json"
    with open(path, "w") as f:
        json.dump({**TRAIN, "model": {**MODEL, "seq_len": K4_SEQ},
                   "data": {**TRAIN["data"], "batch_size": K4_BATCH}}, f)
    # the warm and healed caches hold build's libraries (the healed one
    # with one torn), so the three processes run side by side
    for name in ("warm", "healed"):
        _seed_kernel_cache(f"{cache}_{name}")
    lib = sorted(Path(f"{cache}_healed", "kernels").glob(
        "libflash_attention_fwd-*.so"))
    check(len(lib) == 1, f"kernel cache holds {lib}")
    lib[0].write_bytes(lib[0].read_bytes()[:64])  # a torn write

    def child(name):
        env = dict(os.environ, DMT_COMPILE_CACHE_DIR=(
            cache if name == "cold" else f"{cache}_{name}"))
        try:
            p = subprocess.run(
                [sys.executable, "-c", _CACHE_CHILD, path,
                 f"{tmp}/graphs_cache_{name}",
                 "step" if name == "cold" else "load"], env=env,
                capture_output=True, text=True,
                timeout=GRAPH_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise PhaseError(f"cache child {name} timed out") from e
        check(p.returncode == 0, f"cache child {name} exited "
              f"{p.returncode}: {p.stderr[-3000:]}")
        got = json.loads(p.stdout.strip().splitlines()[-1])
        got["heal_warning"] = "does not load" in p.stderr
        return got

    names = ("cold", "warm", "healed")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        runs = dict(zip(names, pool.map(child, names)))
    from distributedmnist_tpu_torch.ops._build import SOURCES
    n = len(SOURCES)
    cold, warm, healed = runs["cold"], runs["warm"], runs["healed"]
    check(cold["misses"] == n and cold["new_entries"] == n,
          f"cold: {cold}")
    check(warm["misses"] == 0 and warm["new_entries"] == 0
          and warm["hits"] == n, f"warm: {warm}")
    check(healed["rebuilds"] == 1 and healed["heal_warning"]
          and healed["entries"] == n, f"healed: {healed}")
    check(cold["compile"]["source"] == "cuda_graph",
          f"the cold cache child's compile record: {cold}")
    return runs


def phase_graphs(tmp: str, train_dir: str) -> dict:
    """The compile layer: each arm captured against eager, and the kernel
    build cache across processes."""
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    t0 = time.time()
    layers = MODEL["num_layers"]
    flash = {"K1-lse": layers, "K2": layers, "K3": layers, "K4": 0, "K5": 0}
    none = dict.fromkeys(TRACE_NAMES, 0)

    def resnet(name, *over):
        return build_trainer(["train", "--config", RESNET_CONFIG,
                              f"data.data_dir={tmp}/cifar10",
                              f"train.train_dir={tmp}/{name}", *over,
                              "--device", DEVICE])

    # the cache children run beside the arms: their checks are counts,
    # the arms' counts and bits, and the arms' times are a record
    pool = concurrent.futures.ThreadPoolExecutor(1)
    children = pool.submit(_graph_cache_children, tmp)
    pool.shutdown(wait=False)
    arms = {
        "cnn": _graph_train_arm(
            "cnn", lambda n, *o: _cnn_trainer(tmp, n, *o), none,
            bitwise=True),
        "resnet": _graph_train_arm("resnet", resnet, none, bitwise=True),
        "train": _graph_train_arm(
            "train", lambda n, *o: _build_trainer(tmp, n, *o), flash,
            bitwise=False),
        "train_k4": _graph_train_arm(
            "train_k4", lambda n, *o: _build_trainer(
                tmp, n, f"model.seq_len={K4_SEQ}",
                f"data.batch_size={K4_BATCH}", *o),
            {**flash, "K2": 0, "K3": 0, "K4": layers}, bitwise=False),
        "train_replicas": _graph_train_arm(
            "train_replicas", lambda n, *o: _build_trainer(
                tmp, n, f"mesh.num_replicas={REPLICAS}", "sync.mode=quorum",
                f"sync.num_replicas_to_aggregate={REPLICA_K}",
                "sync.straggler_profile=lognormal", *o),
            flash, bitwise=False),
        "decode": _graph_decode_arm(tmp, train_dir)}
    import torch

    from distributedmnist_tpu_torch.ops import flash_attention as fa
    from distributedmnist_tpu_torch.ops import paged_attention as pa
    hd = MODEL["model_dim"] // MODEL["num_heads"]
    routes = {k: fa.kernel_route(k, torch.bfloat16, hd)
              for k in ("K1-lse", "K2", "K3", "K4")}
    routes["K5"] = pa.kernel_route(torch.bfloat16, hd)
    # each arm printed its own line; the phase's line sums them up
    summary = {name: {k: a[k] for k in ("params_bitwise", "tokens_equal",
                                        "replay_over_eager_wall") if k in a}
               for name, a in arms.items()}
    rec = {"phase": "graphs", "card": nvidia_smi(), "arms": summary,
           "routes_after_capture": routes,
           "kernel_cache": children.result(),
           "seconds": time.time() - t0}
    emit(rec)
    check(routes == {"K1-lse": "wgmma", "K2": "wgmma", "K3": "wgmma",
                     "K4": "wgmma", "K5": "cluster_split"},
          f"kernel routes after the captures: {routes}")
    return rec


# the cluster phase: the chaos campaign's train payload (the MNIST CNN
# at its published widths, 2 simulated replicas, momentum 0.9, ZeRO-1
# in 2 buckets, float32) on the port's `launch train` workers on the
# card, paced so that the campaign's 0.5 s poll sees each trigger step
# (pacing sleeps between steps and leaves the numerics alone): seed 0's
# trial 0 stalls worker 1 for 5.5 s at step 11 and kills it with its
# newest checkpoint torn at 13, so worker 0's run must outlast both
CLUSTER_CNN = {"name": "cnn", "trials": 2, "seed": 0, "until_step": 40,
               "save_interval_steps": 5, "shrink": False,
               "poll_secs": 0.5,
               "trial_timeout_s": 300.0, "drain_timeout_s": 120.0}
CLUSTER_CNN_PACE_MS = 200
# one flash-transformer trial through the same campaign: the training
# path's widths (d 2048, 16 heads of 128, seq 1024, vocab 1024, bf16,
# flash) at 2 layers (cut from 4), plain sgd so the step is captured as
# CUDA graphs, batch 16, 20 steps, a save every 5; seed 40's trial 0 is
# a kill of worker 1 at step 7 with no corruption, so the promoted warm
# standby must restore the intact step-5 checkpoint into its captured
# tensors to end on the reference's bits; the profile window's trace
# counts the flash kernels (a replayed graph calls no wrapper, and the
# workers are other processes)
FLASH_LAYERS = 2
FLASH_PROFILE = (16, 18)
FLASH_PACE_MS = 200
FLASH_MIN_RESTORE = 5
CLUSTER_FLASH = {"name": "flash", "trials": 1, "seed": 40, "until_step": 20,
                 "save_interval_steps": 5, "standby_workers": 1,
                 "shrink": False, "trial_timeout_s": 400.0,
                 "drain_timeout_s": 180.0}


def _flash_payload(max_steps: int, pace_ms: float, save: int = 5,
                   profile: bool = True) -> str:
    m = {**MODEL, "num_layers": FLASH_LAYERS}
    return ("python -m distributedmnist_tpu_torch.launch train "
            "train.train_dir=. data.dataset=synthetic_lm "
            "data.batch_size=16 data.synthetic_train_size=512 "
            "data.synthetic_test_size=32 data.use_native_pipeline=false "
            + " ".join(f"model.{k}={v}" for k, v in m.items())
            + " optim.name=sgd optim.initial_learning_rate=0.1 "
            "optim.learning_rate_decay_factor=1.0 eval.eval_batch_size=16 "
            f"train.max_steps={max_steps} train.log_every_steps=1 "
            f"train.save_interval_steps={save} train.keep_checkpoints=2 "
            "train.async_checkpoint=false train.save_results_period=0 "
            f"train.step_pace_ms={pace_ms}"
            + (f" train.profile_steps=[{FLASH_PROFILE[0]},{FLASH_PROFILE[1]}]"
               if profile else ""))


def _worker_compiles(root: str) -> list:
    """Every compile record in every worker journal under a campaign
    root: run, worker, device, source (and reason), kernel cache."""
    import glob

    from distributedmnist_tpu_torch.obsv.report import load_jsonl
    out = []
    for log in sorted(glob.glob(f"{root}/*/worker*/train_log.jsonl")):
        run, worker = log.split("/")[-3:-1]
        for r in load_jsonl(log, "compile"):
            out.append({"run": run, "worker": worker,
                        "device": r.get("device"), "source": r.get("source"),
                        "reason": r.get("reason"),
                        "cache": {k: (r.get("persistent_cache") or {}).get(k)
                                  for k in ("hits", "misses",
                                            "new_entries")}})
    return out


def _standby_restores(trial_dir: str) -> list:
    """Each standby promotion the supervisor journaled in a trial: the
    worker, the step its adopted process restored (its first step
    record after its own ``compile`` record, less one), that record's
    source and the worker log's count of compile records."""
    from distributedmnist_tpu_torch.obsv.report import load_jsonl
    out = []
    for e in load_jsonl(f"{trial_dir}/command_journal.jsonl", "recovery"):
        if e.get("action") != "restart" or e.get("via") != "standby":
            continue
        log = load_jsonl(f"{trial_dir}/worker{e['worker']}/train_log.jsonl")
        at = [i for i, r in enumerate(log) if r.get("event") == "compile"]
        after = log[at[-1] + 1:] if at else []
        first = next((r["step"] for r in after if r.get("event") == "step"),
                     None)
        out.append({"worker": e["worker"], "compiles": len(at),
                    "source": log[at[-1]].get("source") if at else None,
                    "restored_step": first - 1 if first else None})
    return out


def _unpaced(train_command: str) -> str:
    """A payload with its ``train.step_pace_ms`` set to 0. A campaign's
    fault-free reference run needs no pace: the pace is a sleep between
    steps that leaves the numerics alone, and it is there so that the
    trials' faults and polls see each step."""
    return re.sub(r"train\.step_pace_ms=[0-9.]+", "train.step_pace_ms=0",
                  train_command)


def _campaign(cfg, seed_cache: bool = False) -> tuple[dict, list]:
    """Run a campaign, its reference run unpaced and with no standby (a
    fault-free run promotes none); ``seed_cache``: its shared kernel
    cache is seeded from ``build`` before the reference run, so no
    worker compiles."""
    from distributedmnist_tpu_torch.launch.chaos import ChaosCampaign

    class Seeded(ChaosCampaign):
        def _run_trial(self, rel, *args, **kwargs):
            if rel != "reference":
                return super()._run_trial(rel, *args, **kwargs)
            if seed_cache:
                _seed_kernel_cache(self.cfg.root / "compile_cache")
            paced = self.cfg
            self.cfg = dataclasses.replace(
                paced, train_command=_unpaced(paced.train_command),
                standby_workers=0)
            try:
                return super()._run_trial(rel, *args, **kwargs)
            finally:
                self.cfg = paced

    summary = Seeded(cfg).run()
    with open(summary["report_path"]) as f:
        report = [json.loads(line) for line in f]
    return summary, report


def _trial_lines(report: list) -> list:
    return [{"trial": r["trial"], "described": r["described"],
             "outcome": r["outcome"], "duration_s": r["duration_s"],
             "determinism":
                 r["verdicts"]["determinism"], "faults": r["faults"],
             "mttr": r["mttr"], "boot_s": r["boot_s"],
             "stall_timeout_s": r["stall_timeout_s"]} for r in report]


def phase_cluster(tmp: str) -> dict:
    """The chaos campaign on the port's `launch train` workers on the
    card: the CNN campaign and the flash-transformer trial, every
    trial's invariants against its fault-free reference run."""
    from distributedmnist_tpu_torch.launch.chaos import (ChaosConfig,
                                                         generate_schedule)
    t0 = time.time()
    reset_counts()
    cnn_base = ChaosConfig(**CLUSTER_CNN)
    cnn_cfg = ChaosConfig(**CLUSTER_CNN, workdir=f"{tmp}/cluster",
                          train_command=(cnn_base.resolved_train_command()
                                         + f" train.step_pace_ms="
                                         f"{CLUSTER_CNN_PACE_MS}"))
    flash_cfg = ChaosConfig(**CLUSTER_FLASH, workdir=f"{tmp}/cluster",
                            poll_secs=0.5, train_command=_flash_payload(
                                CLUSTER_FLASH["until_step"], FLASH_PACE_MS))
    sched = generate_schedule(flash_cfg.seed, 0, flash_cfg.num_workers,
                              flash_cfg.step_window(),
                              max_faults=flash_cfg.max_faults,
                              min_faults=flash_cfg.min_faults,
                              stall_ms_range=flash_cfg
                              .resolved_stall_ms_range())
    check("kill" in {f.kind for f in sched.faults}
          and "corrupt" not in {f.kind for f in sched.faults},
          f"flash trial schedule is not a kill after an intact save: "
          f"{sched.describe()}")
    # the two campaigns run side by side, each under its own root: every
    # trial is held to its own campaign's fault-free reference run, a
    # pace is a sleep that leaves the numerics alone, and no worker is
    # this process
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        flash_run = pool.submit(_campaign, flash_cfg, seed_cache=True)
        cnn, cnn_report = _campaign(cnn_cfg)
        flash, flash_report = flash_run.result()
    parent = read_counts()
    traces = {}
    for run in ("reference", "trial000"):
        for w in (0, 1):
            path = f"{tmp}/cluster/flash/{run}/worker{w}/profile/trace.json"
            if os.path.exists(path):
                traces[f"{run}/worker{w}"] = _trace_counts(
                    path, FLASH_PROFILE[1] - FLASH_PROFILE[0])
    compiles = {"cnn": _worker_compiles(f"{tmp}/cluster/cnn"),
                "flash": _worker_compiles(f"{tmp}/cluster/flash")}
    promoted = _standby_restores(f"{tmp}/cluster/flash/trial000")
    rec = {"phase": "cluster", "card": nvidia_smi(),
           "cnn": {"all_green": cnn["all_green"],
                   "invariants": cnn["invariants"],
                   "faults": cnn["faults"], "mttr": cnn["mttr"],
                   "trials": _trial_lines(cnn_report)},
           "flash": {"all_green": flash["all_green"],
                     "invariants": flash["invariants"],
                     "faults": flash["faults"], "mttr": flash["mttr"],
                     "trials": _trial_lines(flash_report),
                     "standby_restores": promoted,
                     "launches_a_step_from_trace": traces,
                     "kernel_cache": compiles["flash"]},
           "compile_source": {k: sorted({(c["device"], c["source"])
                                         for c in v})
                              for k, v in compiles.items()},
           "cnn_compiles": len(compiles["cnn"]),
           "parent_launches": parent,
           "seconds": time.time() - t0}
    emit(rec)
    for name, summ in (("cnn", cnn), ("flash", flash)):
        check(summ["all_green"], f"{name} campaign not all green: "
              f"{summ['failing_trials']}")
    dets = {(n, r["trial"]): r["verdicts"]["determinism"]
            for n, rep in (("cnn", cnn_report), ("flash", flash_report))
            for r in rep}
    check(dets[("cnn", 0)] == "pass" and dets[("flash", 0)] == "pass",
          f"determinism: {dets}")
    check(all(v in ("pass", "skipped") for v in dets.values()),
          f"determinism: {dets}")
    fired0 = cnn_report[0]["faults"]["unfired"]
    check(not any(f["kind"] in ("kill", "corrupt") for f in fired0),
          f"cnn trial 0's kill/corrupt never fired: {fired0}")
    check(not flash_report[0]["faults"]["unfired"],
          f"flash trial's faults never fired: "
          f"{flash_report[0]['faults']}")
    every = compiles["cnn"] + compiles["flash"]
    check(every and all(c["device"] == "cuda:0" for c in every),
          f"a worker journal not on cuda:0: {every}")
    check(all(c["source"] == "cuda_graph" for c in compiles["flash"]),
          f"flash workers not captured: {compiles['flash']}")
    check(promoted and all(
        p["source"] == "cuda_graph" and p["compiles"] == 2
        and (p["restored_step"] or 0) >= FLASH_MIN_RESTORE
        for p in promoted),
          f"no promoted standby restored step >= {FLASH_MIN_RESTORE} into "
          f"captured graphs: {promoted}")
    check(traces and all(t[k] == FLASH_LAYERS for t in traces.values()
                         for k in ("K1-lse", "K2", "K3")),
          f"flash kernels a step in the workers' traces: {traces}")
    check(all(v == 0 for v in parent.values()),
          f"this process launched kernels: {parent}")
    return rec


# the restart phase (≙ bench.py bench_restart_latency): spawn (or
# promotion) → first moved step of the chaos train payload, cold (an
# empty kernel directory), warm (the shared cache primed once) and
# standby (a parked, precompiled spare promoted), RESTART_SAMPLES each
# (one since the campaign phase: the gates' margin is 3x, the samples'
# spread 15%); the reference's gates against the cold median
RESTART_SAMPLES = 1
RESTART_GATES = {"warm": 0.6, "standby": 0.3}


def _first_step_after(cluster, anchor: float, timeout_s: float = 300.0
                      ) -> float:
    """Seconds from ``anchor`` to worker 0's first step record stamped
    at or after it."""
    from distributedmnist_tpu_torch.obsv.report import load_jsonl
    log = f"{cluster.cfg.worker_dir(0)}/train_log.jsonl"
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        for r in load_jsonl(log, "step"):
            if isinstance(r.get("time"), (int, float)) and r["time"] >= anchor:
                return r["time"] - anchor
        time.sleep(0.1)
    raise PhaseError(f"no step record within {timeout_s:.0f}s of the "
                     f"(re)spawn: {log}")


def _spawn_and_time(cluster) -> float:
    """Fresh worker dir, spawn, seconds to the first moved step; the
    worker is stopped after."""
    import shutil
    cluster.kill_all(worker="0")
    wdir = str(cluster.cfg.worker_dir(0))
    shutil.rmtree(wdir, ignore_errors=True)
    os.makedirs(wdir)
    cluster.run_train()
    anchor = cluster.status()["workers"][0]["spawned_at"]
    try:
        return _first_step_after(cluster, anchor)
    finally:
        cluster.kill_all(worker="0")


def _restart_cluster(root: str, name: str, payload: str, cache: bool):
    from distributedmnist_tpu_torch.launch.cluster import (
        LocalClusterConfig, LocalProcessCluster)
    from distributedmnist_tpu_torch.launch.exec import (CommandExecutor,
                                                        RetryPolicy)
    cfg = LocalClusterConfig(
        name=name, num_workers=1, workdir=root, train_command=payload,
        compile_cache=cache,
        compile_cache_dir=f"{root}/{name}_cache" if cache else "")
    c = LocalProcessCluster(cfg, CommandExecutor(
        journal=cfg.root / "command_journal.jsonl",
        retry=RetryPolicy(max_attempts=1)))
    c.create()
    return c


def _ready_standbys(cluster) -> int:
    return sum(sb["ready"] for sb in cluster.status().get("standbys", []))


def _promote_and_time(cluster) -> float:
    """Kill worker 0, promote a ready standby into its train_dir, seconds
    from the promotion to the first step it moves."""
    deadline = time.time() + 300.0
    while not _ready_standbys(cluster):
        check(time.time() < deadline, "no standby parked")
        time.sleep(0.2)
    cluster.kill_all(worker="0")
    check(cluster.promote_standby(0), "promote_standby found no ready spare")
    anchor = cluster.status()["workers"][0]["spawned_at"]
    return _first_step_after(cluster, anchor)


def _cold_entries(cluster) -> int:
    """Kernel libraries the cold spawns built, each into its own empty
    directory under ``<root>/cold_compile``: what a prime run would
    persist into a shared cache."""
    import glob

    from distributedmnist_tpu_torch.core.compile_cache import cache_stats
    return sum(cache_stats(d)["entries"]
               for d in glob.glob(f"{cluster.cfg.root}/cold_compile/*"))


def _restart_cnn(root: str) -> dict:
    """The chaos train payload (long enough never to finish while timed):
    cold spawns; warm spawns after a prime spawn, only where the cold
    spawns built a kernel library; and promotions of standbys parked
    before any timing."""
    from distributedmnist_tpu_torch.launch.chaos import ChaosConfig
    payload = ChaosConfig(until_step=100000).resolved_train_command()
    cold_c = _restart_cluster(root, "cnn_cold", payload, cache=False)
    warm_c = _restart_cluster(root, "cnn_warm", payload, cache=True)
    try:
        # boot every standby at once, before the timed spawns: parked,
        # they poll a file and hold the cores no longer
        warm_c.ensure_standbys(RESTART_SAMPLES)
        deadline = time.time() + 300.0
        while _ready_standbys(warm_c) < RESTART_SAMPLES:
            check(time.time() < deadline, "the standbys never parked")
            time.sleep(0.2)
        cold = [_spawn_and_time(cold_c) for _ in range(RESTART_SAMPLES)]
        built = _cold_entries(cold_c)
        prime = None
        skipped = None
        warm = []
        if built == 0:
            skipped = ("the cold spawns built no kernel library (the CNN "
                       "payload has none), so a prime would persist no "
                       "cache entry and nothing is warm to be had")
        else:
            prime = _spawn_and_time(warm_c)
            warm = [_spawn_and_time(warm_c) for _ in range(RESTART_SAMPLES)]
        standby = [_promote_and_time(warm_c) for _ in range(RESTART_SAMPLES)]
    finally:
        cold_c.kill_all()
        warm_c.kill_all()
    med = {"cold": statistics.median(cold),
           "warm": statistics.median(warm) if warm else None,
           "standby": statistics.median(standby)}
    ratio = {k: (med[k] / med["cold"] if med[k] is not None else None)
             for k in RESTART_GATES}
    return {"payload": payload, "cold_s": cold, "prime_s": prime,
            "warm_s": warm, "standby_s": standby, "median_s": med,
            "ratio_vs_cold": ratio, "gates": RESTART_GATES,
            "warm_gate_ok": (None if skipped else
                             ratio["warm"] <= RESTART_GATES["warm"]),
            "warm_skipped": skipped,
            "standby_gate_ok": ratio["standby"] <= RESTART_GATES["standby"],
            "entries_built_cold": built}


def phase_restart(tmp: str) -> dict:
    t0 = time.time()
    root = f"{tmp}/restart"
    cnn = _restart_cnn(root)
    rec = {"phase": "restart", "card": nvidia_smi(), "cnn": cnn,
           "seconds": time.time() - t0}
    emit(rec)
    check(cnn["standby_gate_ok"], f"standby restart over cold: "
          f"{cnn['ratio_vs_cold']['standby']:.3f} > "
          f"{RESTART_GATES['standby']}")
    check(cnn["warm_gate_ok"] is not False, f"warm restart over cold: "
          f"{cnn['ratio_vs_cold']['warm']}")
    return rec


# the serving chaos trial (≙ tests/test_servesvc.py:783, the reference's
# network scenario): `cluster chaos --payload serving --serve-decode
# --network`, 2 decode replicas (`launch serve --decode` on the card)
# following a publisher that trains the flash transformer at the training
# path's widths, cut to FLASH_LAYERS layers, with
# decode.attention_kernel=paged, so every replica prefills through K1 and
# decodes through K5 in its captured decode step; seeded chaos proxies in
# front of the replicas cut one token stream mid-generation (seed 0: at
# byte 665 of worker 2's) and partition worker 1's link under live load
SERVING_CHAOS = {"name": "serving_chaos", "payload": "serving",
                 "serve_decode": True, "network": True,
                 "serve_replicas": 2, "until_step": 60,
                 "save_interval_steps": 10, "trials": 1, "seed": 0,
                 "shrink": False, "trial_timeout_s": 420.0}
SERVING_REPLICAS = (1, 2)
# the TP arm (≙ bench.py bench_tp_serving): two 2-rank decode groups
# following serving_chaos's publisher's kept steps
TP_SERVING = {"ranks": 2, "groups": (1, 2), "concurrency": 3,
              "requests": 24, "slots": 4, "max_new_tokens": 8,
              "max_prompt_len": 16, "boot_timeout_s": 240.0}


def _seed_kernel_cache(cache_dir) -> list:
    """Copy the libraries ``phase_build`` built into a campaign's shared
    kernel cache (the names are the sources' hashes, so each is the
    library a worker would build): no worker of the campaign compiles."""
    import shutil

    from distributedmnist_tpu_torch.core.compile_cache import kernels_dir
    from distributedmnist_tpu_torch.ops import _build
    dst = kernels_dir(cache_dir)
    dst.mkdir(parents=True, exist_ok=True)
    out = []
    for name in _build.SOURCES:
        src = _build.library_path(name)
        check(src.exists(), f"{src} was not built")
        shutil.copy2(src, dst / src.name)
        out.append(src.name)
    return out


def _flash_serving_campaign(cfg):
    """The serving campaign with the flash publisher in place of the
    compact LM: each run's publisher is paced by the reference's rule on
    the boot the campaign measured (``resolved_publisher_pace_ms``, as the
    built-in publisher is), and the shared kernel cache is seeded before
    the reference run."""
    from distributedmnist_tpu_torch.launch.chaos import ChaosCampaign

    class FlashPublisher(ChaosCampaign):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.paces: dict = {}
            self.seeded: list = []

        def _run_trial(self, rel, plan, seed, num_workers,
                       measured_boot_s=None, serving=False):
            if rel == "reference":
                self.seeded[:] = _seed_kernel_cache(
                    self.cfg.root / "compile_cache")
            # the reference run unpaced (see _unpaced); the trials by the
            # reference's rule on the boot it measured
            pace = (0.0 if rel == "reference" else
                    self.cfg.resolved_publisher_pace_ms(measured_boot_s))
            self.paces[rel] = pace
            self.cfg = dataclasses.replace(
                self.cfg, train_command=_flash_payload(
                    self.cfg.until_step, pace,
                    save=self.cfg.save_interval_steps, profile=False)
                + " decode.attention_kernel=paged")
            return super()._run_trial(rel, plan, seed, num_workers,
                                      measured_boot_s=measured_boot_s,
                                      serving=serving)

    return FlashPublisher(cfg)


def _watch_metas(trial_dir: str, stop: threading.Event) -> dict:
    """Each replica's meta answer, asked once its ``serve.json`` is up,
    straight to its port (not through its proxy), on a thread until
    ``stop``; returns the dict the thread fills."""
    from distributedmnist_tpu_torch.servesvc import ServeClient
    got: dict = {}

    def run():
        while not stop.is_set() and len(got) < len(SERVING_REPLICAS):
            for k in SERVING_REPLICAS:
                try:
                    with open(f"{trial_dir}/worker{k}/serve.json") as f:
                        ep = json.load(f)
                except (OSError, ValueError):
                    continue
                if k not in got:
                    meta = ServeClient([(ep["host"], ep["port"])],
                                       deadline_s=2.0,
                                       max_attempts=1).meta(deadline_s=2.0)
                    if meta is not None:
                        got[k] = {key: meta.get(key) for key in (
                            "device", "decode", "model", "model_step",
                            "decode_slots")}
            stop.wait(0.5)

    threading.Thread(target=run, daemon=True, name="meta-watch").start()
    return got


def _replica_evidence(trial_dir: str, workers=SERVING_REPLICAS) -> dict:
    """Per replica: its boot log's ``compile`` records (device, source,
    the kernel cache over the capture) and each of its processes' kernel
    launches (``kernel_launches.jsonl``, written at its stop)."""
    from distributedmnist_tpu_torch.obsv.report import load_jsonl
    out = {}
    for k in workers:
        d = f"{trial_dir}/worker{k}"
        out[k] = {
            "compile": [{"device": r.get("device"),
                         "source": r.get("source"),
                         "reason": r.get("reason"),
                         "compile_s": r.get("compile_s"),
                         "cache": {c: (r.get("persistent_cache") or {})
                                   .get(c) for c in ("hits", "misses",
                                                     "new_entries")}}
                        for r in load_jsonl(f"{d}/train_log.jsonl",
                                            "compile")],
            "processes": load_jsonl(f"{d}/kernel_launches.jsonl")}
    return out


def phase_serving_chaos(tmp: str) -> dict:
    """The serving chaos trial on the card: the reference's network
    scenario over the flash publisher, every check of the reference's
    test, plus the replicas' device, capture, kernel cache and K1/K5
    launches."""
    from distributedmnist_tpu_torch.launch.chaos import (
        ChaosConfig, generate_network_schedule)
    t0 = time.time()
    cfg = ChaosConfig(**SERVING_CHAOS, workdir=f"{tmp}/serving")
    sched = generate_network_schedule(cfg.seed, 0,
                                      list(SERVING_REPLICAS),
                                      max_faults=cfg.max_faults,
                                      min_faults=max(2, cfg.min_faults))
    trial_dir = f"{cfg.root}/trial000"
    reset_counts()
    stop = threading.Event()
    metas = _watch_metas(trial_dir, stop)
    campaign = _flash_serving_campaign(cfg)
    try:
        summary = campaign.run()
    finally:
        stop.set()
    parent = read_counts()
    with open(summary["report_path"]) as f:
        report = [json.loads(line) for line in f]
    from distributedmnist_tpu_torch.obsv.report import load_jsonl
    journal = load_jsonl(f"{trial_dir}/command_journal.jsonl", "fault")
    net = [{k: r.get(k) for k in ("action", "worker", "after_bytes",
                                  "bytes_passed", "mid_stream", "start_s",
                                  "duration_s", "conns_dropped", "conn")
            if k in r} for r in journal
           if str(r.get("action", "")).startswith("net_")]
    replicas = _replica_evidence(trial_dir)
    launches = {key: sum(p["launches"][key] for r in replicas.values()
                         for p in r["processes"]) for key in ("K1", "K5")}
    with open(f"{cfg.root}/reference/outcome.json") as f:
        ref_outcome = json.load(f)
    rec = {"phase": "serving_chaos", "card": nvidia_smi(),
           "schedule": sched.describe(),
           "all_green": summary["all_green"],
           "invariants": summary["invariants"],
           "faults": {k: summary["faults"][k]
                      for k in ("scheduled", "fired", "never_fired")},
           "net": summary["net"], "net_records": net,
           "serving": report[0]["serving"],
           "trial": {k: report[0][k] for k in ("outcome", "duration_s",
                                               "boot_s",
                                               "stall_timeout_s")},
           "reference": {"duration_s": ref_outcome.get("duration_s"),
                         "boot_s": ref_outcome.get("boot_s")},
           "publisher_pace_ms": campaign.paces,
           "kernel_cache_seeded": campaign.seeded,
           "metas": metas, "replicas": replicas, "launches": launches,
           "parent_launches": parent, "root": str(cfg.root),
           "seconds": time.time() - t0}
    emit(rec)
    check(summary["all_green"], f"serving chaos not all green: "
          f"{summary['failing_trials']}")
    inv = summary["invariants"]
    for name in ("net_faults", "serve_outcomes", "serve_digest",
                 "serve_monotone", "decode_swap"):
        check(inv[name]["pass"] == 1, f"invariant {name}: {inv[name]}")
    sv = summary["serving"]
    check(sv["issued"] > 0 and sv["dropped"] == 0,
          f"issued {sv['issued']}, dropped {sv['dropped']}")
    check(summary["faults"]["never_fired"] == 0,
          f"faults never fired: {summary['faults']['per_trial']}")
    resets = [r for r in net if r["action"] == "net_reset"]
    check(len(resets) == 1 and resets[0]["mid_stream"]
          and resets[0]["bytes_passed"] > 0, f"net_reset records: {resets}")
    check(sum(r["action"] == "net_partition" for r in net) == 1,
          f"net_partition records: {net}")
    check(sorted(metas) == list(SERVING_REPLICAS)
          and all(m["device"] == "cuda:0" and m["decode"]
                  for m in metas.values()),
          f"replica metas: {metas}")
    for k, r in replicas.items():
        check(r["compile"] and all(c["device"] == "cuda:0"
                                   and c["source"] == "cuda_graph"
                                   for c in r["compile"]),
              f"worker {k}'s decode steps not captured on cuda:0: "
              f"{r['compile']}")
        check(all(c["cache"]["misses"] == 0 for c in r["compile"])
              and r["processes"]
              and all(p["device"] == "cuda:0"
                      and p["kernel_cache"]["misses"] == 0
                      and p["kernel_cache"]["hits"] > 0
                      for p in r["processes"]),
              f"worker {k} built a kernel or left no launches: {r}")
    check(launches["K1"] > 0 and launches["K5"] > 0,
          f"replicas' K1/K5 launches: {launches}")
    check(all(v == 0 for v in parent.values()),
          f"this process launched kernels: {parent}")
    rec["tp"] = _tp_serving_arm(tmp, f"{trial_dir}/worker0",
                                cfg.root / "compile_cache")
    return rec


def _link_or_copy(src: str, dst: str) -> None:
    import shutil
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _tp_rank_lines(serve_dir: str) -> list:
    """Each rank process's ``kernel_launches.jsonl`` line of one group
    (rank 0 in the group's dir, rank r in ``rank<r>/``)."""
    from distributedmnist_tpu_torch.obsv.report import load_jsonl
    out = []
    for r in range(TP_SERVING["ranks"]):
        d = serve_dir if r == 0 else f"{serve_dir}/rank{r}"
        out += load_jsonl(f"{d}/kernel_launches.jsonl")
    return out


def _tp_serving_arm(tmp: str, src: str, cache_dir) -> dict:
    """``serving_chaos``'s TP arm (≙ ``bench.py bench_tp_serving``): two
    2-rank tensor-parallel decode groups (``launch serve --decode
    --tp-ranks 2``: every rank on ``cuda:0`` over gloo with one card, over
    NCCL with a card a rank), a failover client over both, a publisher
    pushing the chaos publisher's newer kept step mid-sweep, and a
    SIGKILL of rank 1 of group 1 mid-generation. Checked: no request
    dropped or errored; group 1's journal ``rank_exit`` → ``group_down``
    → ``group_restart`` → ``group_start`` and the ``serve_group`` replay
    clean; the restarted group serves; at least one swap on the
    survivor; the serving invariants green; every follower's
    ``shard_verify``; every rank that stopped gracefully (the survivor's
    and the restarted group's) on ``cuda:0`` with K1 and K5 launched and
    no kernel-cache miss; each rank's ``compile`` records say how its
    decode steps ran. Tokens/s and the transfers a decode step staged
    through the host are printed, never gated."""
    import shutil

    from distributedmnist_tpu_torch.obsv.invariants import (
        check_serve_group, check_serving)
    from distributedmnist_tpu_torch.obsv.report import load_jsonl
    from distributedmnist_tpu_torch.servesvc import ServeClient
    from distributedmnist_tpu_torch.servesvc.client import discover_endpoints
    from distributedmnist_tpu_torch.servesvc.loadgen import (make_prompt_fn,
                                                             run_load)
    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    t0 = time.time()
    T = TP_SERVING
    root = f"{tmp}/tp_serving"
    publish, trial = f"{root}/publish", f"{root}/trial"
    os.makedirs(publish)
    steps = ckpt.loadable_steps(src)
    check(len(steps) >= 2, f"the chaos publisher kept {steps}")

    def publish_step(step: int) -> None:
        name = f"ckpt-{step:08d}.msgpack"
        for sfx in ("", ".sha256"):
            _link_or_copy(f"{src}/{name}{sfx}", f"{publish}/{name}{sfx}")
        with open(f"{publish}/checkpoint.json.tmp", "w") as f:
            json.dump({"latest_step": step, "latest_path": name,
                       "written_at": time.time()}, f)
        os.replace(f"{publish}/checkpoint.json.tmp",
                   f"{publish}/checkpoint.json")

    def wait_for(pred, timeout_s: float, what: str) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if pred():
                return
            time.sleep(0.25)
        raise RuntimeError(f"TP arm: timed out after {timeout_s:.0f} s "
                           f"waiting for {what}")

    def actions(k: int) -> list:
        return [r.get("action") for r in
                load_jsonl(f"{trial}/worker{k}/group_log.jsonl")]

    publish_step(steps[-2])
    env = dict(os.environ, DMT_COMPILE_CACHE_DIR=str(cache_dir))
    sups = {}
    for k in T["groups"]:
        os.makedirs(f"{trial}/worker{k}")
        with open(f"{trial}/worker{k}.log", "w") as log:
            sups[k] = subprocess.Popen(
                [sys.executable, "-m", "distributedmnist_tpu_torch.launch",
                 "serve", "--train-dir", publish, "--serve-dir",
                 f"{trial}/worker{k}", "--port", "0", "--poll-secs", "0.2",
                 "--queue-depth", "16", "--decode", "--decode-slots",
                 str(T["slots"]), "--max-new-tokens",
                 str(T["max_new_tokens"]), "--max-prompt-len",
                 str(T["max_prompt_len"]), "--tp-ranks", str(T["ranks"])],
                env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        wait_for(lambda: len(discover_endpoints(trial)) == len(sups)
                 or any(p.poll() is not None for p in sups.values()),
                 T["boot_timeout_s"], "both TP groups' serve.json")
        check(all(p.poll() is None for p in sups.values()),
              f"a TP group's supervisor exited: "
              f"{ {k: p.poll() for k, p in sups.items()} }")
        t_ready = time.time() - t0
        client = ServeClient(lambda: discover_endpoints(trial),
                             deadline_s=120.0, max_attempts=12)
        make_prompt = make_prompt_fn(1024, T["max_prompt_len"])
        bucket = 1
        while bucket <= T["max_prompt_len"]:  # every bucket on both
            for _ in range(2):
                out = client.generate([1] * bucket, max_tokens=2)
                check(out.get("status") == "ok", f"TP warm-up: {out}")
            bucket *= 2
        steady = run_load(client, T["requests"], T["concurrency"],
                          make_prompt, journal_path=f"{root}/steady.jsonl",
                          decode=True)
        kill: dict = {}

        def publisher() -> None:
            time.sleep(0.3)
            publish_step(steps[-1])

        def killer() -> None:
            time.sleep(0.6)
            with open(f"{trial}/worker1/group.json") as f:
                pid = int(json.load(f)["pids"]["1"])
            os.kill(pid, signal.SIGKILL)
            kill.update(pid=pid, at_s=round(time.time() - t0, 3))

        threads = [threading.Thread(target=fn, daemon=True)
                   for fn in (publisher, killer)]
        for th in threads:
            th.start()
        swap = run_load(client, 2 * T["requests"], T["concurrency"],
                        make_prompt, journal_path=f"{root}/swap.jsonl",
                        decode=True, first_id=T["requests"])
        for th in threads:
            th.join(timeout=30)
        wait_for(lambda: "group_restart" in actions(1), 120,
                 "group 1's unit restart")
        wait_for(lambda: os.path.exists(f"{trial}/worker1/serve.json"),
                 T["boot_timeout_s"], "the restarted group 1's endpoint")
        with open(f"{trial}/worker1/serve.json") as f:
            ep = json.load(f)
        confirm = ServeClient([(ep["host"], int(ep["port"]))],
                              deadline_s=120.0, max_attempts=2).generate(
            [1, 2, 3], max_tokens=2)
        t_restart = time.time() - t0
    finally:
        for p in sups.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in sups.values():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
    fault = [{"event": "fault", "action": "kill_worker", "worker": 1,
              "ts": time.time()}]
    violations, applicable, _, decode_applicable = check_serving(
        trial, {"serve_workers": list(T["groups"])}, fault)
    group_violations, group_applicable = check_serve_group(trial)
    acts = actions(1)
    i_exit = acts.index("rank_exit") if "rank_exit" in acts else -1
    verified = {k: [(r["step"], r["digest"][:12]) for r in load_jsonl(
        f"{trial}/worker{k}/rank1/serve_log.jsonl")
        if r.get("action") == "shard_verify"] for k in T["groups"]}
    swaps = {k: [r["step"] for r in load_jsonl(
        f"{trial}/worker{k}/serve_log.jsonl")
        if r.get("action") == "weight_swap" and not r.get("initial")]
        for k in T["groups"]}
    ranks = {k: _tp_rank_lines(f"{trial}/worker{k}") for k in T["groups"]}
    compiles = {k: [{"device": r.get("device"), "source": r.get("source"),
                     "reason": r.get("reason"),
                     "bitwise_vs_eager": r.get("bitwise_vs_eager")}
                    for d in (f"{trial}/worker{k}", f"{trial}/worker{k}/rank1")
                    for r in load_jsonl(f"{d}/train_log.jsonl", "compile")]
                for k in T["groups"]}
    steps_all = sum(r["decode_steps"] for rs in ranks.values() for r in rs)
    staged = {
        "all_reduces_per_decode_step": sum(
            r["decode_all_reduces_staged"] for rs in ranks.values()
            for r in rs) / max(steps_all, 1),
        "broadcasts_per_decode_step": sum(
            r["decode_broadcasts"] for rs in ranks.values() for r in rs)
        / max(steps_all, 1)}
    rec = {"card": nvidia_smi(),
           "backend": sorted({r.get("backend") for rs in ranks.values()
                              for r in rs}),
           "steps": steps[-2:], "ready_s": round(t_ready, 1),
           "restart_ready_s": round(t_restart, 1),
           "steady": {k: steady.get(k) for k in (
               "responses", "dropped", "errors", "retried",
               "tokens_per_sec", "latency_ms", "ttft_ms",
               "inter_token_ms")},
           "swap_sweep": {k: swap.get(k) for k in (
               "responses", "dropped", "errors", "retried",
               "tokens_per_sec", "latency_ms", "ttft_ms",
               "inter_token_ms")},
           "kill": kill, "group1_actions": acts,
           "confirm": confirm.get("status"), "swaps": swaps,
           "shard_verify": verified, "staged": staged,
           "ranks": {k: [{key: r.get(key) for key in (
               "tp_rank", "device", "launches", "kernel_cache",
               "decode_steps", "decode_all_reduces_staged",
               "decode_broadcasts", "blocked_s", "boot_s")} for r in rs]
               for k, rs in ranks.items()},
           "compile": compiles,
           "invariants": {"serving": [str(v) for v in violations],
                          "serve_group": [str(v) for v in
                                          group_violations]},
           "seconds": round(time.time() - t0, 1)}
    emit({"phase": "serving_chaos_tp", **rec})
    for name, sweep, n in (("steady", steady, T["requests"]),
                           ("swap", swap, 2 * T["requests"])):
        check(sweep["dropped"] == 0 and sweep["errors"] == 0
              and sweep["responses"] == n,
              f"TP {name} sweep: {rec[name if name == 'steady' else 'swap_sweep']}")
    check("pid" in kill, f"TP arm: the kill did not land: {kill}")
    check(i_exit >= 0 and acts[i_exit:i_exit + 3] == [
        "rank_exit", "group_down", "group_restart"]
          and acts.count("group_start") >= 2,
          f"group 1's journal: {acts}")
    check(confirm.get("status") == "ok",
          f"the restarted group does not serve: {confirm}")
    check(applicable and decode_applicable and not violations,
          f"TP serving invariants: {rec['invariants']}")
    check(group_applicable and not group_violations,
          f"serve_group: {rec['invariants']}")
    check(len(swaps[2]) >= 1, f"no swap on the surviving group: {swaps}")
    check(all(verified[k] for k in T["groups"]),
          f"followers' shard_verify: {verified}")
    import torch
    cards = torch.cuda.device_count()
    for k, rs in ranks.items():
        # rank r on cuda:(r mod cards); over NCCL every decode step
        # captured and held bitwise to its eager step, over gloo eager
        check(len(rs) == T["ranks"] and all(
            r["device"] == f"cuda:{r['tp_rank'] % cards}"
            and r["launches"]["K1"] > 0 and r["launches"]["K5"] > 0
            and r["kernel_cache"]["misses"] == 0 for r in rs),
              f"group {k}'s ranks: {rec['ranks'][k]}")
        check(compiles[k] and all(
            c["device"].startswith("cuda:")
            and ((c["source"], c["bitwise_vs_eager"]) == ("cuda_graph", True)
                 if rec["backend"] == ["nccl"] else
                 c["source"] == "eager" and "gloo" in c["reason"])
            for c in compiles[k]), f"group {k}'s decode steps: "
              f"{compiles[k]}")
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": {key: [r["launches"][key] for k in T["groups"]
                               for r in ranks[k]] for key in ("K1", "K5")},
            "tokens_per_sec": swap.get("tokens_per_sec"),
            "staged": staged, "backend": rec["backend"],
            "seconds": rec["seconds"]}


# the resource broker's trial (≙ the reference's `cluster chaos --payload
# serving` with broker=true; launch/broker.py): serving_chaos's flash
# publisher (the same seed, steps and saves, so the campaign takes that
# phase's fault-free reference run) with one decode replica, one donor
# trainer on the publisher's payload and one serving spare parked on the
# card; no faults: a seeded trace of a trough at concurrency 1, a peak at
# twice the replica's slots, and a final trough to the trial's end. The
# publisher's decode.num_blocks holds exactly decode_slots sequences
# (admission reserves prompt + max_new_tokens), so the heartbeats'
# kv_free_frac follows the live sequences: 0.75 in a trough (one live),
# 0 at the peak. Only the KV marks can be crossed: every other mark sits
# where no value of the trial reaches it either way (latencies and TTFT
# are capped by the client's deadline and retries far below 1e6 ms;
# reject and queue fractions are at most 1)
BROKER = {"name": "broker", "payload": "serving", "serve_decode": True,
          "serve_replicas": 1, "broker": True, "broker_train_workers": 2,
          "broker_standbys": 1, "max_faults": 0, "min_faults": 0,
          "trials": 1, "shrink": False, "broker_phases": 2,
          "broker_low_concurrency": 1, "broker_phase_secs": 4.0,
          "broker_window_s": 2.0, "trial_timeout_s": 420.0,
          **{k: SERVING_CHAOS[k] for k in ("seed", "until_step",
                                           "save_interval_steps")}}
BROKER_MARKS = {"window_s": 2.0, "cooldown_s": 1.5,
                "kv_free_low": 0.4, "kv_free_high": 0.6,
                "p99_high_ms": 2e6, "p99_low_ms": 1e6,
                "ttft_high_ms": 2e6, "ttft_low_ms": 1e6,
                "reject_high": 2.0, "reject_low": 1.0,
                "queue_high": 2.0, "queue_low": 1.0,
                "min_serve_replicas": 1, "max_serve_replicas": 2,
                "min_train_workers": 1, "max_train_workers": 2,
                "settle_timeout_s": 60.0}
# the plan's margins: the trial must outlast the trace's end, the
# cooldown, two windows and the grown trainer's first log record by
# BROKER_MARGIN; a replica serves REPLICA_READY_S after the first publish
BROKER_MARGIN = 1.5
BROKER_REPLICA_READY_S = 3.0


def _broker_plan(boot_s: float, cfg) -> dict:
    """The publisher's pace that makes the paced trial outlast, by
    ``BROKER_MARGIN``, the trace's end (the first publish at step
    ``save_interval_steps``, a replica ready, each leg at its longest
    jitter), plus the cooldown, two windows and the grown trainer's
    spawn → first ``train_log.jsonl`` record, taken as the publisher's
    measured boot (the same payload; ``_train_live_at`` reads that
    file's mtime). Every time is from the trial's start."""
    steps, save = cfg.until_step, cfg.save_interval_steps
    trace = BROKER_REPLICA_READY_S + 1.2 * cfg.broker_phase_secs \
        * cfg.broker_phases
    tail = BROKER_MARKS["cooldown_s"] + 2 * BROKER_MARKS["window_s"] + boot_s
    # boot + steps·P >= MARGIN·(boot + save·P + trace + tail)
    pace = ((BROKER_MARGIN * (boot_s + trace + tail) - boot_s)
            / (steps - BROKER_MARGIN * save))
    pace_ms = math.floor(pace * 100) * 10.0 + 10.0  # up, past any rounding
    first_publish = boot_s + save * pace_ms / 1e3
    must_outlast = first_publish + trace + tail
    return {"boot_s": boot_s, "grown_trainer_life_s": boot_s,
            "pace_ms": pace_ms, "first_publish_s": first_publish,
            "trace_end_s": first_publish + trace,
            "cooldown_s": BROKER_MARKS["cooldown_s"],
            "window_s": BROKER_MARKS["window_s"],
            "must_outlast_s": must_outlast,
            "trial_s": boot_s + steps * pace_ms / 1e3,
            "margin": (boot_s + steps * pace_ms / 1e3) / must_outlast}


def _broker_campaign(cfg, reference: str, pace_ms: float, blocks: int):
    """The brokered campaign: its reference run is serving_chaos's (the
    same publisher), its trial's publisher and donor run the flash
    payload at the planned pace with ``decode.num_blocks=blocks``, the
    shared kernel cache is seeded from ``build``, and its broker records
    every tick that reaches ``decide``: the arguments and the decision
    taken (``ticks``)."""
    import shutil

    from distributedmnist_tpu_torch.core.config import BrokerConfig
    from distributedmnist_tpu_torch.launch.broker import ResourceBroker
    from distributedmnist_tpu_torch.launch.chaos import ChaosCampaign

    class ReplayedBroker(ResourceBroker):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ticks: list = []

        def read_signals(self, workers, progress, now):
            # tick calls this once a decide call, just before it
            sig = super().read_signals(workers, progress, now)
            serve, train = self._roles(workers)
            self.ticks.append({"serve_n": len(serve), "train_n": len(train),
                               "signals": dict(sig),
                               "last_change_t": self._last_change_t,
                               "now": now, "decision": None})
            return sig

        def execute(self, d, serve_ids, train_ids, now):
            self.ticks[-1]["decision"] = list(dataclasses.astuple(d))
            return super().execute(d, serve_ids, train_ids, now)

    class BrokerCampaign(ChaosCampaign):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.brokers: list = []
            self.seeded: list = []

        def _make_broker(self, sup, lcfg):
            b = ReplayedBroker(
                sup, BrokerConfig(**self.cfg.broker_config),
                serve_command=self.cfg.resolved_serve_command(),
                loadgen_journal=lcfg.root / "loadgen.jsonl",
                warm_standbys=self.cfg.broker_standbys)
            self.brokers.append(b)
            return b

        def _run_trial(self, rel, plan, seed, num_workers,
                       measured_boot_s=None, serving=False):
            if rel == "reference":
                self.seeded[:] = _seed_kernel_cache(
                    self.cfg.root / "compile_cache")
                shutil.copytree(reference, self.cfg.root / "reference",
                                symlinks=True)
                with open(self.cfg.root / "reference/outcome.json") as f:
                    return json.load(f)
            self.cfg = dataclasses.replace(
                self.cfg, train_command=_flash_payload(
                    self.cfg.until_step, pace_ms,
                    save=self.cfg.save_interval_steps, profile=False)
                + f" decode.attention_kernel=paged decode.num_blocks={blocks}")
            return super()._run_trial(rel, plan, seed, num_workers,
                                      measured_boot_s=measured_boot_s,
                                      serving=serving)

    return BrokerCampaign(cfg)


def _in_flight(loadgen: list):
    """The requests the load generator had issued and not yet ended, as
    a function of time (its journal's issue and outcome records), and
    the times at which that count changed."""
    import bisect
    import itertools
    events = sorted((r["time"], 1 if r["action"] == "issue" else -1)
                    for r in loadgen)
    times = [t for t, _ in events]
    level = list(itertools.accumulate(d for _, d in events))

    def at(t: float) -> int:
        i = bisect.bisect_right(times, t)
        return level[i - 1] if i else 0

    return at, list(zip(times, level))


def phase_broker(tmp: str, serving: dict) -> dict:
    """The brokered serving trial on the card: the decisions the trace
    calls for, each licensed by the KV pool, the scale-up promoted from
    the parked spare, the scale-back grown from the seeded checkpoint,
    and every recorded ``decide`` call replayed bitwise."""
    from distributedmnist_tpu_torch.core.config import (BrokerConfig,
                                                        DecodeConfig)
    from distributedmnist_tpu_torch.launch.broker import (SCALE_DOWN,
                                                          SCALE_UP, decide)
    from distributedmnist_tpu_torch.launch.chaos import ChaosConfig
    from distributedmnist_tpu_torch.obsv.report import load_jsonl
    import glob
    t0 = time.time()
    bcfg = BrokerConfig(**BROKER_MARKS)
    bcfg.validate()
    base = ChaosConfig(**BROKER)
    per_seq = -(-(base.decode_max_prompt_len + base.decode_max_new_tokens)
                // DecodeConfig().block_size)
    blocks = 1 + base.decode_slots * per_seq
    cfg = dataclasses.replace(
        base, workdir=f"{tmp}/broker", broker_config=dict(BROKER_MARKS),
        broker_high_concurrency=2 * base.decode_slots)
    reference = f"{serving['root']}/reference"
    with open(f"{reference}/outcome.json") as f:
        boot = json.load(f)["boot_s"]
    plan = _broker_plan(boot, cfg)
    emit({"phase": "broker_plan", "num_blocks": blocks,
          "high_concurrency": cfg.broker_high_concurrency,
          "marks": BROKER_MARKS, **plan})
    check(plan["margin"] >= BROKER_MARGIN, f"trial plan: {plan}")
    trial_dir = f"{cfg.root}/trial000"
    reset_counts()
    campaign = _broker_campaign(cfg, reference, plan["pace_ms"], blocks)
    summary = campaign.run()
    parent = read_counts()
    with open(summary["report_path"]) as f:
        report = [json.loads(line) for line in f]
    with open(f"{trial_dir}/outcome.json") as f:
        outcome = json.load(f)
    journal = load_jsonl(f"{trial_dir}/command_journal.jsonl")
    auto = [r for r in journal if r.get("event") == "autoscale"]
    begins = [r for r in auto if r["action"] == "begin"]
    completes = [r for r in auto if r["action"] == "complete"]
    loadgen = [r for r in load_jsonl(f"{trial_dir}/loadgen.jsonl", "load")
               if r.get("action") in ("issue", "outcome")]
    flight, levels = _in_flight(loadgen)
    peak_times = [t for t, n in levels if n > cfg.broker_low_concurrency]
    at = {r["decision"]: r for r in begins}
    in_flight = {d: flight(r["time"]) for d, r in at.items()}
    up = next((r for r in completes if r["decision"] == SCALE_UP), {})
    down = next((r for r in completes if r["decision"] == SCALE_DOWN), {})
    promoted = [r for r in journal if r.get("action") == "promote_standby"]
    serve_workers = outcome.get("serve_workers") or []
    replicas = _replica_evidence(trial_dir, serve_workers)
    launches = {key: sum(p["launches"][key] for r in replicas.values()
                         for p in r["processes"]) for key in ("K1", "K5")}
    new_replica = replicas.get(up.get("worker"), {})
    answered = sum(r.get("action") == "decode_finish" for r in load_jsonl(
        f"{trial_dir}/worker{up.get('worker')}/serve_log.jsonl"))
    grown_steps = [r["step"] for r in load_jsonl(
        f"{trial_dir}/worker{down.get('worker')}/train_log.jsonl", "step")]
    ready = {}
    for path in sorted(glob.glob(f"{trial_dir}/standby*/*.ready")):
        with open(path) as f:
            ready[path.split("/")[-2]] = json.load(f).get("warm_s")
    replayed = []
    for b in campaign.brokers:
        for tk in b.ticks:
            d = decide(b.cfg, tk["serve_n"], tk["train_n"], tk["signals"],
                       tk["last_change_t"], tk["now"])
            got = None if d is None else list(dataclasses.astuple(d))
            replayed.append(_exact(got) == _exact(tk["decision"]))
    rec = {"phase": "broker", "card": nvidia_smi(), "plan": plan,
           "all_green": summary["all_green"],
           "invariants": {k: summary["invariants"][k] for k in (
               "autoscale", "serve_outcomes", "serve_digest",
               "serve_monotone", "determinism")},
           "serving": report[0]["serving"], "autoscale": report[0].get(
               "autoscale"), "load_phases": outcome.get("load_phases"),
           "begins": [{k: r.get(k) for k in (
               "decision", "trigger", "value", "threshold", "op",
               "old_serve", "new_serve", "old_train", "new_train",
               "time")} for r in begins],
           "completes": [{k: r.get(k) for k in (
               "decision", "worker", "dropped", "reaction_s", "serve",
               "train")} for r in completes],
           "in_flight_at_begin": in_flight,
           "peak": [peak_times[0], peak_times[-1]] if peak_times else None,
           "reaction_s": up.get("reaction_s"), "promoted": promoted,
           "spare_warm_s": ready, "serve_workers": serve_workers,
           "new_replica": {"worker": up.get("worker"),
                           "answered": answered, **new_replica},
           "grown_trainer": {"worker": down.get("worker"),
                             "first_steps": grown_steps[:3]},
           "decide_calls": len(replayed),
           "decide_replayed_bitwise": all(replayed) and bool(replayed),
           "trial": {k: report[0][k] for k in ("outcome", "duration_s",
                                               "boot_s")},
           "kernel_cache_seeded": campaign.seeded, "launches": launches,
           "parent_launches": parent, "seconds": time.time() - t0}
    emit(rec)
    check(summary["all_green"], f"broker trial not all green: "
          f"{summary['failing_trials']}")
    for name, v in rec["invariants"].items():
        check(v["pass"] == 1, f"invariant {name}: {v}")
    sv = summary["serving"]
    check(sv["issued"] > 0 and sv["dropped"] == 0,
          f"issued {sv['issued']}, dropped {sv['dropped']}")
    check(rec["decide_replayed_bitwise"],
          f"decide replayed over {len(replayed)} ticks: {replayed}")
    check([r["decision"] for r in begins] == [SCALE_UP, SCALE_DOWN]
          and [r["decision"] for r in completes] == [SCALE_UP, SCALE_DOWN]
          and len(auto) == 4, f"autoscale records: {auto}")
    check(at[SCALE_UP]["trigger"] == "kv_free_frac"
          and peak_times
          and peak_times[0] <= at[SCALE_UP]["time"] <= peak_times[-1]
          and in_flight[SCALE_UP] > cfg.broker_low_concurrency,
          f"scale-up not licensed by the KV pool during the peak: "
          f"{rec['begins']}, peak {rec['peak']}, in flight {in_flight}")
    check(at[SCALE_DOWN]["time"] > peak_times[-1]
          and in_flight[SCALE_DOWN] <= cfg.broker_low_concurrency,
          f"scale-down not in the final trough: {rec['begins']}, "
          f"peak {rec['peak']}, in flight {in_flight}")
    check([p.get("worker") for p in promoted][:1] == [up.get("worker")],
          f"the scale-up slot was not promoted from the spare: {promoted}")
    check(new_replica.get("compile") and all(
        c["device"] == "cuda:0" and c["source"] == "cuda_graph"
        and c["cache"]["misses"] == 0 for c in new_replica["compile"])
        and answered > 0, f"new replica: {rec['new_replica']}")
    check(grown_steps and grown_steps[0] > cfg.save_interval_steps
          and (grown_steps[0] - 1) % cfg.save_interval_steps == 0,
          f"grown trainer did not resume a seeded checkpoint: "
          f"{rec['grown_trainer']}")
    check(launches["K1"] > 0 and launches["K5"] > 0,
          f"brokered replicas' K1/K5 launches: {launches}")
    check(all(v == 0 for v in parent.values()),
          f"this process launched kernels: {parent}")
    return rec


def _exact(x):
    """A decision with every float spelled exactly (``float.hex``)."""
    if isinstance(x, float):
        return x.hex()
    if isinstance(x, (list, tuple)):
        return [_exact(v) for v in x]
    return x


KERNELS = (
    ("K1", "flash_attention_fwd", "flash_attention_fwd.cu", "54", "e2e"),
    ("K1-lse", "flash_attention_fwd_lse", "flash_attention_fwd.cu", "54",
     "train"),
    ("K2", "flash_attention_bwd_dq", "flash_attention_bwd.cu", "296",
     "train"),
    ("K3", "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "327",
     "train"),
    ("K4", "flash_attention_bwd_fused", "flash_attention_bwd.cu", "368",
     "train_k4"),
    ("K5", "paged_attention", "paged_attention.cu", None, "e2e"))


def _k5_in_place(profile: dict) -> dict:
    """K5's device ms a launch inside the decode-step profile, beside its
    bound for the profile's lengths (all slots live)."""
    t, _ = _k5_bound(profile["lengths"], 2, 2)
    busy = profile["busy_ms_by_class"]["paged_attention"]
    return {"ms_in_place": busy / MODEL["num_layers"] if busy > 0
            else "not measured", "bound_ms_in_place": t * 1e3}


def main() -> int:
    """The phases and the result lines; whatever the way out, every
    process still running below the script is stopped first."""
    now = {"phase": "env"}
    timer = guard_processes(lambda: now["phase"])
    try:
        return _main(now)
    finally:
        timer.cancel()
        stopped = stop_descendants()
        if stopped:
            print(json.dumps({"stopped_at_exit": stopped}), file=sys.stderr,
                  flush=True)


def _main(now: dict) -> int:
    runs = {}
    took = {}
    t_start = time.time()

    def run(name, fn, *args):
        now["phase"] = name
        t0 = time.time()
        try:
            runs[name] = fn(*args)
        except BaseException:
            now["phase"] = name  # a phase beside it may have renamed it
            raise
        took[name] = round(time.time() - t0, 1)
        return runs[name]

    def run_beside(side: tuple, main: tuple) -> None:
        """``side``'s phase in a thread beside ``main``'s; each is timed
        on its own."""
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            other = pool.submit(run, *side)
            run(*main)
            other.result()

    try:
        env = run("env", phase_env)
        resources = run("build", phase_build)
        timed = run("kernels", phase_kernels)
        with tempfile.TemporaryDirectory(prefix="dmt_smoke_",
                                         ignore_cleanup_errors=True) as tmp:
            OWN_DIRS.append(tmp)
            fixture = start_cifar_fixture(tmp)
            train = run("train", phase_train, tmp)
            run("train_k4", phase_train_k4, tmp)
            run("train_replicas", phase_train_replicas, tmp,
                train["ms_per_step"])
            run("long_context", phase_long_context, tmp)
            run("report", phase_report, tmp)
            run("cnn", phase_cnn, tmp)
            run("dist", phase_dist, tmp)
            run("model_parallel", phase_model_parallel, tmp)
            e2e = run("e2e", phase_e2e, train["train_dir"], tmp)
            run("ckpt", phase_ckpt, tmp)
            run("eval", phase_eval, tmp, runs["ckpt"])
            run("fixture", wait_cifar_fixture, fixture)
            run("campaign", phase_campaign, tmp)
            run("serve", phase_serve, tmp, runs["ckpt"])
            run("graphs", phase_graphs, tmp, train["train_dir"])
            # resnet beside the chaos campaigns: its checks are counts,
            # bits and finite losses (its times are a record), theirs
            # are their workers', and neither launches a flash or paged
            # kernel in this process
            run_beside(("resnet", phase_resnet, tmp),
                       ("cluster", phase_cluster, tmp))
            run("restart", phase_restart, tmp)
            run("serving_chaos", phase_serving_chaos, tmp)
            run("broker", phase_broker, tmp, runs["serving_chaos"])
    except Exception as e:  # report the failing phase, then fail
        emit({"phase": now["phase"], "ok": False,
              "error": f"{type(e).__name__}: {e}",
              "traceback": traceback.format_exc()[-4000:]})
        return 1
    import torch
    launches = {"e2e": {"K1": e2e["k1_launches"], "K5": e2e["k5_launches"]},
                "train": runs["train"]["launches"],
                "train_k4": runs["train_k4"]["launches"]}
    rows = []
    k5_in_place = _k5_in_place(e2e["decode_step_profile"])
    serve = runs["serve"]
    serve_launches = {key: {f"decode_{p}": serve["decode_swaps"][p][k]
                            for p in ("pin", "restart")}
                      for key, k in (("K1", "k1_launches"),
                                     ("K5", "k5_launches"))}
    serve_launches["K1"]["lm_one_shot"] = serve["lm_one_shot"]["k1_launches"]
    for key, name, src, line, path in KERNELS:
        c = timed[key]
        chaos = runs["serving_chaos"]["launches"]
        brokered = runs["broker"]["launches"]
        tp = runs["serving_chaos"]["tp"]["launches"]
        extra = ({**k5_in_place, "ms_cold": c["ms_cold"],
                  "launches_serve": serve_launches["K5"],
                  "launches_serving_chaos": chaos["K5"],
                  "launches_tp_serving": tp["K5"],
                  "launches_broker": brokered["K5"]} if key == "K5"
                 else {"launches_eval": runs["eval"]["k1_launches"],
                       "launches_serve": serve_launches["K1"],
                       "launches_serving_chaos": chaos["K1"],
                       "launches_tp_serving": tp["K1"],
                       "launches_broker": brokered["K1"]}
                 if key == "K1" else {})
        if key in ("K1", "K5"):
            # at a 2-rank TP serving group's share of the heads
            extra["tp_serving_shapes"] = c["tp_serving_shapes"]
        if key in ("K1", "K1-lse", "K2", "K3"):
            extra["launches_campaign"] = runs["campaign"][
                "launches_extras"][key]
            # each worker process's count, by arm (4 processes an arm)
            extra["launches_model_parallel"] = {
                arm: [c[key] for c in a["launches_by_rank"]]
                for arm, a in runs["model_parallel"]["arms"].items()}
        if key in ("K1-lse", "K2", "K3"):
            extra = {**extra, "launches_replicas":
                         runs["train_replicas"]["launches"][key],
                     "launches_long_context": {
                         arm: a["launches"][key] for arm, a in
                         runs["long_context"]["arms"].items()},
                     "long_context": c["long_context"],
                     "launches_cluster_a_step": {
                         w: t[key] for w, t in runs["cluster"]["flash"]
                         ["launches_a_step_from_trace"].items()}}
        replaces = ("distributedmnist_tpu/ops/pallas_paged_attention.py:62"
                    if line is None else
                    f"distributedmnist_tpu/ops/pallas_attention.py:{line}")
        rows.append({"name": name, "route": "cuda",
                     "source": f"distributedmnist_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches[path][key],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"], **extra,
                     **resources[key]})
    emit({"phase": "seconds", **took,
          "script": round(time.time() - t_start, 1)})
    emit({"kernels": rows})
    print(env["nvidia_smi"] or "nvidia-smi: not available", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
