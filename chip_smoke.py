#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. build  — compile every CUDA kernel from src/repro_torch/csrc with nvcc,
   all sources in parallel; print the build time and ptxas's register /
   spill report, and the count of HGMMA (wgmma) instructions in the flash
   library's SASS and of HMMA/HGMMA (tensor-core) instructions in the scan
   library's (cuobjdump -sass); neither may be 0.
2. kernels — run each kernel's wrapper on bf16 tensors on the card, at the
   shapes the serving path gives it and at larger ones (flash at S 8-2048
   and at D 128; decode at s_max 512 and S 4096), and hold it to its
   plain PyTorch version on the same inputs (|err| <= 3e-2 + 3e-2 * |want|,
   tests/test_kernels.py's bf16 tolerance).  Print per case the max error,
   the kernel's time (CUDA events around 20 wrapper calls, so it holds the
   wrapper's host cost) and its device time (torch.profiler: every kernel
   a call launches, summed), the plain version's time, the least time the
   card could take (bound: bytes at 3.35 TB/s or FLOPs at 989 TFLOP/s
   bf16, whichever is larger, counted for this run's inputs) and the event
   and device time of one PyTorch library call of the same function
   (scaled_dot_product_attention: with is_causal, on its flash backend, for
   flash without a window, and with an explicit mask where there is a
   window or a decode row's pos; timed as a yardstick only, the port never
   calls it).  A device time must hold every kernel of every timed call:
   where three profiles in a row lose records (the profiler's CUPTI
   tracing, not the port, at fault) it reads "not measured" (null in the
   JSON line), says why on stderr, and the run goes on on event times.
3. serve  — Session.serve() of full-width granite-3-2b (40 layers, random
   weights from seed 0): 8 requests, n_new 32, s_max 512, max_batch 4, on
   the hand-written kernels.  The kernels' launch counters are zeroed just
   before and read just after: flash launches must equal prefills x 40 and
   decode launches engine steps x 40.  Every request must return its n_new
   tokens and no logits row may hold a NaN or inf.  The report must pass
   the port's validate_report; it prints the replica lemma's prediction
   (t_step, t_service, replicas; priced on the H100 SXM's 3.35 TB/s)
   beside the measured t_step, t_prefill and t_service.
4. reference — one full-width prefill and one decode step with the
   kernels against the plain dense path on the same weights and prompt.
5. paged and scan kernels — the paged decode kernel on the tuning shape
   and on PagedKVCache pools of full-width granite-3-2b (40 layers, KV 8,
   D 64, kv_block 16; ragged rows, non-contiguous tables from admissions
   and releases, a strided layer view; s_max 512, and S = 4096 without and
   with window and cap): bitwise equal to the linear decode kernel on the
   gathered cache and within the bf16 tolerance of the plain version.  The SSD scan
   kernels at the tuning shapes (chunks 32/64/128) and at mamba2-780m width
   (H 48, P 64, N 128: L 2048 at chunk 256, one chunk of L = 192 < 256, and
   a ragged chunk of 20 at L 2000) against ref.ssd_scan_ref (y at the bf16
   tolerance, the fp32 state at 1e-3).  Times as in phase 2, the scan's
   device time holding every pass it launches (ssd_kernels); at L 2048 also
   each pass's device time and models.ssm.ssd_chunked in bf16 on the same
   inputs (what impl="auto" runs), whose device time the kernels must beat
   (their event time, where the profiler did not measure both).
   The paged kernel's library yardstick is gather_kv_blocks followed by
   SDPA, timed together; the scan has no single PyTorch call (null).
5b. the fp32 training attention — flash_attention_train's three kernels
   (forward, dQ, dK/dV) at both granite training cells' shapes (B 2, S
   4096 and B 4, S 512; H 32, KV 8, D 64) and at D 128 (B 1, S 2048, H 56,
   KV 8): output and the three gradients held to fp32 dense_attention
   under autograd (within 1e-4 of the largest |reference|), each entry's
   device time (one kernel a call) beside its bound (its products at the
   67 TFLOP/s fp32 peak), the forward and backward's event and device
   time, and beside them the event time of the same forward and backward
   through chunked_attention, dense_attention (where its S x S logits fit)
   and, as a yardstick only, fp32 SDPA (is_causal, enable_gqa).
6. mamba layer — one full-width mamba2-780m ssm_forward layer (random
   weights from seed 0, x (1, 2048, 1536) bf16) with impl="kernel" against
   impl="auto" on the same values in fp32, at tests/test_kernels.py's bf16
   SSD tolerance; the scan kernel's launch counter must move by one.  Then
   the layer's event and device time in bf16 with impl="kernel" and with
   impl="auto".
7. tune — the kernel-choice stage of the paper's procedure:
   bench_kernels(device="cuda") at the JAX package's defaults (seq 128,
   repeats 2, scan chunks 32/64/128), with all four launch counters zeroed
   just before and read just after (each must be (1 + repeats) x its
   kernel variants); no kernel variant may be in ``errors``, and each is
   held to its plain variant on the same inputs.  Then host_microbench()
   and choose_conv_algs(128, the card's memory).

8. train — the training path, which launches none of the four serving
   kernels and, on the card in fp32, the training attention (every
   counter zeroed before; after, exactly 8.2's forward and recompute of
   its two layers, 4 forward launches, 2 dK/dV and 2 dQ, and nothing
   else: the bf16 runs take the chunked and dense paths):
   Session.train() of full-width granite-3-2b (40 layers, random weights
   from seed 0; batch 4 x seq 512, 4 steps, RunConfig(attn_impl="auto",
   remat="block"), AdamW with warmup 1 on fp32 masters held on the card):
   every loss finite; it prints tokens/s, the step phases, R_O,
   torch.cuda.max_memory_allocated() and the wall time.  The same 4 steps
   from weights with smoothed attention (as phase 4): every loss finite,
   the last below the first (at JAX's init the 40-layer model does not
   learn in 4 steps: PERF.md).
   Then one train step of a 2-layer full-width model in fp32 (TF32 off)
   on the card against the same step on the CPU (loss, grad_norm, every
   gradient and the updated params within 2e-4 + 2e-4 * max |want|, but
   where the clipped gradient is below 100 * eps: there AdamW's first
   step turns on ~1e-8 of rounding, and the limit is 2 * lr + 2e-4), and the
   DataParallelTrainer with all_reduce over NCCL at dp = 1 (4 layers, 3
   steps) against the loop from the same params (same limit), with its
   SyncReport.  Both use attention-smoothed weights (as phase 4).
9. processes and overlap — no kernel launches either: (1) the one-rank
   DataParallelTrainer (rank 0 of 1, over NCCL on a TCPStore in this
   process: what each torchrun process builds) from phase 8's params and
   seed, 3 steps, bitwise equal to phase 8's threaded dp = 1 trainer; (2)
   the training launcher under torchrun --standalone --nproc-per-node 1
   (granite-3-2b reduced, --dp 1, 3 steps) as a child with a 300 s limit:
   it must exit 0 with a report that holds a sync section; (3) the
   overlapped trainer (2 serial-bucketed calibration steps, 2 fused) at
   full width and 4 layers, 4 steps, bitwise equal to the serial trainer;
   it prints the buckets, the overlap fraction, exposed against serial
   comm and the SyncReport priced on the H100 node's NVLink tier.
10. checkpoint and async PS — no kernel launches either (counters zeroed
   before, 0 after), phase 9's model (full width, 4 layers, 1.38 GB of
   fp32 params, ~4.1 GB a checkpoint with AdamW's moments), written into a
   temporary directory under build/ that the phase deletes: (1) the loop,
   4 steps uninterrupted, then 2 steps with ckpt_every=2 and a resume to
   4: the resumed losses within 1e-6 of the uninterrupted ones (it prints
   whether they are bitwise equal), with the bytes on disk, the enqueue
   (device-to-host) time, the writer's time and the restore time from the
   loop's ckpt_* spans; (2) a checkpoint written by the one-rank dp = 1
   trainer (NCCL on a TCPStore) restores into the loop, which continues to
   the loop's own losses (1e-6); (3) the one-rank AsyncPSTrainer at
   staleness 0, bitwise equal to the one-rank parameter_server trainer
   over 3 steps, and at staleness 2 over 4 steps, whose report must read
   max_age 2; it prints the async report priced on the NVLink tier.
11. plan — the paper's planner, no kernel launches either (counters zeroed
   before, 0 after): (1) Session.plan() and dryrun() of full granite-3-2b
   on mesh "single" (h100-8) and "multi" (h100-2x8): both reports valid,
   priced on "h100-sxm"; it prints microbatch, attention, remat, sync
   schedule, N_ps, the estimated step and memory and whether it fits;
   (2) Session.train() with use_planner=True at full width (40 layers),
   batch 4 x seq 512, 4 steps, with the plan's attention, remat and
   microbatch (the plan's own shape, 32 x 4096 a card, is
   benchmarks/torch_plan_check.py's): every loss finite, the report valid
   with predicted.lemma31.source "measured"; it prints tokens/s, R_O and
   max_memory_allocated() beside the plan's estimates; (3) the one-rank
   DataParallelTrainer.from_plan at dp = 1 (4 layers, NCCL on a
   TCPStore, the planned run, 3 steps), bitwise equal to the one-rank
   trainer built with the plan's schedule by name.
12. tune — the paper's closed loop through Session.tune(), the one path of
   the system's entry points that runs all four kernels.  Each step zeroes
   the four launch counters before and reads them after.  (1)
   Session(JobSpec(granite-3-2b, reduced=False, batch 2, seq 512, tune,
   tune_steps 3, a calibration cache in a temporary directory under build/
   that the phase deletes)).tune() at full width (40 layers): the report
   valid; launches exactly B1 3, B2 3, B3 3, B4 9 (bench_kernels alone
   launches them: the measured training steps and the re-plan launch
   none); no kernel variant in errors, and each held to its plain variant
   as in phase 7; the chosen minibatch the m_bound edge and the chosen
   microbatch a fresh max_microbatch for the production job (train_4k on
   h100-8); replan.calibrated_closer true; the cache holding the key
   (backend/cluster/config).  It prints each op's pick and times, the
   achieved FLOP/s and its share of the data sheet, the triad bandwidth,
   the best measured step, the executed and production step estimates
   with and without calibration, max_memory_allocated() and each stage's
   span.  (2) A second session on the same cache: from_cache true, no
   measure span, the bench stage's 18 launches again.  (3) train() of the
   first session (2 steps) adopts the tuned attention and microbatch
   min(chosen, 2), carries the tuning section and launches no kernel.  (4)
   Session(JobSpec(granite-3-2b, train_4k), calibration=...).plan() is
   priced on "h100-sxm+cal"; it prints its est_step_time beside the data
   sheet's.
13. pipeline — 1F1B pipeline parallelism, no serving kernel launches; the
   fp32 13.2 runs the training attention, exactly 2 steps x 4 microbatches
   x 4 layers for each trainer: 160 forward (the 1F1B trainer's fwd op,
   its bwd op's recompute and block remat's inside it; the single-stage
   trainer's forward and recompute), 64 dK/dV, 64 dQ, and nothing else
   (counters zeroed before): (1)
   Session(JobSpec(granite-3-2b,
   reduced=False, pipe 2, n_microbatch 4, batch 4, seq 512, 3
   steps)).train() at full width (40 layers, 20 cycles a stage, both
   stages on this card, the session's own sync, auto attention and block
   remat): the report valid, every loss finite, bubble_model exactly
   (p-1)/(m+p-1) = 0.2; it prints each stage's fwd and bwd time per
   microbatch, the measured, model and serial bubble, the makespan, the
   steady step wall (the loop's step span) beside train/step_s (the op
   spans, sync and update), tokens/s and max_memory_allocated(); (2) the
   PipelineTrainer (pipe 2, 4 microbatches, both stages on cuda:0)
   against the DataParallelTrainer (dp 1, microbatch 1) at full width, 4
   layers, fp32, attention-smoothed weights, 2 steps: every param within
   2e-4 + 2e-4 * max |want|, or 2 * lr + 2e-4 where the root of AdamW's
   bias-corrected second moment is below 100 * eps (C5's bound; whether
   the params are bitwise equal is printed, not required); (3)
   host_microbench()'s triad (16 fused passes a timed call) at 32 and
   256 MiB an array, and one pass a call at 32 MiB, beside phase 12's
   calibrated hbm_bw.
14. MLA, MoE and the dense prelude — (1) Session.serve() (continuous, 4
   requests, n_new up to 16, s_max 512) of deepseek-v2-236b at full width
   with 2 layers (the dense prelude layer and one MLA + MoE cycle: 160
   experts, top-6, 2 shared; ~5.4e9 params), no kernel launched (MLA
   serves on "dense"): tokens/s, TTFT (the scheduler's first_token_s);
   then at fp32 on the same weights the engine's prefill logits against
   M.forward and one absorbed-latent decode step against the forward at
   that position, at 2e-4; (2) moe_mlp at deepseek-v2's widths, T = 4 x
   512, fp32: at capacity factor 8 (no drop) against moe_mlp_ref at 2e-4,
   at 1.25 the card's top-k indices and keep mask equal to the CPU's
   (router inputs on a grid where every sum is exact), output, aux and
   the gradients of x and the router bitwise equal across two runs; its
   bf16 time beside its bound; (3) Session.train() of minicpm3-4b at full
   width, 8 layers, 4 steps (losses, step time, max_memory_allocated),
   and one full-width layer's fp32 loss and gradients on the card against
   the CPU; (4) the same for an MoE step at deepseek-v2's widths with 16
   experts (the trainer keeps whole fp32 masters, gradients and AdamW
   state on one card; at 160 experts two layers need ~86 GB), the aux
   non-zero in the loss; (5) PipelineTrainer, pipe 2 on this card, on
   deepseek-v2's reduced config with 4 MLA/MoE cycles: params bitwise the
   single-stage trainer's; (6) Session.serve() of arctic-480b, one layer
   at full width with 16 experts: B1 launches once a prefill and B2 once
   an engine step, and both hold to their plain versions at arctic's
   shapes (H 56, KV 8, D 128), listed in the kernels line with those
   launches.  Every number carries the card's name and power limit.

15. campaigns — Session.sweep on the card: (1) kind "plan" over
   {topology: h100-8, h100-2x8} x {arch: granite-3-2b, mamba2-780m} x
   {batch: 4, 8}, once uncalibrated and once on phase 12's Calibration
   (priced on "h100-sxm+cal"): 8 reports each, every one valid, none
   skipped, a non-empty Pareto front; both fronts printed side by side;
   {"dp": [1, 3]} skips exactly one cell; (2) kind "train" at full width
   (40 layers), seq 512, 3 steps, over {"batch": [128, 2, 4]}: batch 128
   (the memory model's estimate above 80 GB) is the one skipped cell, with
   OutOfMemoryError; the other two train with finite losses and tokens/s
   > 0; no kernel launches; memory_allocated() after the sweep within
   1 GiB of before; (3) kind "serve" at full width, 8 requests, n_new 16,
   s_max 512, over {"max_batch": [2, 4]}: none skipped, flash launches =
   prefills x 40 and decode launches = engine steps x 40 summed over the
   cells; (4) every campaign's JSON read back by Campaign.from_json with
   the same pareto_indices.  It prints the phase's wall time.  Phase 13's
   triad check also holds phase 12's calibrated hbm_bw (timed at 256 MiB
   an array on a card) within 5% of the 256 MiB reading, the best of four
   0.5 s apart (C7).
16. the Mamba slot — (1) Session.serve() of full-width mamba2-780m (48
   layers, random weights from seed 0), continuous: 8 requests, n_new 32,
   s_max 512, max_batch 4; the counters zeroed just before and read just
   after: ssd_scan launches = prefills x 48 and no other kernel; every
   request returns its tokens, no logits row holds a NaN or inf, the
   report passes validate_report; tokens/s, t_prefill and t_step; (2) the
   same in static mode, whose batches' longest prompts (42 and 39) no
   kernel chunk divides (ops.ssd_scan pads them to a multiple of 4):
   ssd_scan launches = batches x 48; (3) the served prefill (41 tokens)
   on B4 in bf16 against impl="auto" in fp32 on the same bf16-rounded
   weights: logits and final states within phase 6's SSD tolerance at one
   layer, the distance at 48 layers printed; then B4 at the continuous
   workload's buckets (L 16, 64) at mamba2-780m's width with its plain
   version, with the serve run's launches; (4) Session.serve() of
   jamba-1.5-large at full widths, its first two slots (attention/dense,
   Mamba/MoE with 16 experts: ~11.9e9 params), continuous, 4 requests,
   cold then warm: flash launches = prefills, decode launches = engine
   steps, ssd_scan launches = prefills; jamba's B1 (S 16, 64; H 64, KV 8,
   D 128), B2 (B 4, s_max 512) and B4 (L 16, 64; H 256) held to their
   plain versions and listed in the kernels line with those launches;
   (5) Session.train() of full-width mamba2-780m, batch 4 x seq 512, 4
   steps (every loss finite, no kernel launched, peak memory), and one
   2-layer fp32 step on the card against the CPU's (C5's bound); (6) the
   PipelineTrainer at pipe 2 on reduced jamba deepened to 4 cycles, both
   stages on this card, bitwise the single-stage trainer.  It prints the
   phase's wall time.
17. the last three architectures and their serving options — every run
   with the counters zeroed just before and read just after, B1 and B2
   only: (1) Session.serve() of gemma2-27b at full widths cut to 16 of
   its 46 layers (8 swa + global cycles; ~62 GB at peak), continuous and
   static, 8 requests, n_new <= 32, s_max 512 < window 4096, so every
   cache is linear: B1 = prefills x 16, B2 = decode steps x 16; (2) one
   Engine.generate of a 4300-token prompt at s_max 4608: B1 16 launches,
   the window binding on the swa slots, whose caches are 4096-slot rings
   that wrap and decode on "dense" (models.attention.decode_impl), so B2
   = 8 global slots x 7 steps; the same prompt through the continuous
   engine at s_max 4608, whose caches are linear: B1 16, B2 = 16 x engine
   steps, the window binding in B2 on the swa slots past position 4096;
   a static Engine.generate at s_max 4096 == window, linear too: B1 16,
   B2 16 x 7; (3) a sampled generate (greedy=False) on
   the card, one seed twice, the same tokens; (4) one cycle's 4300-token
   prefill logits (positions 4032 on) on B1 against "dense" at the bf16
   tolerance, attention smoothed; (5) gemma2 trained at one cycle (2
   layers), 4 x 512, 3 steps; (6) musicgen-large whole (48 layers, 4
   codebooks, MHA: G = 1, D 64) served in both modes (B1 = prefills x
   48, B2 = decode steps x 48) and trained at 4 x 512; (7) llava-next-34b
   at full widths cut to 16 of 60 layers: Engine.generate of 2 ragged rows
   after a 576-token image prefix (B1 16, B2 16 x 15), the tokens differing
   without the prefix; trained at 2 layers with the prefix; (8)
   full-width granite-3-2b served continuous with prefill_chunk 16
   (chunks in plain PyTorch, each prompt <= 16 on B1), then at one layer
   a 45-token prompt's first-token logits from extend_step against the
   whole-prompt prefill at the bf16 tolerance; (9) an int8 KV
   decode_step (one full-width granite layer at fp32, 4 steps) on the
   card against the CPU's at the bf16 tolerance.  It adds B1 and B2 rows
   at gemma2's (window 4096, cap 50; S 4300 and 64; B2 at s_max 512, and
   at 4608 on a swa slot past the window and on a global slot), musicgen's and llava's (S 616, G = 7) shapes to the kernels
   line, each with the launches of its path, and prints the phase's wall.
18. records — the port's benchmark cells in this process, appending no
   record (no tracked file changes; outputs under build/chip_smoke,
   deleted after): (1) benchmarks/torch_serve_continuous.py's measure()
   at its defaults (granite-3-2b at full width, the seeded weights with
   smoothed attention, decode_32k, 8 requests, n_new <= 24, s_max 128,
   max_batch 2), static then continuous after an untimed two-request
   run of each, the counters zeroed just before and read just after each
   timed runtime: B1 = prefills x 40 and B2 = decode steps x 40 in each,
   no other kernel; every request its tokens, no NaN/inf logits row,
   both Reports valid; check 2 (continuous decode-token steps ==
   delivered tokens, none wasted, fewer than static's) asserted; check 1
   (the same token heads) and check 3 (continuous tokens/s above
   static's) printed: equal, or the requests and steps where the streams
   part; and both rates; (2) benchmarks/torch_telemetry.py
   at dp = 1 (full width, batch 8 x seq 64, 8 steps, overlapped; a static
   serve of 4 requests), its reconciliations asserted (bucket_sync spans
   within 5% of per_bucket_comm_s, the trace's compute/bucket_sync/
   fused_step/step spans, prefill spans equal to the batches'
   prefill_s, both Reports valid), its serve B1 = batches x 40 and B2 =
   decode steps x 40, its training none; (3)
   benchmarks/torch_ilp_planner.py's four tables (ilp, planner,
   ilp_h100, planner_h100: one row per arch each).  It prints the
   phase's wall.
19. contracts — repro_torch.analysis.kernel_contracts.card_check(): each
   library's extern "C" query (it launches nothing) reports, for every
   instantiation of B1-B4 (flash D 64/128; the split kernel linear and
   paged and the combine at D 64/128; the scan's three passes at P 32/64
   x N 16-128, chunk 256) and of the training attention (forward, dQ,
   dK/dV at D 64/128), the registers, spill bytes, static shared
   memory and most threads (cudaFuncGetAttributes), the dynamic shared
   memory its launch sets and the blocks an SM can hold at that size
   (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  One line each:
   registers against the __launch_bounds__ cap, spills, static and
   dynamic shared memory against the mirror's formula, resident blocks
   per SM against the design's claim, headroom under 232,448 B.  Fatal:
   a dynamic size that differs from the mirror's, a block that cannot be
   resident, a kernel that takes fewer threads than its launch, a refused
   query.  Then tools/torch_lint.py's main() in this process on this
   checkout (exit 0, no stale suppression); no kernel launched.

20. sharded — the explicit rank program (distributed/spmd.py) and its
   meta dry run, no serving kernel launches; the fp32 granite steps of (2)
   and (4) run the training attention, exactly 1,200 forward (600 layer
   passes, each forward and recompute), 600 dK/dV and 600 dQ, and nothing
   else (counters zeroed before):
   (1) expert parallel at deepseek-v2 width (E 160, k 6, D 5120, F 1536,
   T 2048, bf16): moe_mlp_sharded on a one-rank NCCL group bitwise equal
   to moe_mlp, and the sum of _local_expert_pass over 4 and over 8
   emulated expert shards (plus the shared experts) within the bf16
   tolerance of moe_mlp; each one's device time; (2) the sharded train
   step at mesh (1, 1) on full-width granite-3-2b (40 layers, batch 4 x
   seq 512, auto attention, block remat) in fp32 against the unsharded
   step (C5's bounds: loss and every param within 2e-4 + 2e-4 * max
   |want|, but 2 * lr + 2e-4 where the clipped gradient is below
   100 * eps), run under the dry run's FLOP counter and memory meter:
   the meta dry run of the same step must give the real tensors'
   argument bytes exactly, its FLOPs the real step's plus exactly the
   attention products that the meta step runs in plain PyTorch and the
   real step in the training kernels, outside the FLOP counter's view
   (16 B H S^2 D a layer: the two products, forward, recompute and their
   four gradients), and its temp bytes
   within 15% of what the real step allocated beyond what was allocated
   before it (torch.cuda.max_memory_allocated() less memory_allocated()
   before the step, so nothing an earlier phase left in the allocator
   counts; both and the ratio printed, and argument + temp against the
   whole peak beside them); (3) one dry-run record per slot
   family on the single-pod mesh (granite train_4k, deepseek-v2
   decode_32k, musicgen prefill_32k, jamba train_4k), each ok, with its
   per-chip GiB, FLOPs, wire GiB and trace time (records written under
   build/chip_smoke and deleted); (4) on (2)'s batch and weights, the
   (1, 1) step with microbatch 1 (4 passes of one row) and the sequence
   replicated, against the unsharded step with the same microbatch
   (C5's bounds), its own peak printed beside (2)'s, and the gradients
   alone (build_grad_fn) with and without the microbatches.

21. examples — examples/torch_quickstart.py's main() on the card from
   a temporary directory under build/ (deleted): the reduced granite
   trains 60 steps and serves 2 requests; both Reports pass
   validate_report and are saved, the losses finite.

Then it prints the card's name and power limit (nvidia-smi), a
{"kernels": [...]} JSON line, and, last, the
{"ok": true, "device": {...}} line.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

H100_HBM_BPS = 3.35e12   # H100 SXM data sheet, bytes/s
H100_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor-core FLOP/s
TOL = 3e-2  # bf16 rtol = atol, as tests/test_kernels.py
FP32_TOL = 2e-4  # fp32, as tests/test_kernels.py
SSD_RTOL, SSD_ATOL = 5e-2, 1e-1  # tests/test_kernels.py's bf16 SSD tolerance
LAYERS = 40  # granite-3-2b
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:81",
    "decode_attention": "src/repro/kernels/decode_attention.py:103",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:145",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:73",
    "flash_attention_train": "none: the JAX package trains attention in "
    "XLA (models/attention.py, dense or chunked); its Pallas kernel has no "
    "backward",
}
SOURCES = {
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "flash_attention_train": "src/repro_torch/csrc/flash_attention_train.cu",
}
H100_FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores


def train_attention(fwd: int, bwd: int) -> dict:
    """The launches of the fp32 training attention on a path that runs
    ``fwd`` forwards of an attention layer (a step under block remat runs
    each layer's twice: forward and recompute) and ``bwd`` backwards."""
    return {"flash_train_fwd": fwd, "flash_train_dkdv": bwd,
            "flash_train_dq": bwd}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync(torch) -> None:
    """Surface a fault of the last launch here, where it happened."""
    torch.cuda.synchronize()


def time_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call: CUDA events around ``iters`` calls after
    warm-up."""
    for _ in range(3):
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


def profile_kernels(torch, fn, calls: int) -> dict:
    """{kernel name: (launches, device us)} of ``calls`` calls of ``fn``,
    from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, float(getattr(e, "self_device_time_total",
                                           getattr(e, "self_cuda_time_total",
                                                   0.0))))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def device_ms(torch, fn, kernels=None, iters: int = 20):
    """Device time of one call: every kernel the call launches on the card,
    summed from torch.profiler over ``iters`` calls after warm-up.  Unlike
    the event time it holds none of the host's cost per call.  ``kernels``
    is the number of kernels one call launches (None for a library call:
    then it is what a profile of one call shows, and it must show one).
    The profile of ``iters`` calls must hold each kernel of one call
    exactly ``iters`` times and nothing else, with a device time above 0; a
    profile that lost records is taken again, up to three times.  After
    that the device time is not measured: it returns None (printed as
    "not measured", null in the JSON line) and says why on stderr.  A
    device time that misses kernels is never reported."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        one = profile_kernels(torch, fn, 1)
        many = profile_kernels(torch, fn, iters)
        n_one = sum(c for c, _ in one.values())
        us = sum(t for _, t in many.values())
        if n_one and (kernels is None or n_one == kernels) and us > 0.0 and {
                k: c for k, (c, _) in many.items()} == {
                k: iters * c for k, (c, _) in one.items()}:
            return us / iters / 1e3
    print(f"chip_smoke: torch.profiler lost kernel records in three tries, "
          f"device time not measured: one call "
          f"{[(k[:40], c, t) for k, (c, t) in one.items()]} (want "
          f"{kernels or 'any'} kernels), {iters} calls "
          f"{[(k[:40], c, t) for k, (c, t) in many.items()]}",
          file=sys.stderr, flush=True)
    return None


def timings(torch, kernel, plain, library=None, kernels: int = 1) -> dict:
    """The kernel's event and device time (it launches ``kernels`` kernels
    per call), the plain version's event time and the library call's event
    and device time (None without one)."""
    return dict(
        ms=time_ms(torch, kernel), device_ms=device_ms(torch, kernel, kernels),
        plain_ms=time_ms(torch, plain, iters=5),
        library_ms=None if library is None else time_ms(torch, library),
        library_device_ms=None if library is None else device_ms(torch,
                                                                  library))


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / H100_HBM_BPS, flops / H100_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_case(torch, mods, *, S, window=0, cap=0.0, B=1, H=32, KV=8, D=64,
               seed=0, dev="cuda"):
    fa_k, ref = mods["fa_k"], mods["ref"]
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(seed)
    # model layout (B,S,H,D), handed to the kernel as transposed views, as
    # the serving path does
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scale = D ** -0.5
    got = fa_k.flash_attention(qt, kt, vt, scale=scale, window=window, cap=cap)
    sync(torch)
    want = ref.flash_attention_ref(qt, kt, vt, scale=scale, window=window,
                                   cap=cap)
    err = (got.float() - want.float()).abs()
    if not bool((err <= TOL + TOL * want.float().abs()).all()):
        fail(f"flash_attention S={S} window={window} cap={cap}: max |err| "
             f"{err.max().item()} outside the bf16 tolerance")
    library = None
    if not cap and not window:  # is_causal: SDPA's flash backend

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
    elif not cap:  # SDPA has no tanh cap; a window needs an explicit mask
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (
            (pos[:, None] - pos[None, :]) < window)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
    times = timings(
        torch, lambda: fa_k.flash_attention(qt, kt, vt, scale=scale,
                                            window=window, cap=cap),
        lambda: ref.flash_attention_ref(qt, kt, vt, scale=scale,
                                        window=window, cap=cap), library)
    qpos = torch.arange(S)
    lo = (qpos - window + 1).clamp(min=0) if window else torch.zeros_like(qpos)
    pairs = int((qpos - lo + 1).sum())  # (q, k) pairs the mask keeps, per head
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
    b_ms, b_by = bound(nbytes, 4 * D * pairs * H * B)
    return dict(max_abs_err=err.max().item(), bound_ms=b_ms, bound_by=b_by,
                **times)


def flash_train_case(torch, *, B, S, H, KV, D, seed=0, dev="cuda"):
    """Phase 5b: the fp32 training attention's forward and backward against
    fp32 dense_attention under autograd, each entry's device time beside
    its bound, and the same forward and backward through the plain paths
    and fp32 SDPA (a yardstick)."""
    from repro_torch.kernels import flash_attention_train as fat
    from repro_torch.models.attention import chunked_attention, dense_attention
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=dev)
               for n in (H, KV, KV))
    dout = torch.randn(B, S, H, D, generator=g, device=dev)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    scale = D ** -0.5

    def fwd_bwd(fn):
        def run():
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            out = fn(qq, kk, vv)
            return (out.detach(),) + torch.autograd.grad(
                out, (qq, kk, vv), dout)
        return run

    kernel = fwd_bwd(lambda *a: fat.flash_attention_train(
        *a, pos, pos, scale=scale))
    got = kernel()
    sync(torch)
    dense_fits = B * H * S * S * 4 * 6 < 40e9  # logits, probs and grads
    if dense_fits:
        want = fwd_bwd(lambda *a: dense_attention(*a, pos, pos,
                                                  scale=scale))()
        err = max((a - w).abs().max().item() / w.abs().max().item()
                  for a, w in zip(got, want))
        del want
        if err > 1e-4:
            fail(f"flash_attention_train B={B} S={S} D={D}: |err| {err} of "
                 "the largest |reference|, over 1e-4")
    else:
        err = None
    o, lse = fat.flash_forward(q, k, v, pos, pos, scale=scale)
    dq, delta = fat.flash_backward_dq(q, k, v, o, lse, dout, pos, pos,
                                      scale=scale)
    # the products each entry runs: forward S, PV; dQ S, dP, dQ; dK/dV S,
    # dP, dV, dK; 2 D FLOPs each per kept (query, key) pair and head
    unit = 2 * D * H * B * S * (S + 1) / 2
    r = {"max_rel_err": err}
    for name, fn, products in (
            ("fwd", lambda: fat.flash_forward(q, k, v, pos, pos,
                                               scale=scale), 2),
            ("dq", lambda: fat.flash_backward_dq(q, k, v, o, lse, dout, pos,
                                                 pos, scale=scale), 3),
            ("dkdv", lambda: fat.flash_backward_dkdv(
                q, k, v, lse, delta, dout, pos, pos, scale=scale), 4)):
        r[f"{name}_device_ms"] = device_ms(torch, fn, 1)
        r[f"{name}_bound_ms"] = products * unit / H100_FP32_FLOPS * 1e3
    parts = [r[f"{name}_device_ms"] for name in ("fwd", "dq", "dkdv")]
    r.update(ms=time_ms(torch, kernel, iters=5),
             device_ms=None if None in parts else sum(parts),
             bound_ms=9 * unit / H100_FP32_FLOPS * 1e3, bound_by="operations",
             chunked_ms=time_ms(torch, fwd_bwd(lambda *a: chunked_attention(
                 *a, pos, pos, scale=scale)), iters=3),
             dense_ms=time_ms(torch, fwd_bwd(lambda *a: dense_attention(
                 *a, pos, pos, scale=scale)), iters=3) if dense_fits else None,
             library_ms=time_ms(torch, fwd_bwd(
                 lambda qq, kk, vv: F.scaled_dot_product_attention(
                     qq.transpose(1, 2), kk.transpose(1, 2),
                     vv.transpose(1, 2), is_causal=True, scale=scale,
                     enable_gqa=True).transpose(1, 2)), iters=5))
    r["plain_ms"] = r["chunked_ms"]
    r["library_device_ms"] = None
    return r


def print_train_case(name, r) -> None:
    err = r["max_rel_err"]
    print(f"[kernel] {name}: max |err| "
          f"{'not compared' if err is None else f'{err:.3e}'} of the "
          f"largest |dense|; device ms (bound at 67 TFLOP/s fp32): forward "
          f"{dev_ms(r['fwd_device_ms'])} ({r['fwd_bound_ms']:.4f}), dQ "
          f"{dev_ms(r['dq_device_ms'])} ({r['dq_bound_ms']:.4f}), dK/dV "
          f"{dev_ms(r['dkdv_device_ms'])} ({r['dkdv_bound_ms']:.4f}); forward "
          f"and backward {r['ms']:.4f} ms (the three entries' device time "
          f"{dev_ms(r['device_ms'])}, bound {r['bound_ms']:.4f}); "
          f"chunked_attention {r['chunked_ms']:.4f}"
          f" ms, dense_attention {ms_or_null(r['dense_ms'])} ms, fp32 SDPA "
          f"(yardstick) {r['library_ms']:.4f} ms, event times of the same "
          f"forward and backward", flush=True)


def decode_case(torch, mods, *, B, S, pos, window=0, cap=0.0, H=32, KV=8,
                D=64, seed=1, dev="cuda"):
    dec_k, ref = mods["dec_k"], mods["ref"]
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(seed)
    # q (B,1,H,D) and a linear cache (B,S,KV,D), as the decode step holds
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    q0, kt, vt = q[:, 0], k.transpose(1, 2), v.transpose(1, 2)
    scale = D ** -0.5
    got = dec_k.decode_attention(q0, kt, vt, p, scale=scale, window=window,
                                 cap=cap)
    sync(torch)
    want = ref.decode_attention_ref(q0, kt, vt, p, scale=scale, window=window,
                                    cap=cap)
    err = (got.float() - want.float()).abs()
    if not bool((err <= TOL + TOL * want.float().abs()).all()):
        fail(f"decode_attention B={B} S={S}: max |err| {err.max().item()} "
             "outside the bf16 tolerance")
    library = None
    if not cap:
        kpos = torch.arange(S, device=dev)
        mask = kpos[None, :] <= p[:, None]
        if window:
            mask &= (p[:, None] - kpos[None, :]) < window
        mask = mask[:, None, None, :]  # (B,1,1,S)
        qs = q.transpose(1, 2)  # (B,H,1,D)

        def library():
            return F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
    times = timings(
        torch, lambda: dec_k.decode_attention(q0, kt, vt, p, scale=scale,
                                              window=window, cap=cap),
        lambda: ref.decode_attention_ref(q0, kt, vt, p, scale=scale,
                                         window=window, cap=cap), library,
        kernels=decode_kernels(dec_k, B, KV, S))
    keys = sum(pp + 1 - (max(0, pp - window + 1) if window else 0)
               for pp in pos)  # cache positions the rows read
    nbytes = 2 * (2 * B * H * D + 2 * keys * KV * D) + 4 * B
    b_ms, b_by = bound(nbytes, 4 * D * H * keys)
    return dict(max_abs_err=err.max().item(), bound_ms=b_ms, bound_by=b_by,
                **times)


def decode_kernels(dec_k, B: int, KV: int, S: int) -> int:
    """Kernels one decode call launches: the split pass, and the combine
    when there is more than one split."""
    return 2 if dec_k.decode_splits(B, KV, S)[0] > 1 else 1


def ms_or_null(x) -> str:
    return "null" if x is None else f"{x:.4f}"


def dev_ms(x, timed=True) -> str:
    """A device time as printed: "not measured" where the profiler lost
    its records (``timed``: there was a call to profile)."""
    if x is None:
        return "not measured" if timed is not None else "null"
    return f"{x:.4f}"


def print_cases(cases) -> None:
    for name, _, r in cases:
        print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3e}  "
              f"kernel {r['ms']:.4f} ms (device {dev_ms(r['device_ms'])})  "
              f"plain {r['plain_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"library {ms_or_null(r['library_ms'])} ms (device "
              f"{dev_ms(r['library_device_ms'], r['library_ms'])})",
              flush=True)


def smooth_attention(params, cfg):
    """The port's ``smooth_attention``, imported at the call: the port is
    on the path only once ``main`` has found the checkout."""
    from repro_torch.models.common import smooth_attention as smooth
    return smooth(params, cfg)


def reference_check(torch, M, RunConfig, materialize, cfg, dev="cuda",
                    prompt_len=64):
    """Full-width prefill + one decode step through the kernels against the
    plain dense path, same weights and prompt.  The random weights are
    rescaled so every attention projection has std 1/sqrt(fan-in of the
    whole product) (the JAX init takes fan-in = heads for the (D,H,hd)
    projections, which makes the scores' std ~100 and the softmax one-hot,
    so any rounding difference in a layer's input is amplified through the
    stack); with smooth attention the two paths must agree within the bf16
    tolerance at every depth."""
    params = smooth_attention(
        M.cast_params(materialize(M.model_specs(cfg), 0, dev), cfg), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    pos = torch.tensor([prompt_len], dtype=torch.int32, device=dev)
    outs = {}
    for impl in ("kernel", "dense"):
        run = RunConfig(attn_impl=impl)
        logits, caches, _ = M.forward(params, {"tokens": toks}, cfg, run,
                                      with_cache=True)
        caches = {"slots": {"slot0": {  # room for the decoded position
            n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, prompt_len))
            for n, c in caches["slots"]["slot0"].items()}}}
        step, _ = M.decode_step(params, toks[:, -1:], pos, caches, cfg, run)
        V = cfg.vocab_size  # columns past it are the -1e30 padding mask
        outs[impl] = (logits[0, -1, :V].float(), step[0, -1, :V].float())
    for i, what in enumerate(("prefill", "decode")):
        got, want = outs["kernel"][i], outs["dense"][i]
        if got.shape != (cfg.vocab_size,) or not bool(torch.isfinite(got).all()):
            fail(f"{what} logits: shape {tuple(got.shape)} or not finite")
        err = (got - want).abs().max().item()
        lim = TOL + TOL * want.abs().max().item()
        print(f"[reference] {cfg.num_layers}-layer {what} logits, kernels vs "
              f"dense: max |diff| {err:.4f} (limit {lim:.4f}), argmax "
              f"{int(got.argmax())} vs {int(want.argmax())}", flush=True)
        if err > lim:
            fail(f"{what} logits: kernels and dense path differ by {err}")


def within(got, want, rtol=TOL, atol=TOL):
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + rtol * want.float().abs()).all()), \
        err.max().item()


def paged_case(torch, mods, name, q, kp, vp, table, pos, *, window=0,
               cap=0.0, kernel_table=None):
    """The paged kernel on pools (N,KV,bs,D) (strided views allowed) and a
    table (B,nb): bitwise equal to the linear kernel on the gathered cache,
    within the bf16 tolerance of the plain version.  ``kernel_table`` is
    the table the kernel gets (entries past a row's length poisoned with
    -1: the kernel must never read them); the gather takes ``table``."""
    dec_k, ref, ops = mods["dec_k"], mods["ref"], mods["ops"]
    F = torch.nn.functional
    kt = table if kernel_table is None else kernel_table
    B, H, D = q.shape
    KV, bs = kp.shape[1], kp.shape[2]
    S = table.shape[1] * bs
    scale = D ** -0.5
    got = dec_k.paged_decode_attention(q, kp, vp, kt, pos, scale=scale,
                                       window=window, cap=cap)
    sync(torch)
    kl = ops.gather_kv_blocks(kp.transpose(1, 2), table)  # (B,S,KV,D)
    vl = ops.gather_kv_blocks(vp.transpose(1, 2), table)
    lin = dec_k.decode_attention(q, kl.transpose(1, 2), vl.transpose(1, 2),
                                 pos, scale=scale, window=window, cap=cap)
    sync(torch)
    if not torch.equal(got, lin):
        fail(f"{name}: paged kernel differs from the linear kernel on the "
             f"gathered cache by {(got.float() - lin.float()).abs().max()}")
    want = ref.paged_decode_attention_ref(q, kp, vp, table, pos, scale=scale,
                                          window=window, cap=cap)
    ok, err = within(got, want)
    if not ok:
        fail(f"{name}: max |err| {err} outside the bf16 tolerance")
    library = None
    if not cap:  # SDPA has no tanh cap
        kpos = torch.arange(S, device=q.device)
        mask = kpos[None, :] <= pos[:, None].long()
        if window:
            mask &= (pos[:, None].long() - kpos[None, :]) < window
        mask = mask[:, None, None, :]

        def library():  # the gather and the attention, timed together
            k_lin = ops.gather_kv_blocks(kp.transpose(1, 2), table)
            v_lin = ops.gather_kv_blocks(vp.transpose(1, 2), table)
            return F.scaled_dot_product_attention(
                q[:, :, None], k_lin.transpose(1, 2), v_lin.transpose(1, 2),
                attn_mask=mask, scale=scale, enable_gqa=True)
    times = timings(
        torch, lambda: dec_k.paged_decode_attention(
            q, kp, vp, kt, pos, scale=scale, window=window, cap=cap),
        lambda: ref.paged_decode_attention_ref(
            q, kp, vp, table, pos, scale=scale, window=window, cap=cap),
        library, kernels=decode_kernels(dec_k, B, KV, S))
    keys = sum(p + 1 - (max(0, p - window + 1) if window else 0)
               for p in pos.tolist())  # cache positions the rows read
    blocks = sum(p // bs + 1 for p in pos.tolist())  # table entries read
    nbytes = 2 * (2 * B * H * D + 2 * keys * KV * D) + 4 * (B + blocks)
    b_ms, b_by = bound(nbytes, 4 * D * H * keys)
    return dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)


def granite_pools(torch, PagedKVCache, cfg, *, s_max, lengths, layer=17,
                  seed=5):
    """A PagedKVCache of full-width granite-3-2b (pools (N, 40, bs, KV, D)
    bf16, max_batch 4 rows' worth of blocks) filled with random values.
    Filler requests are admitted and released between the rows, so the
    rows' tables are ragged and non-contiguous.  Returns the layer's pools
    as strided kernel-layout views (N, KV, bs, D), the table (0-padded for
    the gather, -1-padded for the kernel) and pos = length - 1."""
    import numpy as np
    bs = 16
    kv = PagedKVCache(cfg, block_size=bs, n_blocks=4 * (s_max // bs),
                      s_max=s_max, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    pools = [kv._pools[("slots", "slot0", leaf)] for leaf in ("k", "v")]
    for pool in pools:
        pool.copy_(torch.randn(pool.shape, generator=g, device="cuda"))
    tok = iter(range(1, 10 ** 6))  # distinct prompts: no prefix sharing
    rows = []
    for i, n in enumerate(lengths):
        filler = 100 + i
        kv.admit(filler, np.array([next(tok)]), s_max // (4 * (i + 1)))
        kv.admit(i, np.array([next(tok)]), n)
        rows.append(kv._tables[i])
        kv.release(filler)
    nb = max(len(t) for t in rows)
    table = torch.zeros((len(rows), nb), dtype=torch.int32, device="cuda")
    poisoned = torch.full_like(table, -1)
    for r, t in enumerate(rows):
        table[r, :len(t)] = torch.tensor(t, dtype=torch.int32)
        poisoned[r, :len(t)] = table[r, :len(t)]
    if all(t == sorted(t) and t[-1] - t[0] == len(t) - 1 for t in rows):
        fail("granite_pools: every table is contiguous")
    kp, vp = (p[:, layer].transpose(1, 2) for p in pools)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                       device="cuda")
    return kp, vp, table, poisoned, pos


def ssd_case(torch, mods, name, *, B, L, H, P, N, chunk, seed=7,
             yardstick=False):
    """The scan kernels on model-layout views (x (B,L,H,P) and dt (B,L,H)
    transposed, as ssm_forward passes them) against ref.ssd_scan_ref.  The
    device time must hold every pass of every timed call.  With
    ``yardstick``: each pass's device time, and models.ssm.ssd_chunked in
    bf16 on the same inputs in model layout (what impl="auto" runs; no
    single PyTorch call computes the scan, so the library column stays
    null), whose device time the kernels must beat (the event time where
    the profiler did not measure both)."""
    ssd_k, ref = mods["ssd_k"], mods["ref"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, L, H, P, generator=g, device="cuda").to(torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn(B, L, H, generator=g, device="cuda")).to(torch.bfloat16)
    a = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.5)
    b = torch.randn(B, L, N, generator=g, device="cuda").to(torch.bfloat16)
    c = torch.randn(B, L, N, generator=g, device="cuda").to(torch.bfloat16)
    args = (x.transpose(1, 2), dt.transpose(1, 2), a, b, c)
    y, h = ssd_k.ssd_scan(*args, chunk=chunk)
    sync(torch)
    wy, wh = ref.ssd_scan_ref(*args, chunk=chunk)
    ok_y, err = within(y, wy)
    ok_h, err_h = within(h, wh, 1e-3, 1e-3)  # fp32 both, sums reordered
    if not (ok_y and ok_h):
        fail(f"{name}: max |err| y {err}, h {err_h} outside the tolerance")
    kernels = ssd_k.ssd_kernels(B, H, L, chunk)
    times = timings(torch, lambda: ssd_k.ssd_scan(*args, chunk=chunk),
                    lambda: ref.ssd_scan_ref(*args, chunk=chunk),
                    kernels=kernels)
    Q = min(chunk, L)
    tri = Q * (Q + 1) // 2  # (i, j) pairs of a chunk the causal mask keeps
    nc = L // Q
    # C B^T once per (batch, chunk) (it is shared by the heads); per head
    # and chunk the masked product with x, C h and the state update
    flops = 2 * B * nc * (tri * N + H * (tri * P + 2 * Q * N * P))
    nbytes = (2 * 2 * B * L * H * P + 2 * B * L * H + 2 * 2 * B * L * N
              + 4 * H + 4 * B * H * N * P)
    b_ms, b_by = bound(nbytes, flops)
    out = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)
    if not yardstick:
        return out
    # a profile that lost records is taken again, up to three times, as in
    # device_ms; after that the per-pass times are not measured
    for _ in range(3):
        passes = profile_kernels(
            torch, lambda: ssd_k.ssd_scan(*args, chunk=chunk), 20)
        if len(passes) == kernels and all(
                n == 20 and t > 0.0 for n, t in passes.values()):
            out["pass_device_ms"] = {
                re.search(r"(chunk|state|output)_pass", k).group(0):
                    t / 20 / 1e3 for k, (_, t) in passes.items()}
            break
    else:
        print(f"chip_smoke: {name}: the profile of 20 calls shows {passes}, "
              f"not {kernels} passes 20 times each, in three tries: per-pass "
              f"device times not measured", file=sys.stderr, flush=True)
        out["pass_device_ms"] = None
    ssm, a16 = mods["ssm"], a.to(torch.bfloat16)

    def chunked():
        return ssm.ssd_chunked(x, dt, a16, b, c, chunk)

    out["ssd_chunked_ms"] = time_ms(torch, chunked)
    out["ssd_chunked_device_ms"] = device_ms(torch, chunked)
    print(f"[kernel] {name}: passes on the device "
          + (", ".join(f"{k} {v:.4f} ms" for k, v in
                       out["pass_device_ms"].items())
             if out["pass_device_ms"] else "not measured")
          + f"; models.ssm.ssd_chunked bf16 {out['ssd_chunked_ms']:.4f} ms "
          f"(device {dev_ms(out['ssd_chunked_device_ms'])})", flush=True)
    # the scan must beat ssd_chunked: on the device where the profiler
    # measured both, else by CUDA events
    if out["device_ms"] is not None and \
            out["ssd_chunked_device_ms"] is not None:
        mine, theirs, on = (out["device_ms"], out["ssd_chunked_device_ms"],
                            "on the device")
    else:
        mine, theirs, on = out["ms"], out["ssd_chunked_ms"], "by CUDA events"
    if mine >= theirs:
        fail(f"{name}: the kernels take {mine} ms {on}, ssd_chunked "
             f"{theirs} ms")
    return out


def mamba_layer_check(torch, ssm, materialize, get_config, ssd_k):
    """One full-width mamba2-780m mixer layer: the scan on the kernel
    against ssm_forward's plain chunked path.  The plain path runs in fp32
    on the same bf16-rounded weights and input: in bf16, ssd_chunked rounds
    the cumsum of the log decay to bf16 (an ulp of 0.5 at |cl| ~ 100), which
    alone moves the layer's output by more than the tolerance (printed
    below as the bf16 plain path's distance, for information)."""
    cfg = get_config("mamba2-780m")
    p = materialize(ssm.ssm_specs(cfg, 1), 0, "cuda")
    p = {k: v[0].to(torch.bfloat16) for k, v in p.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 2048, cfg.d_model, generator=g,
                    device="cuda").to(torch.bfloat16)
    ssd_k.ssd_scan.launches = 0
    out, cache = ssm.ssm_forward(p, x, None, cfg, impl="kernel")
    sync(torch)
    if ssd_k.ssd_scan.launches != 1:
        fail(f"mamba layer: {ssd_k.ssd_scan.launches} scan launches, not 1")
    p32 = {k: v.float() for k, v in p.items()}
    want, want_cache = ssm.ssm_forward(p32, x.float(), None, cfg, impl="auto")
    bf16_auto, _ = ssm.ssm_forward(p, x, None, cfg, impl="auto")
    if out.shape != want.shape or not bool(torch.isfinite(out).all()):
        fail(f"mamba layer: output {tuple(out.shape)} or not finite")
    ok, err = within(out, want, SSD_RTOL, SSD_ATOL)
    ok_h, err_h = within(cache["state"], want_cache["state"], SSD_RTOL,
                         SSD_ATOL)
    print(f"[mamba] mamba2-780m layer, x (1, 2048, {cfg.d_model}) bf16, "
          f"chunk {cfg.ssm_chunk}: kernel vs plain fp32 max |diff| out "
          f"{err:.4f}, state {err_h:.4f} (rtol {SSD_RTOL}, atol {SSD_ATOL}); "
          f"plain bf16 vs plain fp32 max |diff| out "
          f"{(bf16_auto.float() - want).abs().max().item():.4f}; max |out| "
          f"{want.abs().max().item():.3f}; scan launches "
          f"{ssd_k.ssd_scan.launches}", flush=True)
    if not (ok and ok_h):
        fail(f"mamba layer: kernel path differs from the plain path by "
             f"{err} (out), {err_h} (state)")
    layer = {impl: (lambda impl=impl: ssm.ssm_forward(p, x, None, cfg,
                                                      impl=impl))
             for impl in ("kernel", "auto")}
    t = {impl: (time_ms(torch, fn, iters=10), device_ms(torch, fn, iters=10))
         for impl, fn in layer.items()}
    print(f"[mamba] mamba2-780m layer in bf16, impl=\"kernel\" "
          f"{t['kernel'][0]:.4f} ms (device {dev_ms(t['kernel'][1])}), "
          f"impl=\"auto\" (ssd_chunked) {t['auto'][0]:.4f} ms (device "
          f"{dev_ms(t['auto'][1])})", flush=True)


TUNE_CHUNKS = (32, 64, 128)  # bench_kernels' default scan chunks
# bench_kernels' launches at its defaults (seq 128, repeats 2): one warm-up
# and two timed calls a kernel variant, the scan at three chunks
TUNE_LAUNCHES = {"flash_attention": 3, "decode_attention": 3,
                 "paged_decode_attention": 3, "ssd_scan": 9}


def hold_variants(torch, ops, chunks, label) -> None:
    """Every kernel variant of every tunable op against its plain variant
    on the same inputs (bf16 tolerance; the scan's fp32 state at 1e-3).
    Called outside a counted window: these launches count nowhere."""
    for op in ops.TUNABLE_OPS:
        inputs = ops.tune_inputs(op, seq=128, device="cuda")
        cands = ops.tune_candidates(op, ssd_chunks=chunks)
        plain = cands["gather_ref" if "gather_ref" in cands else "ref"](*inputs)
        for name, fn in cands.items():
            if not name.startswith("kernel"):
                continue
            got = fn(*inputs)
            sync(torch)
            pairs = zip(got, plain) if isinstance(got, tuple) else [(got, plain)]
            for i, (g_, w_) in enumerate(pairs):
                tol = (1e-3, 1e-3) if g_.dtype == torch.float32 else (TOL, TOL)
                ok, err = within(g_, w_, *tol)
                if not ok:
                    fail(f"{label}: {op}/{name} output {i} differs from the "
                         f"plain variant by {err}")


def tune_phase(torch, autotune, ops, wrappers):
    """bench_kernels on the card with every launch counter zeroed just
    before and read just after; returns the launches."""
    repeats, chunks = 2, TUNE_CHUNKS
    for fn in wrappers.values():
        fn.launches = 0
    res = autotune.bench_kernels(seq=128, repeats=repeats, ssd_chunks=chunks,
                                 device="cuda")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for op, entry in res.items():
        bad = {n: e for n, e in entry["errors"].items()
               if n.startswith("kernel")}
        if bad:
            fail(f"tune: {op} kernel variants raised: {bad}")
        print(f"[tune] {op}: chosen {entry['chosen']}; times "
              + ", ".join(f"{n} {t * 1e3:.4f} ms"
                          for n, t in entry["times_s"].items()), flush=True)
    per_variant = 1 + repeats
    want = {"flash_attention": per_variant, "decode_attention": per_variant,
            "paged_decode_attention": per_variant,
            "ssd_scan": per_variant * len(chunks)}
    if launches != want:
        fail(f"tune: launches {launches} != {want}")
    hold_variants(torch, ops, chunks, "tune")
    print(f"[tune] launches {launches}; every kernel variant within "
          "tolerance of its plain variant", flush=True)
    print(f"[tune] host_microbench {json.dumps(autotune.host_microbench())}")
    mem = torch.cuda.get_device_properties(0).total_memory
    conv = autotune.choose_conv_algs(128, mem)
    print(f"[tune] choose_conv_algs(128, {mem}): M_bound "
          f"{conv['m_bound_bytes']:.4e} B; "
          + ", ".join(f"{l['layer']} {l['chosen']}" for l in conv["layers"]),
          flush=True)
    return launches


def trees_close(tree_items, got, want, tol=FP32_TOL):
    """Max |got - want| over every leaf, and whether each leaf is within
    tol + tol * max |want|."""
    worst, ok = 0.0, True
    for (_, g), (_, w) in zip(tree_items(got), tree_items(want)):
        w = w.float().to(g.device)
        err = (g.float() - w).abs().max().item()
        worst = max(worst, err)
        ok &= err <= tol + tol * w.abs().max().item()
    return ok, worst


def trees_equal(torch, tree_items, a, b) -> bool:
    """Every leaf of ``a`` bitwise equal to ``b``'s."""
    return all(torch.equal(x, y) for (_, x), (_, y)
               in zip(tree_items(a), tree_items(b)))


def adam_close(tree_items, got, want, grads, *, scale, lr,
               tol=FP32_TOL, device="cpu"):
    """Updated params after one AdamW step against a reference: within
    tol + tol * max |want| per leaf, except where the reference's clipped
    gradient is below 100 * eps (AdamW's first step moves an element by
    lr * g / (|g| + eps), which there turns on rounding of ~1e-8): there
    within 2 * lr, the most that step can move it, plus tol for the
    rounding of the update itself, compared on ``device``.  Returns (ok,
    max diff elsewhere, count of those elements, max diff on them)."""
    ok, worst, n_eps, worst_eps = True, 0.0, 0, 0.0
    for (_, g), (_, w), (_, gr) in zip(tree_items(got), tree_items(want),
                                       tree_items(grads)):
        d = (g.float().to(device) - w.float().to(device)).abs()
        tiny = (gr.float().to(device) * scale).abs() < 100 * 1e-8
        lim = tol + tol * w.float().abs().max().item()
        rest = d[~tiny].max().item() if bool((~tiny).any()) else 0.0
        eps = d[tiny].max().item() if bool(tiny.any()) else 0.0
        ok &= rest <= lim and eps <= 2 * lr + tol
        worst, worst_eps = max(worst, rest), max(worst_eps, eps)
        n_eps += int(tiny.sum())
    return ok, worst, n_eps, worst_eps


def train_phase(torch, wrappers) -> None:
    """Phase 8: the training path (see the module docstring)."""
    from repro_torch.api import JobSpec, Session
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.launch.steps import build_grad_fn
    from repro_torch.models import model as M
    from repro_torch.models.common import materialize, tree_items, tree_map
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_state
    from repro_torch.train.loop import train

    for fn in wrappers.values():
        fn.launches = 0
    granite = get_config("granite-3-2b")
    # 8.1: full width through the entry point a user calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec = JobSpec(arch="granite-3-2b", reduced=False, steps=4, batch=4,
                   seq=512, log_every=1)
    session = Session(spec, device="cuda")
    rep = session.train()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    m = rep.measured
    losses = m["losses"]
    hist = m["metrics"]["histograms"]["train/step_s"]
    print(f"[train] granite-3-2b full width (40 layers, "
          f"{rep.meta['executed_config']['n_params']:,} params), batch 4 x "
          f"seq 512, 4 steps, auto attention + block remat, AdamW on fp32 "
          f"masters: losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"[train] tokens/s {m['tokens_per_s']:.1f} over the run (first "
          f"step included); step wall p50 {hist['p50'] * 1e3:.1f} ms, min "
          f"{hist['min'] * 1e3:.1f}, max {hist['max'] * 1e3:.1f}; steady "
          f"step phases (s) {json.dumps(m['step_times_mean'])}; R_O "
          f"{m['r_o']:.4f}; peak memory {peak / 1e9:.2f} GB "
          f"(max_memory_allocated); phase wall {wall:.1f} s", flush=True)
    if not all(map(math.isfinite, losses)):
        fail(f"full-width training losses {losses}: not finite")
    run, opt = session.build_run_opt()
    del rep, session
    torch.cuda.empty_cache()

    # 8.1b: learning at full width and depth.  At JAX's init (fan-in =
    # heads for wq/wk/wv: scores of std ~64, a one-hot softmax) the
    # 40-layer model does not learn in 4 steps (PERF.md, section 6: the
    # loss rose for 4 of 4 seeds); with the attention weights smoothed, as
    # in phase 4, the same loop with the same run and optimizer settings
    # must bring the loss down.
    params = smooth_attention(materialize(M.model_specs(granite), 0, "cuda"),
                              granite)
    res = train(granite, run, opt, batch=4, seq=512, steps=4, seed=0,
                device="cuda", params=params, log_every=0)
    print(f"[train] the same 40-layer run with smoothed attention weights: "
          f"losses {[round(x, 4) for x in res.losses]}", flush=True)
    if not all(map(math.isfinite, res.losses)) \
            or not res.losses[-1] < res.losses[0]:
        fail(f"full-width training losses {res.losses}: not finite or not "
             "falling")
    del params
    torch.cuda.empty_cache()

    # 8.2: one step on the card against the same step on the CPU, fp32
    cfg = granite.replace(num_layers=2, dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    p_cpu = smooth_attention(materialize(M.model_specs(cfg), 0, "cpu"), cfg)
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(4))
    grads_of = build_grad_fn(cfg, run)
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        t = toks.to(dev)
        loss, _, g = grads_of(p, {"tokens": t, "labels": t})
        _, _, gnorm = apply_updates(opt, p, g, init_state(opt, p))
        out[dev] = (loss.item(), gnorm.item(), g)
    for k, name in enumerate(("loss", "grad_norm")):
        got, want = out["cuda"][k], out["cpu"][k]
        if abs(got - want) > FP32_TOL + FP32_TOL * abs(want):
            fail(f"card and CPU {name}: {got} vs {want}")
    ok_g, worst_g = trees_close(tree_items, out["cuda"][2],
                                out["cpu"][2])
    ok_p, worst_p, n_eps, worst_eps = adam_close(
        tree_items, p_gpu, p_cpu, out["cpu"][2],
        scale=min(1.0, opt.grad_clip / out["cpu"][1]), lr=opt.lr)
    print(f"[train] 2-layer full-width fp32 step, card vs CPU: loss "
          f"{out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f}, grad_norm "
          f"{out['cuda'][1]:.6f} vs {out['cpu'][1]:.6f}; grads max |diff| "
          f"{worst_g:.3e}; updated params max |diff| {worst_p:.3e} (limit "
          f"2e-4 + 2e-4 * max |want| per leaf), and {worst_eps:.3e} on the "
          f"{n_eps} elements whose clipped gradient is below 100 * eps, "
          f"where AdamW's first direction g / (|g| + eps) turns on 1e-8 "
          f"of rounding (limit 2 * lr + 2e-4)", flush=True)
    if not ok_g:
        fail(f"card and CPU gradients differ by up to {worst_g}")
    if not ok_p:
        fail(f"card and CPU updated params differ by up to {worst_p} "
             f"({worst_eps} where the gradient is below 100 * eps)")
    del out, p_cpu, p_gpu

    # 8.3: the data-parallel trainer, all_reduce over NCCL at dp = 1,
    # against the loop from the same params and loader seed
    cfg = granite.replace(num_layers=4)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    p0 = smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"), cfg)
    p_loop = tree_map(torch.clone, p0)
    res = train(cfg, run, opt, batch=4, seq=512, steps=3, device="cuda",
                params=p_loop, log_every=0)
    tr = DataParallelTrainer(cfg, run, opt, strategy="all_reduce",
                             devices=["cuda:0"])
    try:
        res_dp = tr.train(batch=4, seq=512, steps=3, params=p0, log_every=0)
        sync = tr.report().as_dict()
    finally:
        tr.close()
    ok, worst = trees_close(tree_items, tr.params[0], p_loop)
    print(f"[train] DataParallelTrainer all_reduce over NCCL, dp 1, 4 "
          f"layers, 3 steps: losses {res_dp.losses} vs the loop's "
          f"{res.losses}; params max |diff| {worst:.3e}", flush=True)
    print(f"[train] sync report {json.dumps(sync)}", flush=True)
    if not ok or max(abs(a - b) for a, b in zip(res_dp.losses, res.losses)) \
            > FP32_TOL + FP32_TOL * max(map(abs, res.losses)):
        fail("the dp = 1 trainer and the loop disagree")
    threaded = tr.params[0]
    del tr, p0, p_loop
    torch.cuda.empty_cache()
    moved = {name: fn.launches for name, fn in wrappers.items()
             if fn.launches}
    want = train_attention(fwd=4, bwd=2)  # 8.2's two fp32 layers
    if moved != want:
        fail(f"the training path launched {moved}, want {want}: the fp32 "
             "training attention on 8.2's step alone")
    print(f"[train] launches on the training path: {moved} (8.2's fp32 "
          "step: forward and recompute of two layers, a dK/dV and a dQ "
          "each; the bf16 runs launch nothing)", flush=True)
    return threaded, sum(moved.values())


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def procs_phase(torch, wrappers, threaded) -> None:
    """Phase 9: processes and overlap (see the module docstring)."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.models import model as M
    from repro_torch.models.common import materialize, tree_items
    from repro_torch.models.blocks import RunConfig
    from repro_torch.optim.adamw import OptConfig

    for fn in wrappers.values():
        fn.launches = 0
    cfg = get_config("granite-3-2b").replace(num_layers=4)
    run = RunConfig(attn_impl="auto", remat="block")

    def fresh():  # phase 8.3's params, optimizer and run
        return (smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"),
                                 cfg),
                OptConfig(lr=1e-3, warmup_steps=1, total_steps=3))

    # 9.1: the one-rank trainer a torchrun process builds, in this process
    p0, opt = fresh()
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True,
                          timeout=timedelta(seconds=120))
    tr = DataParallelTrainer(cfg, run, opt, strategy="all_reduce",
                             devices=["cuda:0"], rank=0, world=1, store=store)
    t0 = time.perf_counter()
    try:
        res = tr.train(batch=4, seq=512, steps=3, params=p0, log_every=0)
        rep = tr.report().as_dict()
        # the first barrier also sets up the NCCL communicator
        barrier = [e.dur_s for e in tr.tracer.events("barrier")][1:]
    finally:
        tr.close()
    same = trees_equal(torch, tree_items, tr.params[0], threaded)
    print(f"[procs] one-rank trainer (rank 0 of 1, NCCL on a TCPStore), "
          f"granite-3-2b full width, 4 layers, 3 steps: losses "
          f"{res.losses}; params bitwise equal to phase 8's threaded dp = 1 "
          f"trainer: {same}; compute barrier "
          f"{[round(b * 1e3, 3) for b in barrier]} ms in steps 1-2; "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"[procs] sync report {json.dumps(rep)}", flush=True)
    if not same:
        fail("the one-rank trainer and the threaded dp = 1 trainer differ")
    del tr, p0, threaded, store
    torch.cuda.empty_cache()

    # 9.2: the launcher under torchrun, one process on this card
    root = Path(__file__).resolve().parent
    out = root / "build" / "chip_smoke" / "torchrun_report.json"
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
           "--arch", "granite-3-2b", "--device", "cuda", "--dp", "1",
           "--sync", "all_reduce", "--steps", "3", "--batch", "4",
           "--seq", "128", "--report-out", str(out)]
    t0 = time.perf_counter()
    try:
        child = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=300)
    except subprocess.TimeoutExpired:
        fail("the torchrun child did not finish in 300 s")
    wall = time.perf_counter() - t0
    if child.returncode != 0:
        fail(f"torchrun exited {child.returncode}: "
             f"{(child.stdout + child.stderr)[-3000:]}")
    try:
        rep = json.loads(out.read_text())["measured"]["sync"]
    except (OSError, ValueError, KeyError) as e:
        fail(f"the torchrun child's report does not parse: {e!r}")
    print(f"[procs] torchrun --standalone --nproc-per-node 1 -m "
          f"repro_torch.launch.train (granite-3-2b reduced, --dp 1, 3 steps) "
          f"exited 0 in {wall:.1f} s; its report's sync: dp {rep['dp']}, "
          f"measured_comm_s {rep['measured_comm_s']:.6f}, link_bw "
          f"{rep['link_bw']:.3e}", flush=True)

    # 9.3: overlapped against serial, dp = 1, 4 steps
    params = {}
    for overlap in (False, True):
        p0, opt = fresh()
        opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        tr = DataParallelTrainer(cfg, run, opt, strategy="all_reduce",
                                 devices=["cuda:0"], sync_overlap=overlap)
        try:
            tr.train(batch=4, seq=512, steps=4, params=p0, log_every=0)
            rep = tr.report()
        finally:
            tr.close()
        params[overlap] = tr.params[0]
        del tr, p0
    same = trees_equal(torch, tree_items, params[True], params[False])
    print(f"[procs] overlapped all_reduce, dp 1, 4 layers, 4 steps (2 "
          f"calibration + 2 fused): {rep.n_buckets} buckets of "
          f"{rep.bucket_mb} MiB; overlap_fraction {rep.overlap_fraction:.4f}, "
          f"exposed {rep.exposed_comm_time * 1e3:.3f} ms of "
          f"{rep.measured_comm_s * 1e3:.3f} ms serial comm; params bitwise "
          f"equal to the serial trainer's: {same}", flush=True)
    print(f"[procs] overlap sync report (priced at {rep.link_bw:.3e} B/s, "
          f"the H100 node's NVLink tier) {json.dumps(rep.as_dict())}",
          flush=True)
    if not same:
        fail("the overlapped and the serial trainer differ")
    del params
    torch.cuda.empty_cache()
    moved = {name: fn.launches for name, fn in wrappers.items()
             if fn.launches}
    if moved:
        fail(f"phase 9 launched kernels: {moved}")


def ckpt_phase(torch, wrappers) -> None:
    """Phase 10: checkpoint and async PS (see the module docstring)."""
    import shutil
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import AsyncPSTrainer, DataParallelTrainer
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import materialize, tree_items
    from repro_torch.obs import Tracer
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import train

    for fn in wrappers.values():
        fn.launches = 0
    cfg = get_config("granite-3-2b").replace(num_layers=4)
    run = RunConfig(attn_impl="auto", remat="block")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    kw = dict(batch=4, seq=512, seed=0, log_every=0)

    def fresh():  # phase 9's params
        return smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"),
                                cfg)

    def span_s(tracer, name):
        return [round(e.dur_s, 4) for e in tracer.events(name)]

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_", dir=root))
    try:
        # 10.1: the loop, uninterrupted against stopped at 2 and resumed
        ref = train(cfg, run, opt, steps=4, params=fresh(), device="cuda",
                    **kw).losses
        ck = str(tmp / "loop")
        tr_save, tr_load = Tracer(), Tracer()
        head = train(cfg, run, opt, steps=2, params=fresh(), device="cuda",
                     ckpt_dir=ck, ckpt_every=2, tracer=tr_save, **kw)
        disk = sum(p.stat().st_size for p in Path(ck).glob("*.npz"))
        tail = train(cfg, run, opt, steps=4, params=fresh(), device="cuda",
                     ckpt_dir=ck, ckpt_every=2, tracer=tr_load, **kw)
        worst = max(abs(a - b) for a, b in zip(head.losses + tail.losses,
                                               ref))
        print(f"[ckpt] loop, granite-3-2b full width, 4 layers, batch 4 x "
              f"seq 512: uninterrupted {ref}; stopped at 2 {head.losses}, "
              f"resumed from step {tail.start_step}: {tail.losses}; max "
              f"|diff| {worst:.3e}, bitwise equal: "
              f"{head.losses + tail.losses == ref}; step 2 on disk "
              f"{disk / 1e9:.3f} GB; enqueue (device-to-host copy, the "
              f"step's stall) {span_s(tr_save, 'ckpt_enqueue')} s, write "
              f"(writer thread) {span_s(tr_save, 'ckpt_write')} s, restore "
              f"{span_s(tr_load, 'ckpt_restore')} s", flush=True)
        if tail.start_step != 2 or len(tail.losses) != 2 or worst > 1e-6:
            fail("the resumed loop does not continue the uninterrupted one")
        if latest_step(ck) != 4:
            fail(f"the resumed loop's newest checkpoint is {latest_step(ck)}")

        # 10.2: the one-rank dp = 1 trainer writes, the loop resumes
        store = dist.TCPStore("127.0.0.1", free_port(), 1, True,
                              timeout=timedelta(seconds=120))
        ck = str(tmp / "trainer")
        tr = DataParallelTrainer(cfg, run, opt, strategy="all_reduce",
                                 devices=["cuda:0"], rank=0, world=1,
                                 store=dist.PrefixStore("dp", store))
        try:
            part = tr.train(steps=2, params=fresh(), ckpt_dir=ck,
                            ckpt_every=2, **kw)
        finally:
            tr.close()
        del tr
        written = latest_step(ck)
        tail = train(cfg, run, opt, steps=4, params=fresh(), device="cuda",
                     ckpt_dir=ck, ckpt_every=2, **kw)
        worst = max(abs(a - b) for a, b in zip(part.losses + tail.losses,
                                               ref))
        print(f"[ckpt] the one-rank dp = 1 trainer (NCCL on a TCPStore) "
              f"wrote step {written}: its losses "
              f"{part.losses}; the loop resumed from step {tail.start_step} "
              f"to {tail.losses}; max |diff| against the uninterrupted loop "
              f"{worst:.3e}, bitwise equal: "
              f"{part.losses + tail.losses == ref}", flush=True)
        if written != 2 or tail.start_step != 2 or worst > 1e-6:
            fail("the loop resumed from the trainer's checkpoint does not "
                 "continue the loop's losses")

        # 10.3: the async PS, one rank per process (here rank 0 of 1)
        params, reports = {}, {}
        for n, (cls, extra, steps) in enumerate((
                (DataParallelTrainer, dict(strategy="parameter_server"), 3),
                (AsyncPSTrainer, dict(staleness=0), 3),
                (AsyncPSTrainer, dict(staleness=2), 4))):
            tr = cls(cfg, run, OptConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=steps),
                     devices=["cuda:0"], rank=0, world=1,
                     store=dist.PrefixStore(f"ps{n}", store), **extra)
            try:
                res = tr.train(steps=steps, params=fresh(), **kw)
                if cls is AsyncPSTrainer:
                    reports[extra["staleness"]] = tr.async_report()
            finally:
                tr.close()
            params[n] = (res.losses, tr.params[0])
            del tr
            torch.cuda.empty_cache()
        same = (params[0][0] == params[1][0]
                and trees_equal(torch, tree_items, params[0][1], params[1][1]))
        rep = reports[2]
        print(f"[ckpt] one-rank AsyncPSTrainer, staleness 0, 3 steps: "
              f"losses {params[1][0]}, bitwise equal to the one-rank "
              f"parameter_server trainer: {same}; staleness 2, 4 steps: "
              f"losses {params[2][0]}, max_age {rep.max_age}, mean_age "
              f"{rep.mean_age}, refreshes {rep.refreshes}", flush=True)
        print(f"[ckpt] async report (staleness 2, priced at the H100 node's "
              f"NVLink tier) {json.dumps(rep.as_dict())}", flush=True)
        if not same:
            fail("the staleness-0 async PS and the parameter_server trainer "
                 "differ")
        if rep.max_age != 2 or reports[0].max_age != 0:
            fail(f"async PS ages: max_age {rep.max_age} at staleness 2, "
                 f"{reports[0].max_age} at 0")
        del params, store
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    moved = {name: fn.launches for name, fn in wrappers.items()
             if fn.launches}
    if moved:
        fail(f"phase 10 launched kernels: {moved}")


def plan_phase(torch, wrappers) -> None:
    """Phase 11: the planner (see the module docstring)."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.api import JobSpec, Session, validate_report
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.models import model as M
    from repro_torch.models.common import materialize, tree_items
    from repro_torch.optim.adamw import OptConfig

    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    # 11.1: plan and dry run on the two H100 clusters the meshes name
    for mesh in ("single", "multi"):
        session = Session(JobSpec(arch="granite-3-2b", reduced=False,
                                  mesh=mesh), device="cuda")
        plan = session.plan()
        dry = session.dryrun()
        for rep in (plan, dry):
            validate_report(rep.to_dict())
        p, pred = plan.plan, plan.predicted
        if p["topology"]["chip"] != "h100-sxm":
            fail(f"mesh {mesh}: the plan is priced on "
                 f"{p['topology']['chip']}, not the H100")
        print(f"[plan] granite-3-2b full, train_4k, mesh {mesh} "
              f"({p['topology']['name']}, dp {p['mesh'][0]}, chip "
              f"{p['topology']['chip']}): microbatch {p['microbatch']}, "
              f"attn_impl {p['attn_impl']}, remat {p['remat']}, "
              f"sync_schedule {p['sync_schedule']}, N_ps "
              f"{pred['lemma32']['n_parameter_servers']}, est_step_time "
              f"{p['est_step_time']:.4f} s, est_memory_gb "
              f"{p['est_memory_gb']:.2f}, fits {p['fits']}; Lemma 3.2 comm "
              f"{pred['lemma32']['predicted_comm_s'] * 1e3:.2f} ms; dry run "
              f"memory {dry.predicted['memory_bytes']['total'] / 1e9:.2f} GB",
              flush=True)

    # 11.2: a planned run at full width through Session.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    spec = JobSpec(arch="granite-3-2b", reduced=False, steps=4, batch=4,
                   seq=512, log_every=1, use_planner=True)
    session = Session(spec, device="cuda")
    rep = session.train()
    peak = torch.cuda.max_memory_allocated()
    validate_report(rep.to_dict())
    m, p = rep.measured, rep.plan
    run, _ = session.build_run_opt()
    if rep.predicted["lemma31"]["source"] != "measured":
        fail("the planned run's Lemma 3.1 is not from its measured R_O")
    if not all(map(math.isfinite, m["losses"])):
        fail(f"planned full-width losses {m['losses']}: not finite")
    print(f"[plan] Session.train(use_planner=True), granite-3-2b full width "
          f"(40 layers), batch 4 x seq 512, 4 steps, the plan's knobs "
          f"(attn_impl {run.attn_impl}, remat {run.remat}, microbatch "
          f"{run.microbatch}, {p['opt_kind']}): losses "
          f"{[round(x, 4) for x in m['losses']]}; tokens/s "
          f"{m['tokens_per_s']:.1f}, R_O {m['r_o']:.4f}, peak memory "
          f"{peak / 1e9:.2f} GB (max_memory_allocated), steady step phases "
          f"(s) {json.dumps(m['step_times_mean'])}; {time.perf_counter() - t1:.1f} s",
          flush=True)
    print(f"[plan] beside the plan's estimates for its own shape (32 x 4096 "
          f"a card of h100-8, optimizer state sharded over dp 8; not this "
          f"run's shape): est_step_time {p['est_step_time']:.4f} s, "
          f"est_memory_gb {p['est_memory_gb']:.2f}", flush=True)
    plan = session.resolved_plan
    del rep, session
    torch.cuda.empty_cache()

    # 11.3: from_plan at dp = 1, one rank on a TCPStore, against the
    # trainer built with the plan's schedule by name
    cfg = get_config("granite-3-2b").replace(num_layers=4)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True,
                          timeout=timedelta(seconds=120))
    out = {}
    for name in ("from_plan", "by_name"):
        params = smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"),
                                  cfg)
        opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)
        kw = dict(devices=["cuda:0"], rank=0, world=1,
                  store=dist.PrefixStore(name, store))
        if name == "from_plan":
            tr = DataParallelTrainer.from_plan(plan, cfg, run, opt, **kw)
        else:
            tr = DataParallelTrainer(cfg, run, opt,
                                     strategy=plan.sync_schedule,
                                     topology=plan.cluster, **kw)
        try:
            res = tr.train(batch=4, seq=512, steps=3, params=params,
                           log_every=0)
            out[name] = (res.losses, tr.params[0], tr.report(),
                         (tr.strategy.n_servers, tr.strategy.tiers))
        finally:
            tr.close()
        del tr, params
    same = (out["from_plan"][0] == out["by_name"][0]
            and trees_equal(torch, tree_items, out["from_plan"][1],
                            out["by_name"][1]))
    rep, named = out["from_plan"][2], out["by_name"][2]
    sized = plan.resolve_sync()
    print(f"[plan] DataParallelTrainer.from_plan, rank 0 of 1 (NCCL on a "
          f"TCPStore), 4 layers, the planned run, 3 steps: strategy "
          f"{rep.strategy} (the plan's {plan.sync_schedule}), (n_servers, "
          f"tiers) {out['from_plan'][3]} (plan.resolve_sync(): "
          f"{(sized.n_servers, sized.tiers)}; by name "
          f"{out['by_name'][3]}), link_bw {rep.link_bw:.3e} (by name "
          f"{named.link_bw:.3e}, the plan's {plan.link_bw:.3e}); losses "
          f"{out['from_plan'][0]}; params bitwise equal to the trainer built "
          f"with '{plan.sync_schedule}' by name: {same} (at dp = 1 every "
          f"sync is the identity, so this holds the trainer's plumbing, not "
          f"the strategy's sizing); phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rep.strategy != plan.sync_schedule or not same:
        fail("the from_plan trainer and the trainer built by name differ")
    if out["from_plan"][3][0] != sized.n_servers:
        fail("the from_plan trainer's n_servers is not plan.resolve_sync()'s")
    if not rep.link_bw == named.link_bw == plan.link_bw:
        fail("the from_plan and by-name trainers price Lemma 3.2 on "
             "different links")
    del out, store
    torch.cuda.empty_cache()
    moved = {name: fn.launches for name, fn in wrappers.items()
             if fn.launches}
    if moved:
        fail(f"phase 11 launched kernels: {moved}")
    print("[plan] no kernel launched on the planned paths", flush=True)


def tune_session_phase(torch, wrappers) -> None:
    """Phase 12: Session.tune() (see the module docstring)."""
    import shutil
    import tempfile

    from repro_torch.api import JobSpec, Session, validate_report
    from repro_torch.core import memory_model as mm
    from repro_torch.core.autotune import Calibration, cached_calibration
    from repro_torch.kernels import flash_attention_train as fat
    from repro_torch.kernels import ops

    def counted(fn):
        """fn() with the four launch counters zeroed just before and read
        just after."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        return out, {name: w.launches for name, w in wrappers.items()}

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tune_", dir=root))
    cache = tmp / "calibration_cache.json"
    spec = JobSpec(arch="granite-3-2b", reduced=False, batch=2, seq=512,
                   steps=2, log_every=1, tune=True, tune_steps=3,
                   tune_cache=str(cache))
    t_phase = time.perf_counter()
    try:
        # 12.1: the tune run, full width
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        session = Session(spec, device="cuda")
        rep, launches = counted(session.tune)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        validate_report(rep.to_dict())
        if launches != TUNE_LAUNCHES:
            fail(f"Session.tune(): launches {launches} != {TUNE_LAUNCHES} "
                 "(only the bench stage may launch the kernels)")
        t = rep.measured["tuning"]
        for op, entry in t["kernels"].items():
            bad = {n: e for n, e in entry["errors"].items()
                   if n.startswith("kernel")}
            if bad:
                fail(f"Session.tune(): {op} kernel variants raised: {bad}")
            print(f"[tune-session] {op}: chosen {entry['chosen']}; times "
                  + ", ".join(f"{n} {v * 1e3:.4f} ms"
                              for n, v in entry["times_s"].items()),
                  flush=True)
        hold_variants(torch, ops, TUNE_CHUNKS, "Session.tune()")
        mb = t["minibatch"]
        chosen, hbm = mb["chosen"], mb["m_gpu_bytes"]
        if not (mm.m_bound(mm.ALEXNET, chosen, hbm) >= 0
                > mm.m_bound(mm.ALEXNET, chosen + 1, hbm)):
            fail(f"minibatch {chosen} is not the m_bound edge on {hbm} B")
        p = session.resolved_plan
        mesh = session.mesh_spec
        fresh = mm.max_microbatch(
            session.cfg_full, session.shape, dp=mesh.dp, tp=mesh.tp,
            fsdp=p.fsdp, attn_impl=p.attn_impl, remat=p.remat,
            seq_parallel=p.seq_parallel, hbm_bytes=mesh.chip.hbm_bytes,
            opt_kind=p.opt_kind)
        if mb["microbatch"]["chosen"] != fresh:
            fail(f"microbatch {mb['microbatch']['chosen']} != "
                 f"max_microbatch {fresh} for the production job")
        r, cal = t["replan"], t["calibration"]
        if not r["calibrated_closer"]:
            fail(f"the calibrated estimate {r['est_step_time_calibrated_s']} "
                 f"s is not closer to the measured {r['measured_step_s']} s "
                 f"than the data sheet's {r['est_step_time_uncalibrated_s']}")
        key = Calibration.from_dict(cal).key
        if key.count("/") != 2 or cached_calibration(cache, key) is None:
            fail(f"the cache does not hold {key!r}")
        m, prod = rep.measured, r["production"]
        print(f"[tune-session] Session.tune(), granite-3-2b full width (40 "
              f"layers), measured at batch 2 x seq 512, 3 steps (auto, no "
              f"remat): launches {launches}; minibatch* {chosen} (m_bound "
              f"edge on {hbm:.4g} B), microbatch* "
              f"{mb['microbatch']['chosen']} (max_microbatch {fresh}, the "
              f"plan's {mb['microbatch']['plan_microbatch']}); best step "
              f"{m['best_step_s']:.4f} s (compute {m['best_compute_s']:.4f}, "
              f"mean {m['mean_step_s']:.4f}); achieved_flops "
              f"{cal['achieved_flops']:.4e} FLOP/s, flops_efficiency "
              f"{r['flops_efficiency']:.4f} of {mesh.chip.peak_flops:.4g}; "
              f"matmul_flops (fp32, n 512) {cal['matmul_flops']:.4e}; hbm_bw "
              f"(triad) {cal['hbm_bw']:.4e} B/s; executed step estimate "
              f"{r['est_step_time_uncalibrated_s']:.4f} s data sheet, "
              f"{r['est_step_time_calibrated_s']:.4f} s calibrated; "
              f"train_4k estimate {prod['uncalibrated']['est_step_time']:.4f}"
              f" s data sheet, {prod['calibrated']['est_step_time']:.4f} s "
              f"calibrated; key {key}; peak {peak / 1e9:.2f} GB "
              f"(max_memory_allocated); {wall:.1f} s", flush=True)
        spans = {name: round(session.last_tracer.total_s(name), 4)
                 for name in ("bench_kernels", "measure", "tune_overlap",
                              "replan")}
        print(f"[tune-session] spans (s) {json.dumps(spans)}", flush=True)

        # 12.2: a second session on the same cache
        again = Session(spec, device="cuda")
        rep2, launches2 = counted(again.tune)
        validate_report(rep2.to_dict())
        if not rep2.measured.get("from_cache"):
            fail("the second session did not read the cache")
        if again.last_tracer.events("measure"):
            fail("the cached session measured again")
        if launches2 != TUNE_LAUNCHES:
            fail(f"cached Session.tune(): launches {launches2} != "
                 f"{TUNE_LAUNCHES}")
        print(f"[tune-session] cached session: from_cache "
              f"{rep2.measured['from_cache']}, no measure span, launches "
              f"{launches2}", flush=True)
        del again, rep2

        # 12.3: train() adopts the tuned knobs; it trains in bf16, so the
        # fp32 training attention launches nothing either
        zero_counts(torch, fat.ENTRIES)
        trep, launches3 = counted(session.train)
        launches3.update(read_counts(torch, fat.ENTRIES))
        validate_report(trep.to_dict())
        run, _ = session.build_run_opt()
        want_attn = ("dense" if t["kernels"]["flash_attention"]["chosen"]
                     == "ref" else "auto")
        want_mb = max(min(mb["microbatch"]["chosen"], spec.batch), 1)
        if (run.attn_impl, run.microbatch) != (want_attn, want_mb):
            fail(f"tuned run ({run.attn_impl}, {run.microbatch}) != "
                 f"({want_attn}, {want_mb})")
        if "tuning" not in trep.measured:
            fail("the tuned train report holds no tuning section")
        if any(launches3.values()):
            fail(f"the tuned train() launched kernels: {launches3}")
        losses = trep.measured["losses"]
        if not all(map(math.isfinite, losses)):
            fail(f"tuned losses {losses}: not finite")
        print(f"[tune-session] train() with the tuned knobs (attn_impl "
              f"{run.attn_impl}, microbatch {run.microbatch}, remat "
              f"{run.remat}): losses {[round(x, 4) for x in losses]}; "
              f"tokens/s {trep.measured['tokens_per_s']:.1f}; launches "
              f"{launches3}", flush=True)
        del trep
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 12.4: the production plan priced on the measured constants
    prod_spec = JobSpec(arch="granite-3-2b", shape="train_4k")
    calibrated = Session(prod_spec, calibration=session.tuned.calibration,
                         device="cuda").plan()
    datasheet = Session(prod_spec, device="cuda").plan()
    validate_report(calibrated.to_dict())
    chip = calibrated.plan["topology"]["chip"]
    if chip != "h100-sxm+cal":
        fail(f"the calibrated plan is priced on {chip}, not h100-sxm+cal")
    print(f"[tune-session] calibrated plan, granite-3-2b full, train_4k on "
          f"h100-8 (chip {chip}): est_step_time "
          f"{calibrated.plan['est_step_time']:.4f} s (microbatch "
          f"{calibrated.plan['microbatch']}, {calibrated.plan['attn_impl']}, "
          f"remat {calibrated.plan['remat']}); data sheet "
          f"{datasheet.plan['est_step_time']:.4f} s; "
          f"benchmarks/torch_plan_check.py measured 57.0-59.0 s a step at "
          f"this shape with block remat (H100 80GB HBM3, 700 W); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    calibration = session.tuned.calibration
    del session
    torch.cuda.empty_cache()
    return calibration


def pipeline_phase(torch, wrappers, triad_12: float) -> None:
    """Phase 13: 1F1B pipeline parallelism (see the module docstring)."""
    from repro_torch.api import JobSpec, Session, validate_report
    from repro_torch.configs.base import get_config
    from repro_torch.core.autotune import host_microbench
    from repro_torch.distributed.pipeline import PipelineTrainer
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import materialize, tree_items, tree_map
    from repro_torch.optim.adamw import OptConfig

    for fn in wrappers.values():
        fn.launches = 0
    # 13.1: full width through the entry point a user calls, both stages
    # on this one card
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the session's own sync ("auto": the plan's choice); with one shard a
    # stage the trainer syncs nothing, whatever the strategy
    spec = JobSpec(arch="granite-3-2b", reduced=False, pipe=2,
                   n_microbatch=4, batch=4, seq=512, steps=3, log_every=1)
    session = Session(spec, device="cuda")
    rep = session.train()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    validate_report(rep.to_dict())
    m, pr = rep.measured, rep.measured["pipeline"]
    losses = m["losses"]
    hist = m["metrics"]["histograms"]["train/step_s"]
    phases = m["step_times_mean"]
    # the loop's step span: param_refresh, the ops and the gaps between
    # them, sync and update (train/step_s sums only the op spans, sync
    # and update, as JAX's _publish does)
    step_wall = (phases["compute"] + phases["dist_update"]
                 + phases["param_update"])
    print(f"[pipeline] Session.train(pipe 2, n_microbatch 4), granite-3-2b "
          f"full width ({LAYERS} layers, stage cut {pr['stage_cut']}, both "
          f"stages on cuda:0), batch 4 x seq 512, 3 steps, auto attention + "
          f"block remat, sync {m['sync']['strategy']}: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    for s in range(pr["pipe"]):
        print(f"[pipeline] stage {s}: fwd "
              f"{[round(t * 1e3, 2) for t in pr['fwd_times_s'][s]]} ms, bwd "
              f"{[round(t * 1e3, 2) for t in pr['bwd_times_s'][s]]} ms per "
              f"microbatch (best of the steady steps)", flush=True)
    print(f"[pipeline] bubble measured {pr['bubble_measured']:.4f} (the op "
          f"times replayed through the 1F1B DAG), model "
          f"{pr['bubble_model']:.4f}, serial {pr['bubble_serial']:.4f}; "
          f"makespan {pr['makespan_s'] * 1e3:.1f} ms; steady step wall "
          f"(the loop's step span) {step_wall * 1e3:.1f} ms; op spans + "
          f"sync + update (train/step_s) p50 {hist['p50'] * 1e3:.1f} ms "
          f"(min {hist['min'] * 1e3:.1f}, max {hist['max'] * 1e3:.1f}); "
          f"steady step phases (s) {json.dumps(phases)}; tokens/s "
          f"{m['tokens_per_s']:.1f} over the run (first step included); "
          f"peak memory {peak / 1e9:.2f} GB (max_memory_allocated; "
          f"reserved {reserved / 1e9:.2f} GB, {retries} allocator "
          f"retries); phase wall {wall:.1f} s", flush=True)
    if not all(map(math.isfinite, losses)):
        fail(f"pipelined full-width losses {losses}: not finite")
    if pr["bubble_model"] != 0.2:
        fail(f"bubble_model {pr['bubble_model']} != (p-1)/(m+p-1) = 0.2")
    del rep, session
    torch.cuda.empty_cache()

    # 13.2: the 1F1B trainer against the single-stage trainer, fp32
    cfg = get_config("granite-3-2b").replace(num_layers=4, dtype="float32")
    run = RunConfig(attn_impl="auto", remat="block")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    p0 = smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"), cfg)
    pt = PipelineTrainer(cfg, run, opt, pipe=2, n_microbatch=4,
                         devices=["cuda:0", "cuda:0"])
    try:
        res_p = pt.train(batch=4, seq=512, steps=2, log_every=0,
                         params=tree_map(torch.clone, p0))
    finally:
        pt.close()
    dp = DataParallelTrainer(cfg, RunConfig(attn_impl="auto", remat="block",
                                            microbatch=1), opt,
                             devices=["cuda:0"])
    try:
        res_d = dp.train(batch=4, seq=512, steps=2, log_every=0, params=p0)
    finally:
        dp.close()
    # C5's bound: 2e-4 + 2e-4 * max |want|, and 2 * lr + 2e-4 where
    # AdamW's normalized step turns on rounding (the bias-corrected second
    # moment's root below 100 * eps)
    bc2 = 1.0 - opt.b2 ** 2
    sqrt_v = tree_map(lambda v: (v / bc2).sqrt(), dp.opt_states[0]["v"])
    ok, worst, n_eps, worst_eps = adam_close(
        tree_items, pt.params, dp.params[0], sqrt_v, scale=1.0, lr=opt.lr)
    same = trees_equal(torch, tree_items, pt.params, dp.params[0])
    print(f"[pipeline] PipelineTrainer (pipe 2, 4 microbatches, both stages "
          f"on cuda:0) against DataParallelTrainer (dp 1, microbatch 1), "
          f"granite-3-2b full width, 4 layers, fp32, 2 steps: losses "
          f"{res_p.losses} vs {res_d.losses}; params max |diff| "
          f"{worst:.3e} (limit 2e-4 + 2e-4 * max |want| per leaf), and "
          f"{worst_eps:.3e} on the {n_eps} elements whose root second "
          f"moment is below 100 * eps (limit 2 * lr + 2e-4); bitwise "
          f"equal: {same} (printed, not required)", flush=True)
    if not ok:
        fail(f"the 1F1B trainer and the single-stage trainer differ by up "
             f"to {worst} ({worst_eps} where AdamW turns on rounding)")
    del pt, dp, p0
    torch.cuda.empty_cache()
    moved = {name: fn.launches for name, fn in wrappers.items()
             if fn.launches}
    # 13.2's fp32 trainers: 2 steps x 4 microbatches x 4 layers each, the
    # 1F1B trainer's layer forward three times (its fwd op under no_grad,
    # its bwd op's recompute of the stage, block remat's recompute inside
    # that), the single-stage trainer's twice
    want = train_attention(fwd=2 * 4 * 4 * (3 + 2), bwd=2 * 2 * 4 * 4)
    if moved != want:
        fail(f"phase 13 launched {moved}, want {want}: the fp32 training "
             "attention on 13.2 alone")
    print(f"[pipeline] launches on the pipeline path: {moved} (13.2's fp32 "
          "trainers; 13.1's bf16 session launches nothing)", flush=True)

    # 13.3: C6's triad beside phase 12's calibration, and one fused pass
    # a timed call, where the fixed cost of the call (launch and
    # synchronize) is about one pass's time at 32 MiB.  C7: the
    # calibration times the triad at 256 MiB an array on a card, and its
    # hbm_bw must be within 5% of this run's 256 MiB reading.  Right after
    # a heavy phase the card can read low for a second or two (PERF.md,
    # section 6), so the 256 MiB reading is the best of four, 0.5 s apart,
    # each printed
    triad = host_microbench()["triad_bw"]
    bigs = []
    for _ in range(4):
        bigs.append(host_microbench(copy_mb=256)["triad_bw"])
        time.sleep(0.5)
    big = max(bigs)
    one = host_microbench(passes=1)["triad_bw"]
    print(f"[pipeline] host_microbench triad {triad:.4e} B/s at 32 MiB an "
          f"array (JAX's size), {big:.4e} B/s at 256 MiB (the calibration's "
          f"on a card; best of {[f'{b:.4e}' for b in bigs]}; 16 "
          f"torch.add(u, v, alpha=2) passes a timed call, 12 bytes an "
          f"element a pass); one pass a call {one:.4e} B/s at 32 MiB; phase "
          f"12's calibrated hbm_bw {triad_12:.4e} B/s ({triad_12 / big:.4f} "
          f"of the 256 MiB reading)", flush=True)
    if abs(triad_12 / big - 1.0) > 0.05:
        fail(f"phase 12's calibrated hbm_bw {triad_12:.4e} B/s is not within "
             f"5% of the 256 MiB triad {big:.4e} B/s (C7)")


# phase 19: the kernels' contracts on the card, and the lint gate
def contracts_phase(torch, wrappers) -> None:
    """Phase 19 (see the module docstring).  Launches no kernel."""
    import tempfile

    from repro_torch.analysis import kernel_contracts as kc

    t_phase = time.perf_counter()
    card = card_label()
    zero_counts(torch, wrappers)
    rows = kc.card_check("cuda")  # raises KernelError on a contract fault
    for r in rows:
        print(f"[contracts] {r['kernel']}: {r['regs']} registers (cap "
              f"{r['reg_cap']}), {r['spill_bytes']} B spilled; shared "
              f"{r['static_smem']} B static + {r['dyn_smem']} B dynamic "
              f"(mirror {r['mirror_dyn_smem']}); {r['threads']} threads; "
              f"{r['blocks_resident']} blocks per SM resident, "
              f"{r['blocks_claimed']} claimed; headroom {r['headroom']} B "
              f"under {kc.SMEM_OPTIN}", flush=True)
    under = [r["kernel"] for r in rows
             if r["blocks_resident"] < r["blocks_claimed"]]
    print(f"[contracts] {len(rows)} instantiations queried, every dynamic "
          f"size equal to the mirror's, every block resident; below the "
          f"claimed residency: {under or 'none'} ({card})", flush=True)
    lint = _bench_module("torch_lint", folder="tools")
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="lint_", dir=root) as tmp:
        out = Path(tmp) / "torch_lint.json"
        rc = lint.main(["--out", str(out)])
        payload = json.loads(out.read_text())
    if rc != 0 or not payload["clean"] or payload["stale_suppressions"]:
        fail(f"tools/torch_lint.py exited {rc}: "
             f"{payload['findings'][:5]}, stale "
             f"{payload['stale_suppressions']}")
    moved = read_counts(torch, wrappers)
    if any(moved.values()):
        fail(f"phase 19 launched kernels: {moved}")
    print(f"[contracts] torch_lint rc 0: {len(payload['suppressed'])} "
          f"suppressed, 0 stale; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 20: the sharded step and its dry run
def sharded_phase(torch, wrappers) -> None:
    """Phase 20 (see the module docstring)."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import spmd
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as S
    from repro_torch.launch.steps import build_grad_fn
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import materialize, tree_items, tree_map
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_state

    zero_counts(torch, wrappers)
    t_phase = time.perf_counter()
    card = card_label()
    bf16 = torch.bfloat16

    # 20.1: expert parallel at deepseek-v2 width
    ds = get_config("deepseek-v2-236b")
    p = tree_map(lambda a: a[0].to(bf16),
                 materialize(moe.moe_specs(ds, 1), 0, "cuda"))
    x = torch.randn((1, 2048, ds.d_model), dtype=bf16, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(20))
    mesh = mesh_lib.Mesh((1, 1), ("data", "model"))
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    ctx = mesh_lib.make_context(mesh, 0, mesh_lib.groups(
        mesh, 0, store=store, device="cuda"), ds)
    xf = x.reshape(-1, ds.d_model)

    def shards(n):
        e = ds.num_experts // n
        tot = sum(moe._local_expert_pass(
            xf, p["router"], p["w_gate"][i * e:(i + 1) * e],
            p["w_up"][i * e:(i + 1) * e], p["w_down"][i * e:(i + 1) * e],
            ds, 1.25, i * e, e)[0] for i in range(n))
        return tot.to(bf16).reshape(x.shape) + moe.dense_mlp(p["shared"], x)

    with torch.no_grad():
        want, aux = moe.moe_mlp(p, x, ds)
        got, aux_s = moe.moe_mlp_sharded(p, x, ds, mesh=ctx)
        bitwise = torch.equal(got, want) and torch.equal(aux, aux_s)
        errs = {}
        for n in (4, 8):
            err = (shards(n).float() - want.float()).abs()
            lim = TOL + TOL * want.float().abs()
            errs[n] = (float(err.max()), bool((err <= lim).all()))
        e8 = ds.num_experts // 8
        t_plain = device_ms(torch, lambda: moe.moe_mlp(p, x, ds))
        t_ep = device_ms(torch, lambda: moe.moe_mlp_sharded(p, x, ds,
                                                            mesh=ctx))
        t_shard = device_ms(torch, lambda: moe._local_expert_pass(
            xf, p["router"], p["w_gate"][:e8], p["w_up"][:e8],
            p["w_down"][:e8], ds, 1.25, 0, e8))
    print(f"[sharded] 20.1 deepseek-v2 MoE (E 160, k 6, D 5120, F 1536, T "
          f"2048, bf16): moe_mlp_sharded on a one-rank NCCL group bitwise "
          f"equal to moe_mlp: {bitwise}; the sum of _local_expert_pass "
          f"over 4 / 8 emulated shards (+ shared experts) max |err| "
          f"{errs[4][0]:.3e} / {errs[8][0]:.3e} (limit 3e-2 + 3e-2 * |want|)"
          f"; device time moe_mlp {dev_ms(t_plain)} ms, moe_mlp_sharded "
          f"{dev_ms(t_ep)} ms, one of 8 shards' _local_expert_pass "
          f"{dev_ms(t_shard)} ms ({card})", flush=True)
    if not bitwise:
        fail("moe_mlp_sharded on one rank is not bitwise moe_mlp")
    if not (errs[4][1] and errs[8][1]):
        fail(f"the expert shards' partials do not sum to moe_mlp: {errs}")
    del p, x, xf, want, got, ctx, store
    torch.cuda.empty_cache()

    # 20.2: the sharded step at mesh (1, 1), granite-3-2b full width, fp32
    cfg = get_config("granite-3-2b").replace(dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    run = RunConfig(attn_impl="auto", remat="block")
    toks = torch.randint(0, cfg.vocab_size, (4, 512), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(20))
    batch = {"tokens": toks.cuda(), "labels": toks.cuda()}
    ref = smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"), cfg)
    loss_ref, _, grads = build_grad_fn(cfg, run)(ref, batch)
    ref, moments, gnorm = apply_updates(opt, ref, grads, init_state(opt, ref))
    loss_ref, scale = loss_ref.item(), min(1.0, opt.grad_clip / gnorm.item())
    ref = tree_map(lambda a: a.cpu(), ref)
    grads = tree_map(lambda a: a.cpu(), grads)
    del moments  # nothing of the reference step stays on the card
    torch.cuda.empty_cache()

    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    ctx = mesh_lib.make_context(mesh, 0, mesh_lib.groups(
        mesh, 0, store=store, device="cuda"), cfg)
    params = smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"),
                              cfg)
    state = S.zero_state(cfg, mesh, ctx.rules, opt, "cuda")
    step = S.build_train_step(cfg, RunConfig(attn_impl="auto", remat="block",
                                             shard=ctx), opt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    real = D.trace(step, (params, state, batch), [])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    m = real.pop("out")[2]
    ok_p, worst_p, n_eps, worst_eps = adam_close(
        tree_items, params, ref, grads, scale=scale, lr=opt.lr)
    loss = float(m["loss"])
    del grads, ref
    log = []
    mctx = spmd.ShardContext(
        mesh=mesh, rank=0, groups=mesh_lib.recording_groups(mesh, 0, log),
        rules=ctx.rules, specs=ctx.specs)
    meta_args = (S.abstract_params(cfg, mesh, ctx.rules),
                 S.abstract_opt_state(cfg, mesh, ctx.rules, opt),
                 {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in batch.items()})
    meta = D.trace(S.build_train_step(cfg, RunConfig(
        attn_impl="auto", remat="block", shard=mctx), opt), meta_args, log)
    model_bytes = meta["argument_bytes"] + meta["temp_bytes"]
    ratio = meta["temp_bytes"] / (peak - base)
    print(f"[sharded] 20.2 granite-3-2b full width (40 layers) fp32, batch 4"
          f" x seq 512, auto attention + block remat, mesh (1, 1): loss "
          f"{loss:.6f} vs the unsharded step's {loss_ref:.6f}; updated params"
          f" max |diff| {worst_p:.3e} (limit 2e-4 + 2e-4 * max |want| per "
          f"leaf), {worst_eps:.3e} on the {n_eps} elements whose clipped "
          f"gradient is below 100 * eps (limit 2 * lr + 2e-4)", flush=True)
    print(f"[sharded] 20.2 meta dry run of the same step: argument bytes "
          f"{meta['argument_bytes']} (real tensors {real['argument_bytes']})"
          f", FLOPs {meta['flops']} (FlopCounterMode on the real step "
          f"{real['flops']}); temp {meta['temp_bytes'] / 1e9:.3f} GB against"
          f" the step's own peak {(peak - base) / 1e9:.3f} GB "
          f"(max_memory_allocated {peak / 1e9:.3f} GB less "
          f"{base / 1e9:.3f} GB allocated before the step): ratio "
          f"{ratio:.4f}; argument + temp {model_bytes / 1e9:.3f} GB against "
          f"the whole peak: {model_bytes / peak:.4f}; the "
          f"meter on the real step: temp {real['temp_bytes'] / 1e9:.3f} GB;"
          f" meta trace {meta['trace_s']:.1f} s, real step under the meter "
          f"{real['trace_s']:.1f} s ({card})", flush=True)
    if abs(loss - loss_ref) > FP32_TOL + FP32_TOL * abs(loss_ref) or \
            not ok_p:
        fail(f"the sharded step at (1, 1) and the unsharded step disagree: "
             f"loss {loss} vs {loss_ref}, params {worst_p} ({worst_eps} "
             f"where the gradient is below 100 * eps)")
    # the meta step runs attention in plain PyTorch, the real one in the
    # training kernels, which the FLOP counter does not see: the two
    # products, forward and recompute, and their four gradients
    rows, seq = toks.shape
    attn_flops = (LAYERS * 16 * rows * cfg.num_heads * seq * seq
                  * cfg.head_dim)
    print(f"[sharded] 20.2 FLOPs: meta {meta['flops']} = real "
          f"{real['flops']} + the attention products the kernels run "
          f"{attn_flops}: {meta['flops'] == real['flops'] + attn_flops}",
          flush=True)
    if meta["argument_bytes"] != real["argument_bytes"] or \
            meta["flops"] != real["flops"] + attn_flops:
        fail("the meta dry run's argument bytes or FLOPs differ from the "
             "real step's")
    if not 0.85 <= ratio <= 1.15:
        fail(f"the dry run's temp bytes are {ratio:.3f} x the step's own "
             "peak on the card (limit 15%)")
    del params, state, step, real, ctx, store
    torch.cuda.empty_cache()

    # 20.4: microbatch accumulation with the sequence replicated, (1, 1)
    peak_whole, t4 = peak - base, time.perf_counter()
    run4 = RunConfig(attn_impl="auto", remat="block", microbatch=1)
    ref = smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"), cfg)
    loss_ref, _, grads = build_grad_fn(cfg, run4)(ref, batch)
    ref, moments, gnorm = apply_updates(opt, ref, grads, init_state(opt, ref))
    loss_ref, scale = loss_ref.item(), min(1.0, opt.grad_clip / gnorm.item())
    del moments  # the reference and its gradients stay on the card
    torch.cuda.empty_cache()
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    ctx = mesh_lib.make_context(mesh, 0, mesh_lib.groups(
        mesh, 0, store=store, device="cuda"), cfg, seq_parallel=False)
    params = smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"),
                              cfg)
    state = S.zero_state(cfg, mesh, ctx.rules, opt, "cuda")
    step = S.build_train_step(cfg, RunConfig(
        attn_impl="auto", remat="block", microbatch=1, shard=ctx), opt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = float(step(params, state, batch)[2]["loss"])
    peak = torch.cuda.max_memory_allocated()
    ok_p, worst_p, n_eps, worst_eps = adam_close(
        tree_items, params, ref, grads, scale=scale, lr=opt.lr,
        device="cuda")
    del ref, grads
    torch.cuda.empty_cache()
    grad_peak = {}  # the gradients alone, with and without microbatches
    for mb in (1, 0):
        fn = S.build_grad_fn(cfg, RunConfig(
            attn_impl="auto", remat="block", microbatch=mb, shard=ctx))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        b0 = torch.cuda.memory_allocated()
        out = fn(params, batch)
        torch.cuda.synchronize()
        grad_peak[mb] = torch.cuda.max_memory_allocated() - b0
        del out, fn
        torch.cuda.empty_cache()
    print(f"[sharded] 20.4 granite-3-2b full width fp32, the same batch "
          f"(4 x 512) and weights, microbatch 1 (4 passes of one row), "
          f"sequence replicated, mesh (1, 1): loss {loss:.6f} vs the "
          f"unsharded microbatched step's {loss_ref:.6f}; updated params "
          f"max |diff| {worst_p:.3e} (limit 2e-4 + 2e-4 * max |want| per "
          f"leaf), {worst_eps:.3e} on the {n_eps} elements whose clipped "
          f"gradient is below 100 * eps (limit 2 * lr + 2e-4); the step's "
          f"own peak {(peak - base) / 1e9:.3f} GB against 20.2's "
          f"{peak_whole / 1e9:.3f} GB unmicrobatched; the gradients alone "
          f"(build_grad_fn, the same context) {grad_peak[1] / 1e9:.3f} GB "
          f"microbatched against {grad_peak[0] / 1e9:.3f} GB not; 20.4's "
          f"wall {time.perf_counter() - t4:.1f} s ({card})", flush=True)
    if abs(loss - loss_ref) > FP32_TOL + FP32_TOL * abs(loss_ref) or \
            not ok_p:
        fail(f"the microbatched sharded step at (1, 1) and the unsharded "
             f"microbatched step disagree: loss {loss} vs {loss_ref}, "
             f"params {worst_p} ({worst_eps} where the gradient is below "
             f"100 * eps)")
    del params, state, step, ctx, store
    torch.cuda.empty_cache()

    # 20.3: one dry-run record per slot family on the single-pod mesh
    out = Path(__file__).resolve().parent / "build" / "chip_smoke" / \
        f"dryrun_{os.getpid()}"
    try:
        for arch, shape in (("granite-3-2b", "train_4k"),
                            ("deepseek-v2-236b", "decode_32k"),
                            ("musicgen-large", "prefill_32k"),
                            ("jamba-1.5-large-398b", "train_4k")):
            if not D.run_one(arch, shape, "single", out):
                fail(f"dry run {arch} x {shape}: "
                     f"{json.loads((out / f'{arch}__{shape}__single.json').read_text())['error']}")
            r = json.loads((out / f"{arch}__{shape}__single.json")
                           .read_text())
            mem = r["full"]["memory"]
            print(f"[sharded] 20.3 dry run {arch} x {shape} x single (16 x "
                  f"16, rank 0 on meta): per-chip "
                  f"{(mem['argument_bytes'] + mem['temp_bytes'] + mem['output_bytes']) / 2**30:.2f} GiB "
                  f"(arguments {mem['argument_bytes'] / 2**30:.2f}), FLOPs "
                  f"{r['derived']['flops']:.4e}, wire "
                  f"{r['derived']['wire_bytes'] / 2**30:.3f} GiB, "
                  f"{r['full']['n_collectives']} collectives, trace "
                  f"{r['full']['trace_s']} s", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    moved = {n: c for n, c in read_counts(torch, wrappers).items() if c}
    # fp32 granite, 40 layers: 20.2's two steps (1 + 1 pass of the batch),
    # 20.4's two steps and its two gradients (4 + 4 + 4 + 1 passes)
    want = train_attention(fwd=2 * LAYERS * 15, bwd=LAYERS * 15)
    if moved != want:
        fail(f"phase 20 launched {moved}, want {want}: the fp32 training "
             "attention on 20.2's and 20.4's steps alone")
    print(f"[sharded] launches {moved}, the fp32 training attention on "
          f"20.2's and 20.4's steps; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 21: the examples' twins
def examples_phase(torch, wrappers) -> None:
    """Phase 21 (see the module docstring)."""
    import importlib.util
    import shutil
    import tempfile

    from repro_torch.api import validate_report

    zero_counts(torch, wrappers)
    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent
    path = here / "examples" / "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    (here / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=here / "build"))
    cwd = os.getcwd()
    try:
        os.chdir(work)
        rep, srep = mod.main([])
        for r in (rep, srep):
            validate_report(r.to_dict())
        saved = sorted(p.name for p in (work / "results").glob("*.json"))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    losses = rep.measured["losses"]
    if len(losses) != 60 or not all(math.isfinite(x) for x in losses):
        fail(f"torch_quickstart's losses: {losses}")
    if saved != ["torch_quickstart_serve_report.json",
                 "torch_quickstart_train_report.json"]:
        fail(f"torch_quickstart saved {saved}")
    if any(r.meta["device"]["type"] != "cuda" for r in (rep, srep)):
        fail(f"torch_quickstart ran on {rep.meta['device']}")
    moved = {n: c for n, c in read_counts(torch, wrappers).items() if c}
    print(f"[examples] torch_quickstart.main() on the card: reduced "
          f"granite-3-2b, 60 steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {rep.measured['tokens_per_s']:.1f} tok/s; "
          f"serve {srep.measured['n_tokens']} tokens at "
          f"{srep.measured['tokens_per_s']:.1f} tok/s; both Reports valid "
          f"(validate_report) and saved; launches {moved}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s ({card_label()})",
          flush=True)


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def smooth_mixers(params):
    """smooth_attention for every slot and the prelude, GQA or MLA: each
    (L, in, heads, out) attention projection scaled by sqrt(heads / in),
    ``wo`` (L, H, hd, D) by H^-1/2 (tests/test_torch_archs.py::_smooth);
    in place, returns ``params``."""
    for k, v in params.items():
        if k == "mixer":
            for n, a in v.items():
                if n == "wo":
                    a.mul_(a.shape[1] ** -0.5)
                elif a.ndim == 4:
                    a.mul_((a.shape[2] / a.shape[1]) ** 0.5)
        elif isinstance(v, dict):
            smooth_mixers(v)
    return params


class first_tokens:
    """Collect every ContinuousScheduler's per-request time to first token
    (its own ``first_token_s``) while the block runs."""

    def __enter__(self):
        from repro_torch.serve import continuous

        self.cls, self.orig = continuous.ContinuousScheduler, \
            continuous.ContinuousScheduler.run
        self.ttft = []
        orig, ttft = self.orig, self.ttft

        def run(sched):
            out = orig(sched)
            ttft.extend(sched.first_token_s.values())
            return out

        self.cls.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self.orig


def serve_full_width(torch, wrappers, arch, cfg, label, card, tag="moe"):
    """Session.serve() (continuous) of ``cfg`` at full width, twice on one
    session (cold: the first use of every kernel in the process; then
    warm), each with the kernels' counters zeroed just before and read
    just after; fails on a missing token, a non-finite logits row or an
    invalid report.  Returns each run's (launches, prefills, engine
    steps), cold first."""
    from repro_torch.api import JobSpec, Session, validate_report

    spec = JobSpec(arch=arch, reduced=False, requests=4, n_new=16, s_max=512,
                   max_batch=4, serve_mode="continuous")
    session = Session(spec, config=cfg, device="cuda")
    want = [n_new for _, _, n_new in session._serve_workload()]
    runs = []
    for run in ("cold", "warm"):
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with first_tokens() as ft:
            rep = session.serve()
        launches = {n: fn.launches for n, fn in wrappers.items()}
        validate_report(rep.to_dict())
        m = rep.measured
        hists, counters = m["metrics"]["histograms"], m["metrics"]["counters"]
        got = [r["tokens"] for r in m["per_request"]]
        if got != want:
            fail(f"{label}: tokens per request {got} != n_new {want}")
        if counters["serve/nonfinite_logit_rows"]:
            fail(f"{label}: {counters['serve/nonfinite_logit_rows']} logits "
                 "rows hold NaN or inf")
        ttft = sorted(ft.ttft)
        prefills = hists["serve/prefill_s"]["count"]
        steps = m["serving"]["throughput"]["engine_steps"]
        print(f"[{tag}] {label} ({rep.meta['executed_config']['n_params']:,} "
              f"params), Session.serve() continuous, {run}: 4 requests "
              f"(prompts {m['prompt_lengths']}), n_new up to 16: "
              f"{m['n_tokens']} tokens in {m['wall_s']:.3f} s = "
              f"{m['tokens_per_s']:.1f} tok/s; TTFT p50 "
              f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, max "
              f"{ttft[-1] * 1e3:.1f} ms; prefill p50 "
              f"{hists['serve/prefill_s']['p50'] * 1e3:.2f} ms over "
              f"{prefills}; decode step p50 "
              f"{hists['serve/decode_s']['p50'] * 1e3:.2f} ms over {steps} "
              f"steps; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
              f"(max_memory_allocated); launches "
              f"{ {n: c for n, c in launches.items() if c} } ({card})",
              flush=True)
        runs.append((launches, prefills, steps))
        del rep
    del session
    torch.cuda.empty_cache()
    return runs


def moe_mla_phase(torch, mods, wrappers) -> list:
    """Phase 14: MLA, the MoE MLP and the dense prelude (see the module
    docstring).  Returns arctic's kernel cases, each with the launches of
    arctic's serve run."""
    from repro_torch.api import JobSpec, Session, validate_report
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.pipeline import PipelineTrainer
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.launch.steps import build_grad_fn
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import materialize, tree_items, tree_map
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve import continuous
    from repro_torch.serve.continuous import ContinuousEngine, ServeRequest
    from repro_torch.serve.engine import place_prefill_cache

    card = card_label()
    t_phase = time.perf_counter()
    ds = get_config("deepseek-v2-236b")

    # 14.1: deepseek-v2 full width, the prelude and one MLA + MoE cycle,
    # served through the entry point a user calls (MLA runs on "dense":
    # no kernel may launch)
    cfg = ds.replace(num_layers=2)
    runs = serve_full_width(
        torch, wrappers, "deepseek-v2-236b", cfg,
        "deepseek-v2-236b full width, 2 layers (dense prelude + MLA/MoE: "
        "160 experts, top-6, 2 shared)", card)
    if any(any(launches.values()) for launches, _, _ in runs):
        fail(f"deepseek-v2 serving launched kernels: {runs}")

    # the engine's prefill logits and one absorbed-latent decode step, at
    # fp32 on the same weights (init seed 0, the session's): fp32 keeps
    # the router's top-k off the bf16 rounding of two different paths
    cfg32 = cfg.replace(dtype="float32")
    params = M.init_params(cfg32, 0, "cuda")
    L = 256  # a prefill bucket: the engine's forward sees the prompt alone
    g = torch.Generator(device="cuda").manual_seed(14)
    prompts = torch.randint(0, cfg.vocab_size, (2, L + 1), generator=g,
                            device="cuda", dtype=torch.int32)
    eng = ContinuousEngine(cfg32, RunConfig(attn_impl="dense"), params,
                           s_max=512, max_batch=2, device="cuda")
    seen = []
    greedy = continuous.greedy
    continuous.greedy = lambda logits, metrics: (seen.append(logits),
                                                 greedy(logits, metrics))[1]
    try:
        eng.prefill_whole(ServeRequest(0, prompts[0, :L].cpu().numpy(), 1))
    finally:
        continuous.greedy = greedy
    with torch.no_grad():
        ref, _, _ = M.forward(params, {"tokens": prompts[:1, :L]}, cfg32,
                              RunConfig(attn_impl="dense"))
        err_p = (seen[0][0].float() - ref[0, L - 1]).abs().max().item()
        lim_p = FP32_TOL + FP32_TOL * ref[0, L - 1].abs().max().item()
        # decode at position L over the prompts' fp32 caches, against the
        # forward over L + 1 tokens at L with room for every assignment
        # (decode's 2 rows never drop: C >= 4)
        _, caches, _ = M.forward(params, {"tokens": prompts[:, :L]}, cfg32,
                                 RunConfig(attn_impl="dense"),
                                 with_cache=True)
        caches = tree_map(lambda c: torch.nn.functional.pad(
            c, (0, 0) * (c.ndim - 3) + (0, 1)), caches)
        pos = torch.full((2,), L, dtype=torch.int32, device="cuda")
        step, _ = M.decode_step(params, prompts[:, L:], pos, caches, cfg32,
                                RunConfig(attn_impl="dense"))
        full, _, _ = M.forward(
            params, {"tokens": prompts}, cfg32,
            RunConfig(attn_impl="dense",
                      capacity_factor=cfg.num_experts / cfg.top_k))
        err_d = (step[:, 0] - full[:, L]).abs().max().item()
        lim_d = FP32_TOL + FP32_TOL * full[:, L].abs().max().item()
    print(f"[moe] deepseek-v2 2 layers at fp32 on the card: the engine's "
          f"prefill logits (prompt {L}) vs M.forward max |diff| "
          f"{err_p:.3e} (limit {lim_p:.3e}); the absorbed-latent decode "
          f"step at position {L} (2 rows) vs the forward over {L + 1} "
          f"tokens max |diff| {err_d:.3e} (limit {lim_d:.3e}); argmax "
          f"{step[:, 0].argmax(-1).tolist()} vs "
          f"{full[:, L].argmax(-1).tolist()}", flush=True)
    if not err_p <= lim_p:
        fail(f"the engine's prefill logits differ from M.forward by {err_p}")
    if not err_d <= lim_d:
        fail(f"the MLA decode step differs from the forward by {err_d}")
    del eng, caches, seen, ref, full, step

    # what sets a served decode step's pace (bf16, 4 rows at position
    # 64): the whole step, and its cycle's MoE MLP and absorbed-latent
    # MLA alone
    pb = M.cast_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    run = RunConfig(attn_impl="dense")
    toks = prompts[:, :64].repeat(2, 1)
    with torch.no_grad():
        _, caches, _ = M.forward(pb, {"tokens": toks}, cfg, run,
                                 with_cache=True)
        caches = place_prefill_cache(cfg, caches, 128, 64, ring=False)
        pos = torch.full((4,), 64, dtype=torch.int32, device="cuda")
        last = toks[:, -1:]

        def step():
            return M.decode_step(pb, last, pos, caches, cfg, run)

        ms_step = time_ms(torch, step, iters=10)
        n_kernels = sum(c for c, _ in profile_kernels(torch, step, 1).values())
        layer = tree_map(lambda a: a[0], pb["slots"]["slot0"])
        lcache = tree_map(lambda a: a[0], caches["slots"]["slot0"])
        u = torch.randn(4, 1, cfg.d_model, generator=g, device="cuda").to(
            torch.bfloat16)
        ms_moe = time_ms(torch, lambda: moe.moe_mlp(layer["mlp"], u, cfg),
                         iters=10)
        ms_mla = time_ms(torch, lambda: attn.mla_decode(
            layer["mixer"], u, pos, lcache, cfg, "mla"), iters=10)
    print(f"[moe] deepseek-v2 2 layers, one bf16 decode step of 4 rows at "
          f"position 64: {ms_step:.3f} ms (CUDA events, 10 steps), "
          f"{n_kernels or 'not measured'} kernels a step (torch.profiler); "
          f"its MoE MLP alone {ms_moe:.3f} ms, its absorbed-latent MLA "
          f"alone {ms_mla:.3f} ms ({card})", flush=True)
    del pb, caches, layer, lcache
    torch.cuda.empty_cache()

    # 14.2: moe_mlp at deepseek-v2's widths, T = 4 x 512 tokens.  The
    # router's inputs are multiples of 1/2 and 2^-10 (exact fp32 sums on
    # any device in any order), so the card's logits are the CPU's bit for
    # bit, ties included
    E, K = ds.num_experts, ds.top_k
    p = tree_map(lambda a: a[0], materialize(moe.moe_specs(ds, 1), 0, "cuda"))
    gq = torch.Generator(device="cuda").manual_seed(15)
    p["router"] = torch.randint(-8, 9, p["router"].shape, generator=gq,
                                device="cuda").float() * 2.0 ** -10
    x = torch.randint(-2, 3, (4, 512, ds.d_model), generator=gq,
                      device="cuda").float() / 2
    T = x.shape[0] * x.shape[1]
    with torch.no_grad():
        big = 8.0  # C = 615: room for every assignment (64 would need ~70 GB)
        r_big = moe.route(p, x.reshape(T, -1), ds, big)
        got, _ = moe.moe_mlp(p, x, ds, capacity_factor=big)
        want = moe.moe_mlp_ref(p, x, ds)
        err = (got - want).abs().max().item()
        lim = FP32_TOL + FP32_TOL * want.abs().max().item()
        load = torch.bincount(r_big["idx"].reshape(-1), minlength=E)
        del want
        r_card = moe.route(p, x.reshape(T, -1), ds, 1.25)
        r_cpu = moe.route({"router": p["router"].cpu()}, x.reshape(T, -1).cpu(),
                          ds, 1.25)
        same_idx = torch.equal(r_card["idx"].cpu(), r_cpu["idx"])
        keep_card = torch.zeros(T * K, dtype=torch.bool)
        keep_card[r_card["order"].cpu()] = r_card["keep"].cpu()
        keep_cpu = torch.zeros(T * K, dtype=torch.bool)
        keep_cpu[r_cpu["order"]] = r_cpu["keep"]
        same_keep = torch.equal(keep_card, keep_cpu)
    runs = []
    for _ in range(2):
        xr = x.clone().requires_grad_()
        router = p["router"].clone().requires_grad_()
        out, aux = moe.moe_mlp({**p, "router": router}, xr, ds)
        (out.square().mean() + aux).backward()
        runs.append((out.detach(), aux.detach(), xr.grad, router.grad))
        del out, aux, xr, router
    same_runs = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"[moe] moe_mlp at deepseek-v2 widths (D 5120, 160 experts, top-6, "
          f"2 shared, T {T}), fp32: at capacity factor {big} (C "
          f"{r_big['C']}, largest expert load {int(load.max())}: no drop "
          f"{bool(r_big['keep'].all())}) vs moe_mlp_ref max |diff| "
          f"{err:.3e} (limit {lim:.3e}); at 1.25 (C {r_card['C']}, "
          f"{int((~r_card['keep']).sum())} of {T * K} assignments dropped) "
          f"the card's top-k indices equal the CPU's: {same_idx}, keep mask "
          f"equal: {same_keep}; output, aux and the gradients of x and the "
          f"router bitwise equal across two runs: {same_runs}", flush=True)
    if not bool(r_big["keep"].all()) or not err <= lim:
        fail(f"moe_mlp differs from moe_mlp_ref by {err} (drops "
             f"{int((~r_big['keep']).sum())})")
    if not (same_idx and same_keep):
        fail("moe_mlp's routing on the card differs from the CPU's")
    if not same_runs:
        fail("moe_mlp is not deterministic on the card")
    del runs
    pb = tree_map(lambda a: a.to(torch.bfloat16), p)
    del p
    torch.cuda.empty_cache()
    xb = torch.randn(4, 512, ds.d_model, generator=gq, device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        ms = time_ms(torch, lambda: moe.moe_mlp(pb, xb, ds), iters=10)
        dms = device_ms(torch, lambda: moe.moe_mlp(pb, xb, ds), iters=10)
        r = moe.route(pb, xb.reshape(T, -1), ds, 1.25)
    active = int(r["keep"].sum())
    F_ = ds.moe_d_ff
    flops = 2 * 3 * ds.d_model * F_ * (active + T * ds.num_shared_experts)
    nbytes = 2 * (3 * ds.d_model * F_ * (E + ds.num_shared_experts)
                  + ds.d_model * E + 2 * T * ds.d_model)
    b_ms, b_by = bound(nbytes, flops)
    print(f"[moe] moe_mlp forward at deepseek-v2 widths, bf16, capacity "
          f"1.25, T {T}: {ms:.3f} ms a call (CUDA events, 10 calls; device "
          f"time {dev_ms(dms)} ms, every kernel of a call summed); bound "
          f"{b_ms:.3f} ms ({b_by}: every expert's weights read once, "
          f"{active} kept assignments; {card})", flush=True)
    del pb, xb, r
    torch.cuda.empty_cache()

    # 14.3: minicpm3-4b at full width, 8 layers, through Session.train()
    mc = get_config("minicpm3-4b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(JobSpec(arch="minicpm3-4b", reduced=False, steps=4,
                              batch=4, seq=512, log_every=0),
                      config=mc.replace(num_layers=8), device="cuda")
    rep = session.train()
    validate_report(rep.to_dict())
    m = rep.measured
    hist = m["metrics"]["histograms"]["train/step_s"]
    print(f"[moe] minicpm3-4b full width, 8 layers "
          f"({rep.meta['executed_config']['n_params']:,} params), "
          f"Session.train() batch 4 x seq 512, 4 steps, auto attention + "
          f"block remat: losses {[round(v, 4) for v in m['losses']]}; step "
          f"wall p50 {hist['p50'] * 1e3:.1f} ms (min {hist['min'] * 1e3:.1f}"
          f"); tokens/s {m['tokens_per_s']:.1f} over the run; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated); wall {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    if not all(map(math.isfinite, m["losses"])):
        fail(f"minicpm3-4b losses {m['losses']}: not finite")
    run, _ = session.build_run_opt()
    del rep, session
    torch.cuda.empty_cache()

    def card_vs_cpu(label, cfg1, seed):
        """One fp32 loss-and-gradient evaluation of ``cfg1`` on the card
        and on the CPU from the same smoothed weights and tokens."""
        p_cpu = smooth_mixers(materialize(M.model_specs(cfg1), seed, "cpu"))
        p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
        toks = torch.randint(0, cfg1.vocab_size, (2, 64),
                             generator=torch.Generator().manual_seed(seed))
        grads_of = build_grad_fn(cfg1, run)
        out = {}
        for dev, pp in (("cuda", p_gpu), ("cpu", p_cpu)):
            t = toks.to(dev)
            loss, met, gr = grads_of(pp, {"tokens": t, "labels": t})
            aux = met["aux"]
            out[dev] = (loss.item(), float(aux), gr)
        ok, worst = trees_close(tree_items, out["cuda"][2], out["cpu"][2])
        dl = abs(out["cuda"][0] - out["cpu"][0])
        print(f"[moe] {label}, one fp32 loss and gradient, card vs CPU: "
              f"loss {out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f} (aux "
              f"{out['cuda'][1]:.6f} vs {out['cpu'][1]:.6f}); grads max "
              f"|diff| {worst:.3e} (limit 2e-4 + 2e-4 * max |want| a leaf)",
              flush=True)
        if dl > FP32_TOL + FP32_TOL * abs(out["cpu"][0]) or not ok:
            fail(f"{label}: card and CPU differ (loss {dl}, grads {worst})")
        return out["cpu"][1]

    card_vs_cpu("minicpm3-4b full width, 1 layer",
                mc.replace(num_layers=1, dtype="float32"), 4)

    # 14.4: an MoE training step at deepseek-v2's widths with 16 experts:
    # the trainer keeps fp32 masters, gradients and AdamW state whole on
    # one card (no ZeRO: "After the port"), and at 160 experts two layers
    # take ~86 GB of that state alone
    ds16 = ds.replace(num_layers=2, num_experts=16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(JobSpec(arch="deepseek-v2-236b", reduced=False,
                              steps=3, batch=4, seq=512, log_every=0),
                      config=ds16, device="cuda")
    rep = session.train()
    validate_report(rep.to_dict())
    m = rep.measured
    hist = m["metrics"]["histograms"]["train/step_s"]
    print(f"[moe] deepseek-v2 widths, 16 experts (top-6, 2 shared), dense "
          f"prelude + 1 MLA/MoE layer ({rep.meta['executed_config']['n_params']:,}"
          f" params), Session.train() batch 4 x seq 512, 3 steps: losses "
          f"{[round(v, 4) for v in m['losses']]}; step wall p50 "
          f"{hist['p50'] * 1e3:.1f} ms (min {hist['min'] * 1e3:.1f}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated); wall {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    if not all(map(math.isfinite, m["losses"])):
        fail(f"deepseek-v2 (16 experts) losses {m['losses']}: not finite")
    del rep, session
    torch.cuda.empty_cache()
    aux = card_vs_cpu("deepseek-v2 widths, 16 experts, 1 MLA/MoE layer",
                      ds.replace(num_layers=1, first_k_dense=0,
                                 num_experts=16, dtype="float32"), 5)
    if not aux > 0:
        fail(f"the MoE aux loss is {aux}: it does not reach the loss")

    # 14.5: 1F1B on deepseek-v2's reduced config deepened to two cycles a
    # stage, both stages on this card, bitwise the single-stage trainer
    red = ds.reduced().replace(num_layers=1 + 4, dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    p0 = M.init_params(red, 0, "cuda")
    pt = PipelineTrainer(red, RunConfig(attn_impl="auto", remat="block"), opt,
                         pipe=2, n_microbatch=4, devices=["cuda:0", "cuda:0"])
    try:
        res_p = pt.train(batch=8, seq=64, steps=2, log_every=0,
                         params=tree_map(torch.clone, p0))
    finally:
        pt.close()
    dp = DataParallelTrainer(red, RunConfig(attn_impl="auto", remat="block",
                                            microbatch=2), opt,
                             devices=["cuda:0"])
    try:
        res_d = dp.train(batch=8, seq=64, steps=2, log_every=0,
                         params=tree_map(torch.clone, p0))
    finally:
        dp.close()
    same = trees_equal(torch, tree_items, pt.params, dp.params[0])
    print(f"[moe] PipelineTrainer (pipe 2, 4 microbatches, both stages on "
          f"cuda:0; stage cut {pt.stage_cut}, the prelude on stage 0, "
          f"(h, aux) carried) against DataParallelTrainer (dp 1, microbatch "
          f"2), deepseek-v2 reduced with 4 MLA/MoE cycles, fp32, 2 steps: "
          f"losses {res_p.losses} vs {res_d.losses}; params bitwise equal: "
          f"{same}", flush=True)
    if not same:
        fail("the 1F1B trainer on an MoE + prelude model is not bitwise "
             "the single-stage trainer")
    del pt, dp, p0
    torch.cuda.empty_cache()
    moved = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
    if moved:
        fail(f"deepseek-v2/minicpm3 paths launched kernels: {moved}")

    # 14.6: arctic-480b, one layer at full width with 16 experts (at 128
    # one layer is ~13.7e9 params, more than fp32 init + the bf16 copy
    # fit): GQA serves on B1 (prefill) and B2 (decode)
    ac = get_config("arctic-480b")
    runs = serve_full_width(
        torch, wrappers, "arctic-480b", ac.replace(num_layers=1,
                                                   num_experts=16),
        "arctic-480b full width, 1 layer, 16 experts (top-2, dense "
        "residual MLP in parallel)", card)
    for launches, prefills, steps in runs:
        fa_n, dec_n = launches["flash_attention"], launches["decode_attention"]
        if fa_n != prefills or dec_n != steps or not (fa_n and dec_n):
            fail(f"arctic serving: flash launches {fa_n} (prefills "
                 f"{prefills}), decode launches {dec_n} (engine steps "
                 f"{steps})")
    H, KV, D = ac.num_heads, ac.num_kv_heads, ac.head_dim
    out = []
    for S in (32, 64):  # the workload's prompt buckets
        r = flash_case(torch, mods, S=S, H=H, KV=KV, D=D)
        out.append((f"flash_attention[arctic-480b: S={S},H={H},KV={KV},"
                    f"D={D}]", "flash_attention", {**r, "launches": fa_n}))
    r = decode_case(torch, mods, B=4, S=512, pos=[40, 23, 55, 12], H=H,
                    KV=KV, D=D)
    out.append((f"decode_attention[arctic-480b: B=4,S=512,H={H},KV={KV},"
                f"D={D}]", "decode_attention", {**r, "launches": dec_n}))
    print_cases(out)
    print(f"[moe] the three arctic-shape kernel cases above: {card}; phase "
          f"wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


MAMBA_LAYERS = 48  # mamba2-780m


def mamba_phase(torch, mods, wrappers) -> list:
    """Phase 16: the Mamba slot (see the module docstring).  Returns the
    B4 cases at mamba2-780m's serving shapes and jamba's B1, B2 and B4
    cases, each with the launches of its serve run."""
    from repro_torch.api import JobSpec, Session, validate_report
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.pipeline import PipelineTrainer
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.launch.steps import build_grad_fn
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import materialize, tree_items, tree_map
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_state

    card = card_label()
    t_phase = time.perf_counter()
    mamba = get_config("mamba2-780m")
    L = MAMBA_LAYERS

    def zero():
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {n: fn.launches for n, fn in wrappers.items()}

    # 16.1 and 16.2: full-width mamba2-780m through Session.serve(), both
    # modes, the counters zeroed just before and read just after each run
    serve_runs = {}
    for mode in ("continuous", "static"):
        spec = JobSpec(arch="mamba2-780m", reduced=False, requests=8,
                       n_new=32, s_max=512, max_batch=4, serve_mode=mode)
        session = Session(spec, device="cuda")
        work = session._serve_workload()
        want = [n_new for _, _, n_new in work]
        longest = [max(n for _, n, _ in work[i:i + spec.max_batch])
                   for i in range(0, len(work), spec.max_batch)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero()
        rep = session.serve()
        launches = counts()
        validate_report(rep.to_dict())
        m = rep.measured
        hists, counters = m["metrics"]["histograms"], m["metrics"]["counters"]
        got = [r["tokens"] for r in m["per_request"]]
        if got != want:
            fail(f"mamba2 {mode}: tokens per request {got} != n_new {want}")
        if counters["serve/nonfinite_logit_rows"]:
            fail(f"mamba2 {mode}: {counters['serve/nonfinite_logit_rows']} "
                 "logits rows hold NaN or inf")
        prefills = (hists["serve/prefill_s"]["count"] if mode == "continuous"
                    else len(m["batches"]))
        if launches["ssd_scan"] != prefills * L or any(
                c for n, c in launches.items() if n != "ssd_scan"):
            fail(f"mamba2 {mode}: launches {launches}, want ssd_scan "
                 f"{prefills} prefills x {L} and nothing else")
        if mode == "static" and all(n % 4 == 0 for n in longest):
            fail(f"mamba2 static: no batch's longest prompt ({longest}) "
                 "leaves a remainder mod 4")
        meas = m["serving"]["replica_lemma"]["measured"]
        # one engine step: the continuous scheduler observes each step in
        # serve/decode_s, the static engine each batch's whole decode there
        # and its mean step in serve/decode_token_s
        t_step = hists["serve/decode_s" if mode == "continuous"
                       else "serve/decode_token_s"]["mean"]
        print(f"[mamba] mamba2-780m full width ({L} layers, "
              f"{rep.meta['executed_config']['n_params']:,} params), "
              f"Session.serve() {mode}: 8 requests (prompts "
              f"{m['prompt_lengths']}; longest a batch {longest}), n_new up "
              f"to 32, s_max 512, max_batch 4: {m['n_tokens']} tokens in "
              f"{m['wall_s']:.3f} s = {m['tokens_per_s']:.1f} tok/s; "
              f"t_prefill {meas['t_prefill_s'] * 1e3:.2f} ms (mean of "
              f"{hists['serve/prefill_s']['count']}), t_step "
              f"{t_step * 1e3:.2f} ms (mean over "
              f"{m['serving']['throughput']['engine_steps']} engine steps); "
              f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
              f"(max_memory_allocated); launches "
              f"{ {n: c for n, c in launches.items() if c} } = {prefills} "
              f"prefills x {L} ({card})", flush=True)
        serve_runs[mode] = launches["ssd_scan"]
        del rep, session
    torch.cuda.empty_cache()

    # 16.3: the served prefill (B4, bf16) against the plain path (impl
    # "auto" in fp32 on the same bf16-rounded weights and prompt), at
    # phase 6's tolerance; it holds at one layer (phase 6's depth), and
    # the 48-layer distance is printed for information.  41 tokens: a
    # length the kernels' chunks do not divide, padded by ops.ssd_scan
    toks = torch.randint(0, mamba.vocab_size, (1, 41), device="cuda",
                         dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(
                             16))
    for depth in (1, L):
        cfg = mamba.replace(num_layers=depth)
        pb = M.cast_params(M.init_params(cfg, 0, "cuda"), cfg)
        p32 = tree_map(lambda a: a.float(), pb)
        with torch.no_grad():
            zero()
            got, gc, _ = M.forward(pb, {"tokens": toks}, cfg,
                                   RunConfig(attn_impl="kernel"),
                                   with_cache=True)
            n_scan = counts()["ssd_scan"]
            want, wc, _ = M.forward(p32, {"tokens": toks},
                                    cfg.replace(dtype="float32"),
                                    RunConfig(attn_impl="auto"),
                                    with_cache=True)
        V = cfg.vocab_size
        ok, err = within(got[..., :V], want[..., :V], SSD_RTOL, SSD_ATOL)
        ok_h, err_h = within(gc["slots"]["slot0"]["state"],
                             wc["slots"]["slot0"]["state"], SSD_RTOL,
                             SSD_ATOL)
        finite = bool(torch.isfinite(got[..., :V]).all())
        print(f"[mamba] mamba2-780m served prefill, {depth} layer(s), 41 "
              f"tokens: B4 in bf16 ({n_scan} launches) vs impl=\"auto\" in "
              f"fp32 on the same bf16 weights: logits max |diff| {err:.4f} "
              f"(max |want| {want[..., :V].abs().max().item():.3f}), final "
              f"states max |diff| {err_h:.4f} (rtol {SSD_RTOL}, atol "
              f"{SSD_ATOL}: {'within' if ok and ok_h else 'outside'}); "
              f"argmax at the last position "
              f"{int(got[0, -1, :V].argmax())} vs "
              f"{int(want[0, -1, :V].argmax())}", flush=True)
        if n_scan != depth or not finite:
            fail(f"mamba2 prefill at {depth} layers: {n_scan} scan launches "
                 f"or non-finite logits")
        if depth == 1 and not (ok and ok_h):
            fail(f"mamba2 served prefill differs from the plain path by "
                 f"{err} (logits), {err_h} (state)")
        del pb, p32, got, gc, want, wc
        torch.cuda.empty_cache()

    cases = []
    H, P, N = mamba.ssm_heads, mamba.ssm_head_dim, mamba.ssm_state
    for S in (16, 64):  # the continuous workload's prompt buckets
        name = (f"ssd_scan[mamba2-780m serve: B=1,L={S},H={H},P={P},N={N},"
                f"chunk=256]")
        cases.append((name, "ssd_scan", {
            **ssd_case(torch, mods, name, B=1, L=S, H=H, P=P, N=N,
                       chunk=256),
            "launches": serve_runs["continuous"]}))

    # 16.4: jamba at full widths, its first two slots (attention/dense,
    # then Mamba/MoE with all 16 experts): B1, B2 and B4 in one model
    jamba = get_config("jamba-1.5-large-398b")
    jcfg = jamba.replace(num_layers=2, pattern=jamba.pattern[:2])
    runs = serve_full_width(
        torch, wrappers, "jamba-1.5-large-398b", jcfg,
        "jamba-1.5-large full widths, 2 layers (attention/dense, then "
        "Mamba/MoE: 16 experts, top-2)", card, tag="mamba")
    for launches, prefills, steps in runs:
        fa_n, dec_n = launches["flash_attention"], launches["decode_attention"]
        ssd_n = launches["ssd_scan"]
        if fa_n != prefills or dec_n != steps or ssd_n != prefills \
                or launches["paged_decode_attention"] or not (fa_n and dec_n):
            fail(f"jamba serving: launches {launches}, prefills {prefills}, "
                 f"engine steps {steps}")
    Hj, KV, D = jamba.num_heads, jamba.num_kv_heads, jamba.head_dim
    Hs = jamba.ssm_heads
    for S in (16, 64):  # the workload's prompt buckets
        r = flash_case(torch, mods, S=S, H=Hj, KV=KV, D=D)
        cases.append((f"flash_attention[jamba: S={S},H={Hj},KV={KV},D={D}]",
                      "flash_attention", {**r, "launches": fa_n}))
    r = decode_case(torch, mods, B=4, S=512, pos=[42, 8, 40, 9], H=Hj, KV=KV,
                    D=D)
    cases.append((f"decode_attention[jamba: B=4,S=512,H={Hj},KV={KV},D={D}]",
                  "decode_attention", {**r, "launches": dec_n}))
    for S in (16, 64):
        name = (f"ssd_scan[jamba: B=1,L={S},H={Hs},P={P},N={N},chunk=256]")
        cases.append((name, "ssd_scan", {
            **ssd_case(torch, mods, name, B=1, L=S, H=Hs, P=P, N=N,
                       chunk=256), "launches": ssd_n}))
    print_cases(cases)
    print(f"[mamba] the kernel cases above: {card}", flush=True)
    torch.cuda.empty_cache()

    # 16.5: full-width mamba2-780m through Session.train(), 4 steps, no
    # kernel; then one 2-layer fp32 step on the card against the CPU's
    zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(JobSpec(arch="mamba2-780m", reduced=False, steps=4,
                              batch=4, seq=512, log_every=0), device="cuda")
    rep = session.train()
    validate_report(rep.to_dict())
    m = rep.measured
    hist = m["metrics"]["histograms"]["train/step_s"]
    print(f"[mamba] mamba2-780m full width ({L} layers, "
          f"{rep.meta['executed_config']['n_params']:,} params), "
          f"Session.train() batch 4 x seq 512, 4 steps, the plain "
          f"ssd_chunked + block remat, AdamW on fp32 masters: losses "
          f"{[round(v, 4) for v in m['losses']]}; step wall p50 "
          f"{hist['p50'] * 1e3:.1f} ms (min {hist['min'] * 1e3:.1f}); "
          f"tokens/s {m['tokens_per_s']:.1f} over the run; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated); wall {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    if not all(map(math.isfinite, m["losses"])):
        fail(f"mamba2 training losses {m['losses']}: not finite")
    run, _ = session.build_run_opt()
    del rep, session
    torch.cuda.empty_cache()
    cfg = mamba.replace(num_layers=2, dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    p_cpu = materialize(M.model_specs(cfg), 0, "cpu")
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(16))
    grads_of = build_grad_fn(cfg, run)
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        t = toks.to(dev)
        loss, _, g = grads_of(p, {"tokens": t, "labels": t})
        _, _, gnorm = apply_updates(opt, p, g, init_state(opt, p))
        out[dev] = (loss.item(), gnorm.item(), g)
    ok_g, worst_g = trees_close(tree_items, out["cuda"][2], out["cpu"][2])
    ok_p, worst_p, n_eps, worst_eps = adam_close(
        tree_items, p_gpu, p_cpu, out["cpu"][2],
        scale=min(1.0, opt.grad_clip / out["cpu"][1]), lr=opt.lr)
    dl = abs(out["cuda"][0] - out["cpu"][0])
    print(f"[mamba] mamba2-780m 2 layers at full width, one fp32 step, card "
          f"vs CPU: loss {out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f}, "
          f"grad_norm {out['cuda'][1]:.6f} vs {out['cpu'][1]:.6f}; grads max "
          f"|diff| {worst_g:.3e}; updated params max |diff| {worst_p:.3e} "
          f"(limit 2e-4 + 2e-4 * max |want| a leaf), {worst_eps:.3e} on the "
          f"{n_eps} elements whose clipped gradient is below 100 * eps "
          f"(limit 2 * lr + 2e-4)", flush=True)
    if dl > FP32_TOL + FP32_TOL * abs(out["cpu"][0]) or not (ok_g and ok_p):
        fail(f"mamba2 card and CPU step differ: loss {dl}, grads {worst_g}, "
             f"params {worst_p} ({worst_eps} where the gradient is tiny)")
    del out, p_cpu, p_gpu

    # 16.6: 1F1B on jamba's reduced config deepened to two cycles a stage,
    # both stages on this card, bitwise the single-stage trainer
    red = jamba.reduced().replace(num_layers=4 * 2, dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    p0 = M.init_params(red, 0, "cuda")
    pt = PipelineTrainer(red, RunConfig(attn_impl="auto", remat="block"), opt,
                         pipe=2, n_microbatch=4, devices=["cuda:0", "cuda:0"])
    try:
        res_p = pt.train(batch=8, seq=64, steps=2, log_every=0,
                         params=tree_map(torch.clone, p0))
    finally:
        pt.close()
    dp = DataParallelTrainer(red, RunConfig(attn_impl="auto", remat="block",
                                            microbatch=2), opt,
                             devices=["cuda:0"])
    try:
        res_d = dp.train(batch=8, seq=64, steps=2, log_every=0,
                         params=tree_map(torch.clone, p0))
    finally:
        dp.close()
    same = trees_equal(torch, tree_items, pt.params, dp.params[0])
    print(f"[mamba] PipelineTrainer (pipe 2, 4 microbatches, both stages on "
          f"cuda:0; stage cut {pt.stage_cut}) against DataParallelTrainer "
          f"(dp 1, microbatch 2), jamba reduced with 4 attention + "
          f"Mamba/MoE cycles, fp32, 2 steps: losses {res_p.losses} vs "
          f"{res_d.losses}; params bitwise equal: {same}", flush=True)
    if not same:
        fail("the 1F1B trainer on jamba is not bitwise the single-stage "
             "trainer")
    del pt, dp, p0
    torch.cuda.empty_cache()
    moved = {n: c for n, c in counts().items() if c}
    if moved:
        fail(f"the Mamba training paths launched kernels: {moved}")
    print(f"[mamba] no kernel launched on the training paths; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return cases


# phase 15.2: a batch whose memory-model estimate at this shape (auto =
# dense attention at seq 512, block remat, dp 1) exceeds the card's 80 GB
CAMPAIGN_B_OOM = 128


def campaign_phase(torch, wrappers, calibration) -> None:
    """Phase 15: Session.sweep on the card (see the module docstring)."""
    import gc

    from repro_torch.api import Campaign, JobSpec, Session, validate_report
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import memory_model as mm

    t_phase = time.perf_counter()

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    def check(camp, label, n_ok, n_skipped):
        if len(camp) != n_ok or len(camp.skipped) != n_skipped:
            fail(f"{label}: {len(camp)} reports and {len(camp.skipped)} "
                 f"skipped ({camp.skipped}), want {n_ok} and {n_skipped}")
        for rep in camp.reports:
            validate_report(json.loads(rep.to_json()))
        # 15.4: the artifact reads back with the same front
        back = Campaign.from_json(camp.to_json())
        if (len(back) != len(camp) or back.summary()["pareto_indices"]
                != camp.summary()["pareto_indices"]):
            fail(f"{label}: Campaign.from_json changed the campaign")

    def front(camp):
        return [{k: v for k, v in c.items()
                 if k in camp.grid or k in ("tokens_per_s", "efficiency")}
                for c in camp.summary()["pareto"]]

    # 15.1: plan sweeps, uncalibrated and on phase 12's Calibration
    base = JobSpec(arch="granite-3-2b", steps=2, batch=4, seq=32)
    grid = {"topology": ["h100-8", "h100-2x8"],
            "arch": ["granite-3-2b", "mamba2-780m"], "batch": [4, 8]}
    zero()
    plain = Session.sweep(base, grid, kind="plan", device="cuda")
    cal = Session.sweep(base, grid, kind="plan", calibration=calibration,
                        device="cuda")
    for camp, label in ((plain, "plan sweep"), (cal, "calibrated plan sweep")):
        check(camp, label, 8, 0)
        if not camp.summary()["pareto"]:
            fail(f"{label}: empty Pareto front")
    chips = {r.plan["topology"]["chip"] for r in cal.reports}
    if chips != {"h100-sxm+cal"}:
        fail(f"calibrated plan sweep priced on {chips}")
    print(f"[campaign] plan sweep, topology x arch x batch (8 cells each): "
          f"Pareto front uncalibrated {json.dumps(front(plain))}; on phase "
          f"12's calibration ({calibration.key}: achieved_flops "
          f"{calibration.achieved_flops:.4e} FLOP/s, hbm_bw "
          f"{calibration.hbm_bw:.4e} B/s) {json.dumps(front(cal))}",
          flush=True)
    for c_u, c_c in zip(plain.metrics(), cal.metrics()):
        print(f"[campaign]   {c_u['topology']:8s} {c_u['arch']:12s} batch "
              f"{c_u['batch']}: {c_u['tokens_per_s']:,.1f} tok/s eff "
              f"{c_u['efficiency']:.4f} ({c_u['schedule']}) | calibrated "
              f"{c_c['tokens_per_s']:,.1f} tok/s eff {c_c['efficiency']:.4f} "
              f"({c_c['schedule']})", flush=True)
    bad = Session.sweep(base, {"dp": [1, 3]}, kind="plan", device="cuda")
    check(bad, "dp sweep", 1, 1)
    print(f"[campaign] {{'dp': [1, 3]}}: skipped {bad.skipped}", flush=True)

    # 15.2: a train sweep at full width; the first cell cannot fit
    cfg = get_config("granite-3-2b")
    est = mm.train_memory(
        cfg, ShapeConfig("cell", 512, CAMPAIGN_B_OOM, "train"), dp=1, tp=1,
        fsdp=False, microbatch=CAMPAIGN_B_OOM, attn_impl="dense",
        remat="block", seq_parallel=False).total
    if est <= 80e9:
        fail(f"batch {CAMPAIGN_B_OOM}: the memory model's {est / 1e9:.2f} GB "
             "does not exceed 80 GB")
    base = JobSpec(arch="granite-3-2b", reduced=False, seq=512, steps=3,
                   log_every=0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    zero()
    t0 = time.perf_counter()
    train = Session.sweep(base, {"batch": [CAMPAIGN_B_OOM, 2, 4]},
                          kind="train", device="cuda")
    wall = time.perf_counter() - t0
    launches = counts()
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(train, "train sweep", 2, 1)
    skip = train.skipped[0]
    if (skip["cell"] != {"batch": CAMPAIGN_B_OOM}
            or not skip["error"].startswith("OutOfMemoryError")):
        fail(f"train sweep skipped {skip}, want batch {CAMPAIGN_B_OOM} with "
             "OutOfMemoryError")
    if train.cells != [{"batch": 2}, {"batch": 4}]:
        fail(f"train sweep ran {train.cells}")
    for cell, rep in zip(train.cells, train.reports):
        losses = rep.measured["losses"]
        if not all(map(math.isfinite, losses)):
            fail(f"train sweep {cell}: losses {losses} not finite")
        if not rep.measured["tokens_per_s"] > 0:
            fail(f"train sweep {cell}: tokens/s "
                 f"{rep.measured['tokens_per_s']}")
    if any(launches.values()):
        fail(f"the train sweep launched kernels: {launches}")
    if abs(after - before) > 2**30:
        fail(f"memory_allocated {after / 1e9:.3f} GB after the train sweep "
             f"against {before / 1e9:.3f} GB before: a cell's state was kept")
    print(f"[campaign] train sweep, granite-3-2b full width ({LAYERS} "
          f"layers), seq 512, 3 steps, batch [{CAMPAIGN_B_OOM}, 2, 4]: batch "
          f"{CAMPAIGN_B_OOM} (memory model {est / 1e9:.2f} GB) skipped "
          f"({skip['error'].splitlines()[0][:160]}); "
          + "; ".join(f"batch {c['batch']}: losses "
                      f"{[round(x, 4) for x in r.measured['losses']]}, "
                      f"{r.measured['tokens_per_s']:.1f} tok/s"
                      for c, r in zip(train.cells, train.reports))
          + f"; launches {launches}; memory_allocated {before / 1e9:.3f} GB "
          f"before, {after / 1e9:.3f} GB after; {wall:.1f} s", flush=True)
    del train

    # 15.3: a serve sweep at full width on B1 (prefill) and B2 (decode)
    base = JobSpec(arch="granite-3-2b", reduced=False, requests=8, n_new=16,
                   s_max=512)
    zero()
    t0 = time.perf_counter()
    serve = Session.sweep(base, {"max_batch": [2, 4]}, kind="serve",
                          device="cuda")
    wall = time.perf_counter() - t0
    launches = counts()
    check(serve, "serve sweep", 2, 0)
    prefills = sum(r.measured["metrics"]["histograms"]["serve/prefill_s"]
                   ["count"] for r in serve.reports)
    steps = sum(r.measured["serving"]["throughput"]["engine_steps"]
                for r in serve.reports)
    if launches["flash_attention"] != prefills * LAYERS:
        fail(f"serve sweep: flash launches {launches['flash_attention']} != "
             f"prefills {prefills} x {LAYERS}")
    if launches["decode_attention"] != steps * LAYERS:
        fail(f"serve sweep: decode launches {launches['decode_attention']} "
             f"!= engine steps {steps} x {LAYERS}")
    print(f"[campaign] serve sweep, granite-3-2b full width, 8 requests, "
          f"n_new 16, s_max 512, max_batch [2, 4]: "
          + "; ".join(f"max_batch {c['max_batch']}: "
                      f"{r.measured['tokens_per_s']:.1f} tok/s, "
                      f"{r.measured['serving']['throughput']['engine_steps']}"
                      " engine steps"
                      for c, r in zip(serve.cells, serve.reports))
          + f"; launches {launches} ({prefills} prefills, {steps} engine "
          f"steps, x {LAYERS}); {wall:.1f} s", flush=True)
    print(f"[campaign] every campaign read back by Campaign.from_json with "
          f"its pareto_indices; phase wall {time.perf_counter() - t_phase:.1f}"
          f" s ({card_label()})", flush=True)


# phase 17: the last three architectures and the serving options they need
GEMMA_LAYERS = 16  # gemma2-27b served cut to 16 of its 46 layers (8 cycles)
LLAVA_LAYERS = 16  # llava-next-34b served cut to 16 of its 60 layers
TRAIN_LAYERS = 2  # gemma2 (one cycle) and llava trained at 2 layers
LONG_PROMPT, LONG_S_MAX = 4300, 4608  # gemma2: the window (4096) binds


def zero_counts(torch, wrappers) -> None:
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0


def read_counts(torch, wrappers) -> dict:
    torch.cuda.synchronize()
    return {n: fn.launches for n, fn in wrappers.items()}


def served_counts(m, mode: str):
    """(prefills, decode steps) of a serve Report's measured block: a
    continuous run's decode steps are its engine steps, a static batch's
    n_new - 1 (its first token comes from the prefill)."""
    if mode == "continuous":
        return (m["metrics"]["histograms"]["serve/prefill_s"]["count"],
                m["serving"]["throughput"]["engine_steps"])
    return (len(m["batches"]), sum(b["n_new"] - 1 for b in m["batches"]))


def serve_session(torch, wrappers, arch, cfg, mode, label, card, *,
                  requests=8, n_new=32, **kw):
    """Session.serve() of ``cfg`` at full width, the counters zeroed just
    before and read just after; fails on a missing token, a non-finite
    logits row or an invalid report.  Returns (launches, prefills, decode
    steps (:func:`served_counts`), prefill chunks, prompt lengths)."""
    from repro_torch.api import JobSpec, Session, validate_report

    spec = JobSpec(arch=arch, reduced=False, requests=requests, n_new=n_new,
                   s_max=512, max_batch=4, serve_mode=mode, **kw)
    session = Session(spec, config=cfg, device="cuda")
    want = [n for _, _, n in session._serve_workload()]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(torch, wrappers)
    rep = session.serve()
    launches = read_counts(torch, wrappers)
    validate_report(rep.to_dict())
    m = rep.measured
    hists, counters = m["metrics"]["histograms"], m["metrics"]["counters"]
    got = [r["tokens"] for r in m["per_request"]]
    if got != want:
        fail(f"{label} {mode}: tokens per request {got} != n_new {want}")
    if counters["serve/nonfinite_logit_rows"]:
        fail(f"{label} {mode}: {counters['serve/nonfinite_logit_rows']} "
             "logits rows hold NaN or inf")
    prefills, steps = served_counts(m, mode)
    chunks = hists.get("serve/prefill_chunk_s", {}).get("count", 0)
    lengths = m["prompt_lengths"]
    print(f"[zoo] {label} ({rep.meta['executed_config']['n_params']:,} "
          f"params), Session.serve() {mode}: {requests} requests (prompts "
          f"{m['prompt_lengths']}), n_new up to {n_new}, s_max 512, "
          f"max_batch 4{', prefill_chunk ' + str(kw['prefill_chunk']) if kw else ''}: "
          f"{m['n_tokens']} tokens in {m['wall_s']:.3f} s = "
          f"{m['tokens_per_s']:.1f} tok/s; prefill p50 "
          f"{hists['serve/prefill_s']['p50'] * 1e3:.2f} ms over {prefills}"
          f"{' (+' + str(chunks) + ' chunks)' if chunks else ''}; "
          f"{steps} decode steps; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated); launches "
          f"{ {n: c for n, c in launches.items() if c} } ({card})",
          flush=True)
    del rep, session
    torch.cuda.empty_cache()
    return launches, prefills, steps, chunks, lengths


def b2_layers(cfg, s_max: int, ring: bool) -> int:
    """Layers whose decode runs B2: every attention layer but a sliding-
    window one whose cache is a ring (the static engine (``ring``) folds
    its prefill into one of ``window`` slots when ``window < s_max``),
    which decodes on "dense".  Every linear cache runs B2, one exactly as
    long as the window (``s_max == window``) too."""
    w = cfg.sliding_window
    per_cycle = sum(not (ring and slot.mixer == "swa" and w and w < s_max)
                    for slot in cfg.pattern)
    return per_cycle * (cfg.num_layers // len(cfg.pattern))


def expect(label, launches, b1, b2) -> None:
    """B1 and B2 launches exactly ``b1`` and ``b2``, no other kernel."""
    if launches["flash_attention"] != b1 or \
            launches["decode_attention"] != b2 or \
            launches["paged_decode_attention"] or launches["ssd_scan"]:
        fail(f"{label}: launches {launches}, want B1 {b1}, B2 {b2}, no "
             "other kernel")


def train_session(torch, wrappers, arch, cfg, label, card):
    """Session.train() of ``cfg``: 3 steps at batch 4 x seq 512, no kernel
    launch, every loss finite.  Returns nothing; prints the run."""
    from repro_torch.api import JobSpec, Session, validate_report

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(torch, wrappers)
    t0 = time.perf_counter()
    rep = Session(JobSpec(arch=arch, reduced=False, steps=3, batch=4,
                          seq=512, log_every=0), config=cfg,
                  device="cuda").train()
    launches = read_counts(torch, wrappers)
    validate_report(rep.to_dict())
    m = rep.measured
    hist = m["metrics"]["histograms"]["train/step_s"]
    print(f"[zoo] {label} ({rep.meta['executed_config']['n_params']:,} "
          f"params), Session.train() batch 4 x seq 512, 3 steps (auto "
          f"attention, block remat, AdamW on fp32 masters): losses "
          f"{[round(v, 4) for v in m['losses']]}; step p50 "
          f"{hist['p50'] * 1e3:.1f} ms; {m['tokens_per_s']:.1f} tok/s over "
          f"the run; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated); wall {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    if not all(map(math.isfinite, m["losses"])):
        fail(f"{label} training losses {m['losses']}: not finite")
    if any(launches.values()):
        fail(f"{label} training launched kernels: {launches}")
    del rep
    torch.cuda.empty_cache()


def zoo_phase(torch, mods, wrappers) -> list:
    """Phase 17: gemma2-27b, musicgen-large and llava-next-34b, chunked
    prefill, int8 KV caches and sampled decoding (see the module
    docstring).  Returns B1 and B2 cases at the three models' shapes,
    each with the launches of the path that runs it."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import Engine

    card = card_label()
    t_phase = time.perf_counter()
    cases = []
    gemma = get_config("gemma2-27b")
    n_global = sum(s.mixer == "attn" for s in gemma.pattern)

    # 17.1: gemma2 at full widths, 16 layers: both serve modes (s_max 512
    # < window: every cache is linear, B2 on every slot)
    gcut = gemma.replace(num_layers=GEMMA_LAYERS)
    label = (f"gemma2-27b full widths, {GEMMA_LAYERS} of 46 layers "
             f"({GEMMA_LAYERS // 2} swa + global cycles)")
    gem = {}
    for mode in ("continuous", "static"):
        launches, prefills, steps, _, _ = serve_session(
            torch, wrappers, "gemma2-27b", gcut, mode, label, card)
        expect(f"gemma2 {mode}", launches, prefills * GEMMA_LAYERS,
               steps * b2_layers(gcut, 512, mode == "static"))
        gem[mode] = launches

    # 17.2: one Engine.generate of a 4300-token prompt at s_max 4608: B1
    # with the window binding on the swa slots; their caches are 4096-slot
    # rings that wrap, decoded on "dense"; B2 on the global slots only
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(gcut, RunConfig(attn_impl="kernel"), s_max=LONG_S_MAX,
                 device="cuda")
    gen = torch.Generator().manual_seed(17)
    long_prompt = torch.randint(0, gemma.vocab_size, (1, LONG_PROMPT),
                                generator=gen).numpy()
    n_new = 8
    zero_counts(torch, wrappers)
    res = eng.generate(long_prompt, n_new)
    long_launches = read_counts(torch, wrappers)
    ring = eng.s_max > gemma.sliding_window
    print(f"[zoo] gemma2 {GEMMA_LAYERS} layers, Engine.generate of a "
          f"{LONG_PROMPT}-token prompt at s_max {LONG_S_MAX} (window "
          f"{gemma.sliding_window}: swa caches are rings of "
          f"{gemma.sliding_window} that wrap, on dense): {n_new} tokens "
          f"{res.tokens[0].tolist()} ({res.tokens_per_s:.1f} tok/s); "
          f"prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.decode_s / (n_new - 1) * 1e3:.2f} ms a step; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{ {n: c for n, c in long_launches.items() if c} } ({card})",
          flush=True)
    expect("gemma2 long prompt", long_launches, GEMMA_LAYERS,
           b2_layers(gcut, LONG_S_MAX, True) * (n_new - 1))
    if b2_layers(gcut, LONG_S_MAX, True) != (GEMMA_LAYERS // 2) * n_global:
        fail("gemma2 long prompt: the swa slots' caches are not rings")
    if not ring or eng.metrics.counter("serve/nonfinite_logit_rows").value:
        fail("gemma2 long prompt: no ring, or non-finite logits")

    # 17.3: one sampled generate on the card: one seed twice, the same
    # tokens; greedy=True the default
    prompt = long_prompt[:, :48]
    draws = [eng.generate(prompt, n_new, greedy=False, seed=s).tokens
             for s in (5, 5, 6)]
    print(f"[zoo] gemma2 sampled generate (48-token prompt, softmax draws "
          f"on the card): seed 5 {draws[0][0].tolist()} twice "
          f"{'equal' if (draws[0] == draws[1]).all() else 'DIFFERENT'}, "
          f"seed 6 {draws[2][0].tolist()}", flush=True)
    if not (draws[0] == draws[1]).all() or draws[0].max() >= gemma.vocab_size:
        fail("sampled generate: one seed gave two token streams")

    # 17.2 (continued): the same prompt through the continuous engine at
    # s_max 4608, on the same weights: its paged working cache is linear,
    # so B2 runs on every layer, the window binding on the swa slots at
    # positions past 4096; then a static generate at s_max 4096 == window,
    # whose caches are linear too: B2 on every layer
    from repro_torch.serve.continuous import (ContinuousEngine,
                                              ContinuousScheduler)
    from repro_torch.serve.kvcache import PagedKVCache

    ceng = ContinuousEngine(gcut, RunConfig(attn_impl="kernel"), eng.params,
                            s_max=LONG_S_MAX, max_batch=1, device="cuda")
    sched = ContinuousScheduler(ceng, PagedKVCache(
        gcut, block_size=16, n_blocks=LONG_S_MAX // 16, s_max=LONG_S_MAX,
        device="cuda"))
    sched.submit(long_prompt[0], n_new)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(torch, wrappers)
    t0 = time.perf_counter()
    cont_tokens = sched.run()[0]
    cont_launches = read_counts(torch, wrappers)
    wall = time.perf_counter() - t0
    cont_steps = sched.stats["engine_steps"]
    print(f"[zoo] gemma2 {GEMMA_LAYERS} layers, the {LONG_PROMPT}-token "
          f"prompt through the continuous engine at s_max {LONG_S_MAX} "
          f"(linear caches: B2 on the swa slots with the window binding "
          f"past position {gemma.sliding_window}): {n_new} tokens "
          f"{np.asarray(cont_tokens).tolist()} (the static engine's ring: "
          f"{'equal' if np.array_equal(cont_tokens, res.tokens[0]) else 'different'}"
          f") in {wall:.3f} s; {cont_steps} engine steps; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{ {n: c for n, c in cont_launches.items() if c} } ({card})",
          flush=True)
    expect("gemma2 long prompt, continuous", cont_launches, GEMMA_LAYERS,
           b2_layers(gcut, LONG_S_MAX, False) * cont_steps)
    if b2_layers(gcut, LONG_S_MAX, False) != GEMMA_LAYERS or \
            ceng.metrics.counter("serve/nonfinite_logit_rows").value or \
            np.asarray(cont_tokens).shape != (n_new,):
        fail("gemma2 long prompt, continuous: not every layer on B2, "
             "non-finite logits or missing tokens")
    del sched, ceng
    lin = Engine(gcut, RunConfig(attn_impl="kernel"), eng.params,
                 s_max=gemma.sliding_window, device="cuda")
    zero_counts(torch, wrappers)
    short = gemma.sliding_window // 4
    res_lin = lin.generate(long_prompt[:, :short], n_new)
    lin_launches = read_counts(torch, wrappers)
    print(f"[zoo] gemma2 {GEMMA_LAYERS} layers, Engine.generate of a "
          f"{short}-token prompt at s_max {gemma.sliding_window} == window "
          f"(linear caches, B2 on every layer): {n_new} tokens "
          f"({res_lin.tokens_per_s:.1f} tok/s); launches "
          f"{ {n: c for n, c in lin_launches.items() if c} } ({card})",
          flush=True)
    expect("gemma2 s_max == window", lin_launches, GEMMA_LAYERS,
           b2_layers(gcut, gemma.sliding_window, True) * (n_new - 1))
    if b2_layers(gcut, gemma.sliding_window, True) != GEMMA_LAYERS or \
            lin.metrics.counter("serve/nonfinite_logit_rows").value:
        fail("gemma2 s_max == window: not every layer on B2, or non-finite "
             "logits")
    del eng, res, lin, res_lin
    torch.cuda.empty_cache()

    # 17.4: one cycle's prefill logits, B1 (window 4096, cap 50) against
    # the plain dense path on the same bf16 weights, attention smoothed
    g2 = gemma.replace(num_layers=2)
    params = smooth_mixers(M.cast_params(M.init_params(g2, 0, "cuda"), g2))
    toks = torch.as_tensor(long_prompt, device="cuda")
    out = {}
    with torch.no_grad():
        for impl in ("kernel", "dense"):
            zero_counts(torch, wrappers)
            logits, _, _ = M.forward(params, {"tokens": toks}, g2,
                                     RunConfig(attn_impl=impl))
            out[impl] = (logits[0, gemma.sliding_window - 64:,
                                :gemma.vocab_size].float(),
                         read_counts(torch, wrappers)["flash_attention"])
            del logits
    got, want = out["kernel"][0], out["dense"][0]
    err = (got - want).abs().max().item()
    lim = TOL + TOL * want.abs().max().item()
    print(f"[zoo] gemma2 one cycle (swa + global), {LONG_PROMPT}-token "
          f"prefill logits at positions {gemma.sliding_window - 64}.."
          f"{LONG_PROMPT - 1}: B1 ({out['kernel'][1]} launches) vs dense, "
          f"max |diff| {err:.4f} (limit {lim:.4f}); argmax agree at "
          f"{(got.argmax(-1) == want.argmax(-1)).float().mean().item():.4f} "
          f"of positions", flush=True)
    if err > lim or out["kernel"][1] != 2 or not bool(
            torch.isfinite(got).all()):
        fail(f"gemma2 prefill: B1 and dense differ by {err}")
    del params, out, got, want
    torch.cuda.empty_cache()

    # 17.5: gemma2 trained at one cycle
    train_session(torch, wrappers, "gemma2-27b", g2,
                  "gemma2-27b full widths, one cycle (2 of 46 layers)", card)

    # 17.6: musicgen-large whole: both serve modes (4 codebooks; MHA, G =
    # 1, D 64) and training
    mus = get_config("musicgen-large")
    L_mus = mus.num_layers
    musl = {}
    for mode in ("continuous", "static"):
        launches, prefills, steps, _, _ = serve_session(
            torch, wrappers, "musicgen-large", mus, mode,
            f"musicgen-large whole ({L_mus} layers, 4 codebooks)", card)
        expect(f"musicgen {mode}", launches, prefills * L_mus, steps * L_mus)
        musl[mode] = launches
    train_session(torch, wrappers, "musicgen-large", mus,
                  f"musicgen-large whole ({L_mus} layers)", card)

    # 17.7: llava: Engine.generate after a 576-token image prefix, and
    # training with the prefix
    llava = get_config("llava-next-34b")
    lcut = llava.replace(num_layers=LLAVA_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(lcut, RunConfig(attn_impl="kernel"), s_max=1024,
                 device="cuda")
    n_img = llava.num_image_tokens
    prompts = torch.randint(0, llava.vocab_size, (2, 40),
                            generator=gen).numpy()
    lengths = np.array([40, 23], np.int32)
    images = (torch.randn(2, n_img, llava.d_model, generator=gen)
              * 0.02).numpy()
    zero_counts(torch, wrappers)
    res = eng.generate(prompts, 16, lengths=lengths, image_embeds=images)
    llava_launches = read_counts(torch, wrappers)
    plain = eng.generate(prompts, 16, lengths=lengths).tokens
    print(f"[zoo] llava-next-34b full widths, {LLAVA_LAYERS} of 60 layers, "
          f"Engine.generate of 2 rows (prompts {lengths.tolist()} after the "
          f"{n_img}-token image prefix, decode from positions "
          f"{(lengths + n_img).tolist()}), 16 tokens each: "
          f"{2 * 16 / (res.prefill_s + res.decode_s):.1f} tok/s; prefill "
          f"{res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.decode_s / 15 * 1e3:.2f} ms a step; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; tokens differ "
          f"without the prefix: {not (plain == res.tokens).all()}; launches "
          f"{ {n: c for n, c in llava_launches.items() if c} } ({card})",
          flush=True)
    expect("llava generate", llava_launches, LLAVA_LAYERS,
           LLAVA_LAYERS * 15)
    if eng.metrics.counter("serve/nonfinite_logit_rows").value:
        fail("llava generate: non-finite logits")
    del eng, res
    torch.cuda.empty_cache()
    train_session(torch, wrappers, "llava-next-34b",
                  llava.replace(num_layers=TRAIN_LAYERS),
                  f"llava-next-34b full widths, {TRAIN_LAYERS} of 60 layers, "
                  f"{n_img}-token image prefix", card)

    # 17.8: chunked prefill: full-width granite-3-2b continuous with
    # prefill_chunk 16 (prompts longer than 16 go a chunk a tick, in plain
    # PyTorch; shorter ones on B1), then at one layer the last chunk's
    # logits against the whole-prompt prefill's
    granite = get_config("granite-3-2b")
    launches, prefills, steps, chunks, lengths = serve_session(
        torch, wrappers, "granite-3-2b", granite, "continuous",
        "granite-3-2b full width (40 layers)", card, prefill_chunk=16)
    whole = sum(n <= 16 for n in lengths)  # prompts no longer than a chunk
    expect("granite chunked", launches, whole * granite.num_layers,
           steps * granite.num_layers)
    want_chunks = sum(-(-n // 16) for n in lengths if n > 16)
    print(f"[zoo] granite chunked: {chunks} chunks in plain PyTorch (want "
          f"{want_chunks}), {whole} whole-prompt prefills (prompts <= 16) "
          f"on B1", flush=True)
    if chunks != want_chunks:
        fail(f"granite chunked: {chunks} chunks, want {want_chunks}")
    g1 = granite.replace(num_layers=1)
    params = M.cast_params(M.init_params(g1, 0, "cuda"), g1)
    toks = torch.randint(0, granite.vocab_size, (1, 45), generator=gen
                         ).to("cuda")
    with torch.no_grad():
        whole, _, _ = M.forward(params, {"tokens": toks}, g1,
                                RunConfig(attn_impl="kernel"))
        caches = tree_map(lambda sp: torch.zeros(
            sp.shape, dtype=torch.bfloat16, device="cuda"),
            M.cache_specs(g1, 1, 64))
        for lo in range(0, 45, 16):
            chunk = torch.zeros((1, 16), dtype=toks.dtype, device="cuda")
            n = min(16, 45 - lo)
            chunk[:, :n] = toks[:, lo:lo + n]
            lg, caches = M.extend_step(params, chunk, torch.tensor(
                [lo], dtype=torch.int32, device="cuda"), caches, g1,
                RunConfig(attn_impl="kernel"))
    V = granite.vocab_size
    got, want = lg[0, n - 1, :V].float(), whole[0, -1, :V].float()
    err = (got - want).abs().max().item()
    lim = TOL + TOL * want.abs().max().item()
    print(f"[zoo] granite one layer, a 45-token prompt in chunks of 16 "
          f"(extend_step, bf16 caches): first-token logits vs the "
          f"whole-prompt prefill max |diff| {err:.4f} (limit {lim:.4f}), "
          f"argmax {int(got.argmax())} vs {int(want.argmax())}", flush=True)
    if err > lim:
        fail(f"chunked prefill differs from whole-prompt by {err}")

    # 17.9: one int8 decode_step on the card against the CPU's, one
    # full-width granite layer at fp32, 4 teacher-forced steps
    g32 = g1.replace(dtype="float32")
    p_cpu = M.init_params(g32, 0, "cpu")
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    toks = torch.randint(0, granite.vocab_size, (2, 4), generator=gen)
    outs = {}
    for side, dev, p in (("card", "cuda", p_gpu), ("host", "cpu", p_cpu)):
        caches = tree_map(lambda sp: torch.zeros(
            sp.shape, dtype={"int8": torch.int8,
                             "float32": torch.float32}[sp.dtype], device=dev),
            M.cache_specs(g32, 2, 64, kv_quant=True))
        with torch.no_grad():
            for i in range(4):
                lg, caches = M.decode_step(
                    p, toks[:, i:i + 1].to(dev),
                    torch.full((2,), i, dtype=torch.int32, device=dev),
                    caches, g32, RunConfig(attn_impl="kernel"))
        outs[side] = (lg[:, 0, :V].float().cpu(),
                      caches["slots"]["slot0"]["k"].cpu())
    err = (outs["card"][0] - outs["host"][0]).abs().max().item()
    lim = TOL + TOL * outs["host"][0].abs().max().item()
    same = (outs["card"][1] == outs["host"][1]).float().mean().item()
    print(f"[zoo] int8 KV decode_step, one granite layer at fp32, 4 steps: "
          f"card vs CPU logits max |diff| {err:.3e} (limit {lim:.3e}); the "
          f"int8 k cache equal at {same:.6f} of entries (dtype "
          f"{outs['card'][1].dtype})", flush=True)
    if err > lim or outs["card"][1].dtype != torch.int8:
        fail(f"int8 decode: card and CPU differ by {err}")
    del params, p_cpu, p_gpu, outs
    torch.cuda.empty_cache()

    # B1 and B2 at the three models' shapes, each with its path's launches
    Hg, KVg, Dg = gemma.num_heads, gemma.num_kv_heads, gemma.head_dim
    win, cap = gemma.sliding_window, gemma.attn_softcap
    cases.append((f"flash_attention[gemma2 swa prefill: S={LONG_PROMPT},"
                  f"H={Hg},KV={KVg},D={Dg},window={win},cap={cap:g}]",
                  "flash_attention",
                  {**flash_case(torch, mods, S=LONG_PROMPT, window=win,
                                cap=cap, H=Hg, KV=KVg, D=Dg),
                   "launches": long_launches["flash_attention"]}))
    cases.append((f"flash_attention[gemma2 serve: S=64,H={Hg},KV={KVg},"
                  f"D={Dg},window={win},cap={cap:g}]", "flash_attention",
                  {**flash_case(torch, mods, S=64, window=win, cap=cap,
                                H=Hg, KV=KVg, D=Dg),
                   "launches": gem["continuous"]["flash_attention"]}))
    cases.append((f"decode_attention[gemma2 serve: B=4,S=512,H={Hg},"
                  f"KV={KVg},D={Dg},window={win},cap={cap:g}]",
                  "decode_attention",
                  {**decode_case(torch, mods, B=4, S=512, pos=[47, 20, 63, 9],
                                 window=win, cap=cap, H=Hg, KV=KVg, D=Dg),
                   "launches": gem["continuous"]["decode_attention"]}))
    cases.append((f"decode_attention[gemma2 swa, long prompt, continuous: "
                  f"B=1,S={LONG_S_MAX},H={Hg},KV={KVg},D={Dg},window={win},"
                  f"cap={cap:g}]", "decode_attention",
                  {**decode_case(torch, mods, B=1, S=LONG_S_MAX,
                                 pos=[LONG_PROMPT + n_new - 2], window=win,
                                 cap=cap, H=Hg, KV=KVg, D=Dg),
                   "launches": cont_launches["decode_attention"]}))
    cases.append((f"decode_attention[gemma2 global, long prompt: B=1,"
                  f"S={LONG_S_MAX},H={Hg},KV={KVg},D={Dg},cap={cap:g}]",
                  "decode_attention",
                  {**decode_case(torch, mods, B=1, S=LONG_S_MAX,
                                 pos=[LONG_PROMPT + n_new - 2], cap=cap,
                                 H=Hg, KV=KVg, D=Dg),
                   "launches": long_launches["decode_attention"]}))
    Hm, Dm = mus.num_heads, mus.head_dim
    cases.append((f"flash_attention[musicgen serve: S=64,H=KV={Hm},D={Dm}]",
                  "flash_attention",
                  {**flash_case(torch, mods, S=64, H=Hm, KV=Hm, D=Dm),
                   "launches": musl["continuous"]["flash_attention"]}))
    cases.append((f"decode_attention[musicgen serve: B=4,S=512,H=KV={Hm},"
                  f"D={Dm}]", "decode_attention",
                  {**decode_case(torch, mods, B=4, S=512, pos=[47, 20, 63, 9],
                                 H=Hm, KV=Hm, D=Dm),
                   "launches": musl["continuous"]["decode_attention"]}))
    Hl, KVl, Dl = llava.num_heads, llava.num_kv_heads, llava.head_dim
    S_l = n_img + 40
    cases.append((f"flash_attention[llava prefix prefill: B=2,S={S_l},"
                  f"H={Hl},KV={KVl},D={Dl}]", "flash_attention",
                  {**flash_case(torch, mods, S=S_l, B=2, H=Hl, KV=KVl, D=Dl),
                   "launches": llava_launches["flash_attention"]}))
    cases.append((f"decode_attention[llava after the prefix: B=2,S=1024,"
                  f"H={Hl},KV={KVl},D={Dl}]", "decode_attention",
                  {**decode_case(torch, mods, B=2, S=1024,
                                 pos=[n_img + 40 + 7, n_img + 23 + 7],
                                 H=Hl, KV=KVl, D=Dl),
                   "launches": llava_launches["decode_attention"]}))
    print_cases(cases)
    print(f"[zoo] the kernel cases above: {card}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return cases


# phase 18: the port's record cells, appending nothing
def _bench_module(name: str, folder: str = "benchmarks"):
    """``<folder>/<name>.py`` of this checkout, loaded from its file."""
    import importlib.util

    path = Path(__file__).resolve().parent / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def records_phase(torch, wrappers) -> None:
    """Phase 18: the serve, telemetry and ILP cells (see the module
    docstring)."""
    import shutil
    import tempfile
    from contextlib import contextmanager

    from repro_torch.api import Session
    from repro_torch.configs.base import ARCH_IDS

    t_phase = time.perf_counter()
    card = card_label()
    sc = _bench_module("torch_serve_continuous")
    tel = _bench_module("torch_telemetry")
    ilp = _bench_module("torch_ilp_planner")
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="records_", dir=root))
    try:
        # 18.1: static then continuous, each runtime's launches its own
        args = sc.parse_args(["--no-bench-append", "--outdir", str(tmp)])
        launches = {}

        @contextmanager
        def counted(mode):
            zero_counts(torch, wrappers)
            yield
            launches[mode] = read_counts(torch, wrappers)

        torch.cuda.empty_cache()
        out = sc.measure(args, watch=counted)
        want = [n for _, _, n in
                Session(sc.base_spec(args), device=args.device)._serve_workload()]
        for mode in sc.MODES:
            m = out[mode].measured
            got = [r["tokens"] for r in m["per_request"]]
            if got != want:
                fail(f"[records] {mode}: tokens per request {got} != n_new "
                     f"{want}")
            bad = m["metrics"]["counters"]["serve/nonfinite_logit_rows"]
            if bad:
                fail(f"[records] {mode}: {bad} logits rows hold NaN or inf")
            prefills, steps = served_counts(m, mode)
            expect(f"[records] {mode}", launches[mode], prefills * LAYERS,
                   steps * LAYERS)
            print(f"[records] {mode}: {m['n_tokens']} tokens at "
                  f"{m['tokens_per_s']:.1f} tok/s; {prefills} prefills, "
                  f"{steps} decode steps; launches "
                  f"{ {n: c for n, c in launches[mode].items() if c} } "
                  f"(= {prefills} x {LAYERS}, {steps} x {LAYERS}) ({card})",
                  flush=True)
        ok2, msg2 = sc.check_decode_work(out)
        if not ok2:
            fail(f"[records] check 2: {msg2}")
        print(f"[records] check 2 pass: {msg2}", flush=True)
        ok1, msg1 = sc.check_streams(out)
        print(f"[records] check 1 {'pass' if ok1 else 'not held'}: {msg1} "
              f"({out['summary']['init']} init, "
              f"{out['summary']['dtype']}) ({card})", flush=True)
        ok3, msg3 = sc.check_speed(out)
        print(f"[records] check 3 {'pass' if ok3 else 'not held'}: {msg3}; "
              f"engine steps {out['summary']['engine_steps']} ({card})",
              flush=True)
        del out
        torch.cuda.empty_cache()

        # 18.2: the telemetry cell at one rank
        targs = tel.parse_args(["--devices", "1", "--no-bench-append",
                                "--outdir", str(tmp)])
        zero_counts(torch, wrappers)
        tout = tel.measure(targs)
        moved = read_counts(torch, wrappers)
        prefills, steps = served_counts(tout["serve"].measured, "static")
        expect("[records] telemetry (serve, static; its training none)",
               moved, prefills * LAYERS, steps * LAYERS)
        sync = tout["train"].measured["sync"]
        print(f"[records] telemetry: dp 1, {sync['n_buckets']} buckets, "
              f"reconciled; train {tout['train'].measured['tokens_per_s']:.1f}"
              f" tok/s, serve {tout['serve'].measured['tokens_per_s']:.1f} "
              f"tok/s; launches "
              f"{ {n: c for n, c in moved.items() if c} } ({card})",
              flush=True)
        del tout
        torch.cuda.empty_cache()

        # 18.3: the ILP and planner tables, JAX's mesh and one H100 node
        rows = []
        ilp.run(rows)
        for prefix in ("ilp", "planner", "ilp_h100", "planner_h100"):
            n = sum(r[0].split("/")[0] == prefix for r in rows)
            if n != len(ARCH_IDS):
                fail(f"[records] {n} {prefix} rows, want {len(ARCH_IDS)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[records] phase wall {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs on the card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.api import JobSpec, Session, validate_report
    from repro_torch.configs.base import get_config
    from repro_torch.core import autotune
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import flash_attention_train as fat
    from repro_torch.kernels import ssd_scan as ssd_k
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import materialize
    from repro_torch.serve.kvcache import PagedKVCache

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}",
          flush=True)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    hgmma = sum("HGMMA" in line
                for line in _build.sass("flash_attention").splitlines())
    print(f"[build] flash_attention: {hgmma} HGMMA (wgmma) instructions in "
          "the SASS (cuobjdump -sass)", flush=True)
    if hgmma == 0:
        fail("the flash kernel's SASS holds no HGMMA: it does not run on "
             "the tensor cores")
    hmma = sum("HMMA" in line or "HGMMA" in line
               for line in _build.sass("ssd_scan").splitlines())
    print(f"[build] ssd_scan: {hmma} HMMA/HGMMA (tensor-core) instructions "
          "in the SASS (cuobjdump -sass)", flush=True)
    if hmma == 0:
        fail("the scan kernels' SASS holds no HMMA or HGMMA: they do not "
             "run on the tensor cores")

    # 2. kernels ---------------------------------------------------------------
    mods = {"fa_k": fa_k, "dec_k": dec_k, "ssd_k": ssd_k, "ref": ref,
            "ops": ops, "ssm": ssm}
    cases = []
    for S in (8, 16, 32, 64):  # the serving path's prompt buckets
        cases.append((f"flash_attention[S={S}]", "flash_attention",
                      flash_case(torch, mods, S=S)))
    cases.append(("flash_attention[S=512]", "flash_attention",
                  flash_case(torch, mods, S=512)))
    cases.append(("flash_attention[S=2048]", "flash_attention",
                  flash_case(torch, mods, S=2048)))
    cases.append(("flash_attention[S=2048,D=128,H=16,KV=4]", "flash_attention",
                  flash_case(torch, mods, S=2048, D=128, H=16, KV=4)))
    cases.append(("flash_attention[S=2048,window=512,cap=50]",
                  "flash_attention",
                  flash_case(torch, mods, S=2048, window=512, cap=50.0)))
    path_pos = [47, 20, 63, 9]  # rows of the serving batch: s_max 512
    cases.append(("decode_attention[B=4,S=512]", "decode_attention",
                  decode_case(torch, mods, B=4, S=512, pos=path_pos)))
    ragged = [4095, 1000, 2047, 17]
    cases.append(("decode_attention[B=4,S=4096]", "decode_attention",
                  decode_case(torch, mods, B=4, S=4096, pos=ragged)))
    cases.append(("decode_attention[B=4,S=4096,window=1024,cap=30]",
                  "decode_attention",
                  decode_case(torch, mods, B=4, S=4096, pos=ragged,
                              window=1024, cap=30.0)))
    print_cases(cases)

    # 3. serve -----------------------------------------------------------------
    spec = JobSpec(arch="granite-3-2b", reduced=False, requests=8, n_new=32,
                   s_max=512, max_batch=4)
    session = Session(spec, device="cuda")
    fa_k.flash_attention.launches = 0
    dec_k.decode_attention.launches = 0
    rep = session.serve()
    launches = {"flash_attention": fa_k.flash_attention.launches,
                "decode_attention": dec_k.decode_attention.launches}
    m = rep.measured
    hists, counters = m["metrics"]["histograms"], m["metrics"]["counters"]
    prefills = hists["serve/prefill_s"]["count"]
    steps = m["serving"]["throughput"]["engine_steps"]
    want_tokens = [n_new for _, _, n_new in session._serve_workload()]
    got_tokens = [r["tokens"] for r in m["per_request"]]
    if got_tokens != want_tokens:
        fail(f"tokens per request {got_tokens} != n_new {want_tokens}")
    if counters["serve/nonfinite_logit_rows"]:
        fail(f"{counters['serve/nonfinite_logit_rows']} logits rows hold "
             "NaN or inf")
    if launches["flash_attention"] != prefills * LAYERS:
        fail(f"flash launches {launches['flash_attention']} != prefills "
             f"{prefills} x {LAYERS}")
    if launches["decode_attention"] != steps * LAYERS:
        fail(f"decode launches {launches['decode_attention']} != engine "
             f"steps {steps} x {LAYERS}")
    print(f"[serve] granite-3-2b full width: {len(got_tokens)} requests, "
          f"{m['n_tokens']} tokens in {m['wall_s']:.3f} s = "
          f"{m['tokens_per_s']:.1f} tok/s; decode step p50 "
          f"{hists['serve/decode_s']['p50'] * 1e3:.2f} ms over {steps} steps; "
          f"prefill p50 {hists['serve/prefill_s']['p50'] * 1e3:.2f} ms over "
          f"{prefills} prefills; launches {launches}", flush=True)
    validate_report(rep.to_dict())
    lemma = m["serving"]["replica_lemma"]
    pred, meas = lemma["predicted"], lemma["measured"]
    print(f"[serve] report valid (validate_report); replica lemma "
          f"predicted (H100 SXM, 3.35 TB/s): t_step "
          f"{pred['t_step_s'] * 1e3:.3f} ms, t_service "
          f"{pred['t_service_s'] * 1e3:.3f} ms, replicas {pred['replicas']} "
          f"at {pred['arrival_rate']:.3f} req/s; measured: t_step "
          f"{meas['t_step_s'] * 1e3:.3f} ms, t_prefill "
          f"{meas['t_prefill_s'] * 1e3:.3f} ms, t_service "
          f"{meas['t_service_s'] * 1e3:.3f} ms; KV pool "
          f"{m['serving']['kv_cache']['n_blocks']} blocks", flush=True)
    del rep, session

    # 4. reference -------------------------------------------------------------
    reference_check(torch, M, RunConfig, materialize, get_config("granite-3-2b"))

    # 5. paged and scan kernels ------------------------------------------------
    new_cases = []
    q, kp, vp, table, pos = ops.tune_inputs("paged_decode_attention", seq=128)
    new_cases.append(("paged_decode_attention[tune: B=1,H=KV=2,S=128,bs=16]",
                      "paged_decode_attention",
                      paged_case(torch, mods, "paged tune", q, kp, vp, table,
                                 pos)))
    granite = get_config("granite-3-2b")
    g = torch.Generator(device="cuda").manual_seed(6)
    for label, s_max, lengths, window, cap in [
            ("B=4,s_max=512", 512, [100, 300, 50, 512], 0, 0.0),
            ("B=4,S=4096", 4096, [4096, 1000, 2048, 17], 0, 0.0),
            ("B=4,S=4096,window=1024,cap=30", 4096, [4096, 1000, 2048, 17],
             1024, 30.0)]:
        kp, vp, table, poisoned, pos = granite_pools(
            torch, PagedKVCache, granite, s_max=s_max, lengths=lengths)
        q = torch.randn(4, granite.num_heads, granite.head_dim, generator=g,
                        device="cuda").to(torch.bfloat16)
        name = f"paged_decode_attention[granite pools,{label}]"
        new_cases.append((name, "paged_decode_attention",
                          paged_case(torch, mods, name, q, kp, vp, table, pos,
                                     window=window, cap=cap,
                                     kernel_table=poisoned)))
        del kp, vp
    for chunk in (32, 64, 128):
        name = f"ssd_scan[tune: B=1,H=2,L=128,P=32,N=16,chunk={chunk}]"
        new_cases.append((name, "ssd_scan",
                          ssd_case(torch, mods, name, B=1, L=128, H=2, P=32,
                                   N=16, chunk=chunk)))
    name = "ssd_scan[mamba2-780m: B=1,L=2048,H=48,P=64,N=128,chunk=256]"
    new_cases.append((name, "ssd_scan",
                      ssd_case(torch, mods, name, B=1, L=2048, H=48, P=64,
                               N=128, chunk=256, yardstick=True)))
    for label, L, chunk in (("one chunk, Q = L = 192 < chunk", 192, 256),
                            ("ragged Q = 20", 2000, 20)):
        name = (f"ssd_scan[mamba2-780m width, {label}: B=1,L={L},H=48,P=64,"
                f"N=128,chunk={chunk}]")
        new_cases.append((name, "ssd_scan",
                          ssd_case(torch, mods, name, B=1, L=L, H=48, P=64,
                                   N=128, chunk=chunk)))
    print_cases(new_cases)
    print("[kernel] paged: bitwise equal to the linear kernel on the gathered "
          "cache in every case; library = gather_kv_blocks + SDPA, timed "
          "together. ssd_scan: library null, no single PyTorch call computes "
          "the SSD scan; its yardstick is models.ssm.ssd_chunked in bf16 "
          "(ssd_chunked_ms)", flush=True)
    cases += new_cases

    # 5b. the fp32 training attention ------------------------------------------
    for name, kw in (
            ("flash_attention_train[granite-train-s4k: B=2,S=4096,H=32,KV=8,"
             "D=64]", dict(B=2, S=4096, H=32, KV=8, D=64)),
            ("flash_attention_train[granite-train-s512-dp4, a rank: B=4,S=512,"
             "H=32,KV=8,D=64]", dict(B=4, S=512, H=32, KV=8, D=64)),
            ("flash_attention_train[D=128: B=1,S=2048,H=56,KV=8]",
             dict(B=1, S=2048, H=56, KV=8, D=128))):
        r = flash_train_case(torch, **kw)
        print_train_case(name, r)
        cases.append((name, "flash_attention_train", r))
        torch.cuda.empty_cache()

    # 6. mamba layer -----------------------------------------------------------
    mamba_layer_check(torch, ssm, materialize, get_config, ssd_k)

    # 7. tune ------------------------------------------------------------------
    tuned = tune_phase(torch, autotune, ops, {
        "flash_attention": fa_k.flash_attention,
        "decode_attention": dec_k.decode_attention,
        "paged_decode_attention": dec_k.paged_decode_attention,
        "ssd_scan": ssd_k.ssd_scan})
    # B1 and B2 keep the serve phase's counts; B3 and B4 run on this path
    for kernel in ("paged_decode_attention", "ssd_scan"):
        launches[kernel] = tuned[kernel]

    # 8. train -----------------------------------------------------------------
    wrappers = {
        "flash_attention": fa_k.flash_attention,
        "decode_attention": dec_k.decode_attention,
        "paged_decode_attention": dec_k.paged_decode_attention,
        "ssd_scan": ssd_k.ssd_scan}
    # the training path's phases count the training attention's entries too
    trained = {**wrappers, **fat.ENTRIES}
    threaded, launches["flash_attention_train"] = train_phase(torch, trained)

    # 9. processes and overlap ---------------------------------------------------
    procs_phase(torch, trained, threaded)

    # 10. checkpoint and async PS ------------------------------------------------
    ckpt_phase(torch, trained)

    # 11. plan -------------------------------------------------------------------
    plan_phase(torch, trained)

    # 12. tune (Session.tune) ----------------------------------------------------
    calibration = tune_session_phase(torch, wrappers)

    # 13. 1F1B pipeline parallelism ----------------------------------------------
    pipeline_phase(torch, trained, calibration.hbm_bw)

    # 14. MLA, MoE and the dense prelude -------------------------------------------
    cases += moe_mla_phase(torch, mods, wrappers)

    # 15. campaigns (Session.sweep) ------------------------------------------------
    campaign_phase(torch, wrappers, calibration)

    # 16. the Mamba slot -------------------------------------------------------------
    cases += mamba_phase(torch, mods, wrappers)

    # 17. gemma2, musicgen, llava; chunked prefill, int8 KV, sampling ------------------
    cases += zoo_phase(torch, mods, wrappers)

    # 18. records: the serve, telemetry and ILP cells, appending nothing ------------
    records_phase(torch, wrappers)

    # 19. the kernels' contracts on the card, and the lint gate ------------------
    contracts_phase(torch, trained)

    # 20. the sharded step and its dry run ----------------------------------------
    sharded_phase(torch, trained)

    # 21. the examples' twins -------------------------------------------------------
    examples_phase(torch, wrappers)

    leaked = sorted(n for n in sys.modules
                    if n.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                           "repro"))
    if leaked:
        fail(f"the port imported {leaked[:5]}")

    print(card_label())
    # a case of a later path carries that path's launches in r
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[kernel],
         "replaces": REPLACES[kernel], "launches": launches[kernel], **r}
        for name, kernel, r in cases]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
