#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: the quickest proof that the port builds and runs on the GPU.

  python3 chip_smoke.py

It drives five paths of the port: the paper's Lasso solvers (phases 4-6,
with the rest of the solver family, the large-d prox route and the
distributed solvers in 6a-6d),
serving internlm2-1.8b at full width through the paged engine (phases 7-9),
training it at full width through the CA train step (phases 10-11),
mamba2-780m's forward and training at full width through the SSD kernels
(phases 12-14), and the other four model families at their published
widths (phase 15: granite-moe-1b-a400m, deepseek-moe-16b, zamba2-2.7b,
qwen2-vl-2b, whisper-medium), the rest of training (phase 16: the
single-device CA step and the CA-sync solvers in an NCCL group of one,
whisper and qwen2-vl trained at published widths, grad_smoke, gradient
compression, the prox VJP), the sharded train step on a (1, 1) mesh
(phase 18), the rest of serving (phase 17: sampled decode, the prefix
cache, fan-out, the double-buffered loop, and every family through the
engine); and the observability layer (``repro_torch.obs``) over the
Lasso solves and the engine (phases 6e, 9b and 17(d)). ``--only
families`` builds the kernels and runs phase 15 alone, ``--only
training`` phases 16 and 18, ``--only serving`` phase 17.
Every kernel's bound is its registry op's work function
(``kernels.registry.work``: the FLOPs and bytes of the call) against the
card's peaks in ``repro_torch.roofline.hw.H100`` (``roofline.bound_ms``);
this script keeps no peak or bound formula of its own.
What it does, in order; any failure raises and the exit code is not 0:

1. prints the card (``nvidia-smi`` name and power limit), the torch version
   and the compute capability, which must be (9, 0);
2. turns TF32 off, so every plain PyTorch version is full float32, and
   cuBLAS's reduced-precision bf16 reductions off
   (``allow_bf16_reduced_precision_reduction``, True by default), so bf16
   products sum in float32 as XLA sums them;
3. builds every CUDA kernel from ``src/repro_torch/csrc`` with nvcc (one
   process per source, all at once) into ``build/repro_torch/``;
4. kernel phase: holds each kernel against its plain PyTorch version on the
   card at the main path's shapes (the Gram kernels see the augmented data
   [X; y], so d+1 rows), at ragged shapes and (prox_loop) above the
   shared-memory ring's limit, and times kernel, plain version and, for gram,
   ``torch.bmm``. ``gram_gather`` runs over the sample-major rows of
   covtype and susy at full size (the launcher's synthetic data) with real
   draws, which repeat rows: the CA block (k=32) and the classical draw
   (k=1) of each; its G and R must be bitwise ``gram``'s over the gathered
   copy, scaled, and one draw's alone bitwise its slice of the batch; its
   bound counts each distinct row drawn once, and the gather + ``torch.bmm``
   pair is timed beside it as a diagnostic (no single PyTorch call gathers
   and multiplies). Tolerances are normwise (max |kernel - plain| / max
   |plain|): 1e-5 for the prox kernels; for the Gram kernels 2e-6 over all
   of G (and R) and 2e-5 over G's off-diagonal entries against their own
   largest magnitude, limits that float32 sums in m-chunks meet (3e-7 and
   1.2e-6 in a float32 model of the kernel's summation order) and TF32
   products would not (4e-6 and 3.6e-4 in the same model). The block prox
   kernels (``prox_step_block``, ``prox_loop_block``: a k-block of FISTA or
   proximal Newton updates a launch) run at the CA blocks of covtype (k=32,
   d=54) and susy (k=32, d=18, Q=5) from ``gram_gather``'s own output, at
   k = 1, 2 and 7, ragged d = 61 (G from global memory), d = 130 and 160
   (ring stages of one G_i) and d = 300 (the rows route), every
   variant: bitwise their k = 1 instances run k times (FISTA's momentum by
   the eager ops between), each step within 1e-5 of the plain version's
   step from the kernel's own previous iterate (a whole chain of 32
   momentum steps amplifies rounding past that in float32 with no fault:
   its distance from the plain chain is printed beside the plain chain's
   own distance from float64); timed with
   the wrapper's host time, the chain of dependent steps and, as
   diagnostics, the stepwise route they replace and the same block with
   its G_i read from global memory instead of the ring;
5. main path: ``repro_torch.launch.lasso_solve.main`` with T=256, k=32,
   b=0.1, Q=5 on covtype at full size (CA-SFISTA, SFISTA) and on susy at
   full size (CA-SPNM, SPNM). Each run is read for its kernel launches and
   registry dispatches (zeroed just before it: ``gram_gather`` and the
   rule's block prox kernel launched T/k times for CA and T for classical,
   ``gram``, ``prox_step`` and ``prox_loop`` never), its relative
   solution error,
   CA == classical (5e-6) and the card's w against the port's plain solve on
   the card with the same draws and step (1e-4). Then the solve wall of
   each schedule on the same draws: one untimed warm-up solve of each, then
   three timed solves of each in the order CA, classical, classical, CA,
   CA, classical, reported as all six walls and the two medians; 5b: one
   more warm CA-SFISTA covtype solve under ``repro_torch.roofline.analyze``
   (its 8 ``gram_gather`` and 8 ``prox_step_block`` counted by their work
   functions), its three terms beside the measured warm wall;
6. a profiled CA and classical solve of covtype and of susy: device time
   by kernel, the launches and the device's busy share of the wall time;
   no gather or index kernel may run on the solve (the sampled rows are
   read in place), nor an elementwise update kernel (the momentum is
   computed in the block kernel), and the block kernel runs T/k or T
   times;
6a. the rows route of the prox ops (``prox_rows_kernel``, above
   ``ROWS_ABOVE_D``): prox_step_block, prox_loop_block and pdhg_block at
   d = 4,096 (every variant) and 20,480 (past the one-CTA limit), each
   block bitwise k launches of its k = 1 instance and each step within
   1e-5 of the plain step from the kernel's own previous iterate (PDHG's u
   at the scale max(|u|, sigma |w|)); one step of each timed beside its
   bound (G read once a dependent product) and the plain version (the one
   CTA at d = 4,096 as a diagnostic); both routes timed at k = 8 over
   d = 128..512 with the threshold printed beside the d from which the
   rows route won;
6b. PDHG and BCD on covtype at full size: ``pdhg_block`` on the CA block
   (32, 54), every variant, bitwise its k = 1 instance, each step (w, u)
   held to the plain step from its own previous iterate, at sigma = 1/t
   each step held to ISTA's, timed (ring and global memory); CA-PDHG,
   PDHG, CA-BCD and BCD through ``lasso_solve.main`` (pdhg_block and
   gram_gather T/k and T; gram T/k and T for BCD; nothing else), CA-PDHG
   bitwise PDHG, CA-BCD within 2e-5 of BCD, each against its plain solve on
   the card, warm walls and profiles; ``gram`` at BCD's cross-Gram
   (r = 160 over 581,010) against its plain version and ``torch.mm``;
   the elastic net through CA-SFISTA;
6c. the dual SVM on covtype's first 4,096 samples (labels the sign of y,
   box [0, 1], the step 1/L scaled by m/d): ``gram`` at r = 4,096 on a
   real block against its plain version and ``torch.bmm``; CA-PDHG, PDHG
   and CA-SFISTA, the prox on the rows route (one launch a step), CA-PDHG
   bitwise PDHG, near its plain solve and descending, CA-SFISTA inside the
   box;
6d. ``make_distributed_solver`` in an NCCL group of one in this process
   (an in-process store), all eight algorithms on covtype (susy for the
   SPNM pair) with a single-process solve's draws: w bitwise the single
   process's, T/k and T all-reduces, the gram family's words equal;
   distributed and single-process warm walls side by side. Each of 6b-6d
   zeroes the launch counts before its runs and reads them after; every
   kernel of its path must have run;
6e. obs phase (a): phase 5's solves again (CA-SFISTA and SFISTA on
   covtype, CA-SPNM and SPNM on susy, the same draws) with ``host_loop``
   under ``repro_torch.obs.sync_audit``: the audited round trips, the
   marked dispatches and ``HostSyncs.blocks`` all T/k (8) for CA and T
   (256) classical, no sync the CUDA runtime reports (sync-debug mode
   ``warn``, printed beside the counted reads) outside a counted read, and
   w bitwise the solve without the host loop;
7. attention kernel phase: ``flash_attention`` at the model forward's shape
   (B=2, Hq=16, Hkv=8, S=512, D=128, causal, bf16) and at S=1024, ragged
   (S=1000), right-aligned (Sq=64, Skv=1000), not causal (Sq=37, Skv=300),
   at D=64, at zamba2's D=80 (32 heads, zero-padded to 128), in
   float32, and at the families' shapes: whisper's encoder (not causal,
   Sq=Skv=1500, D=64, 16/16 heads), its cross-attention (Sq=448 and, at
   decode, Sq=1 over Skv=1500) and qwen2-vl's group of 6 (12/2 heads,
   S=1536); every shape but the right-aligned causal one is timed, since
   SDPA's causal mask is top-left (the bf16 timings also print the achieved TFLOP/s, model FLOPs
   over kernel time, and the share of the bf16 bound;
   the JSON entry names the tensor-core route, ``wgmma+tma``; at each bf16
   shape the share of outputs that differ from the float32-p plain
   version's must stay under 2%, where p rounded once to bf16 exceeds it);
   ``paged_decode`` at the engine's shape (B=8, Hq=16,
   Hkv=8, D=128, page size 16, 64 pages a slot, valid 1..1024, table
   entries past valid at page 0) with bf16, int8 (with scales) and float32
   pools, with page size 5, at D=80 (32 heads), and in bf16 at the
   engine's own lengths (the first 8 prompts of phase 9 plus 32 tokens);
   at the engine's shape in bf16 and int8 also its row-map and lse
   instance (sharded serving's: each of m = 2 and 4 ranks holds rows
   [r 16/m, (r+1) 16/m) of every page), each slice's o and lse against
   the plain version on the slice, the slices merged
   (``ref.merge_partials``) against the unsplit kernel and the plain
   version, base 0 with the page size as stride bitwise the default
   call, and rank 0's call timed beside its bound (``rows_m2_*``,
   ``rows_m4_*`` in the kernel's JSON entry; on one card the main path
   launches no row-map instance). Each against its plain
   version, normwise (max |kernel - plain| / max |plain|): at most 1e-5
   for float32 outputs (float32 sums in another order) and 8e-3 for bf16
   outputs (one bf16 rounding at the top of the range, 2^-7). Times:
   kernel and plain version with CUDA events after warm-up (paged decode
   behind an L2 flush before each launch, as 24 layers' pools find it: a
   read of a 256 MB buffer, so no dirty line is written back inside the
   span, beside the flush's own floor, an empty launch behind the same
   flush; and back to back;
   flash_attention and its SDPA yardstick also, as a diagnostic, with
   the card asleep while
   the host enqueues the timed span, so a wrapper's host time does not
   hide the kernel's), and the
   library yardstick ``scaled_dot_product_attention``, timed alone on the
   same q/k/v (KV heads repeated beforehand). No single PyTorch call walks
   a page table, so paged decode has no library time; the page gather
   from the table (dequantized for int8) and SDPA with a length mask are
   timed together in one span beside it, as a diagnostic. The port never
   calls either;
8. model phase: first the JAX package's own check (tests/test_models.py)
   at its own size, the smoke config: ``forward`` (flash_attention) and
   the same 64 tokens one at a time through ``decode_step`` on a bf16
   paged cache (paged_decode), every logit within atol = rtol = 0.05.
   Then full width: internlm2-1.8b (24 layers) with bf16 weights from the
   port's ``init_params`` and a seeded ``torch.Generator``; ``forward`` on
   (2, 512) numpy-seeded tokens (flash_attention launched 24 times) and
   the first 128 positions through ``decode_step`` (paged_decode launched
   128 * 24 times; the forward's 512 cut to 128 to keep the run inside
   its time limit),
   every kernel call of both held to its plain version
   on that call's own inputs (normwise 8e-3); the logits of decode,
   forward and both with the plain attention against each other, with
   their atol = rtol = 0.05 margins, and the model's GEMMs at 1,024 rows
   against the same rows two at a time, printed (see ``model_phase``);
9. serve phase, full width: ``Engine(num_slots=8, max_len=1024,
   max_prompt=512, k=8, page_size=16)``, greedy, 16 requests of
   numpy-seeded prompts of 32-512 tokens and 64 new tokens each, every
   block under ``torch.cuda.set_sync_debug_mode("error")``: all retire at
   64 tokens, steps == syncs * k, paged_decode launched steps * 24 times and
   flash_attention never; the same requests at k=1 give bit-identical
   streams; then int8 pages (same accounting; the share of tokens equal
   to the bf16 run is printed, not gated); steady-state tok/s,
   ms/step and ms/sync at k=8 and k=1; one profiled k=8 block (device time by kernel,
   busy share, the paged kernel's own time a launch and its launches a
   step: one paged kernel name, 24 launches a step, no merge kernel); and
   once the CLI, ``repro_torch.launch.serve.main`` with
   ``--preset full --page-size 16``;
9b. obs phase (b)-(d): (b) phase 9's engine with 8 shorter requests
   (prompts of 32-64 tokens, 32 new tokens), once with obs off, then at
   k=8 and k=1 with obs on under a sync audit: the audited round trips ==
   ``EngineStats.syncs`` == the marked dispatches, steps == syncs * k,
   every sync inside the ``serve.decode_block`` span, none the runtime
   reports outside a counted read, the metrics equal to the stats, and the
   streams bit-identical to the obs-off run's; (c) the serve CLI
   (``--preset full``) with ``--metrics`` and ``--trace-out``: the
   Prometheus text parses and agrees with the run, the trace loads with
   the expected span names (the train CLI's run with a failure in phases
   11 and 14 passes both flags and is checked so too, and its metrics
   stay bit-equal to the run without obs); (d)
   the host time of one k=1 round of instrumentation with obs disabled,
   against phase 9's k=1 ms/sync: under 1%;
10. backward kernel phase: the lse forward (o and lse), ``flash_dq`` and
   ``flash_dkv`` at the training shape (B=8, Hq=16, Hkv=8, S=1024, D=128,
   causal, bf16), at phase 7's shapes (ragged S=1000, right-aligned
   Sq=64/Skv=1000, not causal Sq=37/Skv=300, float32 at S=512), at
   zamba2's D=80 and at the families' shapes where grads reach (whisper's
   encoder and cross-attention, granite's train step at D=64 (8, 16/8,
   1024), qwen2-vl's group of 6), each against its plain version, normwise as in phase 7
   (lse absolute, 1e-4); at each bf16 shape the share of dq, dk and dv
   outputs that differ from the float32 plain version's must stay under 2%,
   where p and ds rounded once to bf16 (``ref.flash_dq_rounded``,
   ``flash_dkv_rounded``) exceed it; two launches of each backward kernel
   bit-equal; kernel and plain version timed with CUDA events (each bf16
   kernel's achieved TFLOP/s, of model work and of the work its tensor
   cores run with the hi/lo split, and its share of the bf16 bound beside
   them; the JSON entries name the tensor-core route, ``wgmma+tma``) at
   the training shape and the families' shapes,
   beside their bounds and the library yardstick, the backward of
   ``scaled_dot_product_attention`` (KV heads repeated, its backward timed
   alone);
11. train phase, full width: internlm2-1.8b with float32 masters from a
   seeded ``torch.Generator``, ``make_train_step(ca_k=4, remat=True)`` on
   ``TokenStream(32, 1024, seed 0)``: one warm-up step, then three steps
   with loss and grad norm finite at each, flash_dq and flash_dkv launched
   24 * ca_k times a step and the lse forward twice that (forward and
   recompute); for one microbatch every attention call of the forward and
   the backward held to its plain version on that call's own inputs
   (normwise 8e-3 for o, dq, dk and dv; each lse absolute, 1e-4);
   ms/step, tokens/s, the share of the bf16 peak the model's FLOPs reach,
   peak memory; 11b: one more step under ``repro_torch.roofline.analyze``
   (its FLOPs, HBM and collective bytes, the three terms and the
   bottleneck beside the measured ms a step, and ``mfu``, JAX's 6 N D
   model FLOPs over that time at the bf16 peak); and one profiled step (each port kernel's device time and
   share of the step, and the backward pair's together). Then the JAX
   package's own training checks (tests/test_train.py) on the card at the
   smoke config:
   30 steps on one batch at lr 1e-2 bring the loss below 0.7 of the first,
   the CA-accumulated grad equals the full-batch grad (atol 5e-3, rtol
   5e-2), CA k=2 and the classical schedule both run; and once the CLI,
   ``repro_torch.launch.train --preset tiny --steps 12 --ckpt-every 4
   --fail-at 6`` with ``--metrics`` and ``--trace-out`` (obs phase (c)'s
   train CLI): one restart, its metrics and spans, and the final loss
   bit-equal to a run with no failure and obs off;
12. SSD kernel phase: ``ssd`` (y, the final state and the per-chunk
   states) and ``ssd_bwd`` (dxdt, da, dB and dC per head) at the training
   shape (Bt=8, S=1024, H=48, P=64, N=128, chunk 64, bf16 x), the forward's
   (Bt=2, S=512), ragged (S=1000), shorter than a chunk (S=37), chunk 32,
   the smoke config's heads at chunk 32 and zamba2's heads (H=80, N=64),
   with B and C in bf16 as mamba2 hands them (the tensor-core bodies), then
   with B and C in float32 and in float32 x (the CUDA-core bodies), some
   with mamba2's decay (A = -(1..16)), where exp overflows above the
   diagonal. Each call runs the body its operand types choose (checked by
   its count), against its plain version (which sums in float64),
   normwise: float32 outputs 1e-5, y in bf16 8e-3, da 1e-4 (its reverse
   cumsum subtracts large terms); at each bf16 shape the share of y's bf16
   outputs that differ from the plain version's must stay under 2%, where
   M' and h rounded once to bf16 (``ref.ssd_chunked_rounded``) exceed it;
   two launches of each bit-equal; kernel and plain version timed with
   CUDA events at the training shape, both bodies, and the forward at
   zamba2's heads (tensor-core body), beside their bounds:
   bytes over HBM bandwidth or the products the scan needs at the bf16
   peak
   (the float32 CUDA-core bound beside it, and the FLOP the tensor-core
   bodies run counting each bf16 term, not part of the bound), the L x L
   products over the pairs t >= s only (no PyTorch call computes the
   scan, so no library yardstick);
13. mamba2 model phase: first the JAX package's own check
   (tests/test_models.py) at the smoke config: ``forward`` (ssd) against
   the same 64 tokens one at a time through ``decode_step`` (the plain
   recurrence), atol = rtol = 0.05. Then full width, bf16 weights (A_log
   and dt_bias float32): ``forward`` on (2, 512) numpy-seeded tokens
   launches ssd 48 times, all on the tensor-core body (bf16 x, B and C),
   every call held to its plain version on its own
   inputs (y 8e-3, the final state 1e-5), and the first 128 positions
   through ``decode_step`` (the forward's 512 cut to 128, as in phase 8),
   the decode-vs-forward logits
   margin printed, not gated;
14. mamba2 train phase, full width, as phase 11: float32 masters,
   ``make_train_step(ca_k=4, remat=True)`` on ``TokenStream(32, 1024,
   seed 0)``, a warm-up step and three timed ones with loss and grad norm
   finite, ssd launched 3 * 48 * ca_k times a step (forward, remat
   recompute and the backward's states sweep) and ssd_bwd 48 * ca_k, all
   on the tensor-core bodies; for
   one microbatch every ssd and ssd_bwd call held to its plain version on
   its own inputs (as in phase 12); ms/step, tokens/s, the FLOP share (the
   SSD's own FLOPs in place of attention's), peak memory and one profiled
   step; the JAX package's training checks at the mamba2 smoke config; and
   the CLI, ``--arch mamba2-780m --preset tiny --steps 12 --ckpt-every 4
   --fail-at 6``, one restart, final loss bit-equal to a clean run;
15. families phase, published widths and depths, bf16 weights from a
   seeded ``torch.Generator``, one arch after another, each freed before
   the next: granite-moe-1b-a400m, deepseek-moe-16b (16.4 B parameters,
   33 GB: a forward and decode fit the card, training does not),
   zamba2-2.7b, qwen2-vl-2b and whisper-medium. For each: (a) the forward
   at (B=2, S=512) (qwen2-vl: 1,024 patch embeddings before the tokens;
   whisper: 1,500 frame embeddings into the encoder, 448 decoder tokens),
   flash_attention launched once an attention (zamba2: once a superblock;
   whisper: 24 encoder + 2 x 24 decoder) and ssd once a mamba2 layer
   (zamba2: 54), nothing else, every call held to its plain version
   (normwise 8e-3; ssd's state 1e-5), finite logits, the wall time; (b) 32
   positions through ``decode_step`` on a slot cache (whisper: after
   ``prefill_audio_cache`` over the 1,500 frames), ms a step, no kernel
   launched but whisper's cross-attention (flash_attention at Sq = 1, 24 a
   step, every call held); (c) the teacher-forcing gap at full width,
   printed, and the JAX package's check (tests/test_models.py) gated at
   the smoke config with the capacity factor raised to 8, atol = rtol =
   0.05 (qwen2-vl: neither, as JAX skips it); (d) granite only: phase 11's
   train phase at the full preset (ca_k=4, batch 32 x 1024, remat, float32
   masters): finite loss and grad norm, flash_dq and flash_dkv 24 x ca_k
   a step, ms/step, tokens/s, peak memory, a profiled step, the JAX
   package's training checks at the smoke config and the train CLI with
   a failure;
16. the rest of training (one arch at a time, each freed before the
   next): (a) the single-device step (``make_train_step(cfg)``) at
   phase 11's configuration, two CA steps and then one classical step
   (``sync_every_microbatch``) on a third batch: ms, peak memory, metrics,
   and every master and moment copied to the host after each schedule
   (phase 18's yardstick);
   (b) ``ca_local_sgd_solver`` and ``ca_stale_k_solver`` at internlm2's
   widths (float32 params, k = 4 local steps on 8 x 1,024 rows, three
   rounds): one all-reduce a round each, every stale-k collective waited
   in the round after its own (the solver's log), finalize within atol
   2e-4 and rtol 1e-3 of the synchronous params, finite losses, ms a round
   and peak memory; (c) whisper-medium (1,500 frame embeddings, 448
   tokens) and qwen2-vl-2b (1,024 patch embeddings before 512 tokens)
   through the CA train step at their published widths and depths (ca_k
   = 4, batch 8 x ca_k, halved on an out-of-memory), finite loss and grad
   norm, the lse forward, flash_dq and flash_dkv launches a step, every
   attention call of one microbatch held to its plain version, ms/step,
   tokens/s, peak memory; (d) ``launch.grad_smoke`` on the card (the
   registry's CUDA picks through ``FlashAttentionFn`` and ``SSDFn``, every
   family's backward kernels launched); (e) top-k (frac 0.01) and int8
   compression of internlm2's embedding grad: rebuilt exactly, timed; (f)
   the prox block ops' recompute backward at the covtype and susy block
   shapes, within 1e-5 normwise of autograd through the plain block;
   then phase 18: ``make_train_step(cfg, rules)`` on a (data=1, model=1)
   mesh (``make_rules`` over an NCCL group of one in this process) for
   16(a)'s two CA steps from the same weights and then its classical
   step: after each, every master, moment and metric bitwise 16(a)'s (the
   sharded state in JAX's stacked layout, compared layer by layer), the
   layout (every leaf whole), the collectives (every leaf whole, so no
   gather and no reduce-scatter: an all-reduce of every gradient and the
   loss, one of the squared norm, a step under CA and a microbatch under
   the classical schedule), the flash kernels' launches (the lse forward
   2 x 24 x ca_k, flash_dq and flash_dkv 24 x ca_k a step), ms and peak
   memory; then the host and card time of one all-reduce of every
   gradient and the loss;
17. the rest of serving: (a) phase 9's engine and its 16 requests on
   internlm2-1.8b with prompts of 32-128 tokens (phase 9's 32-512 cut so
   that the phase's drains of them fit the run's time limit), sampled
   (temperature 0.8, top-p 0.9, top-k 50, request i seeded 1000 + i) at
   k=8 and k=1: all retire at 64 tokens, steps == syncs * k, every block
   under the sync-debug error mode, paged_decode 24 a step, streams
   bit-identical across k; tok/s beside greedy's on the same requests,
   and one profiled sampled block with the sampler's device time (the
   kernels launched inside ``sample_tokens``) and its share; (b) the
   prefix cache: 16 requests sharing a 264-token prefix (16.5 pages of
   16), each with its own 32-64-token tail, the first run alone so that
   its pages are published: streams bit-identical to the cache-off run,
   15 hits, 15 x 264 prefill tokens skipped, copies on write, and after
   the drain only the trie's pages live; (c) fan-out: 4 sampled requests
   of n = 4 against 16 standalone requests seeded ``fold_in_seed(seed,
   i)``, bit for bit, and fewer peak pages; (d) the double-buffered loop
   on (a)'s requests at k=8 (submitted in reverse order: other slots, a
   fresh engine) and k=1, bit-identical to (a)'s streams, hidden syncs
   counted, ms/sync beside (a)'s; then at k=8 under the sync audit on
   9b's shorter requests: audited round trips == ``EngineStats.syncs``, the
   hidden ones == the audit's overlap epochs, none the runtime reports
   outside a counted read; (e) granite-moe-1b-a400m, deepseek-moe-16b,
   zamba2-2.7b, qwen2-vl-2b, whisper-medium (1,500 seeded frames) and
   mamba2-780m, one at a time at their published configs, through the
   engine (4 greedy requests of 32-64 prompt tokens, 32 new, max_len 256,
   4 slots): the slot engine, the paged engine (page 16) at k=8 and at
   k=1 bit-identical, one k=8 block's paged_decode and flash_attention
   calls held to their plain versions, paged_decode launched once a step
   per attention layer (zamba2: its 9 shared blocks, at the D = 80
   instance; mamba2: never), whisper's cross-attention through
   flash_attention once a layer and step, ms a step;
19. prints ``{"kernels": [...]}``, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Each phase prints its wall time.

With no card, or run from a directory that holds nothing else of the
repository, it exits with an error before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: kernel vs plain version, normwise (see the module docstring)
KERNEL_RTOL = 1e-5
GRAM_RTOL = 2e-6
GRAM_OFFDIAG_RTOL = 2e-5
#: CA vs classical on the card: the reference's own trajectory tolerance
CA_ATOL = 5e-6
#: card vs the port's plain solve with the same draws and step
PLAIN_ATOL = 1e-4
#: attention kernel vs plain version, normwise, by output dtype
ATTN_RTOL = {"float32": 1e-5, "bfloat16": 8e-3}
#: an lse output against its plain version: absolute, over the rows that
#: see a key (a 1e-4 error in lse is a 1e-4 relative error in every p)
LSE_ATOL = 1e-4
#: share of the bf16 flash forward's outputs that may differ from the
#: float32-p plain version's: float32 sums in another order move a few in a
#: thousand across a bf16 rounding boundary, p rounded once to bf16 more
#: than a third (tests/test_torch_kernels.py, on the CPU)
P_FLIP_LIMIT = 0.02
#: teacher-forced decode vs forward logits (tests/test_models.py)
LOGIT_TOL = 0.05
ARCH = "internlm2-1.8b"
#: positions of phases 8's and 13's teacher-forced decode (the forward's
#: first ones: it is causal)
TF_POSITIONS = 128
SSM_ARCH = "mamba2-780m"
#: SSD kernels vs plain, normwise, by output dtype: the kernels' float32
#: sums against the plain versions' float64 sums, rounded once; y in bf16
#: is one rounding at the top of the range
SSD_RTOL = {"float32": 1e-5, "bfloat16": 8e-3}
#: da against its plain version, normwise: its reverse cumsum subtracts
#: large terms
SSD_DA_RTOL = 1e-4
T, K, B, Q = 256, 32, 0.1, 5
#: each solver rule's block prox kernel
BLOCK_OPS = {"fista": "prox_step_block", "pnm": "prox_loop_block"}
VARIANTS = ("l1", "elastic_net", "box", "none")
SCAL = (0.05, 0.02, 0.3, -0.1, 0.2)     # [t, lam, mu, lo, hi]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound(op: str, *args, f32: bool = False, **kwargs):
    """The least time the card could take for one call of registry op
    ``op`` on these arguments, in ms, and what bounds it ("bytes" or
    "operations"): the op's work function (``kernels.registry.work``)
    against the card's peaks (``repro_torch.roofline``). With ``f32`` the
    same work at the float32 CUDA-core peak, whatever its dtype."""
    import dataclasses
    import torch
    from repro_torch import roofline
    from repro_torch.kernels import registry
    w = registry.work(op, *args, **kwargs)
    if f32:
        w = dataclasses.replace(w, dtype=torch.float32)
    return roofline.bound_ms(w)


def time_ms(fn, iters: int) -> float:
    """ms a call of ``fn``, back to back: CUDA events around ``iters``
    calls after three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def compare(name, shape, got, want, rtol=KERNEL_RTOL) -> float:
    """A kernel's output against its plain version, normwise (max |got -
    want| / max |want|) within ``rtol``; printed. Returns max |got - want|."""
    import torch
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}{shape}: not finite")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = err / max(scale, 1e-30)
    print(f"  {name:9s} {str(shape):22s} max_abs_err={err:.3e} "
          f"normwise_rel={rel:.3e}")
    check(rel <= rtol, f"{name}{shape}: normwise error {rel:.3e} > "
          f"{rtol}")
    return err


def compare_offdiag(shape, got, want, name="gram") -> None:
    """A Gram kernel's off-diagonal entries against their own largest
    magnitude, within GRAM_OFFDIAG_RTOL; printed."""
    import torch
    off = ~torch.eye(got.shape[1], dtype=torch.bool, device=got.device)
    err = float((got - want).abs()[:, off].max())
    rel = err / max(float(want.abs()[:, off].max()), 1e-30)
    print(f"  {name:9s} {str(shape):22s} off-diagonal "
          f"max_abs_err={err:.3e} normwise_rel={rel:.3e}")
    check(rel <= GRAM_OFFDIAG_RTOL, f"{name}{shape}: off-diagonal error "
          f"{rel:.3e} > {GRAM_OFFDIAG_RTOL}")


def _self_device_us(ev) -> float:
    """A profiler average's own device time, under either of the names
    torch has given it."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, attr):
            return getattr(ev, attr)
    return 0.0


def _event_ms(fn, iters: int, flush=None, queued=False) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after 3 warm-up
    calls, by CUDA events. With ``flush`` (a call that reads or writes a
    buffer larger than the L2 cache) the L2 is flushed before each launch,
    outside the timed span. With
    ``queued`` the card sleeps while the host enqueues the whole span, so
    a wrapper whose host time exceeds its kernel's leaves no gap inside it
    (without it, back-to-back launches time the slower of the two)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(400_000 * iters)   # ~0.2 ms a launch
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters
    pairs = []
    for _ in range(iters):
        # keep the card busy while the host enqueues the flush and the
        # launch, so no host gap falls inside the timed span
        torch.cuda._sleep(1_000_000)
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn`` (enqueue only: no synchronize inside),
    the wrapper's own cost on the CPU."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _normwise(name, shape, got, want, rtol) -> float:
    import torch
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}{shape}: not finite")
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    print(f"  {name:15s} {str(shape):44s} max_abs_err={err:.3e} "
          f"normwise_rel={rel:.3e} (limit {rtol})")
    check(rel <= rtol, f"{name}{shape}: normwise error {rel:.3e} > {rtol}")
    return err


#: template arguments as the Itanium mangling writes them, shortened
_MANGLED_ARGS = (("13__nv_bfloat16", "bf16"), ("Li", ""), ("Lb", ""),
                 ("S1_", "kv=q"), ("f", "f32"), ("a", "i8"))


def _ptxas_report(log: str):
    """(kernel<args>, registers, spill line) for every entry function in
    nvcc's ``-Xptxas -v`` report."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        # _ZN <len><anonymous namespace> <len><kernel> I<template args>EE...
        m = re.search(r"Compiling entry function '_ZN(\d+)(\w*)'", line)
        if m:
            sym = m.group(2)[int(m.group(1)):]
            k = re.match(r"(\d+)", sym)
            n = int(k.group(1)) if k else 0
            ident, rest = sym[k.end():k.end() + n] if k else sym, \
                sym[k.end() + n:] if k else ""
            args = re.match(r"I(.*?)EE", rest)
            name = ident
            if args:
                toks = re.findall(r"13__nv_bfloat16|Li\d+|Lb\d|S1_|f|a",
                                  args.group(1))
                for old, new in _MANGLED_ARGS:
                    toks = [t.replace(old, new, 1) if t.startswith(old)
                            else t for t in toks]
                name = f"{ident}<{','.join(toks)}>"
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip() if ":" in line \
                else line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((name, regs.group(1) if regs else "?", spill))
            name = None
    return out


#: how the bf16 flash kernels (the forward, flash_dq and flash_dkv) reach
#: the tensor cores and load their tiles
FLASH_ROUTE = "wgmma+tma"


def _tensor_core_line(flops: float, ms: float, bms: float,
                      split_flops: float = 0.0) -> str:
    """A bf16 flash kernel's achieved rate (model FLOPs over kernel time;
    with ``split_flops``, also the FLOPs its tensor cores run with p, or p
    and ds, split into two bf16 halves) and its share of the bound, for a
    timing line."""
    split = (f", {split_flops / ms / 1e9:.1f}TFLOP/s with the split"
             if split_flops else "")
    return (f" achieved={flops / ms / 1e9:.1f}TFLOP/s{split} "
            f"({100 * bms / ms:.1f}% of the bf16 bound; {FLASH_ROUTE})")


#: phase 4d's random block shapes (k, d) beside the CA blocks of covtype
#: and susy: the classical k = 1 (G from global memory), k = 2 (ring stages
#: of one G_i) and a short block, ragged d = 61 (d^2 not a multiple of 4: G
#: from global memory), d = 130 and 160 (stages of one G_i near the limit)
#: and d = 300 (the rows route)
PROX_BLOCK_SHAPES = ((1, 54), (2, 54), (7, 54), (1, 18), (7, 61), (32, 61),
                     (3, 130), (7, 160), (7, 300), (1, 300))


def solve_walls(problem, cfg, rule, draws):
    """Phase 5's warm solve walls: one untimed CA and classical solve, then
    CA, classical, classical, CA, CA, classical on the same draws. Returns
    ({ca: the median of three}, {ca: [seconds, ...]})."""
    import torch
    from repro_torch.core import sstep

    def timed_solve(ca):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sstep.solve(problem, cfg, None, rule, name="timed", ca=ca, idx=draws)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed_solve(True)    # warm-up, untimed: first use of these shapes
    timed_solve(False)
    walls = {True: [], False: []}
    for ca in (True, False, False, True, True, False):
        walls[ca].append(timed_solve(ca))
    return {ca: sorted(w)[1] for ca, w in walls.items()}, walls


def profile_solve(problem, cfg, rule, draws, ca):
    """Phase 6: one solve under ``torch.profiler``. Returns its wall in
    seconds and its device kernels as (name, own device us, launches),
    largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import sstep
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sstep.solve(problem, cfg, None, rule, name="profiled", ca=ca,
                    idx=draws)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(ev.key, _self_device_us(ev), ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return wall, rows


def prox_block_phase(dev, gen, blocks, compare, time_ms):
    """Phase 4d: ``prox_step_block`` and ``prox_loop_block`` at the CA
    blocks of covtype (FISTA, k=32, d=54) and susy (PNM, k=32, d=18,
    Q=5) from ``gram_gather``'s own output, and at PROX_BLOCK_SHAPES, every
    variant: bitwise the k = 1 instance run k times (FISTA: ``fista_update``,
    the eager momentum ops and a ``prox_step`` launch a step, as the
    parent's solves ran it, and the block kernel at k = 1), and each step
    within KERNEL_RTOL of the plain version's step from the kernel's own
    previous iterates. The whole block's distance from the plain chain is
    printed beside the plain float32 chain's own distance from a float64
    chain, not gated: k steps with FISTA's momentum amplify a rounding
    difference (at k = 32 with momentum near 1, two float32 chains that
    sum in different orders can differ by more than KERNEL_RTOL with no
    fault in either). Then each is timed at its main-path
    shape, beside the same block with G's base off 16 bytes, which no bulk
    copy can fill a ring stage from, so its G_i come from global memory
    (bitwise the same W). Returns the two JSON entries."""
    import torch
    from repro_torch.core import update_rules as ur
    from repro_torch.kernels import registry
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.prox_step import ref as prox_ref
    print("kernel phase: prox_step_block, prox_loop_block")
    scal = prox_ops.prox_scalars(*SCAL, device=dev)
    cases = [(name, *blocks[name]) for name in ("covtype", "susy")]
    for k, d in PROX_BLOCK_SHAPES:
        A = torch.randn(k, d, d, generator=gen, device=dev)
        cases.append(("random", (A @ A.transpose(1, 2) / d).contiguous(),
                      torch.randn(k, d, generator=gen, device=dev)))
    errs = {"prox_step_block": [], "prox_loop_block": []}
    chains = {"prox_step_block": [], "prox_loop_block": []}

    def hold(name, shape, got, steps, whole, whole64):
        """Each step against the plain step from the kernel's own previous
        iterate (gated); the block against the plain chain, and the block
        and the plain float32 chain against float64 (printed)."""
        errs[name].append(compare(name, shape, got, steps))
        three = tuple(float((a.double() - b).abs().max() / b.abs().max())
                      for a, b in ((got, whole.double()), (whole, whole64),
                                   (got, whole64)))
        chains[name].append(three)
        print(f"    the whole chain: kernel vs plain {three[0]:.3e}; from "
              f"float64, plain float32 {three[1]:.3e}, kernel {three[2]:.3e}")

    for label, G, R in cases:
        k, d = R.shape
        wp = torch.randn(d, generator=gen, device=dev)
        w0 = torch.randn(d, generator=gen, device=dev)
        for vid, variant in enumerate(VARIANTS):
            j0 = 1 + 32 * vid
            shape = (label, k, d, variant)
            W = prox_ops.prox_step_block_cuda(G, R, wp, w0, scal, j0=j0,
                                              variant=variant)
            state, rows = ur.IterState(w_prev=wp, w=w0, j=j0), []
            for i in range(k):
                state = ur.fista_update(G[i], R[i], state, scal,
                                        variant=variant)
                rows.append(state.w)
            a, b, ones = wp, w0, []
            for i in range(k):
                a, b = b, prox_ops.prox_step_block_cuda(
                    G[i:i + 1], R[i:i + 1], a, b, scal, j0=j0 + i,
                    variant=variant)[0]
                ones.append(b)
            torch.cuda.synchronize()
            check(torch.equal(W, torch.stack(rows)),
                  f"prox_step_block{shape}: not bitwise the stepwise route")
            check(torch.equal(W, torch.stack(ones)),
                  f"prox_step_block{shape}: not bitwise k launches at k=1")
            prev = [wp, w0] + list(W)
            hold("prox_step_block", shape, W, torch.stack([
                prox_ref.prox_step_block(
                    G[i:i + 1], R[i:i + 1], prev[i], prev[i + 1], scal,
                    j0=j0 + i, variant=variant)[0] for i in range(k)]),
                prox_ref.prox_step_block(G, R, wp, w0, scal, j0=j0,
                                         variant=variant),
                prox_ref.prox_step_block(
                    G.double(), R.double(), wp.double(), w0.double(),
                    scal.double(), j0=j0, variant=variant))
            Z = prox_ops.prox_loop_block_cuda(G, R, w0, scal, Q=Q,
                                              variant=variant)
            z, zs = w0, []
            for i in range(k):
                z = prox_ops.prox_loop_cuda(G[i], R[i], z, scal, Q=Q,
                                            variant=variant)
                zs.append(z)
            torch.cuda.synchronize()
            check(torch.equal(Z, torch.stack(zs)),
                  f"prox_loop_block{shape}: not bitwise k launches at k=1")
            prev = [w0] + list(Z)
            hold("prox_loop_block", shape + (Q,), Z, torch.stack([
                prox_ref.prox_loop(G[i], R[i], prev[i], scal, Q=Q,
                                   variant=variant) for i in range(k)]),
                prox_ref.prox_loop_block(G, R, w0, scal, Q=Q, variant=variant),
                prox_ref.prox_loop_block(G.double(), R.double(), w0.double(),
                                         scal.double(), Q=Q, variant=variant))

    out = {}
    for name, label in (("prox_step_block", "covtype"),
                        ("prox_loop_block", "susy")):
        G, R = blocks[label]
        k, d = R.shape
        wp = torch.randn(d, generator=gen, device=dev)
        w0 = torch.randn(d, generator=gen, device=dev)
        if name == "prox_step_block":
            def call(G=G):
                return prox_ops.prox_step_block_cuda(G, R, wp, w0, scal, j0=1)

            def plain():
                return prox_ref.prox_step_block(G, R, wp, w0, scal, j0=1)

            def stepwise():   # the parent's route for the block
                st = ur.IterState(w_prev=wp, w=w0, j=1)
                for i in range(k):
                    st = ur.fista_update(G[i], R[i], st, scal)
            chain, op, kw = k, "prox_step_block", dict(j0=1)
            vecs = (wp, w0)
            shape = [k, d]
            replaces = "src/repro/kernels/prox_step/kernel.py:89"
        else:
            def call(G=G):
                return prox_ops.prox_loop_block_cuda(G, R, w0, scal, Q=Q)

            def plain():
                return prox_ref.prox_loop_block(G, R, w0, scal, Q=Q)

            def stepwise():
                z = w0
                for i in range(k):
                    z = ur.pnm_update(G[i], R[i], ur.IterState(z, z, 1),
                                      scal, Q).w
            chain, op, kw = k * Q, "prox_loop_block", dict(Q=Q)
            vecs = (w0,)
            shape = [k, d, Q]
            replaces = "src/repro/kernels/prox_step/kernel.py:77"
        # G and R read once, the input vectors (w_prev and w; z0) and the
        # scalars, W written once
        nbytes = registry.work(op, G, R, *vecs, scal, **kw).bytes
        bms, by = bound(op, G, R, *vecs, scal, **kw)
        Gu = torch.empty(G.numel() + 1, device=dev)[1:].view_as(G).copy_(G)
        check(torch.equal(call(), call(Gu)),
              f"{name} {label}: the ring and global memory disagree")
        ms = time_ms(call, 200)
        # the ring against global memory, queued (device time), alternating
        routes = [_event_ms(fn, 200, queued=True)
                  for fn in (call, lambda: call(Gu)) * 2]
        queued = routes[0]
        host = _host_us(call)
        plain_ms = time_ms(plain, 10)
        step_ms = time_ms(stepwise, 10)
        step_host = _host_us(stepwise, 10)
        print(f"  time {name} {label} {shape}: kernel={ms:.4f}ms back to "
              f"back, {queued:.4f}ms queued ({1e3 * queued / chain:.3f}us "
              f"a dependent step, chain of {chain}); wrapper host time "
              f"{host:.1f}us a call; plain={plain_ms:.4f}ms "
              f"bound={bms:.7f}ms ({by}; {nbytes / 1e3:.1f} KB); the "
              f"stepwise route it replaces (a diagnostic): {step_ms:.4f}ms "
              f"of device time, {step_host:.1f}us of host time a block")
        print(f"  time {name} {label} {shape}: G through the ring "
              f"{routes[0]:.4f}ms, {routes[2]:.4f}ms; from global memory "
              f"{routes[1]:.4f}ms, {routes[3]:.4f}ms (queued, alternating)")
        out[name] = dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/prox_step.cu",
                         replaces=replaces, launches=0,
                         max_abs_err=max(errs[name]), ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=None,
                         shape=shape)
    for name, e in errs.items():
        worst = max(chains[name])
        print(f"  {name}: max_abs_err over all shapes and variants "
              f"{max(e):.3e}, each step against the plain step; the whole "
              f"chain against the plain chain at most {worst[0]:.3e} "
              f"normwise (there, from float64: the plain float32 chain "
              f"{worst[1]:.3e}, the kernel {worst[2]:.3e})")
    return out


#: phase 6a's sizes: the rows route's two d, and the d over which both
#: routes are timed to read the threshold
ROWS_D = (4096, 20_480)
SWEEP_D = (128, 192, 256, 320, 384, 512)
#: phase 6c's dual SVM: n samples of covtype, T and k of its solves
SVM_N, SVM_T, SVM_K = 4096, 64, 16
#: CA-BCD against BCD: the JAX package's tolerance (its in-block replay
#: reassociates a matrix-vector product)
BCD_ATOL = 2e-5


def _prox_route_block(dev, gen, k, d):
    """A (k, d, d) block for the rows route: symmetric positive definite
    up to d = 4096, scaled Gaussian above."""
    import torch
    if d <= 4096:
        A = torch.randn(k, d, d, generator=gen, device=dev)
        G = (A @ A.transpose(1, 2) / d).contiguous()
        del A
    else:
        G = torch.randn(k, d, d, generator=gen, device=dev) / d ** 0.5
    return G, torch.randn(k, d, generator=gen, device=dev)


def _dual_err(u, want_u, want_w, sigma) -> float:
    """PDHG's dual iterate against the plain one, normwise at the scale it
    is computed at: u+ = x - sigma prox(x / sigma) with x near sigma w+, so
    max(|u+|, sigma |w+|) (at variant "none" u+ is rounding noise around 0
    and its own maximum no scale)."""
    scale = max(float(want_u.abs().max()),
                float(sigma) * float(want_w.abs().max()))
    return float((u - want_u).abs().max()) / scale


def large_d_phase(dev, gen, compare, time_ms):
    """Phase 6a: the rows route (``prox_rows_kernel``) of prox_step_block,
    prox_loop_block and pdhg_block at d = 4,096 and 20,480 (past the
    one-CTA limit): each block bitwise k launches of its k = 1 instance,
    each step within KERNEL_RTOL of the plain step from the kernel's own
    previous iterate; one step of each timed beside its bound (G_i read
    once a dependent product) and the plain version; then both routes
    timed over SWEEP_D at k = 8, back to back and queued, and the threshold
    ``ROWS_ABOVE_D`` printed beside the smallest d from which the rows route
    was faster for all three (by device time, and back to back). Returns
    the rows route's JSON entry."""
    import torch
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.prox_step import ref as prox_ref
    shared_d, max_d = prox_ops.prox_loop_limits()
    threshold = prox_ops.ROWS_ABOVE_D
    print(f"phase 6a: the rows route above d={threshold} (one CTA up to "
          f"d={max_d})")
    check(threshold <= max_d, f"ROWS_ABOVE_D={threshold} above the one-CTA "
          f"limit {max_d}")
    scal = prox_ops.prox_scalars(*SCAL, device=dev)
    sigma = torch.tensor([0.5 / SCAL[0]], device=dev)
    errs, entry = [], None
    for d in ROWS_D:
        check(prox_ops.rows_route(d), f"d={d} not on the rows route")
        k = 2
        G, R = _prox_route_block(dev, gen, k, d)
        wp = torch.randn(d, generator=gen, device=dev)
        w = torch.randn(d, generator=gen, device=dev)
        u = torch.randn(d, generator=gen, device=dev) * 0.01
        for variant in (VARIANTS if d == ROWS_D[0] else ("l1",)):
            shape = (k, d, variant)
            W = prox_ops.prox_step_block_cuda(G, R, wp, w, scal, j0=5,
                                              variant=variant)
            Z = prox_ops.prox_loop_block_cuda(G, R, w, scal, Q=Q,
                                              variant=variant)
            P, pu = prox_ops.pdhg_block_cuda(G, R, w, u, scal, sigma,
                                             variant=variant)
            a, b, z, pd = wp, w, w, [(w, u)]
            for i in range(k):
                a, b = b, prox_ops.prox_step_block_cuda(
                    G[i:i + 1], R[i:i + 1], a, b, scal, j0=5 + i,
                    variant=variant)[0]
                z = prox_ops.prox_loop_cuda(G[i], R[i], z, scal, Q=Q,
                                            variant=variant)
                x, c = prox_ops.pdhg_block_cuda(G[i:i + 1], R[i:i + 1],
                                                *pd[-1], scal, sigma,
                                                variant=variant)
                pd.append((x[0], c))
                check(torch.equal(W[i], b) and torch.equal(Z[i], z)
                      and torch.equal(P[i], x[0]),
                      f"rows route {shape}: step {i} not bitwise its k = 1 "
                      f"instance")
            check(torch.equal(pu, pd[-1][1]), f"rows route {shape}: u")
            prev, zprev = [wp, w] + list(W), [w] + list(Z)
            for i in range(k):
                errs.append(compare("rows fista", shape + (i,), W[i],
                                    prox_ref.prox_step_block(
                                        G[i:i + 1], R[i:i + 1], prev[i],
                                        prev[i + 1], scal, j0=5 + i,
                                        variant=variant)[0]))
                errs.append(compare("rows pnm", shape + (i,), Z[i],
                                    prox_ref.prox_loop(
                                        G[i], R[i], zprev[i], scal, Q=Q,
                                        variant=variant)))
                rw, ru = prox_ref.pdhg_step(G[i], R[i], *pd[i], scal, sigma,
                                            variant=variant)
                errs.append(compare("rows pdhg", shape + (i,), pd[i + 1][0],
                                    rw))
                e_u = _dual_err(pd[i + 1][1], ru, rw, sigma)
                print(f"  rows pdhg u {str(shape + (i,)):22s} normwise (at "
                      f"the scale max(|u|, sigma |w|)) {e_u:.3e}")
                check(e_u <= KERNEL_RTOL, f"rows pdhg u{shape}: {e_u:.3e}")
        # one dependent step of each, k = 1: G_i read once a product
        G1, R1 = G[:1], R[:1]
        iters = 20 if d == ROWS_D[0] else 5
        for name, call, plain, reads, (bms, by) in (
                ("fista", lambda: prox_ops.prox_step_block_cuda(
                    G1, R1, wp, w, scal, j0=5),
                 lambda: prox_ref.prox_step_block(G1, R1, wp, w, scal, j0=5),
                 1, bound("prox_step_block", G1, R1, wp, w, scal, j0=5)),
                ("pnm", lambda: prox_ops.prox_loop_block_cuda(
                    G1, R1, w, scal, Q=Q),
                 lambda: prox_ref.prox_loop_block(G1, R1, w, scal, Q=Q), Q,
                 bound("prox_loop_block", G1, R1, w, scal, Q=Q)),
                ("pdhg", lambda: prox_ops.pdhg_block_cuda(
                    G1, R1, w, u, scal, sigma),
                 lambda: prox_ref.pdhg_block(G1, R1, w, u, scal, sigma), 1,
                 bound("pdhg_block", G1, R1, w, u, scal, sigma))):
            ms = time_ms(call, iters)
            queued = _event_ms(call, iters, queued=True)
            plain_ms = time_ms(plain, iters)
            print(f"  time rows {name} d={d} (one step, {reads} product"
                  f"{'s' if reads > 1 else ''} of G): kernel={ms:.4f}ms back "
                  f"to back, {queued:.4f}ms queued; plain={plain_ms:.4f}ms "
                  f"bound={bms:.4f}ms ({by})")
            if name == "fista" and d == ROWS_D[0]:
                entry = dict(name="prox_rows", route="cuda",
                             source="src/repro_torch/csrc/prox_step.cu",
                             replaces=("src/repro/kernels/prox_step/"
                                       "kernel.py:89"),
                             launches=0, max_abs_err=0.0, ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=None, shape=[1, d])
        if d == ROWS_D[0]:   # the one-CTA route at the same d, a diagnostic
            prox_ops.ROWS_ABOVE_D = max_d
            one = time_ms(lambda: prox_ops.prox_step_block_cuda(
                G1, R1, wp, w, scal, j0=5), iters)
            prox_ops.ROWS_ABOVE_D = threshold
            print(f"  time one-CTA fista d={d} (one step, a diagnostic): "
                  f"{one:.4f}ms")
        del G, R, G1, R1
        torch.cuda.empty_cache()
    entry["max_abs_err"] = max(errs)
    # both routes over SWEEP_D, k = 8: where the rows route starts to win
    faster, faster_b2b = [], []
    for d in SWEEP_D:
        k = 8
        G, R = _prox_route_block(dev, gen, k, d)
        w = torch.randn(d, generator=gen, device=dev)
        u = torch.randn(d, generator=gen, device=dev) * 0.01
        calls = (("fista", lambda: prox_ops.prox_step_block_cuda(
                     G, R, w, w, scal, j0=5)),
                 ("pnm", lambda: prox_ops.prox_loop_block_cuda(
                     G, R, w, scal, Q=Q)),
                 ("pdhg", lambda: prox_ops.pdhg_block_cuda(
                     G, R, w, u, scal, sigma)))
        row, wins, wins_b2b = [], True, True
        for name, call in calls:
            t = {}
            for rows in (False, True, True, False):
                prox_ops.ROWS_ABOVE_D = 0 if rows else max_d
                t.setdefault(rows, []).append(
                    (time_ms(call, 50), _event_ms(call, 50, queued=True)))
            prox_ops.ROWS_ABOVE_D = threshold
            cta = tuple(min(x[i] for x in t[False]) for i in (0, 1))
            rws = tuple(min(x[i] for x in t[True]) for i in (0, 1))
            wins &= rws[1] < cta[1]
            wins_b2b &= rws[0] < cta[0]
            row.append(f"{name} one-CTA {cta[0]:.4f}/{cta[1]:.4f} rows "
                       f"{rws[0]:.4f}/{rws[1]:.4f}")
        if wins:
            faster.append(d)
        if wins_b2b:
            faster_b2b.append(d)
        print(f"  sweep d={d} k={k} (ms back to back/queued): "
              + "; ".join(row))
        del G, R
    print(f"  rows route faster for all three from d="
          f"{min(faster, default=None)} by device time (queued), from d="
          f"{min(faster_b2b, default=None)} back to back, in this run's "
          f"sweep; ROWS_ABOVE_D={threshold}")
    return entry


def family_phase(dev, gen, compare, compare_offdiag, time_ms, problem):
    """Phase 6b: PDHG and BCD on covtype at full size. ``pdhg_block`` on
    the CA block (k=32, d=54) from ``gram_gather``'s own output, every
    variant: bitwise 32 launches of its k = 1 instance, each step (w and u)
    within KERNEL_RTOL of the plain step from the kernel's own previous
    iterate, and at sigma = 1/t each step within KERNEL_RTOL of the ISTA
    step (``prox_step``) from the previous w; timed. Then CA-PDHG, PDHG,
    CA-BCD and BCD through ``lasso_solve.main``: launches (pdhg_block and
    gram_gather T/k and T; gram T/k and T for BCD, no prox kernel), CA-PDHG
    bitwise PDHG, CA-BCD within BCD_ATOL of BCD, each against its plain
    solve on the card (PLAIN_ATOL), warm walls and a profile of each;
    ``gram`` at BCD's CA cross-Gram (r = 160 over 581,010) against its plain
    version, timed beside ``torch.mm``; and ElasticNet through CA-SFISTA.
    Returns (JSON entries, launches per op)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import ElasticNetProblem, SolverConfig, ca_sfista
    from repro_torch.core import sstep
    from repro_torch.core.sampling import sample_index_batch
    from repro_torch.kernels import registry
    from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.prox_step import ref as prox_ref
    from repro_torch.launch import lasso_solve
    print("phase 6b: PDHG and BCD on covtype")
    step = float(problem.default_step(SolverConfig(T=T, k=K, b=B, Q=Q)))
    cfg = SolverConfig(T=T, k=K, b=B, Q=Q, step_size=step)
    draws = sample_index_batch(torch.Generator(device=dev).manual_seed(0),
                               T, problem.n, sstep.draw_size(problem, cfg))
    G, R = problem.block_stats(draws[:K])
    k, d = R.shape
    t = torch.tensor(step, device=dev)
    out, errs = {}, []
    w0 = torch.randn(d, generator=gen, device=dev) * 0.1
    u0 = torch.randn(d, generator=gen, device=dev) * 0.01
    for variant in VARIANTS:
        lam, mu, lo, hi = SCAL[1:]
        scal = prox_ops.prox_scalars(t, lam, mu, lo, hi)
        sigma = (0.5 / t).reshape(1)
        W, u = prox_ops.pdhg_block_cuda(G, R, w0, u0, scal, sigma,
                                        variant=variant)
        pd = [(w0, u0)]
        for i in range(k):
            x, c = prox_ops.pdhg_block_cuda(G[i:i + 1], R[i:i + 1], *pd[-1],
                                            scal, sigma, variant=variant)
            pd.append((x[0], c))
        check(torch.equal(W, torch.stack([p[0] for p in pd[1:]]))
              and torch.equal(u, pd[-1][1]),
              f"pdhg_block covtype {variant}: not bitwise k launches at k=1")
        worst = 0.0
        for i in range(k):
            rw, ru = prox_ref.pdhg_step(G[i], R[i], *pd[i], scal, sigma,
                                        variant=variant)
            err = float((pd[i + 1][0] - rw).abs().max())
            for rel in (err / float(rw.abs().max()),
                        _dual_err(pd[i + 1][1], ru, rw, sigma)):
                check(rel <= KERNEL_RTOL, f"pdhg_block covtype {variant} "
                      f"step {i}: {rel:.3e} > {KERNEL_RTOL}")
                worst = max(worst, rel)
            errs.append(err)
        print(f"  pdhg_block covtype (32, 54) {variant}: bitwise 32 "
              f"launches at k=1; each step (w, u) within {worst:.3e} of the "
              f"plain step, normwise")
        # sigma = 1/t, u0 = 0: the ISTA step
        W, _ = prox_ops.pdhg_block_cuda(G, R, w0, torch.zeros_like(w0), scal,
                                        (1.0 / t).reshape(1),
                                        variant=variant)
        prev = [w0] + list(W)
        worst = 0.0
        for i in range(k):
            want = prox_ops.prox_step_cuda(G[i], R[i], prev[i], scal,
                                           variant=variant)
            rel = float((W[i] - want).abs().max() / want.abs().max())
            check(rel <= KERNEL_RTOL, f"pdhg_block at sigma = 1/t, "
                  f"{variant}, step {i}: {rel:.3e} from ISTA")
            worst = max(worst, rel)
        print(f"  pdhg_block at sigma = 1/t, {variant}: each step within "
              f"{worst:.3e} of ISTA's (prox_step) from the previous w")
    scal = prox_ops.prox_scalars(t, problem.lam)
    sigma = (0.5 / t).reshape(1)

    def call(G=G):
        return prox_ops.pdhg_block_cuda(G, R, w0, u0, scal, sigma)
    ms = time_ms(call, 200)
    queued = _event_ms(call, 200, queued=True)
    host = _host_us(call)
    plain_ms = time_ms(lambda: prox_ref.pdhg_block(G, R, w0, u0, scal,
                                                   sigma), 10)
    bms, by = bound("pdhg_block", G, R, w0, u0, scal, sigma)
    Gu = torch.empty(G.numel() + 1, device=dev)[1:].view_as(G).copy_(G)
    check(torch.equal(call()[0], call(Gu)[0]),
          "pdhg_block: the ring and global memory disagree")
    routes = [_event_ms(fn, 200, queued=True)
              for fn in (call, lambda: call(Gu)) * 2]
    print(f"  time pdhg_block covtype [32, 54]: kernel={ms:.4f}ms back to "
          f"back, {queued:.4f}ms queued ({1e3 * queued / k:.3f}us a "
          f"dependent step); wrapper host time {host:.1f}us a call; "
          f"plain={plain_ms:.4f}ms bound={bms:.7f}ms ({by}); G through the "
          f"ring {routes[0]:.4f}, {routes[2]:.4f}ms, from global memory "
          f"{routes[1]:.4f}, {routes[3]:.4f}ms (queued, alternating)")
    out["pdhg_block"] = dict(
        name="pdhg_block", route="cuda",
        source="src/repro_torch/csrc/prox_step.cu",
        replaces="src/repro/kernels/prox_step/kernel.py:89", launches=0,
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, shape=[k, d])
    del Gu

    # the four solves through the launcher, each path's counts zeroed first
    total = {}
    runs = {}
    for algo in ("ca_pdhg", "pdhg", "ca_bcd", "bcd"):
        kernels.reset_launch_counts()
        registry.reset_dispatch_counts()
        run = lasso_solve.main([
            "--dataset", "covtype", "--scale", "10", "--algorithm", algo,
            "--T", str(T), "--k", str(K), "--b", str(B), "--Q", str(Q),
            "--seed", "0", "--device", "cuda"])
        launches = kernels.launch_counts()
        dispatches = registry.dispatch_counts()
        runs[algo] = run
        blocks = T // K if algo.startswith("ca_") else T
        print(f"  covtype {algo}: rel_err={run.rel_err:.6f} "
              f"objective={run.objective:.6f} wall={run.seconds:.4f}s "
              f"launches={ {o: n for o, n in launches.items() if n} }")
        check(launches == run.launches, "launch counts disagree")
        check(all(b == "cuda" for (_, b) in dispatches),
              f"{algo}: a plain version ran: {dispatches}")
        want = ({"gram_gather": blocks, "pdhg_block": blocks}
                if "pdhg" in algo else {"gram": blocks})
        check({o: n for o, n in launches.items() if n} == want,
              f"{algo}: launches {launches}, want {want}")
        check(math.isfinite(run.rel_err) and run.rel_err < 1.0,
              f"{algo}: rel_err {run.rel_err}")
        for op, n in launches.items():
            total[op] = total.get(op, 0) + n
    check(torch.equal(runs["ca_pdhg"].w, runs["pdhg"].w),
          "CA-PDHG is not bitwise PDHG")
    diff = float((runs["ca_bcd"].w - runs["bcd"].w).abs().max())
    print(f"  covtype: CA-PDHG bitwise PDHG; |w_ca_bcd - w_bcd|_max = "
          f"{diff:.3e}")
    check(diff <= BCD_ATOL, f"CA-BCD vs BCD {diff:.3e} > {BCD_ATOL}")
    coord = sstep.draws(problem, cfg, torch.Generator(device=dev)
                        .manual_seed(0), None, "coord")
    for rule, idx, names in ((sstep.PDHG_RULE, draws, ("ca_pdhg", "pdhg")),
                             (sstep.BCD_RULE, coord, ("ca_bcd", "bcd"))):
        with registry.use("torch"):
            w_plain = sstep.solve(problem, cfg, None, rule, name="plain",
                                  idx=idx)
        w_card = sstep.solve(problem, cfg, None, rule, name="card", idx=idx)
        diff = float((w_card - w_plain).abs().max())
        print(f"  covtype {names[1]}: |w - w_plain|_max = {diff:.3e}")
        check(diff <= PLAIN_ATOL, f"{names[1]} vs plain {diff:.3e}")
        med, walls = solve_walls(problem, cfg, rule, idx)
        print(f"  covtype: warm solve wall, median of 3: {names[0]} "
              f"{med[True]!r}s {walls[True]!r}, {names[1]} {med[False]!r}s "
              f"{walls[False]!r}, classical/CA {med[False] / med[True]!r}")
        for ca in (True, False):
            wall, rows = profile_solve(problem, cfg, rule, idx, ca)
            busy = sum(r[1] for r in rows) / 1e6
            print(f"profile covtype {names[0] if ca else names[1]}: wall "
                  f"{wall:.4f}s (profiled), device kernels {busy:.4f}s "
                  f"({100 * busy / wall:.1f}% busy), "
                  f"{sum(r[2] for r in rows)} launches of {len(rows)} kernel "
                  f"names")
            for key, us, count in rows[:8]:
                print(f"    {us / 1e3:10.3f} ms  x{count:<5d} {key[:90]}")

    # gram at BCD's CA cross-Gram: r = k m_c = 160 over the 581,010 samples
    BU = problem.X.index_select(0, coord[:K].reshape(-1))
    shape = (1, BU.shape[0], BU.shape[1])
    got = gram_ops.gram_cuda(BU[None])
    want = gram_ref.gram(BU[None])
    err = compare("gram", shape, got, want, rtol=GRAM_RTOL)
    compare_offdiag(shape, got, want)
    ms = time_ms(lambda: gram_ops.gram_cuda(BU[None]), 20)
    plain_ms = time_ms(lambda: gram_ref.gram(BU[None]), 20)
    lib = time_ms(lambda: torch.mm(BU, BU.T), 20)
    bms, by = bound("gram", BU[None])
    print(f"  time gram {list(shape)} (BCD's cross-Gram): kernel={ms:.4f}ms "
          f"plain={plain_ms:.4f}ms torch.mm={lib:.4f}ms bound={bms:.5f}ms "
          f"({by}) max_abs_err={err:.3e}")
    del BU, got, want

    # ElasticNet through CA-SFISTA
    enet = ElasticNetProblem(X=problem.X, y=problem.y, lam=problem.lam,
                             mu=0.05)
    kernels.reset_launch_counts()
    w = ca_sfista(enet, cfg, idx=draws)
    launches = kernels.launch_counts()
    for op, n in launches.items():
        total[op] = total.get(op, 0) + n
    check({o: n for o, n in launches.items() if n} == {
        "gram_gather": T // K, "prox_step_block": T // K},
        f"elastic net: launches {launches}")
    with registry.use("torch"):
        w_plain = ca_sfista(enet, cfg, idx=draws)
    diff = float((w - w_plain).abs().max())
    f0 = float(enet.objective(torch.zeros_like(w)))
    f = float(enet.objective(w))
    print(f"  covtype elastic net (mu=0.05) CA-SFISTA: objective {f:.6f} "
          f"(from {f0:.6f} at 0), |w - w_plain|_max = {diff:.3e}")
    check(diff <= PLAIN_ATOL and f < f0, "elastic net CA-SFISTA")
    return out, total


def svm_phase(dev, compare, time_ms, problem):
    """Phase 6c: the dual SVM on covtype's first SVM_N samples (labels the
    sign of y, box [0, 1]): d = n = 4,096 for the prox, the step 1/L
    scaled by m/d. ``gram`` at r = 4,096 on a real block of draws against
    its plain version; CA-PDHG, PDHG and CA-SFISTA on the same draws, their
    prox on the rows route when SVM_N lies above the threshold (one launch
    a step), CA-PDHG bitwise PDHG and against its plain solve on the card,
    PDHG's objective below its value at 0 and CA-SFISTA's iterate inside
    the box. Returns launches per op."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import (DualSVMProblem, SolverConfig, ca_pdhg,
                                  ca_sfista, pdhg, sstep)
    from repro_torch.core.sampling import gather_columns
    from repro_torch.kernels import registry
    from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
    from repro_torch.kernels.prox_step import ops as prox_ops
    X = problem.X[:, :SVM_N].contiguous()
    labels = torch.where(problem.y[:SVM_N] >= 0, 1.0, -1.0)
    svm = DualSVMProblem(X=X, y=labels, C=1.0)
    rows = prox_ops.rows_route(svm.dim)
    print(f"phase 6c: dual SVM, n={svm.n} (the prox's d), d={svm.d} "
          f"features; prox route: {'rows' if rows else 'one CTA'}")
    # the default 1/L is the full Hessian's; the G_j of m of the d features
    # has a top eigenvalue up to d/m times larger, and with the default
    # step the stochastic solvers leave the box or grow (the JAX package's
    # too, at these sizes), so the step is scaled by m/d
    m = max(int(B * svm.n_units), 1)
    step = float(svm.default_step(SolverConfig())) * m / svm.n_units
    cfg = SolverConfig(T=SVM_T, k=SVM_K, b=B, Q=Q, step_size=step)
    draws = sstep.draws(svm, cfg, torch.Generator(device=dev).manual_seed(0),
                        None)
    Bs = gather_columns(svm.Zt, draws[:2])        # (2, n, m)
    shape = tuple(Bs.shape)
    got = gram_ops.gram_cuda(Bs)
    err = compare("gram", shape, got, gram_ref.gram(Bs), rtol=GRAM_RTOL)
    ms = time_ms(lambda: gram_ops.gram_cuda(Bs), 20)
    plain_ms = time_ms(lambda: gram_ref.gram(Bs), 5)
    lib = time_ms(lambda: torch.bmm(Bs, Bs.transpose(1, 2)), 20)
    bms, by = bound("gram", Bs)
    print(f"  time gram {list(shape)} (the dual SVM's G): kernel={ms:.4f}ms "
          f"plain={plain_ms:.4f}ms torch.bmm={lib:.4f}ms bound={bms:.5f}ms "
          f"({by}) max_abs_err={err:.3e}")
    del Bs, got
    total, ws = {}, {}
    f0 = float(svm.objective(torch.zeros(svm.dim, device=dev)))
    for name, solver in (("ca_pdhg", ca_pdhg), ("pdhg", pdhg),
                         ("ca_sfista", ca_sfista)):
        kernels.reset_launch_counts()
        registry.reset_dispatch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ws[name] = solver(svm, cfg, idx=draws)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        blocks = cfg.T // cfg.k if name.startswith("ca_") else cfg.T
        prox = ({"prox_rows": cfg.T} if rows else
                {("pdhg_block" if "pdhg" in name else "prox_step_block"):
                 blocks})
        want = {"gram": blocks, **prox}
        got_l = {o: n for o, n in launches.items() if n}
        f = float(svm.objective(ws[name]))
        print(f"  svm {name}: objective {f:.6f} (from {f0:.6f} at 0), wall "
              f"{wall:.4f}s, launches {got_l}")
        check(got_l == want, f"svm {name}: launches {got_l}, want {want}")
        check(all(b == "cuda" for (_, b) in registry.dispatch_counts()),
              f"svm {name}: a plain version ran")
        # PDHG descends at this step; FISTA's momentum does not, but its
        # box prox keeps every iterate feasible
        check(math.isfinite(f) and (f < f0 or "pdhg" not in name),
              f"svm {name}: objective {f}")
        for op, n in launches.items():
            total[op] = total.get(op, 0) + n
    check(torch.equal(ws["ca_pdhg"], ws["pdhg"]), "svm: CA-PDHG is not "
          "bitwise PDHG")
    a = ws["ca_sfista"]
    check(float(a.min()) >= 0.0 and float(a.max()) <= 1.0,
          "svm: CA-SFISTA left the box")
    with registry.use("torch"):
        w_plain = ca_pdhg(svm, cfg, idx=draws)
    diff = float((ws["ca_pdhg"] - w_plain).abs().max())
    print(f"  svm: CA-PDHG bitwise PDHG; |w - w_plain|_max = {diff:.3e}")
    check(diff <= PLAIN_ATOL, f"svm CA-PDHG vs plain {diff:.3e}")
    return total


def distributed_phase(dev):
    """Phase 6d: ``make_distributed_solver`` in an NCCL group of one in
    this process (an in-process store, no network), all eight algorithms
    on covtype at full size (susy for the SPNM pair) with the draws of a
    single-process solve: w bitwise the single-process w, T/k and T
    all-reduces, the gram family's words equal (T (d^2 + d)); the
    distributed and single-process warm walls side by side. Returns
    launches per op."""
    import torch
    from repro_torch import core as tcore
    from repro_torch import kernels
    from repro_torch.core import SolverConfig, sstep
    from repro_torch.core.distributed import (COORD_ALGORITHMS,
                                              CollectiveCount,
                                              make_distributed_solver,
                                              shard_problem)
    from repro_torch.core.sampling import sample_index_batch
    from repro_torch.data import make_dataset_like
    from repro_torch.launch import mesh
    print("phase 6d: distributed solvers, an NCCL group of one")
    mesh.init("cuda", rank=0, world_size=1)
    total = {}
    try:
        for dataset, scale, algs in (
                ("covtype", 10, ("ca_sfista", "sfista", "ca_pdhg", "pdhg",
                                 "ca_bcd", "bcd")),
                ("susy", 50, ("ca_spnm", "spnm"))):
            problem, _ = make_dataset_like(dataset, scale=scale, device=dev)
            step = float(problem.default_step(SolverConfig(T=T, k=K, b=B,
                                                           Q=Q)))
            cfg = SolverConfig(T=T, k=K, b=B, Q=Q, step_size=step)
            gram_idx = sample_index_batch(
                torch.Generator(device=dev).manual_seed(0), T, problem.n,
                sstep.draw_size(problem, cfg))
            coord_idx = sstep.draws(problem, cfg, torch.Generator(
                device=dev).manual_seed(0), None, "coord")
            X, y = shard_problem(problem.X, problem.y, 0, 1)
            w0 = torch.zeros(problem.d, device=dev)
            words = {}
            for alg in algs:
                idx = coord_idx if alg in COORD_ALGORITHMS else gram_idx
                count = CollectiveCount()
                solve = make_distributed_solver(alg, cfg, problem.lam,
                                                counter=count)
                single = getattr(tcore, alg)
                kernels.reset_launch_counts()
                w_d = solve(X, y, w0, step, idx=idx)
                for op, n in kernels.launch_counts().items():
                    total[op] = total.get(op, 0) + n
                w_s = single(problem, cfg, idx=idx)
                want = T // K if alg.startswith("ca_") else T
                check(count.all_reduces == want, f"distributed {alg}: "
                      f"{count.all_reduces} all-reduces, want {want}")
                check(torch.equal(w_d, w_s), f"distributed {alg} at world "
                      f"1: not bitwise the single-process w")
                words[alg] = count.words
                all_reduces = count.all_reduces
                walls = {True: [], False: []}
                for dist_run in (True, False, False, True, True, False):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if dist_run:
                        solve(X, y, w0, step, idx=idx)
                    else:
                        single(problem, cfg, idx=idx)
                    torch.cuda.synchronize()
                    walls[dist_run].append(time.perf_counter() - t0)
                print(f"  {dataset} {alg}: {all_reduces} all-reduces, "
                      f"{words[alg]} words a solve; bitwise the single-"
                      f"process w; "
                      f"warm walls distributed {sorted(walls[True])[1]!r}s "
                      f"{walls[True]!r}, single-process "
                      f"{sorted(walls[False])[1]!r}s {walls[False]!r}")
            for alg in algs:
                if alg.startswith("ca_") and alg not in COORD_ALGORITHMS:
                    d = problem.d
                    check(words[alg] == words[alg[3:]] == T * (d * d + d),
                          f"{alg}: words {words[alg]} vs {words[alg[3:]]}")
            del problem, X, y
            torch.cuda.empty_cache()
    finally:
        mesh.shutdown()
    return total


def attention_kernel_phase(dev):
    """Phase 7: flash_attention and paged_decode against their plain
    versions, timed beside their bounds and the SDPA yardstick. Returns the
    JSON entries at the main path's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    rng = np.random.default_rng(0)

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=dev, dtype=dtype)

    entries = {}
    print("kernel phase: flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    for (Bq, Hq, Hkv, Sq, Skv, D, causal, dtype) in (
            (2, 16, 8, 512, 512, 128, True, bf16),      # the forward's
            (2, 16, 8, 1024, 1024, 128, True, bf16),
            (2, 16, 8, 1000, 1000, 128, True, bf16),    # ragged
            (2, 16, 8, 64, 1000, 128, True, bf16),      # right-aligned
            (2, 16, 8, 37, 300, 128, False, bf16),      # not causal
            (2, 16, 8, 512, 512, 64, True, bf16),       # D=64
            (2, 32, 32, 512, 512, 80, True, bf16),      # zamba2's D=80
            (2, 16, 8, 512, 512, 128, True, f32),
            # the families' shapes (phase 15): whisper's encoder (not
            # causal), its cross-attention in the forward and at decode's
            # single query; qwen2-vl's GQA group of 6 over the vision
            # prefix and the text
            (2, 16, 16, 1500, 1500, 64, False, bf16),
            (2, 16, 16, 448, 1500, 64, False, bf16),
            (2, 16, 16, 1, 1500, 64, False, bf16),
            (2, 12, 2, 1536, 1536, 128, True, bf16)):
        q = normal((Bq, Sq, Hq, D), dtype)
        k = normal((Bq, Skv, Hkv, D), dtype)
        v = normal((Bq, Skv, Hkv, D), dtype)
        shape = (Bq, Hq, Hkv, Sq, Skv, D, "causal" if causal else "full",
                 str(dtype).split(".")[1])
        got = fa_ops.flash_attention_cuda(q, k, v, causal=causal)
        want = fa_ref.flash_attention(q, k, v, causal=causal)
        err = _normwise("flash_attention", shape, got, want,
                        ATTN_RTOL[shape[-1]])
        if dtype == bf16:
            # p kept at float32 accuracy through its hi/lo split: the
            # normwise limit cannot tell it from p rounded once to bf16
            once = fa_ref.flash_attention_p_rounded(q, k, v, causal=causal)
            flips, flips_once = (float((x != want).float().mean())
                                 for x in (got, once))
            print(f"  p split         {str(shape):44s} outputs off the "
                  f"float32-p version's bf16: {100 * flips:.3f}% (p rounded "
                  f"once: {100 * flips_once:.3f}%; limit "
                  f"{100 * P_FLIP_LIMIT:g}%)")
            check(flips <= P_FLIP_LIMIT < flips_once,
                  f"flash_attention{shape}: {flips:.4f} of the outputs off "
                  f"the float32-p version (p rounded once: {flips_once:.4f},"
                  f" limit {P_FLIP_LIMIT})")
            del once
        if Sq != Skv and causal:
            # right-aligned: SDPA's causal mask is top-left, another
            # function
            continue
        ms = _event_ms(lambda: fa_ops.flash_attention_cuda(
            q, k, v, causal=causal), 20)
        queued = _event_ms(lambda: fa_ops.flash_attention_cuda(
            q, k, v, causal=causal), 20, queued=True)
        plain = _event_ms(lambda: fa_ref.flash_attention(
            q, k, v, causal=causal), 5)
        # the yardstick: SDPA on the same q/k/v, KV heads repeated and the
        # layout made (B, H, S, D) beforehand; only the call is timed
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
        lib = _event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 20)
        lib_queued = _event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 20, queued=True)
        del qt, kt, vt
        host = _host_us(lambda: fa_ops.flash_attention_cuda(
            q, k, v, causal=causal), 50)
        # causal work counts the visible (query, key) pairs only
        flops = registry.work("flash_attention", q, k, v,
                              causal=causal).flops
        bms, by = bound("flash_attention", q, k, v, causal=causal)
        cuda_core_ms = bound("flash_attention", q, k, v, causal=causal,
                             f32=True)[0]
        print(f"  time flash_attention {str(shape):44s} kernel={ms:.4f}ms "
              f"plain={plain:.4f}ms sdpa={lib:.4f}ms bound={bms:.5f}ms "
              f"({by}, {str(dtype).split('.')[1]} peak) float32-CUDA-core "
              f"bound={cuda_core_ms:.5f}ms host={host:.1f}us/call"
              + (_tensor_core_line(flops, ms, bms) if dtype == bf16 else ""))
        # diagnostic only: device time with the host's enqueueing hidden
        print(f"  queued flash_attention {str(shape):42s} kernel="
              f"{queued:.4f}ms sdpa={lib_queued:.4f}ms")
        if Sq == 512 and D == 128 and dtype == bf16:
            entries["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:250",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib,
                tensor_core_route=FLASH_ROUTE)
        del q, k, v, got, want

    entries.update(paged_decode_phase(dev))
    return entries


#: the L2 cache holds 50 MB; a flush reads a buffer five times that (a
#: sum), so the L2 holds only clean lines when the timed span opens
L2_FLUSH_BYTES = 256 * 2 ** 20


def paged_decode_phase(dev):
    """Phase 7's paged half: ``paged_decode`` against its plain version at
    the engine's shapes, timed behind an L2 flush beside the flush's own
    floor (an empty launch behind the same flush), back to back, and beside
    the page gather + SDPA pair (a diagnostic: no single PyTorch call walks
    a page table). Returns the JSON entry at the engine's bf16 shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    rng = np.random.default_rng(1)
    bf16, f32 = torch.bfloat16, torch.float32

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=dev, dtype=dtype)

    print("kernel phase: paged_decode")
    buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        # a read: zeroing the buffer would leave dirty lines that the
        # kernel's own reads write back inside the timed span
        buf.sum()

    floor = _event_ms(lambda: torch.cuda._sleep(0), 100, flush)
    print(f"  flush floor (an empty launch behind the flush): "
          f"{floor:.4f}ms")
    # the engine's first 8 rows at 32 decoded tokens: prompts of 32-512
    engine_lens = [len(r.prompt) + 32
                   for r in _serve_requests(get_arch(ARCH))[:8]]
    entries = {}
    for kv, P, npages, Hq, Hkv, D, lens in (
            ("bf16", 16, 64, 16, 8, 128, None),
            ("int8", 16, 64, 16, 8, 128, None),
            ("f32", 16, 64, 16, 8, 128, None),
            ("bf16", 5, 205, 16, 8, 128, None),
            ("int8", 5, 205, 16, 8, 128, None),
            ("bf16", 16, 64, 32, 32, 80, None),        # zamba2's heads
            ("bf16", 16, 64, 16, 8, 128, engine_lens),
            # the other families' engine shapes (phase 17(e)): granite,
            # qwen2-vl's group of 6, whisper's self-attention, deepseek
            ("bf16", 16, 64, 16, 8, 64, None),
            ("bf16", 16, 64, 12, 2, 128, None),
            ("bf16", 16, 64, 16, 16, 64, None),
            ("bf16", 16, 64, 16, 16, 128, None)):
        Bq = 8
        num_pages = 1 + Bq * npages
        valid = (np.linspace(1, min(npages * P, 1024), Bq) if lens is None
                 else np.asarray(lens)).astype(np.int32)
        perm = rng.permutation(np.arange(1, num_pages)).reshape(Bq, npages)
        table = np.where(np.arange(npages)[None] < -(-valid // P)[:, None],
                         perm, 0).astype(np.int32)
        qdt = f32 if kv == "f32" else bf16
        q = normal((Bq, 1, Hq, D), qdt)
        shp = (num_pages, P, Hkv, D)
        scales = {}
        if kv == "int8":
            kp = torch.randint(-127, 128, shp, dtype=torch.int8, device=dev)
            vp = torch.randint(-127, 128, shp, dtype=torch.int8, device=dev)
            scales = {n: torch.rand(shp[:3], device=dev) * 0.02 + 1e-3
                      for n in ("k_scale", "v_scale")}
        else:
            kp = normal(shp, f32 if kv == "f32" else bf16)
            vp = normal(shp, f32 if kv == "f32" else bf16)
        t = torch.from_numpy(table).to(dev)
        n = torch.from_numpy(valid).to(dev)
        shape = (Bq, Hq, Hkv, D, f"page {P}", kv,
                 "engine lengths" if lens else "valid 1..1024")

        def kernel():
            return fa_ops.paged_decode_cuda(q, kp, vp, t, n, **scales)

        def plain():
            return fa_ref.paged_decode(q, kp, vp, t, n, **scales)

        got, want = kernel(), plain()
        err = _normwise("paged_decode", shape[:6], got, want,
                        ATTN_RTOL[str(qdt).split(".")[1]])
        ms = _event_ms(kernel, 100, flush)
        plain_ms = _event_ms(plain, 20, flush)
        warm = _event_ms(kernel, 200)
        host = _host_us(kernel)

        # the diagnostic pair, in one span: the pages gathered from the
        # table (dequantized for int8), then SDPA with a length mask
        T = npages * P
        tl = t.long()
        qd = q.transpose(1, 2)
        mask = (torch.arange(T, device=dev)[None, :] < n[:, None])
        mask = mask[:, None, None, :]

        def gather_sdpa():
            kd, vd = kp[tl], vp[tl]
            if kv == "int8":
                kd = (kd.float() * scales["k_scale"][tl][..., None]).to(qdt)
                vd = (vd.float() * scales["v_scale"][tl][..., None]).to(qdt)
            kd = kd.reshape(Bq, T, Hkv, D).transpose(1, 2)
            vd = vd.reshape(Bq, T, Hkv, D).transpose(1, 2)
            return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                  enable_gqa=True)

        pair_err = float((gather_sdpa().transpose(1, 2).float()
                          - want.float()).abs().max())
        pair = _event_ms(gather_sdpa, 100, flush)
        # bytes: q and out once, the valid K/V rows (and their scales) once
        tokens = float(valid.sum())
        bms, by = bound("paged_attention", q, kp, vp, t, n, **scales)
        print(f"  time paged_decode {str(shape):62s} kernel={ms:.4f}ms "
              f"(behind the flush; {ms - floor:.4f}ms above its floor "
              f"{floor:.4f}ms; {warm:.4f}ms back to back) "
              f"plain={plain_ms:.4f}ms bound={bms:.5f}ms ({by}) "
              f"gather+sdpa={pair:.4f}ms (diagnostic, max |d| vs plain "
              f"{pair_err:.2e}) valid tokens={int(tokens)} "
              f"host={host:.1f}us/call")
        if (kv, P, Hq, Hkv, D, lens) == ("bf16", 16, 16, 8, 128, None):
            entries["paged_decode"] = dict(
                name="paged_decode", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:208",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None, floor_ms=floor,
                warm_ms=warm, gather_sdpa_ms=pair)
        if (P, Hq, Hkv, D, lens) == (16, 16, 8, 128, None) and \
                kv in ("bf16", "int8"):
            entries["paged_decode"].update(_row_map_check(
                kernel, plain, q, kp, vp, t, n, scales, shape, flush, kv))
        del q, kp, vp, got, want
    del buf
    return entries


def _row_map_check(kernel, plain, q, kp, vp, t, n, scales, shape, flush,
                   kv):
    """The row-map and lse instance of ``paged_decode`` (sharded serving:
    each of m ranks holds rows [r P/m, (r + 1) P/m) of every page) at the
    engine's shape, on one card: each slice's o and lse against the plain
    version on the same slice, the m slices merged
    (``ref.merge_partials``) against the unsplit kernel and the plain
    version, and base 0 with the page size as stride, no lse, bitwise the
    default call. Times rank 0's call (the most valid rows) behind the
    flush beside its bound (the rank's rows only) and its plain version.
    Returns the keys it adds to the kernel's JSON entry."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    P = kp.shape[1]
    whole = kernel()
    check(torch.equal(whole, fa_ops.paged_decode_cuda(
        q, kp, vp, t, n, **scales, row_base=0, row_stride=P)),
        "paged_decode: base 0, stride P is not the default call's bits")
    want = plain()
    out = {}
    for m in (2, 4):
        R = P // m
        parts, lses, calls = [], [], []
        for r in range(m):
            cut = slice(r * R, (r + 1) * R)
            ks, vs = kp[:, cut].contiguous(), vp[:, cut].contiguous()
            sc = {k: v[:, cut].contiguous() for k, v in scales.items()}
            kw = dict(sc, row_base=r * R, row_stride=P, return_lse=True)
            o, lse = fa_ops.paged_decode_cuda(q, ks, vs, t, n, **kw)
            wo, wl = fa_ref.paged_decode(q, ks, vs, t, n, **kw)
            err = _normwise(f"rows {r}/{m}", shape[:6], o, wo,
                            ATTN_RTOL[str(q.dtype).split(".")[1]])
            fin = torch.isfinite(wl)
            check(torch.equal(torch.isinf(lse), torch.isinf(wl)),
                  f"paged_decode rows {r}/{m}: lse -inf where the plain "
                  f"version's is not")
            lerr = float((lse[fin] - wl[fin]).abs().max())
            check(lerr <= 1e-5 * max(1.0, float(wl[fin].abs().max())),
                  f"paged_decode rows {r}/{m}: lse off by {lerr:.3e}")
            parts.append(o)
            lses.append(lse)
            calls.append((ks, vs, kw))
        merged = fa_ref.merge_partials(torch.stack(parts), torch.stack(lses))
        rtol = ATTN_RTOL[str(q.dtype).split(".")[1]]
        m_err = _normwise(f"merged m={m}", shape[:6], merged, whole, rtol)
        _normwise(f"merged m={m}", shape[:6], merged, want, rtol)
        ks, vs, kw = calls[0]
        ms = _event_ms(lambda: fa_ops.paged_decode_cuda(q, ks, vs, t, n,
                                                        **kw), 100, flush)
        plain_ms = _event_ms(lambda: fa_ref.paged_decode(q, ks, vs, t, n,
                                                         **kw), 20, flush)
        bms, by = bound("paged_attention", q, ks, vs, t, n, **kw)
        print(f"  time paged_decode rows of 1/{m} {str(shape):48s} rank 0: "
              f"kernel={ms:.4f}ms (behind the flush) plain={plain_ms:.4f}ms "
              f"bound={bms:.5f}ms ({by}); merged vs the unsplit kernel "
              f"max |d| {m_err:.3e}")
        if kv == "bf16":
            out.update({f"rows_m{m}_ms": ms, f"rows_m{m}_plain_ms": plain_ms,
                        f"rows_m{m}_bound_ms": bms,
                        f"rows_m{m}_bound_by": by,
                        f"rows_m{m}_max_abs_err": m_err})
    return out


def _normwise_dev(got, want):
    """max |got - want| / max |want| over the entries where ``want`` is
    finite (an lse is -inf on rows that see no key), as a device scalar."""
    import torch
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    zero = torch.zeros((), device=want.device)
    err = torch.where(fin, (got - want).abs(), zero).max()
    return err / torch.where(fin, want.abs(), zero).max().clamp_min(1e-30)


def _lse_err_dev(got, want):
    """max |got - want| over the rows where the plain lse is finite, or inf
    where the two disagree on which rows see no key, as a device scalar."""
    import torch
    fin = torch.isfinite(want)
    err = torch.where(fin, (got - want).abs(),
                      torch.zeros((), device=want.device)).max()
    mismatch = (torch.isfinite(got) != fin).any()
    return torch.where(mismatch, torch.full_like(err, math.inf), err)


#: each held op's outputs, named; a call that returns fewer (the forward
#: without its lse or its states) fills the first names
HELD_OUTS = {"flash_attention": ("o", "lse"), "paged_attention": ("o_paged",),
             "flash_dq": ("dq",), "flash_dkv": ("dk", "dv"),
             "ssd": ("y", "h_final", "states"),
             "ssd_bwd": ("dxdt", "da", "dB", "dC")}
#: each named output's limit: normwise, the lse's absolute; attention and
#: y in the bf16 stream, the SSD's float32 outputs at the float32 limit
HELD_TOL = dict(o=ATTN_RTOL["bfloat16"], o_paged=ATTN_RTOL["bfloat16"],
                dq=ATTN_RTOL["bfloat16"], dk=ATTN_RTOL["bfloat16"],
                dv=ATTN_RTOL["bfloat16"], lse=LSE_ATOL,
                y=SSD_RTOL["bfloat16"], h_final=SSD_RTOL["float32"],
                states=SSD_RTOL["float32"], dxdt=SSD_RTOL["float32"],
                da=SSD_DA_RTOL, dB=SSD_RTOL["float32"],
                dC=SSD_RTOL["float32"])


@contextlib.contextmanager
def _held_to_plain(errs: dict):
    """Hold every kernel dispatch of the block (the ops of ``HELD_OUTS``)
    against its plain version on the same inputs, right after the kernel
    and before the next layer writes the pool: ``errs[output]`` collects
    each call's error on that output as a device scalar, max |kernel -
    plain| / max |plain| (``_normwise_dev``), and for the lse its absolute
    error (``_lse_err_dev``). The plain calls go straight to the ``ref.py``
    modules, so the launch counts still see the kernels only."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ref as attn
    from repro_torch.kernels.ssd import ref as ssd

    plain = {"flash_attention": attn.flash_attention,
             "paged_attention": attn.paged_decode,
             "flash_dq": attn.flash_dq, "flash_dkv": attn.flash_dkv,
             "ssd": ssd.ssd_chunked, "ssd_bwd": ssd.ssd_bwd}
    for names in HELD_OUTS.values():
        for n in names:
            errs[n] = []
    dispatch = registry.dispatch

    def held(name, *args, **kw):
        out = dispatch(name, *args, **kw)
        if name in plain:
            want = plain[name](*args, **kw)
            pairs = zip(out, want) if isinstance(out, tuple) else \
                [(out, want)]
            for n, (g, w) in zip(HELD_OUTS[name], pairs):
                errs[n].append((_lse_err_dev if n == "lse" else
                                _normwise_dev)(g, w))
        return out

    registry.dispatch = held
    try:
        yield
    finally:
        registry.dispatch = dispatch
    for name, e in errs.items():
        errs[name] = torch.stack(e) if e else torch.zeros(0)


def _check_held(errs: dict, counts: dict, where: str) -> None:
    """Print and gate ``_held_to_plain``'s errors: ``counts[output]`` calls
    each, within ``HELD_TOL``."""
    for name, want in counts.items():
        e, tol = errs[name], HELD_TOL[name]
        emax = float(e.max()) if e.numel() else math.nan
        kind = "max abs" if name == "lse" else "normwise max"
        print(f"  {where}: every {name} held to its plain version: "
              f"{e.numel()} calls, {kind} {emax:.3e} (limit {tol})")
        check(e.numel() == want and emax <= tol,
              f"{where}: {name} vs plain on the main path {emax:.3e} (limit "
              f"{tol}) over {e.numel()} calls, want {want}")


def _allclose_margin(got, ref):
    """(max |got - ref|, worst excess over allclose(atol=rtol=LOGIT_TOL))
    of two logit tensors: the check passes where the excess is <= 0."""
    diff = (got.float() - ref.float()).abs()
    excess = diff - LOGIT_TOL - LOGIT_TOL * ref.float().abs()
    return float(diff.max()), float(excess.max())


def _teacher_forcing(dev, cfg, params, toks):
    """decode_step one token at a time through a bf16 paged cache (page
    16): returns (logits (B, S, V) as decode_step gives them, seconds,
    launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import decode_step
    from repro_torch.serve import PagedCachePool

    Bm, S = toks.shape
    pool = PagedCachePool(cfg, Bm, S, page_size=16, device=dev)
    for b in range(Bm):
        pool.reserve(pool.allocate(f"tf{b}"), S)
    cache = pool.make_cache()
    table = torch.from_numpy(pool.tables.copy()).to(dev)
    out = torch.empty(Bm, S, cfg.vocab, dtype=torch.bfloat16, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(S):
        pos = torch.full((Bm,), t, dtype=torch.int32, device=dev)
        lg, cache = decode_step(params, cfg, cache, toks[:, t:t + 1],
                                positions=pos, page_table=table)
        out[:, t] = lg[:, 0]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernels.launch_counts()


def _gemm_m_gap(x, w):
    """x (M, K) @ w (K, N) in bf16 at M rows against the same rows two at
    a time (decode's M at batch 2): (share of outputs whose bits differ,
    max |difference|)."""
    import torch
    full = x @ w
    pairs = torch.cat([x[i:i + 2] @ w for i in range(0, x.shape[0], 2)])
    return (float((full != pairs).float().mean()),
            float((full.float() - pairs.float()).abs().max()))


def model_phase(dev, cfg, params):
    """Phase 8: forward through flash_attention, then teacher-forced
    decode_step through paged_decode on a bf16 paged cache.

    The JAX package's check (tests/test_models.py: decode vs forward
    logits, atol = rtol = 0.05) is gated at its own size, the smoke config,
    with both kernels. At full width the kernels are held on the main
    path itself: every flash_attention call of a forward and every
    paged_decode call of the 512 teacher-forced steps against its plain
    version on that call's inputs, normwise within the bf16 kernel
    tolerance (8e-3). The logits comparisons at full width are printed,
    not gated: decode vs forward (the JAX package's 0.05), decode vs
    decode with the plain attention (same GEMM shapes, only the kernel
    differs), the two plain paths against each other (no kernel at all)
    and forward vs forward with the plain attention; and, for the cause of
    the gap, the model's GEMMs at 1,024 rows against the same rows two at
    a time. Through 24 bf16 layers any one-ulp flip grows to ~0.09 in the
    logits, so no pair of paths meets 0.05 at this width (PERF.md).
    Returns flash_attention's launches in the forward."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import registry
    from repro_torch.models import forward, init_params
    from repro_torch.models.layers import rms_norm

    # the JAX check at its own size
    small = smoke_config(cfg)
    sp = init_params(small, torch.Generator(device=dev).manual_seed(0),
                     dtype=torch.bfloat16, device=dev)
    stoks = torch.from_numpy(np.random.RandomState(1).randint(
        0, small.vocab, size=(2, 64)).astype(np.int32)).to(dev)
    sref, _ = forward(sp, small, {"tokens": stoks})
    sdec, _, launches = _teacher_forcing(dev, small, sp, stoks)
    worst, excess = _allclose_margin(sdec, sref)
    print(f"model phase: smoke config ({small.n_layers} layers, d_model "
          f"{small.d_model}), 64 positions: max |decode - forward| = "
          f"{worst:.4e}, allclose atol=rtol={LOGIT_TOL} worst margin "
          f"{excess:+.4e}")
    check(excess <= 0.0, f"smoke config: decode logits exceed atol=rtol="
          f"{LOGIT_TOL} of forward's (max |d| {worst:.4e})")
    check(launches["paged_decode"] == 64 * small.n_layers,
          "smoke config: paged_decode launches")
    del sp, sref, sdec

    Bm, S = 2, 512
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(Bm, S)).astype(np.int32)).to(dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"model phase: {cfg.name} forward (B={Bm}, S={S}) {fwd_s:.3f}s "
          f"(first call) logits {tuple(logits.shape)} {logits.dtype} "
          f"launches={launches}")
    check(tuple(logits.shape) == (Bm, S, cfg.vocab), "forward logits shape")
    check(bool(torch.isfinite(logits).all()), "forward logits not finite")
    check(launches["flash_attention"] == cfg.n_layers,
          f"forward launched flash_attention {launches['flash_attention']} "
          f"times, want {cfg.n_layers}")
    check(launches["paged_decode"] == 0, "forward launched paged_decode")
    flash_launches = launches["flash_attention"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    print(f"  forward again: {(time.perf_counter() - t0) * 1e3:.2f} ms")

    # the kernels on the main path's own inputs, call by call
    errs = {}
    with _held_to_plain(errs):
        held, _ = forward(params, cfg, {"tokens": toks})
    _check_held(errs, {"o": cfg.n_layers}, "forward, flash_attention")
    del held
    errs = {}
    T = TF_POSITIONS
    with _held_to_plain(errs):
        dec, tf_s, launches = _teacher_forcing(dev, cfg, params, toks[:, :T])
    print(f"  teacher-forced decode_step x{T} (paged, bf16, page 16): "
          f"{tf_s:.3f}s with the plain calls; launches={launches}")
    _check_held(errs, {"o_paged": T * cfg.n_layers}, "decode, paged_decode")
    check(launches["paged_decode"] == T * cfg.n_layers,
          f"decode launched paged_decode {launches['paged_decode']} times")
    check(bool(torch.isfinite(dec).all()), "decode logits not finite")

    # the logits, printed: through 24 bf16 layers any rounding flip grows
    with registry.use("torch"):
        plain_fwd, _ = forward(params, cfg, {"tokens": toks})
        plain_dec, _, _ = _teacher_forcing(dev, cfg, params, toks[:, :T])
    logits, plain_fwd = logits[:, :T], plain_fwd[:, :T]
    print(f"  logits max |x| {float(logits.abs().max()):.3f}, std "
          f"{float(logits.float().std()):.3f}; allclose "
          f"atol=rtol={LOGIT_TOL} over the first {T} positions (max |d|, "
          f"worst margin; printed, not gated):")
    for label, a, b in (
            ("decode vs forward (the kernels)", dec, logits),
            ("decode vs decode with plain attention", dec, plain_dec),
            ("plain decode vs plain forward (no kernel)", plain_dec,
             plain_fwd),
            ("forward vs forward with plain attention", logits, plain_fwd)):
        worst, excess = _allclose_margin(a, b)
        w0, e0 = _allclose_margin(a[:, 0], b[:, 0])
        print(f"    {label}: {worst:.4e}, {excess:+.4e} "
              f"({'met' if excess <= 0 else 'not met'}); position 0 "
              f"{w0:.4e}, {e0:+.4e}")
    del dec, plain_dec, plain_fwd, logits

    # the cause: the same rows at M = 1,024 and two at a time
    lp = params["layers"][0]
    x = rms_norm(torch.randn(Bm * S, cfg.d_model, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(torch.bfloat16),
        lp["ln1"], cfg.norm_eps)
    h = torch.randn(Bm * S, cfg.d_ff, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev).to(torch.bfloat16)
    for label, a, w in (("wq", x, lp["attn"]["wq"]),
                        ("w_gate", x, lp["mlp"]["w_gate"]),
                        ("w_down", h, lp["mlp"]["w_down"]),
                        ("lm_head", x, params["lm_head"])):
        share, gap = _gemm_m_gap(a, w.to(torch.bfloat16))
        print(f"  GEMM {label} {tuple(w.shape)} at M={Bm * S} vs M=2: "
              f"{100 * share:.3f}% of outputs differ, max |d| {gap:.4e}")
    return flash_launches


#: phase 9's prompt lengths: 32-512 tokens
SERVE_PROMPT_LENS = (32, 513)
#: phase 17(a) and (d)'s prompt lengths: phase 9's requests with their
#: prompts drawn from 32-128 tokens, so that phase 17's six drains of them
#: stay inside the run's time limit (the engine prefills a token a step)
SAMPLED_PROMPT_LENS = (32, 129)


def _serve_requests(cfg, n=16, new_tokens=64,
                    prompt_lens=SERVE_PROMPT_LENS):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(*prompt_lens))
        prompt = rng.randint(0, cfg.vocab, size=plen).tolist()
        reqs.append(Request(id=f"req-{i}", prompt=prompt,
                            max_new_tokens=new_tokens))
    return reqs


def serve_profile(dev, cfg, params, k=8):
    """One profiled k-step block of the paged engine in steady state
    (phase 9's): device time by kernel and the busy share, then each paged
    kernel's own device time a launch and launches a step. Returns the
    paged kernels' (name, device us, launches) in the block."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Engine

    eng = Engine(params, cfg, num_slots=8, max_len=1024, max_prompt=512, k=k,
                 page_size=16, eos_id=None, device=dev, sync_debug=True)
    for r in _serve_requests(cfg):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(ev.key, _self_device_us(ev), ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    print(f"  profile one k={k} block: wall {wall * 1e3:.3f} ms (profiled), "
          f"device kernels {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}% "
          f"busy), {sum(r[2] for r in rows)} kernel launches, "
          f"{len(rows)} kernel names")
    for key, us, count in rows[:10]:
        print(f"    {us / 1e3:10.3f} ms  x{count:<5d} {key[:90]}")
    paged = [r for r in rows if "paged" in r[0]]
    for key, us, count in paged:
        print(f"  paged kernel {key[:70]}: {us / max(count, 1):.2f} us a "
              f"launch, {count / k:.1f} launches a step, {us / k:.2f} us a "
              f"step")
    del eng
    return paged


def serve_phase(dev, cfg, params):
    """Phase 9: the paged engine at full width. Returns paged_decode's
    launches in the k=8 run and the k=1 run's steady ms/sync."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import Engine

    def engine(k, **kw):
        return Engine(params, cfg, num_slots=8, max_len=1024, max_prompt=512,
                      k=k, page_size=16, eos_id=None, device=dev,
                      sync_debug=True, **kw)

    def run(k, **kw):
        eng = engine(k, **kw)
        for r in _serve_requests(cfg):
            eng.submit(r)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.step()                 # first block: allocator warm-up
        first = time.perf_counter() - t0
        toks0, syncs0 = eng.stats.tokens_out, eng.stats.syncs
        t0 = time.perf_counter()
        out += eng.run()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        s = eng.stats
        steps = (s.syncs - syncs0) * k
        label = f"k={k} {kw.get('kv_dtype', 'bf16')}"
        print(f"  serve {label}: first block {first:.3f}s; steady "
              f"{(s.tokens_out - toks0) / wall:.1f} tok/s, "
              f"{wall / steps * 1e3:.3f} ms/step, "
              f"{wall / (s.syncs - syncs0) * 1e3:.3f} ms/sync over "
              f"{s.syncs - syncs0} syncs; {s.summary()}; "
              f"page_defrags={s.page_defrags} "
              f"peak_live_pages={s.peak_live_pages} launches={launches}")
        check(s.retired == 16 and len(out) == 16, f"{label}: retired "
              f"{s.retired}")
        check(all(len(r.tokens) == 64 and r.finish_reason == "length"
                  for r in out), f"{label}: a response is not 64 tokens "
              f"finished by length")
        check(s.steps == s.syncs * k, f"{label}: steps {s.steps} != syncs "
              f"{s.syncs} * k")
        check(launches["paged_decode"] == s.steps * cfg.n_layers,
              f"{label}: paged_decode launched {launches['paged_decode']} "
              f"times, want steps * {cfg.n_layers} = "
              f"{s.steps * cfg.n_layers}")
        check(launches["flash_attention"] == 0,
              f"{label}: flash_attention launched in decode")
        return ({r.id: r.tokens for r in out}, launches["paged_decode"],
                wall / (s.syncs - syncs0) * 1e3)

    print(f"serve phase: {cfg.name} Engine(num_slots=8, max_len=1024, "
          f"max_prompt=512, k, page_size=16), 16 requests x 64 new tokens, "
          f"blocks under set_sync_debug_mode('error')")
    streams8, paged_launches, _ = run(8)
    streams1, _, k1_ms_per_sync = run(1)
    same = streams8 == streams1
    print(f"  k=8 vs k=1 token streams bit-identical: {same}")
    check(same, "k=8 and k=1 token streams differ")
    streams_q, _, _ = run(8, kv_dtype="int8")
    total = sum(len(v) for v in streams_q.values())
    equal = sum(a == b for rid in streams_q
                for a, b in zip(streams8[rid], streams_q[rid]))
    print(f"  int8 pages vs bf16: {equal}/{total} tokens equal "
          f"({100.0 * equal / total:.1f}%, not gated)")

    # where the time goes: one profiled k=8 block in steady state; one
    # paged kernel, launched once a layer and step, and no merge kernel
    paged = serve_profile(dev, cfg, params)
    check(len(paged) == 1 and paged[0][2] == 8 * cfg.n_layers,
          f"profiled block: paged kernels {paged}, want one name launched "
          f"{8 * cfg.n_layers} times")
    check(not any("merge" in key for key, _, _ in paged),
          "profiled block: a paged merge kernel ran")

    # the normal entry point
    t0 = time.perf_counter()
    out = serve_cli.main(["--arch", cfg.name, "--preset", "full",
                          "--page-size", "16", "--batch", "8",
                          "--max-len", "1024", "--k", "8",
                          "--new-tokens", "32", "--requests", "16",
                          "--device", "cuda"])
    print(f"  launch.serve --preset full --page-size 16: {len(out)} "
          f"responses in {time.perf_counter() - t0:.2f}s")
    check(len(out) == 16 and all(len(r.tokens) == 32 for r in out),
          "launch.serve: not every request got 32 tokens")
    return paged_launches, k1_ms_per_sync


#: phase 10's shapes (B, Hq, Hkv, Sq, Skv, D, causal, dtype name): the train
#: step's first, then phase 7's, then zamba2's attention (32 heads of 80,
#: run zero-padded to 128)
BWD_SHAPES = ((8, 16, 8, 1024, 1024, 128, True, "bfloat16"),
              (2, 16, 8, 1000, 1000, 128, True, "bfloat16"),    # ragged
              (2, 16, 8, 64, 1000, 128, True, "bfloat16"),      # right-aligned
              (2, 16, 8, 37, 300, 128, False, "bfloat16"),      # not causal
              (2, 16, 8, 512, 512, 128, True, "float32"),
              (2, 32, 32, 512, 512, 80, True, "bfloat16"))      # D=80
#: the families' shapes where grads reach (phase 15), held and timed:
#: whisper's encoder and its cross-attention, granite's train step (D=64),
#: qwen2-vl's group of 6
FAMILY_BWD_SHAPES = (
    (2, 16, 16, 1500, 1500, 64, False, "bfloat16"),
    (2, 16, 16, 448, 1500, 64, False, "bfloat16"),
    (8, 16, 8, 1024, 1024, 64, True, "bfloat16"),
    (2, 12, 2, 1536, 1536, 128, True, "bfloat16"),
    # llama3-8b's local heads under tensor parallelism, a microbatch of 8
    # rows: model = 4 (8 query heads, 2 kv heads) and (2, 2)'s model = 2
    # on 4 rows (16 and 4)
    (8, 8, 2, 1024, 1024, 128, True, "bfloat16"),
    (4, 16, 4, 1024, 1024, 128, True, "bfloat16"))


def backward_kernel_phase(dev):
    """Phase 10: the lse forward, flash_dq and flash_dkv against their plain
    versions, bit-equal across launches, timed beside their bounds and the
    SDPA backward. Returns the JSON entries of flash_dq and flash_dkv at
    the training shape, and the lse forward's times there (printed)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    rng = np.random.default_rng(1)

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=dev, dtype=dtype)

    entries = {}
    print("backward kernel phase: lse forward, flash_dq, flash_dkv")
    for i, case in enumerate(BWD_SHAPES + FAMILY_BWD_SHAPES):
        Bq, Hq, Hkv, Sq, Skv, D, causal, tname = case
        dtype = getattr(torch, tname)
        q = normal((Bq, Sq, Hq, D), dtype)
        k = normal((Bq, Skv, Hkv, D), dtype)
        v = normal((Bq, Skv, Hkv, D), dtype)
        do = normal((Bq, Sq, Hq, D), dtype)
        shape = (Bq, Hq, Hkv, Sq, Skv, D, "causal" if causal else "full",
                 tname)
        tol = ATTN_RTOL[tname]
        o, lse = fa_ops.flash_attention_cuda(q, k, v, causal=causal,
                                             return_lse=True)
        wo, wlse = fa_ref.flash_attention_lse(q, k, v, causal=causal)
        err_o = _normwise("lse fwd: o", shape, o, wo, tol)
        torch.cuda.synchronize()
        seen = torch.isfinite(wlse)
        check(torch.equal(torch.isfinite(lse), seen),
              f"lse{shape}: rows seeing no key differ")
        err_l = float((lse[seen] - wlse[seen]).abs().max())
        print(f"  {'lse fwd: lse':15s} {str(shape):44s} "
              f"max_abs_err={err_l:.3e} (limit {LSE_ATOL})")
        check(err_l <= LSE_ATOL, f"lse{shape}: {err_l:.3e} > {LSE_ATOL}")
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dq = fa_ops.flash_dq_cuda(*args, causal=causal)
        dk, dv = fa_ops.flash_dkv_cuda(*args, causal=causal)
        wdq = fa_ref.flash_dq(*args, causal=causal)
        wdk, wdv = fa_ref.flash_dkv(*args, causal=causal)
        err_dq = _normwise("flash_dq", shape, dq, wdq, tol)
        err_dkv = max(_normwise("flash_dkv: dk", shape, dk, wdk, tol),
                      _normwise("flash_dkv: dv", shape, dv, wdv, tol))
        if dtype == torch.bfloat16:
            # p and ds kept at float32 accuracy through their hi/lo split:
            # the normwise limit cannot tell it from rounding them once
            once = (fa_ref.flash_dq_rounded(*args, causal=causal),
                    *fa_ref.flash_dkv_rounded(*args, causal=causal))
            for name, got, want, rnd in zip(("dq", "dk", "dv"),
                                            (dq, dk, dv), (wdq, wdk, wdv),
                                            once):
                flips, flips_once = (float((x != want).float().mean())
                                     for x in (got, rnd))
                print(f"  p, ds split: {name} {str(shape):40s} outputs off "
                      f"the float32 version's bf16: {100 * flips:.3f}% (p "
                      f"and ds rounded once: {100 * flips_once:.3f}%; limit "
                      f"{100 * P_FLIP_LIMIT:g}%)")
                check(flips <= P_FLIP_LIMIT < flips_once,
                      f"{name}{shape}: {flips:.4f} of the outputs off the "
                      f"float32 version (rounded once: {flips_once:.4f}, "
                      f"limit {P_FLIP_LIMIT})")
            del once
        del wdq, wdk, wdv
        same = (torch.equal(dq, fa_ops.flash_dq_cuda(*args, causal=causal))
                and all(torch.equal(a, b) for a, b in zip(
                    (dk, dv), fa_ops.flash_dkv_cuda(*args, causal=causal))))
        print(f"  two launches of each backward kernel bit-equal: {same}")
        check(same, f"backward{shape}: two launches differ")
        if i > 0 and case not in FAMILY_BWD_SHAPES:
            del q, k, v, do, o, lse, delta, dq, dk, dv
            continue

        # times at the training shape and the families' shapes
        t = dict(
            lse=_event_ms(lambda: fa_ops.flash_attention_cuda(
                q, k, v, causal=causal, return_lse=True), 20),
            lse_plain=_event_ms(lambda: fa_ref.flash_attention_lse(
                q, k, v, causal=causal), 5),
            dq=_event_ms(lambda: fa_ops.flash_dq_cuda(*args, causal=causal),
                         10),
            dq_plain=_event_ms(lambda: fa_ref.flash_dq(*args, causal=causal),
                               5),
            dkv=_event_ms(lambda: fa_ops.flash_dkv_cuda(
                *args, causal=causal), 10),
            dkv_plain=_event_ms(lambda: fa_ref.flash_dkv(
                *args, causal=causal), 5))
        # the yardstick: SDPA's backward on the same q/k/v/do, KV heads
        # repeated and the layout made (B, H, S, D) beforehand; only the
        # backward is timed
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2) \
            .contiguous().requires_grad_()
        vt = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2) \
            .contiguous().requires_grad_()
        dot = do.transpose(1, 2).contiguous()
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        t["sdpa_fwd"] = _event_ms(lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), is_causal=causal), 20)
        t["sdpa_bwd"] = _event_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 10)
        del qt, kt, vt, dot, out
        # one product over the visible pairs
        pf = registry.work("flash_attention", q, k, v,
                           causal=causal).flops / 2
        calls = {"lse forward": ("flash_attention", (q, k, v),
                                 dict(causal=causal, return_lse=True)),
                 "flash_dq": ("flash_dq", args, dict(causal=causal)),
                 "flash_dkv": ("flash_dkv", args, dict(causal=causal))}
        b_lse, b_dq, b_dkv = (bound(op, *a, **kw)
                              for op, a, kw in calls.values())
        # (name, bound, kernel ms, plain ms, model products, products the
        # tensor cores run with p (and ds) split in two halves)
        for name, (bms, by), ms, plain, n_model, n_split in (
                ("lse forward", b_lse, t["lse"], t["lse_plain"], 2, 3),
                ("flash_dq", b_dq, t["dq"], t["dq_plain"], 3, 4),
                ("flash_dkv", b_dkv, t["dkv"], t["dkv_plain"], 4, 6)):
            op, a, kw = calls[name]
            print(f"  time {name:11s} {str(shape):44s} kernel={ms:.4f}ms "
                  f"plain={plain:.4f}ms sdpa_backward={t['sdpa_bwd']:.4f}ms "
                  f"bound={bms:.5f}ms ({by}, "
                  f"{tname} peak) float32-CUDA-core bound="
                  f"{bound(op, *a, f32=True, **kw)[0]:.5f}ms"
                  + (_tensor_core_line(n_model * pf, ms, bms,
                                       n_split * pf)
                     if tname == "bfloat16" else ""))
        print(f"  time sdpa {str(shape):44s} forward={t['sdpa_fwd']:.4f}ms "
              f"backward={t['sdpa_bwd']:.4f}ms (dq, dk and dv together); "
              f"flash_dq + flash_dkv {t['dq'] + t['dkv']:.4f}ms, "
              f"{(t['dq'] + t['dkv']) / t['sdpa_bwd']:.2f}x")
        if i > 0:
            del q, k, v, do, o, lse, delta, dq, dk, dv, args
            continue
        for name, (bms, by), ms, plain, err in (
                ("flash_dq", b_dq, t["dq"], t["dq_plain"], err_dq),
                ("flash_dkv", b_dkv, t["dkv"], t["dkv_plain"], err_dkv)):
            entries[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=("src/repro/kernels/flash_attention/backward.py:144"
                          if name == "flash_dq" else
                          "src/repro/kernels/flash_attention/backward.py:178"),
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=t["sdpa_bwd"],
                tensor_core_route=FLASH_ROUTE)
        lse_times = dict(ms=t["lse"], plain_ms=t["lse_plain"],
                         bound_ms=b_lse[0], library_ms=t["sdpa_fwd"],
                         max_abs_err=max(err_o, err_l),
                         tflops=2 * pf / t["lse"] / 1e9)
        del q, k, v, do, o, lse, delta, dq, dk, dv, args
    return entries, lse_times


#: phase 12's shapes (Bt, S, H, P, N, chunk, x dtype, decay, B/C dtype):
#: the train step's first; "model" is mamba2's A = -(1..16) with dt up to
#: ~2, where exp overflows above the diagonal. bf16 x, B and C (as mamba2
#: hands them) run the tensor-core bodies, a float32 B and C the CUDA-core
#: ones
SSD_SHAPES = (
    (8, 1024, 48, 64, 128, 64, "bfloat16", "test", "bfloat16"),  # train
    (2, 512, 48, 64, 128, 64, "bfloat16", "model", "bfloat16"),  # forward
    (2, 1000, 48, 64, 128, 64, "bfloat16", "test", "bfloat16"),  # ragged
    (2, 37, 48, 64, 128, 64, "bfloat16", "test", "bfloat16"),    # S < chunk
    (2, 512, 48, 64, 128, 32, "bfloat16", "test", "bfloat16"),   # chunk 32
    (2, 70, 8, 16, 16, 32, "bfloat16", "model", "bfloat16"),     # smoke32
    (2, 512, 80, 64, 64, 64, "bfloat16", "model", "bfloat16"),   # zamba2
    (8, 1024, 48, 64, 128, 64, "bfloat16", "test", "float32"),
    (2, 512, 48, 64, 128, 64, "bfloat16", "model", "float32"),
    (2, 1000, 48, 64, 128, 64, "bfloat16", "test", "float32"),
    (2, 37, 48, 64, 128, 64, "bfloat16", "test", "float32"),
    (2, 512, 48, 64, 128, 32, "bfloat16", "test", "float32"),
    (2, 512, 48, 64, 128, 64, "float32", "model", "float32"),
    (2, 512, 80, 64, 64, 64, "bfloat16", "model", "float32"))
#: the SSD bodies by operand type, and how the bf16 ones reach the tensor
#: cores and load their tiles
SSD_BODIES = {True: ("ssd_fwd_bf16_kernel", "ssd_bwd_bf16_kernel"),
              False: ("ssd_fwd_f32_kernel", "ssd_bwd_f32_kernel")}
SSD_ROUTE = "wgmma+tma"
def _ssd_inputs(dev, Bt, S, H, P, N, dtype, seed, decay, bc):
    """x as a strided view of a wider projection (as the model hands it),
    dt, A float32, B and C float32 or, with ``bc`` bf16, views of the same
    projection (mamba2's conv output), and dy, dh_final for the backward,
    from numpy. "test" draws as the JAX tests do (dt = softplus(normal) /
    2, A = -exp(normal / 2))."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    wide = t(rng.standard_normal((Bt, S, H * P + 2 * N)), dtype)
    x = wide[..., :H * P].reshape(Bt, S, H, P)
    dt = np.logaddexp(rng.standard_normal((Bt, S, H)), 0.0)
    if decay == "model":
        A = -np.linspace(1.0, 16.0, H)
    else:
        dt, A = dt * 0.5, -np.exp(rng.standard_normal(H) * 0.5)
    B, C = (t(rng.standard_normal((Bt, S, N))) for _ in range(2))
    if bc == torch.bfloat16:
        B, C = wide[..., H * P:H * P + N], wide[..., H * P + N:]
    dy = t(rng.standard_normal((Bt, S, H, P)), dtype)
    dh = t(rng.standard_normal((Bt, H, P, N)))
    return (x, t(dt), t(A), B, C), dy, dh


def ssd_kernel_phase(dev):
    """Phase 12: ssd and ssd_bwd against their plain versions by the body
    the operand types choose, bit-equal across launches, bf16 y within the
    flip share, timed beside their bounds. Returns their JSON entries at
    the training shape."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ops import ssd_work_counts
    from repro_torch.kernels.ssd import ref as ssd_ref

    entries = {}
    f32 = SSD_RTOL["float32"]
    print("SSD kernel phase: ssd, ssd_bwd")
    for i, (Bt, S, H, P, N, L, tname, decay, bcname) in enumerate(SSD_SHAPES):
        dtype, bc = getattr(torch, tname), getattr(torch, bcname)
        args, dy, dh = _ssd_inputs(dev, Bt, S, H, P, N, dtype, i, decay, bc)
        tc = dtype == bc == torch.bfloat16
        shape = (Bt, S, H, P, N, f"chunk {L}", tname, decay, f"B,C {bcname}")
        fwd, bwd = ssd_ops.ssd_cuda, ssd_ops.ssd_bwd_cuda
        n0 = (fwd.launches_bf16, fwd.launches_f32)
        y, h, st = fwd(*args, chunk=L, return_states=True)
        check((fwd.launches_bf16 - n0[0], fwd.launches_f32 - n0[1]) ==
              ((1, 0) if tc else (0, 1)), f"ssd{shape}: the wrong body ran")
        wy, wh, ws = ssd_ref.ssd_chunked(*args, chunk=L, return_states=True)
        errs = [_normwise("ssd: y", shape, y, wy, SSD_RTOL[tname]),
                _normwise("ssd: h_final", shape, h, wh, f32)]
        if S > L:
            errs.append(_normwise("ssd: states", shape, st, ws, f32))
        if dtype == torch.bfloat16:
            # the normwise limit cannot tell M' and h carried at float32
            # accuracy from M' and h rounded once to bf16; the share of
            # bf16 outputs that move can
            once = ssd_ref.ssd_chunked_rounded(*args, chunk=L)
            flips, flips_once = (float((a != wy).float().mean())
                                 for a in (y, once))
            print(f"  ssd: y outputs off the plain version's bf16: "
                  f"{100 * flips:.3f}% (M' and h rounded once: "
                  f"{100 * flips_once:.3f}%; limit {100 * P_FLIP_LIMIT}%)")
            check(flips <= P_FLIP_LIMIT < flips_once,
                  f"ssd{shape}: {flips:.4f} of y off the plain version "
                  f"(rounded once: {flips_once:.4f}, limit {P_FLIP_LIMIT})")
            del once
        del wy, wh, ws
        got = bwd(*args, dy, st, dh, chunk=L)
        want = ssd_ref.ssd_bwd(*args, dy, st, dh, chunk=L)
        berrs = [_normwise(f"ssd_bwd: {n}", shape, g, w,
                           SSD_DA_RTOL if n == "da" else f32)
                 for n, g, w in zip(("dxdt", "da", "dB", "dC"), got, want)]
        del want
        same = (all(torch.equal(a, b) for a, b in zip(
            (y, h, st), fwd(*args, chunk=L, return_states=True)))
            and all(torch.equal(a, b) for a, b in zip(
                got, bwd(*args, dy, st, dh, chunk=L))))
        print(f"  two launches of each SSD kernel bit-equal: {same}")
        check(same, f"ssd{shape}: two launches differ")
        if (Bt, S, H) == (2, 512, 80) and tc:
            # zamba2's heads, as its forward launches the scan
            ms = _event_ms(lambda: fwd(*args, chunk=L), 20)
            plain = _event_ms(lambda: ssd_ref.ssd_chunked(*args, chunk=L), 3)
            w = ssd_work_counts(Bt, S, H, P, N, L, y.element_size(),
                                args[3].element_size())
            bms, by = bound("ssd", *args, chunk=L)
            print(f"  time ssd (zamba2) {str(shape):46s} kernel={ms:.4f}ms "
                  f"plain={plain:.4f}ms bound={bms:.5f}ms ({by}; "
                  f"{w['fwd_bytes'] / 1e6:.1f} MB, "
                  f"{w['fwd_f32'] / 1e9:.3f} GFLOP) {100 * bms / ms:.1f}% "
                  f"of the bound")
        if (Bt, S) != (8, 1024):
            del args, dy, dh, y, h, st, got
            continue

        # times at the training shape: the forward as the model runs it,
        # with the states (the backward's sweep), and the reverse scan
        t = dict(
            fwd=_event_ms(lambda: fwd(*args, chunk=L), 10),
            states=_event_ms(lambda: fwd(*args, chunk=L,
                                         return_states=True), 10),
            bwd=_event_ms(lambda: bwd(*args, dy, st, dh, chunk=L), 5),
            fwd_plain=_event_ms(lambda: ssd_ref.ssd_chunked(
                *args, chunk=L), 3),
            bwd_plain=_event_ms(lambda: ssd_ref.ssd_bwd(
                *args, dy, st, dh, chunk=L), 2))
        w = ssd_work_counts(Bt, S, H, P, N, L, y.element_size(),
                            args[3].element_size())
        ws_ = ssd_work_counts(Bt, S, H, P, N, L, y.element_size(),
                              args[3].element_size(), states=True)
        calls = {"ssd": ("ssd", args, dict(chunk=L)),
                 "ssd+states": ("ssd", args, dict(chunk=L,
                                                  return_states=True)),
                 "ssd_bwd": ("ssd_bwd", (*args, dy, st, dh),
                             dict(chunk=L))}
        body = SSD_BODIES[tc]
        rows = []
        for name, nbytes, kind, ms, plain in (
                ("ssd", w["fwd_bytes"], "fwd", t["fwd"], t["fwd_plain"]),
                ("ssd+states", ws_["fwd_bytes"], "fwd", t["states"],
                 t["fwd_plain"]),
                ("ssd_bwd", w["bwd_bytes"], "bwd", t["bwd"], t["bwd_plain"])):
            # the bound counts the work the scan needs; the bf16 terms the
            # tensor-core bodies run for it are printed beside it only
            op, a, kw = calls[name]
            b32 = bound(op, *a, f32=True, **kw)
            bms, by = bound(op, *a, **kw)
            print(f"  time {name:10s} {str(shape):52s} kernel={ms:.4f}ms "
                  f"({body[kind == 'bwd']}) plain={plain:.4f}ms "
                  f"bound={bms:.5f}ms ({by}; {nbytes / 1e6:.1f} MB, "
                  f"{w[f'{kind}_f32'] / 1e9:.2f} GFLOP) [float32 CUDA-core "
                  f"bound {b32[0]:.5f}ms] {100 * bms / ms:.1f}% of the "
                  f"bound; the tensor-core bodies run "
                  f"{w[f'{kind}_tc'] / 1e9:.2f} GFLOP counting each bf16 "
                  f"term ({w[f'{kind}_tc'] / (ms * 1e9):.1f} TFLOP/s)")
            rows.append((name, bms, by, b32[0], ms, plain))
        if not tc:
            continue
        for name, bms, by, b32, ms, plain in (rows[0], rows[2]):
            err = max(errs) if name == "ssd" else max(berrs)
            entries[name] = dict(
                name=name, route="cuda", source="src/repro_torch/csrc/ssd.cu",
                replaces=("src/repro/kernels/ssd/kernel.py:120"
                          if name == "ssd" else
                          "src/repro/kernels/ssd/backward.py:123"),
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None,
                body=body[name == "ssd_bwd"], tensor_core_route=SSD_ROUTE,
                bound_f32_ms=b32)
        del args, dy, dh, y, h, st, got
    return entries


def _ssm_teacher_forcing(dev, cfg, params, toks):
    """decode_step one token at a time through the recurrent cache: returns
    (logits (B, S, V), seconds, launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import decode_step, init_cache

    Bm, S = toks.shape
    cache = init_cache(cfg, Bm, S, device=dev)
    out = torch.empty(Bm, S, cfg.vocab, dtype=torch.bfloat16, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(S):
        lg, cache = decode_step(params, cfg, cache, toks[:, t:t + 1])
        out[:, t] = lg[:, 0]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernels.launch_counts()


def mamba2_model_phase(dev, cfg, params):
    """Phase 13: the JAX package's teacher-forcing check at the smoke config
    (gated), then full width: the forward through ssd, every call held to
    its plain version, and the 512 positions through decode_step (the
    margin printed). Returns ssd's launches in the forward."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import smoke_config
    from repro_torch.models import forward, init_params

    small = smoke_config(cfg)
    sp = init_params(small, torch.Generator(device=dev).manual_seed(0),
                     dtype=torch.bfloat16, device=dev)
    stoks = torch.from_numpy(np.random.RandomState(1).randint(
        0, small.vocab, size=(2, 64)).astype(np.int32)).to(dev)
    kernels.reset_launch_counts()
    sref, _ = forward(sp, small, {"tokens": stoks})
    check(kernels.launch_counts()["ssd"] == small.n_layers,
          "smoke config: ssd launches")
    sdec, _, launches = _ssm_teacher_forcing(dev, small, sp, stoks)
    worst, excess = _allclose_margin(sdec, sref)
    print(f"mamba2 model phase: smoke config ({small.n_layers} layers, "
          f"d_model {small.d_model}), 64 positions: max |decode - forward| "
          f"= {worst:.4e}, allclose atol=rtol={LOGIT_TOL} worst margin "
          f"{excess:+.4e}")
    check(excess <= 0.0, f"smoke config: decode logits exceed atol=rtol="
          f"{LOGIT_TOL} of forward's (max |d| {worst:.4e})")
    check(launches["ssd"] == 0, "decode launched ssd")
    del sp, sref, sdec

    Bm, S = 2, 512
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(Bm, S)).astype(np.int32)).to(dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"mamba2 model phase: {cfg.name} forward (B={Bm}, S={S}) "
          f"{fwd_s:.3f}s (first call) logits {tuple(logits.shape)} "
          f"{logits.dtype} launches={launches}")
    check(tuple(logits.shape) == (Bm, S, cfg.vocab), "forward logits shape")
    check(bool(torch.isfinite(logits).all()), "forward logits not finite")
    check(launches["ssd"] == cfg.n_layers, f"forward launched ssd "
          f"{launches['ssd']} times, want {cfg.n_layers}")
    check(kernels.body_launch_counts()["ssd.launches_bf16"] == cfg.n_layers,
          "the forward's ssd launches did not all run the tensor-core body")
    ssd_launches = launches["ssd"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    print(f"  forward again: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    errs = {}
    with _held_to_plain(errs):
        forward(params, cfg, {"tokens": toks})
    _check_held(errs, {"y": cfg.n_layers, "h_final": cfg.n_layers},
                "forward, ssd")
    T = TF_POSITIONS
    dec, tf_s, launches = _ssm_teacher_forcing(dev, cfg, params, toks[:, :T])
    check(bool(torch.isfinite(dec).all()), "decode logits not finite")
    worst, excess = _allclose_margin(dec, logits[:, :T])
    w0, e0 = _allclose_margin(dec[:, 0], logits[:, 0])
    print(f"  decode_step x{T} (recurrent cache) {tf_s:.3f}s, launches="
          f"{launches}; decode vs forward over the first {T} positions: "
          f"max |d| "
          f"{worst:.4e}, allclose atol=rtol={LOGIT_TOL} margin {excess:+.4e} "
          f"({'met' if excess <= 0 else 'not met'}; printed, not gated); "
          f"position 0 {w0:.4e}, {e0:+.4e}")
    return ssd_launches


def _model_flops(cfg, n_params, B, S, chunk=64) -> float:
    """A training step's model FLOPs (no recompute): 6 per non-embedding
    parameter a token runs (MoE: its top_k experts of each layer), plus attention's visible (query, key) pairs, 2 D
    FLOP per product, 2 products forward and 4 backward; for the ssm family
    the SSD's instead: per token and head (L + 1) (N + P) for the
    intra-chunk products over their visible pairs (L (L + 1) / 2 a chunk,
    as ``kernels.ssd.ops.ssd_work_counts`` counts them) and 4 P N for the state's carry in and
    out, times 3 for forward and backward."""
    n = n_params - cfg.vocab * cfg.d_model
    if cfg.family == "moe":
        # a token runs top_k of the E experts of each MoE layer
        n_moe = cfg.n_layers - int(cfg.first_layer_dense)
        n -= n_moe * (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model \
            * cfg.moe_d_ff
    if cfg.family == "ssm":
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        H = cfg.ssm_expand * cfg.d_model // P
        per = (chunk + 1.0) * (N + P) + 4.0 * P * N
        return 6.0 * n * B * S + 3.0 * cfg.n_layers * B * S * H * per
    pairs = S * (S + 1) // 2
    return (6.0 * n * B * S
            + 12.0 * cfg.n_layers * B * cfg.n_heads * pairs * cfg.head_dim)


def _roof_terms(r) -> str:
    """A Roofline's counts and terms, for a line."""
    return (f"{r.flops:.4e} FLOP, {r.bytes_hbm:.4e} HBM bytes, "
            f"{r.bytes_collective:.4e} collective bytes; t_compute "
            f"{r.t_compute * 1e3:.3f} ms, t_memory {r.t_memory * 1e3:.3f} ms, "
            f"t_collective {r.t_collective * 1e3:.3f} ms; bottleneck "
            f"{r.bottleneck}")


def roofline_step_line(cfg, step, state, batch, ms, B, S):
    """Phase 11b: one more CA train step under ``roofline.analyze``: its
    FLOPs (registry ops by their work functions, the rest by
    ``torch.utils.flop_counter``), HBM and collective bytes, the three
    terms and the bottleneck, beside the timed steps' median ``ms``; and
    ``mfu``, JAX's model FLOPs (6 N D, N the active parameters) over that
    time at the bf16 peak."""
    import torch
    from repro_torch import roofline
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import active_params
    r = roofline.analyze(step, state, batch)
    check(r.registry_ops.get("flash_dq", 0) > 0 and r.flops > 0,
          f"analyze: the step's kernels were not counted: {r.registry_ops}")
    n = active_params(cfg, state.params)
    mf = roofline.model_flops(cfg, ShapeConfig("train", S, B, "train"), n,
                              "train")
    largest = max(r.t_compute, r.t_memory, r.t_collective)
    print(f"  analyzed step (phase 11b): {_roof_terms(r)}; registry ops "
          f"{r.registry_ops}; max_memory_allocated "
          f"{r.per_device_memory['max_memory_allocated'] / 2 ** 30:.2f} GiB; "
          f"measured {ms:.1f} ms a step, {100 * largest * 1e3 / ms:.1f}% of "
          f"it the largest term; model FLOPs {mf:.4e} (6 N D, N = {n} "
          f"active), mfu {roofline.mfu(mf, ms * 1e-3):.4f} "
          f"({torch.cuda.get_device_name(0)}, {nvidia_smi()})")


def train_phase(dev, cfg, *, ca_k=4, B=32, S=1024, steps=3, analyze=False):
    """Phases 11 and 14: the CA train step at full width
    (``make_train_step(ca_k)`` on ``TokenStream(B, S)``: a warm-up step,
    ``steps`` timed ones), its kernels held to their plain versions over
    one microbatch (attention for the dense family, the SSD scans for the
    ssm family), the JAX package's own training checks at the smoke config,
    and the CLI with a failure; with ``analyze``, phase 11b (one more step
    under ``roofline.analyze``: :func:`roofline_step_line`). Returns the
    kernel launches of the timed steps."""
    import re

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels, roofline
    from repro_torch.configs import smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import loss_fn, param_count
    from repro_torch.tree import leaves, tree_map

    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    step = make_train_step(cfg, ca_k=ca_k, peak_lr=3e-4, warmup=10,
                           total_steps=100, remat=True)
    stream = TokenStream(B, S, cfg.vocab, seed=0, device=dev)
    try:
        print(f"train phase: {cfg.name} make_train_step(ca_k={ca_k}, "
              f"remat=True), TokenStream({B}, {S}), float32 masters")
        t0 = time.perf_counter()
        state, m = step(state, next(stream))
        torch.cuda.synchronize()
        print(f"  warm-up step {time.perf_counter() - t0:.3f}s loss "
              f"{float(m['loss']):.4f} grad_norm {float(m['grad_norm']):.4f}")
        kernels.reset_launch_counts()
        walls, logs = [], []
        for _ in range(steps):
            batch = next(stream)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            logs.append({k: float(v) for k, v in m.items()})
        launches = kernels.launch_counts()
        bodies = kernels.body_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for i, (w, lg) in enumerate(zip(walls, logs)):
            print(f"  step {i + 1}: {w * 1e3:.1f} ms loss {lg['loss']:.5f} "
                  f"grad_norm {lg['grad_norm']:.5f} lr {lg['lr']:.3e}")
            check(math.isfinite(lg["loss"]) and math.isfinite(
                lg["grad_norm"]), f"train step {i + 1}: loss or grad norm "
                f"not finite: {lg}")
        want = cfg.n_layers * ca_k * steps
        if cfg.family == "ssm":
            print(f"  launches over {steps} steps: {launches} (want ssd = "
                  f"{3 * want}: forward, recompute and states sweep; "
                  f"ssd_bwd = {want})")
            check(launches["ssd"] == 3 * want and
                  launches["ssd_bwd"] == want,
                  f"SSD kernels launched {launches}, want {3 * want} and "
                  f"{want}")
            # the model hands bf16 x, B and C: every launch on the tensor
            # cores
            print(f"  by body: {bodies}")
            check(bodies["ssd.launches_bf16"] == 3 * want and
                  bodies["ssd_bwd.launches_bf16"] == want,
                  f"SSD launches off the tensor-core bodies: {bodies}")
            check(launches["flash_attention"] == 0, "attention launched")
        else:
            print(f"  launches over {steps} steps: {launches} (want "
                  f"flash_dq = flash_dkv = {want}, flash_attention = "
                  f"{2 * want})")
            check(launches["flash_dq"] == want and
                  launches["flash_dkv"] == want,
                  f"backward kernels launched {launches}, want {want} each")
            check(launches["flash_attention"] == 2 * want,
                  f"lse forward launched {launches['flash_attention']}, "
                  f"want {2 * want} (forward and recompute)")
        ms = sorted(walls)[1] * 1e3
        flops = _model_flops(cfg, param_count(state.params), B, S)
        print(f"  median {ms:.1f} ms/step, {B * S / ms * 1e3:.0f} tokens/s, "
              f"model FLOPs {flops:.4e} a step: "
              f"{100 * roofline.mfu(flops, ms * 1e-3):.2f}% of "
              f"{roofline.H100.peak_flops_bf16 / 1e12:g} TFLOP/s; peak "
              f"memory {peak / 2 ** 30:.2f} GiB "
              f"(max_memory_allocated)")
        if analyze:
            t_phase = time.perf_counter()
            roofline_step_line(cfg, step, state, next(stream), ms, B, S)
            print(f"phase 11b: {time.perf_counter() - t_phase:.1f}s")

        # every kernel call of one microbatch against its plain version
        mb = {k: v[:B // ca_k] for k, v in batch.items()}
        params = tree_map(lambda t: t.detach().to(torch.bfloat16)
                          .requires_grad_(), state.params)
        p_comp = leaves(params)
        errs, n = {}, cfg.n_layers
        with _held_to_plain(errs):
            loss = loss_fn(params, cfg, mb, remat=True)
            torch.autograd.grad(loss, p_comp)
        _check_held(errs, dict(
            y=3 * n, h_final=3 * n, states=n, dxdt=n, da=n, dB=n, dC=n)
            if cfg.family == "ssm" else
            dict(o=2 * n, lse=2 * n, dq=n, dk=n, dv=n), "one microbatch")
        del p_comp, params, errs, loss

        # where the time goes: one profiled step
        batch = next(stream)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(ev.key, _self_device_us(ev), ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e6
        print(f"  profile one step: wall {wall * 1e3:.1f} ms (profiled), "
              f"device kernels {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}% "
              f"busy), {sum(r[2] for r in rows)} kernel launches")
        for key, us, count in rows[:12]:
            print(f"    {us / 1e3:10.3f} ms  x{count:<5d} {key[:90]}")
        # the port's own kernels, each with its share of the step, and the
        # attention backward's pair together
        pair = 0.0
        for key, us, count in rows:
            name = re.search(r"(flash_\w+|ssd_\w+)", key)
            if name:
                print(f"  kernel {name.group(1)}: {us / 1e3:.3f} ms "
                      f"x{count}, {100 * us / 1e6 / wall:.1f}% of the "
                      f"profiled step")
                if name.group(1).startswith("flash_bwd"):
                    pair += us
        if cfg.family != "ssm":
            print(f"  flash_dq + flash_dkv: {pair / 1e3:.3f} ms, "
                  f"{100 * pair / 1e6 / wall:.1f}% of the profiled step")
    finally:
        stream.close()
    del state
    torch.cuda.empty_cache()

    # the JAX package's own training checks, on the card at its own size
    small = smoke_config(cfg)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, small.vocab, (8, 17),
                                         dtype=np.int32)).to(dev)
    sb = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    st = init_train_state(small, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    sstep = make_train_step(small, ca_k=2, peak_lr=1e-2, warmup=2,
                            total_steps=60, remat=False)
    losses = []
    for _ in range(30):
        st, m = sstep(st, sb)
        losses.append(float(m["loss"]))
    print(f"  smoke config: 30 steps on one batch, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (want below 0.7 of the first)")
    check(all(map(math.isfinite, losses)) and losses[-1] < 0.7 * losses[0],
          f"smoke config: loss did not fall: {losses[::6]}")
    sparams = init_train_state(small, torch.Generator(
        device=dev).manual_seed(0), device=dev).params
    sp = [t.requires_grad_() for t in leaves(sparams)]
    g_full = torch.autograd.grad(loss_fn(sparams, small, sb), sp)
    acc = [torch.zeros_like(t) for t in sp]
    for i in range(4):
        mb = {k: v[2 * i:2 * i + 2] for k, v in sb.items()}
        for a, g in zip(acc, torch.autograd.grad(
                loss_fn(sparams, small, mb), sp)):
            a.add_(g / 4)
    excess = max(float(((a - g).abs() - 5e-3 - 5e-2 * g.abs()).max())
                 for a, g in zip(acc, g_full))
    print(f"  smoke config: CA-accumulated grad vs full batch, worst margin "
          f"over atol 5e-3 rtol 5e-2: {excess:+.3e}")
    check(excess <= 0.0, "smoke config: accumulated grad != full batch")
    for classical in (False, True):
        st = init_train_state(small, torch.Generator(
            device=dev).manual_seed(0), device=dev)
        _, m = make_train_step(small, ca_k=2, remat=False,
                               sync_every_microbatch=classical)(st, sb)
        check(math.isfinite(float(m["loss"])),
              f"smoke config: classical={classical} loss not finite")
    print("  smoke config: CA k=2 and classical steps both run")

    # the CLI, with a failure (and obs on: obs phase (c)'s train CLI) and
    # without
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        prom, trace = f"{tmp}/train.prom", f"{tmp}/train.json"
        for label, extra in (("fail", ["--fail-at", "6", "--metrics", prom,
                                       "--trace-out", trace]),
                             ("clean", [])):
            t0 = time.perf_counter()
            runs[label] = train_cli.main(
                ["--arch", cfg.name, "--preset", "tiny", "--steps", "12",
                 "--ckpt-every", "4", "--ckpt-dir", f"{tmp}/{label}",
                 "--device", dev.type] + extra)
            print(f"  launch.train --preset tiny --steps 12 --ckpt-every 4 "
                  f"{' '.join(extra[:2])}: {time.perf_counter() - t0:.2f}s, "
                  f"restarts={runs[label].restarts}, final loss "
                  f"{runs[label].metrics_log[-1]['loss']!r}")
        check_train_obs(prom, trace, runs["fail"])
    check(runs["fail"].restarts == 1 and runs["clean"].restarts == 0,
          "launch.train: restarts")
    same = runs["fail"].metrics_log == runs["clean"].metrics_log
    print(f"  launch.train: metrics of the run with a failure (obs on) "
          f"bit-equal to the run without (obs off): {same}")
    check(same, "launch.train: the restarted run's metrics differ")
    return launches


#: phase 15's archs, one after another, at their published widths and depth
FAMILY_ARCHS = ("granite-moe-1b-a400m", "deepseek-moe-16b", "zamba2-2.7b",
                "qwen2-vl-2b", "whisper-medium")
#: phase 15's decode positions
FAMILY_DECODE = 32


def _family_inputs(dev, cfg, B, S, enc_len, seed=0):
    """A family's forward batch, numpy-seeded: tokens (B, S); qwen2-vl's
    patch embeddings (B, vision_patches, d) and whisper's frame embeddings
    (B, enc_len, d), normal, in bf16."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    batch = dict(tokens=torch.from_numpy(rng.randint(
        0, cfg.vocab, size=(B, S)).astype(np.int32)).to(dev))
    for key, n, fam in (("vision_embeds", cfg.vision_patches, "vlm"),
                        ("enc_embeds", enc_len, "audio")):
        if cfg.family == fam:
            batch[key] = torch.from_numpy(rng.standard_normal(
                (B, n, cfg.d_model)).astype(np.float32)).to(
                dev, torch.bfloat16)
    return batch


def _family_decode(dev, cfg, params, batch, steps):
    """``steps`` positions of ``batch["tokens"]`` through ``decode_step`` on
    a bf16 slot cache (whisper: after ``prefill_audio_cache`` over its
    frames): (logits (B, steps, V), seconds of the steps, launches of the
    steps)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import decode_step, init_cache, \
        prefill_audio_cache

    toks = batch["tokens"]
    B, S = toks.shape
    enc = batch.get("enc_embeds")
    cache = init_cache(cfg, B, S, device=dev,
                       enc_len=None if enc is None else enc.shape[1])
    if enc is not None:
        cache = prefill_audio_cache(params, cfg, cache, enc)
    out = torch.empty(B, steps, cfg.vocab, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(steps):
        lg, cache = decode_step(params, cfg, cache, toks[:, t:t + 1])
        out[:, t] = lg[:, 0]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernels.launch_counts()


def _family_attention_calls(cfg) -> int:
    """flash_attention calls of a forward: one a layer, zamba2's one a
    superblock, whisper's encoder layers plus two a decoder layer (self
    and cross)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_period
    if cfg.family == "audio":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def _family_smoke_gate(dev, cfg):
    """The JAX package's teacher-forcing check (tests/test_models.py) at
    the smoke config with the capacity factor raised to 8 (no token
    drops): 8 decode steps against the forward, atol = rtol = 0.05."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import forward, init_params

    small = smoke_config(cfg).scaled(capacity_factor=8.0)
    sp = init_params(small, torch.Generator(device=dev).manual_seed(0),
                     dtype=torch.bfloat16, device=dev)
    batch = _family_inputs(dev, small, 2, 8, 20, seed=5)
    ref, _ = forward(sp, small, batch)
    dec, _, _ = _family_decode(dev, small, sp, batch, 8)
    worst, excess = _allclose_margin(dec, ref)
    print(f"  smoke config (capacity factor 8), 8 positions: max |decode - "
          f"forward| = {worst:.4e}, allclose atol=rtol={LOGIT_TOL} worst "
          f"margin {excess:+.4e}")
    check(excess <= 0.0, f"{cfg.name} smoke config: decode logits exceed "
          f"atol=rtol={LOGIT_TOL} of forward's (max |d| {worst:.4e})")


def families_phase(dev):
    """Phase 15: granite-moe-1b-a400m, deepseek-moe-16b, zamba2-2.7b,
    qwen2-vl-2b and whisper-medium at their published widths and depths,
    one after another, bf16 weights from a seeded ``torch.Generator``:
    (a) the forward at (B=2, S=512) (qwen2-vl: 1,024 patch embeddings
    first; whisper: 1,500 frames into the encoder, 448 decoder tokens),
    its flash_attention and ssd launches counted, every call held to its
    plain version, finite logits, the wall time; (b) 32 positions of
    ``decode_step`` on a slot cache (whisper: after
    ``prefill_audio_cache``; its cross-attention runs flash_attention at
    Sq = 1, every call held), ms a step; (c) the teacher-forcing gap at
    full width, printed (qwen2-vl not compared, as JAX skips it), and the
    JAX package's check gated at the smoke config; (d) granite: the train
    phase at the full preset. Returns the launches of every kernel on
    these paths (forwards, decodes, granite's timed train steps)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models import forward, init_params, param_count

    total = {}
    for name in FAMILY_ARCHS:
        t_arch = time.perf_counter()
        cfg = get_arch(name)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
        S = cfg.dec_len if cfg.family == "audio" else 512
        batch = _family_inputs(dev, cfg, 2, S, 1500)
        print(f"families phase: {name} ({cfg.family}), "
              f"{param_count(params)} parameters (bf16; routers, A_log and "
              f"dt_bias float32), {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
              f"head_dim {cfg.head_dim}; inputs "
              f"{ {k: tuple(v.shape) for k, v in batch.items()} }")

        # (a) the forward
        n_attn = _family_attention_calls(cfg)
        n_ssd = cfg.n_layers if cfg.family == "hybrid" else 0
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, aux = forward(params, cfg, batch)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        for op, n in launches.items():
            total[op] = total.get(op, 0) + n
        t0 = time.perf_counter()
        forward(params, cfg, batch)
        torch.cuda.synchronize()
        again = time.perf_counter() - t0
        print(f"  (a) forward: {fwd_s:.3f}s first call, {again * 1e3:.2f} "
              f"ms again; logits {tuple(logits.shape)}, aux "
              f"{float(aux):.5f}; launches flash_attention="
              f"{launches['flash_attention']} ssd={launches['ssd']}")
        check(launches["flash_attention"] == n_attn and
              launches["ssd"] == n_ssd,
              f"{name} forward launched {launches}, want flash_attention "
              f"{n_attn}, ssd {n_ssd}")
        check(sum(launches.values()) == n_attn + n_ssd,
              f"{name} forward launched another kernel: {launches}")
        check(bool(torch.isfinite(logits).all()),
              f"{name}: forward logits not finite")
        errs = {}
        with _held_to_plain(errs):
            held, _ = forward(params, cfg, batch)
        want = {"o": n_attn}
        if n_ssd:
            want.update(y=n_ssd, h_final=n_ssd)
        _check_held(errs, want, f"{name} forward")
        del held

        # (b) decode
        steps = FAMILY_DECODE
        dec, dec_s, launches = _family_decode(dev, cfg, params, batch, steps)
        n_cross = steps * cfg.n_layers if cfg.family == "audio" else 0
        for op, n in launches.items():
            total[op] = total.get(op, 0) + n
        print(f"  (b) decode_step x{steps} (slot cache, bf16): "
              f"{dec_s / steps * 1e3:.2f} ms a step; launches "
              f"flash_attention={launches['flash_attention']} (want "
              f"{n_cross}: whisper's cross-attention at Sq = 1)")
        check(launches["flash_attention"] == n_cross and
              sum(launches.values()) == n_cross,
              f"{name} decode launched {launches}, want flash_attention "
              f"{n_cross} and nothing else")
        check(bool(torch.isfinite(dec).all()),
              f"{name}: decode logits not finite")
        if n_cross:
            errs = {}
            with _held_to_plain(errs):
                _family_decode(dev, cfg, params, batch, steps)
            # the prefill's encoder, then the steps' cross-attention
            _check_held(errs, {"o": cfg.n_enc_layers + n_cross},
                        f"{name} prefill and decode")

        # (c) the teacher-forcing gap
        if cfg.family == "vlm":
            print("  (c) full width: decode against the forward not compared"
                  " (its positions do not continue the vision prefix's; "
                  "JAX skips it too)")
        else:
            worst, excess = _allclose_margin(dec, logits[:, :steps])
            print(f"  (c) full width, {steps} positions: max |decode - "
                  f"forward| = {worst:.4e}, allclose atol=rtol={LOGIT_TOL} "
                  f"worst margin {excess:+.4e} (printed, not gated: the "
                  f"bf16 floor of a deep stack)")
            _family_smoke_gate(dev, cfg)
        del logits, dec, params, batch
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t_arch:.1f}s")

        # (d) granite's training at the full preset
        if name == "granite-moe-1b-a400m":
            t0 = time.perf_counter()
            launches = train_phase(dev, cfg)
            for op, n in launches.items():
                total[op] = total.get(op, 0) + n
            print(f"  {name} train phase: {time.perf_counter() - t0:.1f}s")
            torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------ phase 16 ---
#: phase 16's CA step: phase 11's configuration
DP_CA_K, DP_BATCH, DP_SEQ = 4, 32, 1024
DP_KW = dict(ca_k=DP_CA_K, peak_lr=3e-4, warmup=10, total_steps=100,
             remat=True)
#: (b): k local steps a round on 8 x 1,024 microbatches, three rounds
SYNC_K, SYNC_ROWS, SYNC_ROUNDS, SYNC_LR = 4, 8, 3, 1e-3
#: (b): stale-k's finalize against the synchronous params
#: (tests/test_stale_k.py's LM tolerance)
STALE_ATOL, STALE_RTOL = 2e-4, 1e-3
#: (c): the archs trained at their published widths and depths
EMBED_ARCHS = ("whisper-medium", "qwen2-vl-2b")
#: (f): the prox VJP against autograd through the plain block, normwise
PROX_VJP_RTOL = 1e-5


def _add(total: dict, launches: dict) -> None:
    for op, n in launches.items():
        total[op] = total.get(op, 0) + n


def _timed_steps(step, state, batches):
    """Run ``step`` over ``batches``, each timed with a synchronize on
    either side: (state, walls, metrics read after each step)."""
    import torch
    walls, logs = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        logs.append({k: float(v) for k, v in m.items()})
    return state, walls, logs


def dp_step_phase(dev, cfg, total):
    """Phase 16(a): the single-device step (``make_train_step(cfg)``) at
    phase 11's configuration: two CA steps (ms, peak memory, metrics, every
    master and moment copied to the host after them), then one classical
    step (``sync_every_microbatch``) from there on a third batch, its
    metrics and state copied to the host too. Returns (the batches, the CA
    metrics and host copies in ``leaves`` order of the state, the classical
    ones, internlm2's embedding grad of one microbatch after the CA steps
    (phase 16(e)'s leaf))."""
    import torch
    from repro_torch import kernels
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import loss_fn
    from repro_torch.tree import leaves, tree_map

    stream = TokenStream(DP_BATCH, DP_SEQ, cfg.vocab, seed=0, device=dev)
    try:
        batches = [next(stream) for _ in range(3)]
    finally:
        stream.close()
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    step = make_train_step(cfg, None, **DP_KW)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, walls, logs = _timed_steps(step, state, batches[:2])
    launches = kernels.launch_counts()
    _add(total, launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"  (a) {[round(w * 1e3, 1) for w in walls]} ms a step, peak "
          f"{peak / 2 ** 30:.2f} GiB; launches "
          f"{ {op: n for op, n in launches.items() if n} }; loss "
          f"{[lg['loss'] for lg in logs]}")
    for lg in logs:
        check(math.isfinite(lg["loss"]) and math.isfinite(lg["grad_norm"]),
              f"(a) loss not finite {lg}")
    host = [t.detach().cpu() for t in leaves(list(state))]
    # phase 16(e)'s leaf: the embedding grad of one microbatch
    p = tree_map(lambda t: t.detach().to(torch.bfloat16), state.params)
    p["embed"].requires_grad_()
    mb = {k: v[:DP_BATCH // DP_CA_K] for k, v in batches[0].items()}
    g_embed = torch.autograd.grad(loss_fn(p, cfg, mb, remat=True),
                                  p["embed"])[0].float()
    del p
    # the classical schedule, one step on the third batch
    classical = make_train_step(cfg, None, sync_every_microbatch=True,
                                **DP_KW)
    kernels.reset_launch_counts()
    state, cwalls, clogs = _timed_steps(classical, state, batches[2:])
    _add(total, kernels.launch_counts())
    print(f"  (a) sync_every_microbatch: {cwalls[0] * 1e3:.1f} ms, loss "
          f"{clogs[0]['loss']:.5f}")
    check(math.isfinite(clogs[0]["loss"]) and math.isfinite(
        clogs[0]["grad_norm"]), f"(a) classical loss not finite {clogs}")
    chost = [t.detach().cpu() for t in leaves(list(state))]
    del state, step, classical
    torch.cuda.empty_cache()
    return batches, (logs, host), (clogs, chost), g_embed


def sharded_step_phase(dev, cfg, total, batches, ca, classical):
    """Phase 18: ``make_train_step(cfg, rules)`` on a (data=1, model=1)
    mesh in an NCCL group of one, from the weights 16(a) started from
    (``init_train_state`` with the rules shards what one device draws):
    16(a)'s two CA steps, then its classical step on the third batch.
    After each, every master, moment and metric bitwise 16(a)'s (``ca``
    and ``classical``: its metrics and host copies); the layout, the
    collectives and the flash kernels' launches; ms and peak memory. Then
    the host and card time of one all-reduce of a step's words."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core.distributed import CollectiveCount
    from repro_torch.dist import Mesh, make_rules
    from repro_torch.launch import mesh
    from repro_torch.launch.steps import (init_train_state, layout,
                                          make_train_step)
    from repro_torch.tree import leaves

    def run(label, state, batches, logs, host, **kw):
        count = CollectiveCount()
        step = make_train_step(cfg, rules, counter=count, **DP_KW, **kw)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state, walls, got = _timed_steps(step, state, batches)
        launches = kernels.launch_counts()
        _add(total, launches)
        peak = torch.cuda.max_memory_allocated()
        print(f"  {label}: {[round(w * 1e3, 1) for w in walls]} ms a step, "
              f"peak {peak / 2 ** 30:.2f} GiB; collectives in "
              f"{len(batches)} step(s): {vars(count)}; launches "
              f"{ {op: n for op, n in launches.items() if n} }")
        # every leaf whole: no gather, no reduce-scatter; an all-reduce of
        # every gradient and the loss and one of the squared norm, a step
        # (CA) or a microbatch (classical)
        calls = len(batches) * (DP_CA_K if kw.get("sync_every_microbatch")
                                else 1)
        want = dict(all_reduces=2 * calls, words=calls * (n + 2),
                    all_gathers=0, reduce_scatters=0)
        check(vars(count) == want,
              f"{label}: collectives {vars(count)}, want {want}")
        per = len(batches) * DP_CA_K * cfg.n_layers
        check(launches["flash_dq"] == per and launches["flash_dkv"] == per
              and launches["flash_attention"] == 2 * per,
              f"{label}: flash launches {launches}, want {per} (lse "
              f"forward {2 * per})")
        check(got == logs, f"{label}: metrics {got} are not 16(a)'s {logs}")
        mine = []
        for tree in (state.params, state.opt.step, state.opt.m,
                     state.opt.v):
            mine += ([tree] if isinstance(tree, torch.Tensor)
                     else leaves(lay.unstack(leaves(tree))))
        same = len(mine) == len(host) and all(
            torch.equal(t, h.to(dev)) for t, h in zip(mine, host))
        print(f"  {label}: every master, moment and metric bitwise 16(a)'s "
              f"single-device step: {same} ({len(host)} tensors)")
        check(same, f"{label}: the sharded step at (1, 1) is not 16(a)'s")
        return state

    mesh.init("cuda", rank=0, world_size=1)
    try:
        rules = make_rules(Mesh(("data", "model"), (1, 1)), dist.group.WORLD)
        lay = layout(cfg, rules)
        whole = all(lf.local == lf.shape for lf in lay.leaves)
        print(f"  {len(lay.leaves)} stacked leaves, every leaf whole: "
              f"{whole}")
        check(whole and not lay.sharded, "layout at (1, 1) splits a leaf")
        n = lay.n_replicated
        state = init_train_state(cfg, torch.Generator(
            device=dev).manual_seed(0), device=dev, rules=rules)
        state = run("CA", state, batches[:2], *ca)
        state = run("sync_every_microbatch", state, batches[2:], *classical,
                    sync_every_microbatch=True)
        del state
        torch.cuda.empty_cache()
        # the collective's own cost on the host and the card
        buf = torch.zeros(n + 1, device=dev)
        host_us = _host_us(lambda: dist.all_reduce(buf), iters=20)
        dev_ms = time_ms(lambda: dist.all_reduce(buf), 5)
        print(f"  all_reduce of every gradient and the loss ({n + 1} words) "
              f"at world 1: "
              f"{host_us:.1f} us of host a call, {dev_ms:.4f} ms on the "
              f"card (multi-rank time: tools/dp_step_time.py)")
        del buf
    finally:
        mesh.shutdown()


def ca_sync_phase(dev, cfg, total):
    """Phase 16(b): ``ca_local_sgd_solver`` and ``ca_stale_k_solver`` at
    internlm2's published widths (float32 params) in the group of one: k
    local steps a round on 8 x 1,024 microbatches, three rounds each; one
    all-reduce a round each, every stale-k collective waited in a later
    round (the solver's log), finalize within the LM tolerance of the
    synchronous params, losses finite, ms a round and peak memory."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core.distributed import CollectiveCount
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim.ca_sync import (ca_local_sgd_solver,
                                           ca_stale_k_solver)
    from repro_torch.tree import leaves

    gen = torch.Generator(device=dev).manual_seed(1)
    rounds = []
    for _ in range(SYNC_ROUNDS):
        toks = torch.randint(0, cfg.vocab, (SYNC_K, SYNC_ROWS, DP_SEQ + 1),
                             generator=gen, device=dev, dtype=torch.int32)
        rounds.append(dict(tokens=toks[..., :-1], labels=toks[..., 1:]))

    def lm_loss(p, b):
        return loss_fn(p, cfg, b, remat=True)

    group = dist.group.WORLD
    out = {}
    for name in ("sync", "stale"):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.float32, device=dev)
        count = CollectiveCount()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        walls, losses = [], []
        if name == "sync":
            step = ca_local_sgd_solver(lm_loss, group, k=SYNC_K, lr=SYNC_LR,
                                       counter=count)
            for b in rounds:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, loss = step(params, b)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(loss)
            final = params
        else:
            solver = ca_stale_k_solver(lm_loss, group, k=SYNC_K, lr=SYNC_LR,
                                       counter=count)
            carry = solver.init(params)
            del params
            for b in rounds:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                carry, loss = solver.step(carry, b)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(loss)
            final = solver.finalize(carry)
            del carry
            print(f"  (b) stale-k waits (round launched, round waited): "
                  f"{solver.waits}")
            check(solver.waits == [(t, t + 1) for t in range(SYNC_ROUNDS)],
                  f"(b) a stale-k collective was waited inside its own "
                  f"round: {solver.waits}")
        _add(total, kernels.launch_counts())
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in losses]
        print(f"  (b) {name}: {count.all_reduces} all-reduces "
              f"({count.words} words) in {SYNC_ROUNDS} rounds; losses "
              f"{[round(x, 5) for x in losses]}; "
              f"{[round(w * 1e3, 1) for w in walls]} ms a round; peak "
              f"{peak / 2 ** 30:.2f} GiB")
        check(count.all_reduces == SYNC_ROUNDS, f"(b) {name}: "
              f"{count.all_reduces} all-reduces in {SYNC_ROUNDS} rounds")
        check(all(map(math.isfinite, losses)), f"(b) {name}: losses "
              f"{losses}")
        out[name] = [t.detach().cpu() for t in leaves(final)]
        del final
        torch.cuda.empty_cache()
    worst = max(float(((a - b).abs() - STALE_ATOL - STALE_RTOL * b.abs()
                       ).max()) for a, b in zip(out["stale"], out["sync"]))
    diff = max(float((a - b).abs().max())
               for a, b in zip(out["stale"], out["sync"]))
    print(f"  (b) stale-k finalize against the synchronous params: max "
          f"|diff| {diff:.3e}, worst margin over atol {STALE_ATOL} rtol "
          f"{STALE_RTOL}: {worst:+.3e}")
    check(worst <= 0.0, "(b) stale-k finalize off the synchronous params")


def _embed_batch(dev, cfg, B, seed=0):
    """A training batch of a family with embeddings, numpy-seeded: whisper
    1,500 frame embeddings and 448 tokens, qwen2-vl 1,024 patch embeddings
    before 512 tokens; labels the next tokens."""
    import numpy as np
    import torch
    S = cfg.dec_len if cfg.family == "audio" else 512
    batch = _family_inputs(dev, cfg, B, S + 1, 1500, seed=seed)
    toks = batch.pop("tokens")
    batch.update(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    return batch


def embed_train_phase(dev, total):
    """Phase 16(c): whisper-medium and qwen2-vl-2b through the CA train
    step at their published widths and depths (float32 masters, ca_k = 4,
    remat, batch 8 x ca_k, halved on an out-of-memory): a warm-up step and
    three timed ones, finite loss and grad norm, flash_attention (lse),
    flash_dq and flash_dkv launches a step, every call of one microbatch
    held to its plain version, ms/step, tokens/s, peak memory. Returns
    (launches a step by arch)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import loss_fn
    from repro_torch.tree import leaves, tree_map

    per_step = {}
    for name in EMBED_ARCHS:
        cfg = get_arch(name)
        B = 8 * DP_CA_K
        while True:
            oom = False
            try:
                torch.cuda.reset_peak_memory_stats()
                state = init_train_state(cfg, torch.Generator(
                    device=dev).manual_seed(0), device=dev)
                step = make_train_step(cfg, ca_k=DP_CA_K, peak_lr=3e-4,
                                       warmup=10, total_steps=100,
                                       remat=True)
                batches = [_embed_batch(dev, cfg, B, seed=i)
                           for i in range(4)]
                state, _, _ = _timed_steps(step, state, batches[:1])
            except torch.cuda.OutOfMemoryError:
                oom = True
            if not oom:
                break
            state = step = batches = None
            torch.cuda.empty_cache()
            check(B > DP_CA_K, f"(c) {name}: out of memory at batch {B}")
            print(f"  (c) {name}: batch {B} does not fit in 80 GB; halved "
                  f"to {B // 2}")
            B //= 2
        kernels.reset_launch_counts()
        state, walls, logs = _timed_steps(step, state, batches[1:])
        launches = kernels.launch_counts()
        _add(total, launches)
        peak = torch.cuda.max_memory_allocated()
        n_attn = _family_attention_calls(cfg)
        want = n_attn * DP_CA_K
        toks = batches[1]["tokens"].numel()
        ms = sorted(walls)[1] * 1e3
        per_step[name] = {op: launches[op] // 3 for op in
                          ("flash_attention", "flash_dq", "flash_dkv")}
        print(f"  (c) {name}: batch {B} ({ {k: tuple(v.shape) for k, v in batches[1].items()} }), "
              f"{[round(w * 1e3, 1) for w in walls]} ms a step, median "
              f"{ms:.1f} ms, {toks / ms * 1e3:.0f} tokens/s, peak "
              f"{peak / 2 ** 30:.2f} GiB; launches a step {per_step[name]} "
              f"(want flash_dq = flash_dkv = {want}, lse forward {2 * want})")
        for lg in logs:
            check(math.isfinite(lg["loss"]) and math.isfinite(
                lg["grad_norm"]), f"(c) {name}: loss not finite {lg}")
        print(f"  (c) {name}: loss {[round(lg['loss'], 5) for lg in logs]}"
              f" grad_norm {[round(lg['grad_norm'], 5) for lg in logs]}")
        check(per_step[name] == dict(flash_attention=2 * want,
                                     flash_dq=want, flash_dkv=want),
              f"(c) {name}: launches {per_step[name]}")
        # every attention call of one microbatch against its plain version
        mb = {k: v[:B // DP_CA_K] for k, v in batches[1].items()}
        params = tree_map(lambda t: t.detach().to(torch.bfloat16)
                          .requires_grad_(), state.params)
        errs = {}
        with _held_to_plain(errs):
            loss = loss_fn(params, cfg, mb, remat=True)
            torch.autograd.grad(loss, leaves(params))
        _check_held(errs, dict(o=2 * n_attn, lse=2 * n_attn, dq=n_attn,
                               dk=n_attn, dv=n_attn), f"(c) {name}")
        del params, errs, loss, state, step, batches, mb
        torch.cuda.empty_cache()
    return per_step


def compression_phase(dev, g):
    """Phase 16(e): top-k (frac 0.01) and int8 compression of a full-width
    gradient leaf: the kept values and the residual rebuild g exactly, g -
    deq - residual is exactly 0; both timed."""
    import torch
    from repro_torch.optim import compression as comp
    c, resid = comp.topk_compress(g, 0.01)
    rebuilt = comp.topk_decompress(c, g.shape) + resid
    exact = torch.equal(rebuilt, g)
    q, qres = comp.int8_compress(g)
    zero = bool(((g - comp.int8_decompress(q, g.shape)) - qres == 0).all())
    t_top = time_ms(lambda: comp.topk_compress(g, 0.01), 3)
    t_int8 = time_ms(lambda: comp.int8_compress(g), 10)
    print(f"  (e) {tuple(g.shape)} float32 ({g.numel()} values): top-k "
          f"keeps {c.values.numel()}, decompress + residual == g: {exact}; "
          f"{t_top:.3f} ms; int8 g - deq - residual == 0: {zero}, "
          f"{t_int8:.3f} ms (scale {float(q.scale):.4e})")
    check(exact and zero, "(e) compression does not rebuild g exactly")


def prox_vjp_phase(dev, total):
    """Phase 16(f): the prox block ops' recompute backward at the covtype
    (k=32, d=54, FISTA) and susy (k=32, d=18, Q=5, PNM) block shapes: the
    forward one block-kernel launch, the grads within 1e-5 normwise of
    autograd through the plain block version on the same inputs."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.prox_step import ref as prox_ref
    gen = torch.Generator(device=dev).manual_seed(7)
    scal = torch.tensor(SCAL, device=dev)
    for d, op in ((54, "prox_step_block"), (18, "prox_loop_block")):
        A = torch.randn(K, d, d, generator=gen, device=dev)
        G = (A @ A.transpose(1, 2) / d).contiguous()
        R, w_prev, w = (torch.randn(*s, generator=gen, device=dev)
                        for s in ((K, d), (d,), (d,)))
        cot = torch.randn(K, d, generator=gen, device=dev)
        if op == "prox_step_block":
            inputs, kw = (G, R, w_prev, w, scal), dict(j0=3)
        else:
            inputs, kw = (G, R, w, scal), dict(Q=Q)
        grads = []
        for fn in (getattr(prox_ops, op), getattr(prox_ref, op)):
            xs = [t.clone().requires_grad_() for t in inputs]
            kernels.reset_launch_counts()
            W = fn(*xs, **kw)
            grads.append(torch.autograd.grad(W, xs, cot))
            if fn is getattr(prox_ops, op):
                n = kernels.launch_counts()
                _add(total, n)
                check(n[op] == 1, f"(f) {op}: {n[op]} launches, want 1")
        errs = []
        for g, want in zip(*grads):
            m = float(want.abs().max())
            errs.append(float((g - want).abs().max()) / m if m else
                        float(g.abs().max()))
        print(f"  (f) {op} (k={K}, d={d}): grads of "
              f"{len(errs)} inputs against autograd through the plain "
              f"block, normwise max {max(errs):.3e} (limit {PROX_VJP_RTOL})")
        check(max(errs) <= PROX_VJP_RTOL, f"(f) {op}: VJP off by "
              f"{max(errs):.3e}")


def training_dist_phase(dev):
    """Phase 16: the rest of training, (a)-(f), one arch at a time, each
    freed before the next, then phase 18 on 16(a)'s batches and host
    copies. Returns the kernel launches of their paths."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import grad_smoke, mesh

    total = {}
    cfg = get_arch(ARCH)
    mesh.init("cuda", rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        print(f"phase 16(a): the single-device CA and classical steps, "
              f"{cfg.name}, ca_k="
              f"{DP_CA_K}, batch {DP_BATCH} x {DP_SEQ}")
        batches, ca, classical, g_embed = dp_step_phase(dev, cfg, total)
        print(f"  (a): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        print(f"phase 16(b): CA local-SGD and stale-k at {cfg.name}'s "
              f"widths, k={SYNC_K} on {SYNC_ROWS} x {DP_SEQ}, "
              f"{SYNC_ROUNDS} rounds")
        ca_sync_phase(dev, cfg, total)
        print(f"  (b): {time.perf_counter() - t0:.1f}s")
    finally:
        mesh.shutdown()
    t0 = time.perf_counter()
    print("phase 16(e): compression of the embedding grad")
    compression_phase(dev, g_embed)
    del g_embed
    torch.cuda.empty_cache()
    print(f"  (e): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    print("phase 16(c): whisper-medium and qwen2-vl-2b trained at published "
          "widths")
    per_step = embed_train_phase(dev, total)
    print(f"  (c): {time.perf_counter() - t0:.1f}s; launches a step "
          f"{per_step}")
    t0 = time.perf_counter()
    print("phase 16(d): grad_smoke on the card")
    kernels.reset_launch_counts()
    check(grad_smoke.main(["--device", "cuda"]) == 0,
          "(d) grad_smoke failed")
    smoke = kernels.launch_counts()
    _add(total, smoke)
    for op in grad_smoke.GRAD_OPS:
        check(smoke[op] > 0, f"(d) grad_smoke launched no {op}")
    print(f"  (d): {time.perf_counter() - t0:.1f}s; launches "
          f"{ {op: n for op, n in smoke.items() if n} }")
    t0 = time.perf_counter()
    print("phase 16(f): the prox recompute VJP")
    prox_vjp_phase(dev, total)
    print(f"  (f): {time.perf_counter() - t0:.1f}s")
    for op in ("flash_attention", "flash_dq", "flash_dkv", "ssd", "ssd_bwd",
               "prox_step_block", "prox_loop_block"):
        check(total.get(op, 0) > 0, f"{op} was not launched in phase 16")
    t0 = time.perf_counter()
    print(f"phase 18: the sharded CA and classical steps on a (data=1, "
          f"model=1) mesh, {cfg.name}, an NCCL group of one, 16(a)'s "
          f"batches")
    sharded_step_phase(dev, cfg, total, batches, ca, classical)
    del ca, classical
    print(f"phase 18: {time.perf_counter() - t0:.1f}s")
    return total


# ------------------------------------------------------------ phase 17 ---
#: phase 17's families (e), one at a time, each freed before the next
SERVE_FAMILIES = ("granite-moe-1b-a400m", "deepseek-moe-16b", "zamba2-2.7b",
                  "qwen2-vl-2b", "whisper-medium", "mamba2-780m")
#: phase 17(a)'s policy: request i seeds 1000 + i
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=50)


def _engine(dev, cfg, params, k, **kw):
    from repro_torch.serve import Engine
    kw = dict(dict(num_slots=8, max_len=1024, max_prompt=512, page_size=16,
                   eos_id=None, device=dev, sync_debug=True), **kw)
    return Engine(params, cfg, k=k, **kw)


def _sampled(reqs, base=1000):
    import dataclasses
    from repro_torch.serve import SamplingParams
    return [dataclasses.replace(r, sampling=SamplingParams(
        seed=base + i, **SAMPLED)) for i, r in enumerate(reqs)]


def _drain_timed(eng, reqs):
    """Submit ``reqs`` in order and drain: (responses, wall seconds after
    the first round, syncs after it)."""
    import torch
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    out = eng.step()                      # first round: allocator warm-up
    syncs0 = eng.stats.syncs
    t0 = time.perf_counter()
    out += eng.run()
    wall = time.perf_counter() - t0
    return out, wall, eng.stats.syncs - syncs0


def _profiled_block(dev, cfg, params, reqs):
    """One profiled k=8 block of phase 9's engine over ``reqs`` in steady
    state (after 3 rounds): (wall seconds, device kernels by name as
    (name, device us, launches), sorted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = _engine(dev, cfg, params, 8)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.key, _self_device_us(ev), ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    return wall, rows


def _sampler_profile(dev, cfg, params, reqs):
    """The sampled block against the greedy one at the same point of the
    same requests, both profiled: the sampler's device time a block is
    their difference in kernel time (its kernels' names are the
    elementwise ones the model launches too); and one ``sample_tokens``
    call at the block's shape by CUDA events, two calls at a time behind
    a sleep, so their ~800 launches fit the launch queue and the events
    bracket device time only; and its host time a call."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.serve import SlotSampling, sample_tokens

    wall, rows = _profiled_block(dev, cfg, params, reqs)
    _, grows = _profiled_block(dev, cfg, params, [
        dataclasses.replace(r, sampling=None) for r in reqs])
    busy = sum(r[1] for r in rows) / 1e3
    gbusy = sum(r[1] for r in grows) / 1e3
    n_launch = sum(r[2] for r in rows) - sum(r[2] for r in grows)
    B = 8
    logits = torch.randn(B, cfg.vocab, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev).to(torch.bfloat16)
    greedy = logits.argmax(-1).to(torch.int32)
    keys = np.stack([[0, 1000 + i] for i in range(B)]).astype(np.int64)
    samp = SlotSampling(
        temperature=torch.full((B,), SAMPLED["temperature"], device=dev),
        top_p=torch.full((B,), SAMPLED["top_p"], device=dev),
        top_k=torch.full((B,), SAMPLED["top_k"], dtype=torch.int32,
                         device=dev),
        key=torch.from_numpy(keys).to(dev))
    n_out = torch.arange(B, dtype=torch.int32, device=dev)

    def call():
        return sample_tokens(logits, greedy, samp, n_out)

    for _ in range(3):
        call()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)        # ~20 ms: longer than 2 calls'
        a.record()                           # enqueue
        call()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 2)
    one = float(np.median(times))
    host = _host_us(call, 20) / 1e3
    samp_ms = busy - gbusy
    print(f"  17(a) profile one sampled k=8 block: wall {wall * 1e3:.3f} ms "
          f"(profiled), device kernels {busy:.3f} ms "
          f"({100 * busy / 1e3 / wall:.1f}% busy); the greedy block at the "
          f"same point {gbusy:.3f} ms: the sampler {samp_ms:.3f} ms of "
          f"device time a block ({100 * samp_ms / busy:.1f}% of the sampled "
          f"block's), {n_launch} launches; one call at ({B}, {cfg.vocab}) "
          f"{one:.4f} ms of device time (CUDA events, median of 10 pairs "
          f"behind a sleep), {host:.3f} ms of host to enqueue it")
    for key, us, count in rows[:8]:
        print(f"    {us / 1e3:10.3f} ms  x{count:<5d} {key[:90]}")
    return samp_ms, busy


def serving_phase(dev):
    """Phase 17, the rest of serving: (a) sampled serving, (b) the prefix
    cache, (c) fan-out and (d) the double-buffered loop on internlm2-1.8b
    at phase 9's engine; (e) every other family through the engine.
    Returns the kernels' launches in the engines' drains."""
    import numpy as np
    import torch
    from repro_torch import kernels, obs
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve import Request, SamplingParams, fold_in_seed

    total: dict = {}
    cfg = get_arch(ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    greedy = _serve_requests(cfg, prompt_lens=SAMPLED_PROMPT_LENS)
    reqs = _sampled(greedy)

    # (a) sampled serving at k=8 and k=1, and greedy at k=8 on the same
    # requests for the tok/s ratio
    def sampled_run(k, order=1, rs=reqs, **kw):
        kernels.reset_launch_counts()
        eng = _engine(dev, cfg, params, k, **kw)
        out, wall, syncs = _drain_timed(eng, rs[::order])
        launches = kernels.launch_counts()
        _add(total, launches)
        s = eng.stats
        label = (f"17({'d' if kw.get('overlap') else 'a'}) k={k}"
                 f"{' greedy' if rs is greedy else ''}"
                 f"{' reversed' if order < 0 else ''}")
        check(s.retired == 16 and all(len(r.tokens) == 64 and
                                      r.finish_reason == "length"
                                      for r in out),
              f"{label}: retired {s.retired}")
        check(s.steps == s.syncs * k, f"{label}: steps {s.steps} != "
              f"syncs {s.syncs} * k")
        check(launches["paged_decode"] == s.steps * cfg.n_layers,
              f"{label}: paged_decode launched {launches['paged_decode']}, "
              f"want {s.steps * cfg.n_layers}")
        print(f"  {label}: {s.summary()}; {wall / syncs * 1e3:.3f} ms/sync, "
              f"{wall / (syncs * k) * 1e3:.3f} ms/step over {syncs} syncs "
              f"after the first; launches {launches}")
        return {r.id: r.tokens for r in out}, s, wall / syncs

    print(f"phase 17(a): {cfg.name} sampled at {SAMPLED} (request i seeded "
          f"1000 + i), phase 9's 16 requests with prompts of "
          f"{SAMPLED_PROMPT_LENS[0]}-{SAMPLED_PROMPT_LENS[1] - 1} tokens, "
          f"Engine(num_slots=8, "
          f"max_len=1024, max_prompt=512, page_size=16), blocks under "
          f"set_sync_debug_mode('error')")
    s8, st8, ms8 = sampled_run(8)
    s1, _, ms1 = sampled_run(1)
    print(f"  17(a) streams: k=8 == k=1 {s8 == s1}")
    check(s8 == s1, "17(a): sampled streams differ across k")
    _, gst8, gms8 = sampled_run(8, rs=greedy)
    print(f"  17(a) k=8: sampled {st8.tokens_out / (ms8 * st8.syncs)!r} "
          f"tok/s, greedy {gst8.tokens_out / (gms8 * gst8.syncs)!r} tok/s "
          f"on the same requests (all tokens over the syncs after the "
          f"first, at their mean ms/sync)")
    samp_ms, block_ms = _sampler_profile(dev, cfg, params, reqs)

    # (b) the prefix cache: a 264-token shared prefix (16.5 pages), a
    # 32-64-token tail each; the first request alone publishes the pages
    rng = np.random.RandomState(7)
    shared = rng.randint(0, cfg.vocab, size=264).tolist()
    preqs = [Request(id=f"p{i}", prompt=shared + rng.randint(
        0, cfg.vocab, size=int(rng.randint(32, 65))).tolist(),
        max_new_tokens=32) for i in range(16)]
    runs = {}
    for on in (False, True):
        kernels.reset_launch_counts()
        eng = _engine(dev, cfg, params, 8, prefix_cache=on)
        t0 = time.perf_counter()
        out = eng.run(preqs[:1]) + eng.run(preqs[1:])
        wall = time.perf_counter() - t0
        _add(total, kernels.launch_counts())
        runs[on] = ({r.id: r.tokens for r in out}, eng, wall)
        print(f"  17(b) prefix cache {'on' if on else 'off'}: {wall:.3f}s, "
              f"{eng.stats.summary()}")
    eng = runs[True][1]
    s = eng.stats
    ref = eng.pool.refcounts()
    trie = {n.page for n in eng.pool.prefix.iter_nodes()}
    live = {int(p) for p in np.flatnonzero(ref[1:] > 0) + 1}
    check(runs[True][0] == runs[False][0], "17(b): streams differ with the "
          "prefix cache on")
    check(s.prefix_hits >= 15 and s.prefix_tokens >= 15 * 256,
          f"17(b): {s.prefix_hits} hits, {s.prefix_tokens} tokens skipped")
    check(s.cow_copies > 0, "17(b): no copy-on-write")
    check(live == trie and all(ref[p] == 1 for p in trie),
          f"17(b): after the drain {len(live)} live pages, the trie holds "
          f"{len(trie)}")
    print(f"  17(b) streams bit-identical to the cache-off run; "
          f"{s.prefix_hits} hits, {s.prefix_tokens} prefill tokens skipped, "
          f"{s.cow_copies} copies on write; {len(live)} live pages after "
          f"the drain, all the trie's; wall {runs[True][2]:.3f}s against "
          f"{runs[False][2]:.3f}s off")
    del runs

    # (c) fan-out: 4 sampled requests of n = 4 against 16 standalone
    # requests seeded fold_in_seed(seed, i)
    freqs = [Request(id=f"g{i}", prompt=rng.randint(
        0, cfg.vocab, size=int(rng.randint(32, 65))).tolist(),
        max_new_tokens=32, n=4,
        sampling=SamplingParams(seed=2000 + i, **SAMPLED)) for i in range(4)]
    alone = [Request(id=f"g{i}.{j}", prompt=r.prompt, max_new_tokens=32,
                     sampling=SamplingParams(seed=fold_in_seed(2000 + i, j),
                                             **SAMPLED))
             for i, r in enumerate(freqs) for j in range(4)]
    kernels.reset_launch_counts()
    fan = _engine(dev, cfg, params, 8)
    got = {f"{r.id}.{r.stream}": r.tokens for r in fan.run(freqs)}
    ref_eng = _engine(dev, cfg, params, 8)
    want = {r.id: r.tokens for r in ref_eng.run(alone)}
    _add(total, kernels.launch_counts())
    fs, rs = fan.stats, ref_eng.stats
    print(f"  17(c) fan-out: {fs.summary()}; standalone: peak live pages "
          f"{rs.peak_live_pages} against {fs.peak_live_pages} fanned out")
    check(got == want, "17(c): a fan-out stream differs from its standalone "
          "request")
    check(fs.shared_prompt_pages > 0 and
          fs.peak_live_pages < rs.peak_live_pages,
          f"17(c): pages {fs.peak_live_pages} fanned out vs "
          f"{rs.peak_live_pages} standalone")
    del fan, ref_eng

    # (d) the double-buffered loop on (a)'s requests, timed beside (a)'s
    # blocking runs; at k=8 submitted in reverse order, so the same run
    # holds (a)'s streams across a fresh engine and other slots too; then
    # under the sync audit (its patches cost host time a call, so the
    # audited run is not timed) at k=8 on obs phase (b)'s shorter requests
    for k, order, blocking, ms_b in ((8, -1, s8, ms8), (1, 1, s1, ms1)):
        o, so, ms_o = sampled_run(k, order=order, overlap=True)
        print(f"  17(d) overlap k={k}{' reversed' if order < 0 else ''}: "
              f"{ms_o * 1e3:.3f} ms/sync against {ms_b * 1e3:.3f} blocking; "
              f"hidden syncs {so.hidden_syncs} of {so.syncs}; streams "
              f"bit-identical to the blocking engine's: {o == blocking}")
        check(o == blocking, f"17(d) k={k}: streams differ from blocking")
        check(so.hidden_syncs > 0, f"17(d) k={k}: no hidden sync")
    short = _sampled(_serve_requests(cfg, **OBS_REQUESTS))
    eng = _engine(dev, cfg, params, 8, overlap=True)
    for r in short:
        eng.submit(r)
    with obs.sync_audit(dev) as audit:
        eng.run()
    so = eng.stats
    print(f"  17(d) audited overlap k=8, {len(short)} requests: "
          f"{so.syncs} syncs, {so.hidden_syncs} hidden; audit "
          f"{audit.as_dict()}, runtime {audit.runtime_syncs} "
          f"({audit.runtime_uncounted} uncounted)")
    check(audit.syncs == so.syncs == audit.dispatches and
          audit.overlap_epochs == so.hidden_syncs > 0 and
          audit.runtime_uncounted == 0,
          f"17(d) k=8: audit {audit.as_dict()} vs stats "
          f"{so.syncs}/{so.hidden_syncs}")
    del params
    torch.cuda.empty_cache()
    fam = families_engine_phase(dev)
    _add(total, fam)
    return total, samp_ms, block_ms


def families_engine_phase(dev):
    """Phase 17(e): each other family through the engine at its published
    config: 4 greedy requests of 32-64 prompt tokens, 32 new, max_len 256,
    page 16 where it has attention K/V; slot == paged == paged at k=1 bit
    for bit; one block's kernel calls held to their plain versions; the
    launches a step equal the attention calls a step."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve import Request

    total: dict = {}
    for name in SERVE_FAMILIES:
        t0 = time.perf_counter()
        cfg = get_arch(name)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
        rng = np.random.RandomState(3)
        audio = cfg.family == "audio"
        reqs = [Request(id=f"e{i}", prompt=rng.randint(
            0, cfg.vocab, size=int(rng.randint(32, 65))).tolist(),
            max_new_tokens=32,
            enc_embeds=rng.randn(1500, cfg.d_model).astype(np.float32)
            if audio else None) for i in range(4)]
        attn = (0 if cfg.family == "ssm" else
                cfg.n_layers // cfg.shared_attn_period
                if cfg.family == "hybrid" else cfg.n_layers)
        kw = dict(num_slots=4, max_len=256, max_prompt=64,
                  enc_len=1500 if audio else None)
        streams, per_step = {}, {}
        for label, k, page in (("slot", 8, None), ("paged", 8, 16),
                               ("paged", 1, 16)):
            eng = _engine(dev, cfg, params, k, page_size=page, **kw)
            if (label, k) == ("paged", 8):
                errs: dict = {}
                for r in reqs:
                    eng.submit(r)
                kernels.reset_launch_counts()
                with _held_to_plain(errs):
                    out = eng.step()
                steps = eng.stats.steps
                held = {"o_paged": steps * attn}
                if audio:
                    # the cross-attention a layer and step, and the encoder
                    # layers of each request's prefill at its admission
                    held["o"] = (steps * cfg.n_layers
                                 + len(reqs) * cfg.n_enc_layers)
                _check_held(errs, {n: c for n, c in held.items() if c},
                            f"17(e) {name} one k=8 block")
                _add(total, kernels.launch_counts())
                kernels.reset_launch_counts()
                t1 = time.perf_counter()
                out += eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                launches = kernels.launch_counts()
                s = eng.stats
                run_steps = s.steps - steps
                per_step = {op: n / run_steps for op, n in launches.items()
                            if n}
                print(f"  17(e) {name}: {wall / run_steps * 1e3:.3f} ms a "
                      f"step at 4 slots (k=8, paged={eng.paged}); launches a "
                      f"step {per_step}; {s.summary()}")
                check(launches["paged_decode"] == run_steps * attn,
                      f"17(e) {name}: paged_decode {launches['paged_decode']}"
                      f" over {run_steps} steps, want {attn} a step")
                check(launches["flash_attention"] ==
                      (run_steps * cfg.n_layers if audio else 0),
                      f"17(e) {name}: flash_attention "
                      f"{launches['flash_attention']} over {run_steps} steps")
                _add(total, launches)
            else:
                kernels.reset_launch_counts()
                out = eng.run(list(reqs))
                _add(total, kernels.launch_counts())
            check(eng.stats.retired == 4 and all(
                len(r.tokens) == 32 for r in out),
                f"17(e) {name} {label} k={k}: retired {eng.stats.retired}")
            streams[(label, k)] = {r.id: r.tokens for r in out}
            del eng
        same = streams[("slot", 8)] == streams[("paged", 8)] == \
            streams[("paged", 1)]
        print(f"  17(e) {name}: slot == paged == paged k=1 bit for bit: "
              f"{same}; {time.perf_counter() - t0:.1f}s")
        check(same, f"17(e) {name}: streams differ across pools or k")
        del params
        torch.cuda.empty_cache()
    return total


#: obs phase (b)'s requests: 8 of phase 9's kind with shorter prompts
#: (32-64 tokens) and 32 new tokens, so three engine runs take seconds
OBS_REQUESTS = dict(n=8, new_tokens=32, prompt_lens=(32, 65))
#: the zero-cost promise (README, "Observability"): one round of the
#: engine's instrumentation with obs disabled under 1% of a k=1 sync
OBS_OVERHEAD_LIMIT = 0.01
#: a well-formed Prometheus sample line
PROM_SAMPLE = r'^[A-Za-z_:][A-Za-z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+-]+$'


def _prometheus(path) -> str:
    """The Prometheus text at ``path``; every sample line must parse."""
    import re
    text = Path(path).read_text()
    lines = [l for l in text.splitlines() if l and not l.startswith("#")]
    bad = [l for l in lines if not re.match(PROM_SAMPLE, l)]
    check(lines and not bad, f"{path}: malformed Prometheus lines {bad[:3]}")
    return text


def _prom_value(text: str, name: str) -> float:
    import re
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    check(m is not None, f"no sample {name!r} in the Prometheus text")
    return float(m.group(1))


def _trace_names(path):
    import collections
    trace = json.loads(Path(path).read_text())
    return collections.Counter(e["name"] for e in trace["traceEvents"])


def obs_lasso_phase(dev, profiled):
    """Obs phase (a): phase 5's four solves (same problems, draws and
    step) with the host loop under a sync audit."""
    import torch
    from repro_torch import kernels, obs
    from repro_torch.core import sstep
    print("obs phase (a): phase 5's solves, host_loop=True under "
          "obs.sync_audit (the runtime's sync-debug mode 'warn' beside it)")
    for dataset, (problem, cfg, draws, rule, names) in profiled.items():
        for ca, algo in ((True, names[0]), (False, names[1])):
            w_plain = sstep.solve(problem, cfg, None, rule, name=algo, ca=ca,
                                  idx=draws)
            blocks = sstep.HostSyncs()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with obs.sync_audit(dev) as a:
                w = sstep.solve(problem, cfg, None, rule, name=algo, ca=ca,
                                idx=draws, host_loop=True, syncs=blocks)
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
            want = cfg.T // cfg.k if ca else cfg.T
            same = torch.equal(w, w_plain)
            print(f"  {dataset} {algo}: audit {a.as_dict()}; runtime sync "
                  f"warnings {a.runtime_syncs} ({a.runtime_uncounted} "
                  f"outside a counted read) beside transfers "
                  f"{a.transfers}; HostSyncs.blocks {blocks.blocks}; "
                  f"wall {wall:.4f}s; w bitwise the solve without the host "
                  f"loop: {same}")
            check(a.syncs == a.dispatches == blocks.blocks == want,
                  f"{dataset} {algo}: audit {a.as_dict()}, blocks "
                  f"{blocks.blocks}, want {want}")
            check(a.runtime_uncounted == 0,
                  f"{dataset} {algo}: {a.runtime_uncounted} syncs the "
                  f"runtime reports outside a counted read")
            check(launches["gram_gather"] == want
                  and launches[BLOCK_OPS[rule.name]] == want,
                  f"{dataset} {algo}: launches {launches}, want {want} each")
            check(same, f"{dataset} {algo}: the host loop changed w")


def check_train_obs(prom, trace, runner):
    """Obs phase (c), the train CLI's half (run in the train phases, whose
    CLI run with a failure passes ``--metrics`` and ``--trace-out``): the
    Prometheus text parses and counts the run, the trace has its spans."""
    text, names = _prometheus(prom), _trace_names(trace)
    print(f"  launch.train --fail-at 6 --metrics --trace-out: restarts "
          f"{runner.restarts}, repro_train_restarts_total "
          f"{_prom_value(text, 'repro_train_restarts_total')!r}, "
          f"repro_train_step_seconds_count "
          f"{_prom_value(text, 'repro_train_step_seconds_count')!r}, "
          f"repro_train_ckpt_saves_total "
          f"{_prom_value(text, 'repro_train_ckpt_saves_total')!r}; trace "
          f"{dict(names)}")
    # steps 0-5, the failure at 6, steps 4-11 again from the step-4
    # checkpoint: 14 steps, snapshots before steps 0, 4, 4 and 8
    check(runner.restarts == 1
          and _prom_value(text, "repro_train_restarts_total") == 1
          and _prom_value(text, "repro_train_step_seconds_count") == 14
          and _prom_value(text, "repro_train_ckpt_saves_total") == 4,
          "launch.train: metrics disagree with the run")
    check(names["train.step"] == 14 and names["train.ckpt_save"] == 4
          and names["train.restore"] == names["train.restart"] == 1,
          f"launch.train: trace spans {dict(names)}")


def obs_serve_phase(dev, cfg, params, k1_ms_per_sync):
    """Obs phase (b)-(d): the engine's audit against its stats at k=8 and
    k=1 with obs on, streams against an obs-off run; the serve CLI's
    ``--metrics`` and ``--trace-out`` (the train CLI's are checked in the
    train phases, by :func:`check_train_obs`); the disabled-instrumentation
    cost of a k=1 round against phase 9's k=1 ms/sync."""
    import tempfile
    import torch
    from repro_torch import kernels, obs
    from repro_torch.kernels import registry
    from repro_torch.launch import serve as serve_cli, train as train_cli
    from repro_torch.serve import Engine

    def run(k, on):
        eng = Engine(params, cfg, num_slots=8, max_len=1024, max_prompt=512,
                     k=k, page_size=16, eos_id=None, device=dev,
                     sync_debug=True)
        reqs = _serve_requests(cfg, **OBS_REQUESTS)
        obs.reset()
        if on:
            obs.enable()
        kernels.reset_launch_counts()
        registry.reset_dispatch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with (obs.sync_audit(dev) if on
                  else contextlib.nullcontext()) as a:
                out = eng.run(reqs)
        finally:
            obs.disable()
        wall = time.perf_counter() - t0
        s = eng.stats
        launches = kernels.launch_counts()
        label = f"k={k} obs {'on' if on else 'off'}"
        check(s.retired == 8 and all(len(r.tokens) == 32 for r in out),
              f"{label}: retired {s.retired}")
        check(s.steps == s.syncs * k, f"{label}: steps {s.steps}")
        check(launches["paged_decode"] == s.steps * cfg.n_layers,
              f"{label}: paged_decode launched {launches['paged_decode']}")
        dispatches = sum(registry.dispatch_counts().values())
        line = (f"  engine {label}: {s.syncs} syncs, {s.steps} steps, "
                f"{wall:.3f}s, paged_decode {launches['paged_decode']}")
        if on:
            snap = obs.metrics_snapshot()
            line += (f"; audit {a.as_dict()}; runtime sync warnings "
                     f"{a.runtime_syncs} ({a.runtime_uncounted} outside a "
                     f"counted read) beside transfers {a.transfers}; "
                     f"repro_serve_syncs_total "
                     f"{snap['repro_serve_syncs_total']!r}")
            check(a.syncs == s.syncs == a.dispatches,
                  f"{label}: audit {a.as_dict()} vs stats syncs {s.syncs}")
            check(a.by_span == {"serve.decode_block": s.syncs},
                  f"{label}: syncs outside the decode span {a.by_span}")
            check(a.runtime_uncounted == 0, f"{label}: "
                  f"{a.runtime_uncounted} syncs the runtime reports "
                  f"outside a counted read")
            check(snap["repro_serve_syncs_total"] == s.syncs
                  and snap["repro_serve_steps_total"] == s.steps
                  and snap["repro_serve_tokens_total"] == s.tokens_out
                  and snap["repro_serve_ttft_seconds_count"] == 8,
                  f"{label}: metrics differ from the stats: {snap}")
        print(line)
        return {r.id: r.tokens for r in out}, s, dispatches

    print(f"obs phase (b): phase 9's engine, {OBS_REQUESTS['n']} requests "
          f"(prompts {OBS_REQUESTS['prompt_lens'][0]}-"
          f"{OBS_REQUESTS['prompt_lens'][1] - 1} tokens, "
          f"{OBS_REQUESTS['new_tokens']} new)")
    off, _, _ = run(8, False)
    on8, _, _ = run(8, True)
    on1, s1, dispatches1 = run(1, True)
    print(f"  streams with obs on, k=8 and k=1, bit-identical to obs off: "
          f"{on8 == off}, {on1 == off}")
    check(on8 == off and on1 == off, "obs on changed a token stream")

    print("obs phase (c): the serve CLI with --metrics and --trace-out")
    with tempfile.TemporaryDirectory() as tmp:
        prom, trace = f"{tmp}/serve.prom", f"{tmp}/serve.json"
        out = serve_cli.main(["--arch", cfg.name, "--preset", "full",
                              "--page-size", "16", "--batch", "8",
                              "--max-len", "1024", "--k", "8",
                              "--new-tokens", "32", "--requests", "16",
                              "--device", "cuda", "--metrics", prom,
                              "--trace-out", trace])
        text, names = _prometheus(prom), _trace_names(trace)
        syncs = _prom_value(text, "repro_serve_syncs_total")
        print(f"  launch.serve: repro_serve_syncs_total {syncs!r}, "
              f"repro_serve_steps_total "
              f"{_prom_value(text, 'repro_serve_steps_total')!r}; trace "
              f"{dict(names)}")
        check(len(out) == 16 and not obs.enabled(), "launch.serve: run")
        check(_prom_value(text, "repro_serve_steps_total") == 8 * syncs
              and _prom_value(text, "repro_serve_tokens_total") == 16 * 32,
              "launch.serve: metrics disagree with the run")
        check(names["serve.decode_block"] == 2 * syncs
              and names["serve.retire"] == 16
              and names["serve.admit"] == syncs + 16,
              f"launch.serve: trace spans {dict(names)}")

    # (d) what one k=1 round of the engine runs of obs with obs disabled:
    # the admit span, the scheduler's gauge, two enabled() checks, the
    # dispatch mark and fetch mark, the two decode spans, and the registry
    # counter of every kernel dispatch the round makes
    gauge = obs.gauge("repro_sched_queue_depth")
    counter = obs.counter("repro_kernel_dispatch_total")
    per_round = dispatches1 // s1.syncs

    def bundle():
        with obs.span("serve.admit"):
            gauge.set(0)
            obs.enabled()
        ticket = obs.mark_dispatch("serve.decode_block")
        with obs.span("serve.decode_block", k=1, live=8):
            for _ in range(per_round):
                counter.inc(op="paged_attention", backend="cuda")
        obs.mark_fetch(ticket)
        with obs.span("serve.decode_block", k=1, live=8, fetch=1):
            pass
        obs.enabled()

    check(not obs.enabled(), "obs must be disabled for the overhead")
    us = _host_us(bundle, iters=20_000)
    ratio = us / (k1_ms_per_sync * 1e3)
    print(f"obs phase (d): one disabled round of instrumentation "
          f"({per_round} registry dispatches a k=1 round) {us:.3f} us of "
          f"host; k=1 {k1_ms_per_sync:.3f} ms/sync (phase 9); ratio "
          f"{ratio:.6%} (limit {OBS_OVERHEAD_LIMIT:.0%}); card: "
          f"{nvidia_smi()}")
    check(ratio < OBS_OVERHEAD_LIMIT, f"disabled instrumentation costs "
          f"{ratio:.3%} of a k=1 sync")


T_START = time.perf_counter()


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="the port's smoke run on one "
                                 "NVIDIA Hopper card")
    ap.add_argument("--only", choices=["families", "training", "serving"],
                    help="build the kernels, then run phase 15 (families), "
                    "phase 16 (training) or phase 17 (serving) alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs an NVIDIA Hopper card",
              file=sys.stderr)
        return 1

    from repro_torch import kernels, roofline
    from repro_torch.core import sstep
    from repro_torch.core.sampling import gather_columns, sample_index_batch
    from repro_torch.data import make_dataset_like
    from repro_torch.kernels import _build, registry
    from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.prox_step import ref as prox_ref
    from repro_torch.launch import lasso_solve

    dev = torch.device("cuda")
    card = nvidia_smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability()
    print(f"device: {torch.cuda.get_device_name(0)} capability {cap} "
          f"count {torch.cuda.device_count()}")
    check(cap == (9, 0), f"need compute capability (9, 0), got {cap}")

    # 2. full float32 in every plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 3. build
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f}s "
          + " ".join(f"{s}={v:.2f}s" for s, v in secs.items()))
    for stem in _build.SOURCES:
        for name, regs, spill in _ptxas_report(_build.build_log(stem)):
            print(f"  ptxas[{stem}] {name}: {regs} registers, {spill}")
    if args.only == "families":
        t_phase = time.perf_counter()
        fam15 = families_phase(dev)
        print(f"families phase: {time.perf_counter() - t_phase:.1f}s; "
              f"launches " + str({op: n for op, n in fam15.items() if n}))
        return 0
    if args.only == "training":
        t_phase = time.perf_counter()
        train16 = training_dist_phase(dev)
        print(f"phase 16: {time.perf_counter() - t_phase:.1f}s; launches "
              + str({op: n for op, n in train16.items() if n}))
        return 0
    if args.only == "serving":
        t_phase = time.perf_counter()
        serve17, _, _ = serving_phase(dev)
        print(f"phase 17: {time.perf_counter() - t_phase:.1f}s; launches "
              + str({op: n for op, n in serve17.items() if n}))
        return 0
    shared_d, max_d = prox_ops.prox_loop_limits()
    print(f"prox kernels: one CTA up to d={prox_ops.ROWS_ABOVE_D}, G "
          f"through the shared-memory ring up to d={shared_d} (d^2 a "
          f"multiple of 4), from global memory above; the rows route above "
          f"d={prox_ops.ROWS_ABOVE_D} (the one-CTA kernels stop at "
          f"d={max_d})")

    def hold_gram_gather(shape, rows, Xy, draws, r):
        """gram_gather against its plain version and, bitwise, against gram
        over the gathered copy, scaled; returns (G, R, max_abs_err)."""
        inv_m = 1.0 / draws.shape[1]
        G, R = gram_ops.gram_gather_cuda(rows, draws, r, inv_m)
        want_G, want_R = gram_ref.gram_gather(rows, draws, r, inv_m)
        err = compare("gram_gather", shape, torch.cat([G.flatten(1), R], 1),
                      torch.cat([want_G.flatten(1), want_R], 1),
                      rtol=GRAM_RTOL)
        compare_offdiag(shape, G, want_G, "gram_gather")
        Ga = gram_ops.gram_cuda(gather_columns(Xy, draws)) * inv_m
        d = r - 1
        check(torch.equal(G, Ga[:, :d, :d]) and torch.equal(R, Ga[:, :d, d]),
              f"gram_gather{shape}: not bitwise gram over the gathered copy")
        return G, R, err

    gen = torch.Generator(device=dev).manual_seed(0)
    blocks = {}    # the CA blocks' (G, R) of covtype and susy
    entries = {}   # one per kernel, at its main-path shape, for the JSON line
    timings = []   # every timed shape

    # 4a. gram: the CA block of covtype and of susy at full size, the
    # classical (k=1) draw of each (all with the y row: d+1 rows), and a
    # ragged shape
    print("kernel phase: gram")
    for shape in ((32, 55, 58_101), (32, 19, 500_000), (1, 55, 58_101),
                  (1, 19, 500_000), (3, 61, 129)):
        Xs = torch.randn(*shape, generator=gen, device=dev)
        got = gram_ops.gram_cuda(Xs)
        want = gram_ref.gram(Xs)
        err = compare("gram", shape, got, want, rtol=GRAM_RTOL)
        compare_offdiag(shape, got, want)
        if shape[0] > 1:
            # one draw's G has the same bits alone (classical) as in the batch
            for j in (0, shape[0] - 1):
                check(torch.equal(gram_ops.gram_cuda(Xs[j:j + 1])[0], got[j]),
                      f"gram{shape}: draw {j} alone differs from its batch")
        k, d, m = shape
        if m < 1000:
            continue
        iters = 20 if k > 1 else 200
        ms = time_ms(lambda: gram_ops.gram_cuda(Xs), iters)
        plain = time_ms(lambda: gram_ref.gram(Xs), iters)
        lib = time_ms(lambda: torch.bmm(Xs, Xs.transpose(1, 2)), iters)
        # G is symmetric: d(d+1)/2 distinct entries of 2m FLOP each
        bms, by = bound("gram", Xs)
        e = dict(name="gram", route="cuda",
                 source="src/repro_torch/csrc/gram.cu",
                 replaces="src/repro/kernels/gram/kernel.py:44",
                 launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                 bound_ms=bms, bound_by=by, library_ms=lib, shape=list(shape))
        timings.append(e)
        if shape == (32, 55, 58_101):
            entries["gram"] = e
        del Xs, got

    # 4b. gram_gather: the solvers' block statistics over the sample-major
    # rows of covtype and susy at full size, with real draws (with
    # replacement: rows repeat); the CA block (k=32) and the classical draw
    # (k=1) of each, then ragged shapes
    print("kernel phase: gram_gather")
    for dataset, scale in (("covtype", 10), ("susy", 50)):
        problem, _ = make_dataset_like(dataset, scale=scale, device=dev)
        rows, Xy = problem.Xy_rows, problem.Xy
        n, r = problem.n, problem.d + 1
        m = max(int(B * n), 1)
        idx = sample_index_batch(gen, K, n, m)
        for k in (K, 1):
            draws = idx[:k]
            shape = (k, r, m)
            G, R, err = hold_gram_gather(shape, rows, Xy, draws, r)
            if k > 1:
                for j in (0, k - 1):
                    Gj, Rj = gram_ops.gram_gather_cuda(rows, draws[j:j + 1],
                                                       r, 1.0 / m)
                    check(torch.equal(Gj[0], G[j]) and torch.equal(Rj[0], R[j]),
                          f"gram_gather{shape}: draw {j} alone differs from "
                          f"its batch")
            distinct = int(torch.unique(draws).numel())
            check(distinct < k * m, f"gram_gather{shape}: no row drawn twice")
            iters = 20 if k > 1 else 200
            ms = time_ms(lambda: gram_ops.gram_gather_cuda(rows, draws, r,
                                                           1.0 / m), iters)
            plain = time_ms(lambda: gram_ref.gram_gather(rows, draws, r,
                                                         1.0 / m), iters)

            def gather_bmm():
                Xs = gather_columns(Xy, draws)
                return torch.bmm(Xs, Xs.transpose(1, 2))
            pair = time_ms(gather_bmm, iters)
            host = _host_us(lambda: gram_ops.gram_gather_cuda(rows, draws, r,
                                                              1.0 / m))
            # each distinct row read once, the draws, G and R written once;
            # r(r+1)/2 entries of m FMAs each
            bms, by = bound("gram_gather", rows, draws, r, 1.0 / m,
                            distinct=distinct)
            every, _ = bound("gram_gather", rows, draws, r, 1.0 / m,
                             distinct=k * m)
            print(f"  gram_gather {dataset} {shape}: {distinct} distinct rows "
                  f"of {k * m} draws; kernel={ms:.4f}ms plain={plain:.4f}ms "
                  f"bound={bms:.5f}ms ({by}; {every:.5f}ms if every drawn "
                  f"row is read) gather+bmm={pair:.4f}ms (diagnostic); "
                  f"wrapper host time {host:.1f}us a call")
            e = dict(name="gram_gather", route="cuda",
                     source="src/repro_torch/csrc/gram.cu",
                     replaces="src/repro/kernels/gram/kernel.py:44",
                     launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     shape=list(shape))
            timings.append(e)
            if k > 1 and dataset == "covtype":
                entries["gram_gather"] = e
            if k > 1:
                blocks[dataset] = (G, R)   # phase 4d's block prox inputs
            del G, R
        del problem, rows, Xy, idx, draws
        torch.cuda.empty_cache()
    for shape in ((3, 61, 129), (2, 130, 777), (1, 8, 1)):
        k, r, m = shape
        n = m // 2 + 3
        # padding columns of garbage: they take part in no entry
        rows = torch.randn(n, -(-r // 4) * 4 + 4, generator=gen, device=dev)
        draws = torch.randint(0, n, (k, m), generator=gen, device=dev)
        hold_gram_gather(shape, rows, rows[:, :r].T, draws, r)

    # 4c. prox_step / prox_loop, the block kernels' k = 1 instances, at
    # d = 54 and 18 for each variant, ragged d = 61, and d = 300, above the
    # shared-memory ring
    print("kernel phase: prox_step, prox_loop")
    scal = prox_ops.prox_scalars(*SCAL, device=dev)
    errs = {"prox_step": {}, "prox_loop": {}}
    for d in (54, 18, 61, 300):
        A = torch.randn(d, d, generator=gen, device=dev)
        G = (A @ A.T / d).contiguous()
        R = torch.randn(d, generator=gen, device=dev)
        v = torch.randn(d, generator=gen, device=dev)
        for variant in VARIANTS:
            if d != 300:
                errs["prox_step"][(d, variant)] = compare(
                    "prox_step", (d, variant),
                    prox_ops.prox_step_cuda(G, R, v, scal, variant=variant),
                    prox_ref.prox_step(G, R, v, scal, variant=variant))
            errs["prox_loop"][(d, variant)] = compare(
                "prox_loop", (d, variant, Q),
                prox_ops.prox_loop_cuda(G, R, v, scal, Q=Q, variant=variant),
                prox_ref.prox_loop(G, R, v, scal, Q=Q, variant=variant))
        if d not in (54, 18):
            continue
        for name in ("prox_step", "prox_loop"):
            if name == "prox_step":
                ms = time_ms(lambda: prox_ops.prox_step_cuda(G, R, v, scal), 500)
                plain = time_ms(lambda: prox_ref.prox_step(G, R, v, scal), 500)
                bms, by = bound("prox_step", G, R, v, scal)
                replaces = "src/repro/kernels/prox_step/kernel.py:89"
            else:
                ms = time_ms(lambda: prox_ops.prox_loop_cuda(G, R, v, scal, Q=Q),
                             500)
                plain = time_ms(lambda: prox_ref.prox_loop(G, R, v, scal, Q=Q),
                                200)
                bms, by = bound("prox_loop", G, R, v, scal, Q=Q)
                replaces = "src/repro/kernels/prox_step/kernel.py:77"
            e = dict(name=name, route="cuda",
                     source="src/repro_torch/csrc/prox_step.cu",
                     replaces=replaces, launches=0,
                     max_abs_err=errs[name][(d, "l1")], ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     shape=[d] if name == "prox_step" else [d, Q])
            timings.append(e)
            # FISTA runs on covtype (d=54), PNM on susy (d=18)
            if (name, d) in (("prox_step", 54), ("prox_loop", 18)):
                entries[name] = e
    for name in ("prox_step", "prox_loop"):
        print(f"  {name}: max_abs_err over all shapes and variants "
              f"{max(errs[name].values()):.3e}")
    for e in timings:
        print(f"  time {e['name']:9s} {str(e['shape']):18s} kernel={e['ms']:.4f}ms "
              f"plain={e['plain_ms']:.4f}ms library={e['library_ms']} "
              f"bound={e['bound_ms']:.5f}ms ({e['bound_by']})")
    entries.update(prox_block_phase(dev, gen, blocks, compare, time_ms))
    del blocks

    # 5. main path
    print(f"main path: lasso_solve T={T} k={K} b={B} Q={Q}")
    profiled = {}
    total = {"gram": 0, "gram_gather": 0, "prox_step": 0, "prox_loop": 0,
             "prox_step_block": 0, "prox_loop_block": 0}
    for dataset, scale, (ca_name, cl_name), rule, n_full in (
            ("covtype", "10", ("ca_sfista", "sfista"), sstep.FISTA_RULE,
             581_010),
            ("susy", "50", ("ca_spnm", "spnm"), sstep.PNM_RULE, 5_000_000)):
        runs = {}
        for algo in (ca_name, cl_name):
            kernels.reset_launch_counts()
            registry.reset_dispatch_counts()
            run = lasso_solve.main([
                "--dataset", dataset, "--scale", scale, "--algorithm", algo,
                "--T", str(T), "--k", str(K), "--b", str(B), "--Q", str(Q),
                "--seed", "0", "--device", "cuda"])
            launches = kernels.launch_counts()
            dispatches = registry.dispatch_counts()
            runs[algo] = run
            ca = algo.startswith("ca_")
            prox = BLOCK_OPS[rule.name]
            print(f"  {dataset} {algo}: n={run.problem.n} d={run.problem.d} "
                  f"rel_err={run.rel_err:.6f} objective={run.objective:.6f} "
                  f"wall={run.seconds:.4f}s launches={launches} "
                  f"dispatches={dispatches}")
            check(run.problem.n == n_full, f"{dataset}: n={run.problem.n}")
            check(launches == run.launches, "launch counts disagree")
            check(all(b == "cuda" for (_, b) in dispatches),
                  f"{algo}: a plain version ran: {dispatches}")
            want_gram = T // K if ca else T
            check(launches["gram_gather"] == want_gram,
                  f"{algo}: gram_gather launched {launches['gram_gather']}, "
                  f"want {want_gram}")
            check(launches["gram"] == 0,
                  f"{algo}: gram launched {launches['gram']} times on the "
                  f"solve")
            check(launches[prox] == want_gram,
                  f"{algo}: {prox} launched {launches[prox]}, want "
                  f"{want_gram}")
            check(launches["prox_step"] == launches["prox_loop"] == 0,
                  f"{algo}: the one-step prox kernels ran on the solve: "
                  f"{launches}")
            check(math.isfinite(run.rel_err) and run.rel_err < 1.0,
                  f"{algo}: rel_err {run.rel_err}")
            for op in total:
                total[op] += launches[op]
        ca_run, cl_run = runs[ca_name], runs[cl_name]
        check(ca_run.step == cl_run.step, "CA and classical step sizes differ")
        diff = float((ca_run.w - cl_run.w).abs().max())
        print(f"  {dataset}: |w_{ca_name} - w_{cl_name}|_max = {diff:.3e}")
        check(diff <= CA_ATOL, f"{dataset}: CA vs classical {diff:.3e} > "
              f"{CA_ATOL}")
        # the port's plain solve on the card, same draws and step
        problem, cfg = cl_run.problem, cl_run.cfg
        draws = sample_index_batch(
            torch.Generator(device=dev).manual_seed(0), cfg.T, problem.n,
            sstep.draw_size(problem, cfg))
        with registry.use("torch"):
            w_plain = sstep.solve(problem, cfg, None, rule, name="plain",
                                  ca=False, idx=draws)
        for algo, run in runs.items():
            diff = float((run.w - w_plain).abs().max())
            print(f"  {dataset}: |w_{algo} - w_plain|_max = {diff:.3e}")
            check(diff <= PLAIN_ATOL, f"{dataset} {algo}: vs plain "
                  f"{diff:.3e} > {PLAIN_ATOL}")

        med, walls = solve_walls(problem, cfg, rule, draws)
        print(f"  {dataset}: warm solve wall, median of 3: {ca_name} "
              f"{med[True]!r}s {walls[True]!r}, {cl_name} {med[False]!r}s "
              f"{walls[False]!r}, classical/CA {med[False] / med[True]!r}")
        if dataset == "covtype":
            # phase 5b: one more warm CA-SFISTA solve under the roofline
            r = roofline.analyze(sstep.solve, problem, cfg, None, rule,
                                 name="analyzed", ca=True, idx=draws)
            check(r.registry_ops == {"gram_gather": T // K,
                                     "prox_step_block": T // K},
                  f"analyze: the solve's ops {r.registry_ops}")
            largest = max(r.t_compute, r.t_memory, r.t_collective)
            print(f"  covtype analyzed {ca_name} solve (phase 5b): "
                  f"{_roof_terms(r)}; registry ops {r.registry_ops}; "
                  f"measured warm wall {med[True] * 1e3:.3f} ms, the "
                  f"largest term {100 * largest / med[True]:.1f}% of it")
        profiled[dataset] = (problem, cfg, draws, rule, (ca_name, cl_name))
        del runs, ca_run, cl_run, problem, w_plain

    for name, e in list(entries.items()):
        e["launches"] = total[name]
    for name in ("gram_gather", "prox_step_block", "prox_loop_block"):
        check(total[name] > 0, f"{name} was not launched on the main path")
    # gram, the Pallas kernel's pre-gathered counterpart, and the block
    # kernels' k = 1 instances, held in phase 4
    for name in ("gram", "prox_step", "prox_loop"):
        check(total[name] == 0, f"{name} was launched on the solves")

    # 6. where the time goes: a profiled CA and classical solve of each
    # dataset; the sampled rows are read in place, so no gather or index
    # kernel may run
    for dataset, (problem, cfg, draws, rule, names) in profiled.items():
        for ca in (True, False):
            wall, rows = profile_solve(problem, cfg, rule, draws, ca)
            busy = sum(r[1] for r in rows) / 1e6
            algo = names[0] if ca else names[1]
            print(f"profile {dataset} {algo}: wall "
                  f"{wall:.4f}s (profiled), device kernels {busy:.4f}s "
                  f"({100 * busy / wall:.1f}% busy), "
                  f"{sum(r[2] for r in rows)} launches of {len(rows)} "
                  f"kernel names")
            for key, us, count in rows[:8]:
                print(f"    {us / 1e3:10.3f} ms  x{count:<5d} {key[:90]}")
            # the momentum is computed inside the block kernel: no eager
            # elementwise kernel runs (torch.zeros' fill for w0 is not an
            # update)
            eager = [key for key, _, _ in rows
                     if "elementwise" in key.lower() and "fill" not in
                     key.lower()]
            check(not eager, f"{algo}: elementwise kernels ran on the "
                  f"solve: {eager}")
            kernel = f"{BLOCK_OPS[rule.name]}_kernel"
            prox = sum(c for key, _, c in rows if kernel in key)
            want = cfg.T // cfg.k if ca else cfg.T
            check(prox == want, f"{algo}: {kernel} ran {prox} times in the "
                  f"profile, want {want}")
            gathers = [key for key, _, _ in rows
                       if ("gather" in key.lower() or "index" in key.lower())
                       and "gram_gather" not in key]
            check(not gathers, f"{dataset}: a gather ran on the solve: "
                  f"{gathers}")

    # 6e. obs phase (a): the same solves, host loop under a sync audit
    t_phase = time.perf_counter()
    obs_lasso_phase(dev, profiled)
    print(f"obs phase (a): {time.perf_counter() - t_phase:.1f}s")
    del profiled

    # 6a-6d. the rest of the solver family, the large-d prox route and the
    # distributed solvers; each path's counts zeroed before it, read after
    t_phase = time.perf_counter()
    entries["prox_rows"] = large_d_phase(dev, gen, compare, time_ms)
    print(f"phase 6a: {time.perf_counter() - t_phase:.1f}s")
    t_phase = time.perf_counter()
    covtype, _ = make_dataset_like("covtype", scale=10, device=dev)
    fam_entries, fam = family_phase(dev, gen, compare, compare_offdiag,
                                    time_ms, covtype)
    entries.update(fam_entries)
    print(f"phase 6b: {time.perf_counter() - t_phase:.1f}s")
    t_phase = time.perf_counter()
    svm = svm_phase(dev, compare, time_ms, covtype)
    print(f"phase 6c: {time.perf_counter() - t_phase:.1f}s")
    del covtype
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dist6 = distributed_phase(dev)
    print(f"phase 6d: {time.perf_counter() - t_phase:.1f}s")
    for name, e in entries.items():
        if name in total or name in fam:
            e["launches"] = (total.get(name, 0) + fam.get(name, 0)
                             + svm.get(name, 0) + dist6.get(name, 0))
    for name, counts in (("phase 6b", fam), ("phase 6d", dist6)):
        for op in (("gram", "gram_gather", "pdhg_block") if name == "phase 6b"
                   else ("gram", "gram_gather", "prox_step_block",
                         "prox_loop_block", "pdhg_block")):
            check(counts.get(op, 0) > 0, f"{op} was not launched in {name}")
    check(svm.get("gram", 0) > 0, "gram was not launched in phase 6c")
    print("family launches: 6b " + str({o: n for o, n in fam.items() if n})
          + ", 6c " + str({o: n for o, n in svm.items() if n}) + ", 6d "
          + str({o: n for o, n in dist6.items() if n}))

    # 7-9. serving internlm2-1.8b at full width
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, param_count
    t_phase = time.perf_counter()
    entries.update(attention_kernel_phase(dev))
    print(f"attention kernel phase: {time.perf_counter() - t_phase:.1f}s")
    cfg = get_arch(ARCH)
    t_phase = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    print(f"{cfg.name}: {param_count(params)} parameters (bf16), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}")
    entries["flash_attention"]["launches"] = model_phase(dev, cfg, params)
    print(f"model phase: {time.perf_counter() - t_phase:.1f}s")
    t_phase = time.perf_counter()
    entries["paged_decode"]["launches"], k1_ms_per_sync = serve_phase(
        dev, cfg, params)
    print(f"serve phase: {time.perf_counter() - t_phase:.1f}s")
    t_phase = time.perf_counter()
    obs_serve_phase(dev, cfg, params, k1_ms_per_sync)
    print(f"obs phase (b)-(d): {time.perf_counter() - t_phase:.1f}s")
    del params
    torch.cuda.empty_cache()

    # 10-11. training internlm2-1.8b at full width
    t_phase = time.perf_counter()
    bwd_entries, lse_times = backward_kernel_phase(dev)
    entries.update(bwd_entries)
    print(f"backward kernel phase: {time.perf_counter() - t_phase:.1f}s")
    t_phase = time.perf_counter()
    launches = train_phase(dev, cfg, analyze=True)
    print(f"train phase: {time.perf_counter() - t_phase:.1f}s")
    # flash_attention's two paths: the serving forward and the training
    # step's lse forward
    print(f"flash_attention launches: {entries['flash_attention']['launches']}"
          f" in the model phase's forward, {launches['flash_attention']} "
          f"(with lse) in the train phase; lse forward at the training "
          f"shape: {lse_times}")
    entries["flash_attention"]["launches"] += launches["flash_attention"]
    for name in ("flash_dq", "flash_dkv"):
        entries[name]["launches"] = launches[name]
    torch.cuda.empty_cache()

    # 12-14. mamba2-780m at full width: the SSD kernels, the forward and
    # decode, training
    t_phase = time.perf_counter()
    entries.update(ssd_kernel_phase(dev))
    print(f"SSD kernel phase: {time.perf_counter() - t_phase:.1f}s")
    mcfg = get_arch(SSM_ARCH)
    t_phase = time.perf_counter()
    mparams = init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.bfloat16, device=dev)
    print(f"{mcfg.name}: {param_count(mparams)} parameters (bf16, A_log and "
          f"dt_bias float32), {mcfg.n_layers} layers, d_model "
          f"{mcfg.d_model}, {mcfg.ssm_expand * mcfg.d_model // mcfg.ssm_head_dim}"
          f" SSD heads of P={mcfg.ssm_head_dim}, N={mcfg.ssm_state}")
    entries["ssd"]["launches"] = mamba2_model_phase(dev, mcfg, mparams)
    print(f"mamba2 model phase: {time.perf_counter() - t_phase:.1f}s")
    del mparams
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mlaunches = train_phase(dev, mcfg)
    print(f"mamba2 train phase: {time.perf_counter() - t_phase:.1f}s")
    print(f"ssd launches: {entries['ssd']['launches']} in the forward, "
          f"{mlaunches['ssd']} in the train phase's timed steps")
    entries["ssd"]["launches"] += mlaunches["ssd"]
    entries["ssd_bwd"]["launches"] = mlaunches["ssd_bwd"]
    torch.cuda.empty_cache()

    # 15. the other four families at their published widths
    t_phase = time.perf_counter()
    fam15 = families_phase(dev)
    print(f"families phase: {time.perf_counter() - t_phase:.1f}s; launches "
          + str({op: n for op, n in fam15.items() if n}))
    for name in ("flash_attention", "flash_dq", "flash_dkv", "ssd"):
        check(fam15.get(name, 0) > 0,
              f"{name} was not launched in the families phase")
        entries[name]["launches"] += fam15[name]

    # 16 and 18. the rest of training: the single-device CA step, the
    # CA-sync solvers, whisper and qwen2-vl trained, grad_smoke,
    # compression, the prox VJP; then the sharded step on a (1, 1) mesh
    t_phase = time.perf_counter()
    train16 = training_dist_phase(dev)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f}s; launches "
          + str({op: n for op, n in train16.items() if n}))
    for name, e in entries.items():
        e["launches"] += train16.get(name, 0)

    # 17. the rest of serving: sampled decode, the prefix cache, fan-out and
    # the double-buffered loop on internlm2-1.8b, then every other family
    # through the engine
    t_phase = time.perf_counter()
    serve17, samp_ms, block_ms = serving_phase(dev)
    print(f"phase 17: {time.perf_counter() - t_phase:.1f}s; launches "
          + str({op: n for op, n in serve17.items() if n}))
    for name in ("paged_decode", "flash_attention"):
        check(serve17.get(name, 0) > 0,
              f"{name} was not launched in phase 17")
    for name, e in entries.items():
        e["launches"] += serve17.get(name, 0)

    # 19. the result
    for name in ("flash_attention", "paged_decode", "flash_dq", "flash_dkv",
                 "ssd", "ssd_bwd"):
        check(entries[name]["launches"] > 0,
              f"{name} was not launched on the main path")
    print(f"total: {time.perf_counter() - T_START:.1f}s")

    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k != "shape"}
        for e in entries.values()]}))
    print(f"card: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
