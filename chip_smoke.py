#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Drives the port's paths on one device — the paper's COSMO hdiff on
the full 64x256x256 float32 domain through the IR compiler, the §3.5
elementary-stencil suite (fig11's domain) through the hand-written and the
generated kernels, the gradient path (the data-assimilation trainer fitting
``hdiff_coupled``'s coefficient field through the derived adjoints, on the
same domain), the recurrent LMs (RWKV-6 3B, RecurrentGemma 2B, at
their published shapes) served by ``BatchedServer`` through the WKV-6 and
RG-LRU kernels, the rows x cols decomposition on 8 gloo ranks, and
forecast serving (``ForecastServer``: ensemble members folded into one K2
launch a batch), the shallow-water weather driver with its checkpoint
store, LM training at published widths on RecurrentGemma 2B (K6 forward
and backward) and RWKV-6 3B (K7 and its backward kernel), the dense
LMs (qwen1.5-0.5b served, with a 4096-token flash prefill, and trained;
starcoder2-3b's 4096-token blocked local prefill), and the MoE LMs
(qwen3-moe served at 4 layers and trained at 1, arctic served and trained
at 1, at published widths; the expert-parallel MoE on gloo ranks), the
media LMs (llama-3.2-vision served at one superblock of published widths,
with and without media; hubert-xlarge encoded and trained at published
widths and depth), glm4-9b and nemotron-4-15b served whole at published
widths and depth, tensor-parallel serving over 4 gloo ranks (heads, MLP,
vocabulary and the decode cache split over ``model``) and the LM trainer
sharded over gloo ranks (FSDP storage, data-parallel compute) — and holds
every hand-written kernel against its plain PyTorch version on the card. Each phase prints one JSON line (``t_s``: the
script's seconds so far when it was printed):

  env         torch / CUDA versions, the card, ``nvidia-smi`` name and power
              limit
  build       seconds to compile K1/K3, K4/K5, K6, K7, K7's backward and every K2 and K5'
              program below, the gradient path's adjoint and augmented K2
              programs included (one nvcc each, all at once, into
              build/repro_torch/)
  parity      each kernel against its plain version on the same inputs, at
              64x256x256 and a ragged 3x250x190 (K1 — one frame per 64x64
              tile loaded by cp.async, register windows down runs of rows —
              f32 and bf16, limiter on and off, bit-equal; K4 — the same
              design at radius 1 — with every named mask and a random one,
              f32 and bf16, bit-equal; K2 — the generated kernel,
              single-reader offset-0 ops inlined, taps slid through
              registers down runs of rows, 64x64 tiles loaded by cp.async —
              on all 11 2-D conformance programs x k = 1..3, f32 and bf16,
              bit-equal), at (16384, 256) and a long
              ragged row (4, 4194307) (K5; K5' — flat spans across rows,
              a warp's or a block's, 16-byte vectors, every sweep in
              registers — on jacobi1d and the 1-D chains hdiff1d and
              smooth1d, k=1..3, f32 and bf16, bit-equal): max abs error and bit
              equality, asserted <= 1e-6 (int32, K1-K4, K5', K6: exact); plus a 20-step run
              on the card against the same run on the CPU. K7 (three launches:
              chunk-local k_tail^T v, the scan over chunks, the chunk outputs,
              products in 3xTF32 on the tensor cores) at
              (1, 512, 40, 64) and (2, 128, 3, 16), zero and non-zero initial
              state, within 1e-5 * max|y| + 1e-6 of its plain chunked version
              (summation order in the four products) and 3e-4 of the
              sequential oracle (the JAX test's bound); K7's backward
              (wkv6_bwd_cuda: chunk-local k^T v and r~^T dy, the forward and
              reverse scans over chunks, the chunk gradients; products in
              3xTF32 on the tensor cores, P = dy v^T and the two with
              tril(P) in FP32) at (1, 512, 40, 64), (4, 256, 40, 64) and (2,
              128, 3, 16) with non-zero state and state cotangent, each of dr, dk,
              dv, dw, du, dstate0 within 1e-5 * max|g| + 1e-6 of
              wkv6_backward_plain, and that within 1e-5 relative of autograd
              through wkv6_plain; K6 (channel tiles
              sized for one wave, a and b streamed through a cp.async ring
              of 64-step stages) at (1, 512, 2560), (3, 64, 128) and
              (2, 100, 2562), f32 and bf16, and replayed from a CUDA graph,
              bit-equal; K3 (one int32 frame per 64x64 tile, register
              windows down runs of rows) also on inputs at the sign test's
              edges, bit-equal; and each LM at full width and
              reduced depth (RWKV-6 2 layers, RecurrentGemma 3, qwen1.5-0.5b,
              starcoder2-3b and hubert-xlarge 2), float32, a 128-token prefill
              (hubert: a forward over 128 frames) on the card against the
              same on the CPU (the plain versions), and for the
              two dense LMs a 4096-token one (the flash scan, the blocked
              local path): last logits and every cache leaf within
              1e-3 * max|.|. The gradient path's K2 programs (every
              conformance sweep's adjoint and augmented forward, up to 9
              inputs and 6 outputs) at the padded paper and ragged grids,
              f32 and bf16, bit-equal; make_vjp (all 11 programs x k = 1..3)
              and hdiff_fused_ad's dpsi on the card bit-equal to the same
              calls on the CPU, its dcoeff within 1e-5; the trainer's first
              gradient at 3x70x90 bit-equal to the CPU's and its 5-step loss
              trajectory within 1e-4 (the mean and the clip's norm are
              reductions)
  main        the hdiff path with the launch counters reset just before it:
              CompoundStencil(hdiff) under its three policies, a 100-step
              run_simulation with hdiff_fused (K1), 50 hdiff_twostep calls
              (K2) and a 100-step int32 fixed-point run (K3); the counters
              must read exactly 100 / 51 / 100 afterwards
  elementary  the §3.5 path (fig11 on the card) with the counters reset
              just before it: 10 sweeps (laplacian: 1) of each 2-D stencil
              through stencil2d (K4) and lower_cuda (K2), 10 jacobi1d sweeps
              through jacobi1d (K5) and lower_cuda (K5'), 5 calls of
              lower_cuda(repeat(jacobi1d, 2)); the counters must read exactly
              41 / 41 / 10 / 15; then the lower_cuda legs again outside the
              count and uninstrumented (the counted ones synchronise per
              call for the obs phase), each bit-equal to its counted leg, so
              their host time per sweep compares with stencil2d's and
              jacobi1d's; every leg equal to the same sweeps of its
              plain version, the three routes (hand-written kernel,
              lower_reference, IR kernel) within 1e-5 after one sweep, the
              derived op counts equal to ELEMENTARY_SPECS
  trace       one torch.profiler trace (build/repro_torch/trace/) of one
              synchronised launch each of K1, K2 and K4, then 10 K1 steps,
              5 hdiff_twostep calls and 10 K4 sweeps: calls and device time
              per kernel name and the device's busy share; fails unless K1,
              K2 and K4 each show device time (it runs before serve: behind
              serve's profiled windows a trace once recorded no device time)
  grad        the gradient path with the launch counters reset just before
              it: fit_coefficient_field (AdamW, lr 3e-3, backend "cuda") at
              64x256x256, 20 steps at k = 1 then 5 at k = 2, then one
              hdiff_fused_ad forward and backward; K2 must count exactly
              1 + 3 x 20 = 61, then 1 + 5 x 5 = 26, then K1 = 1 and K2 = 2,
              and its N-output launches (augmented forwards and adjoints,
              counted at the launch under their own key) 40, 20 and 2;
              every loss finite, the best below the first, the boundary
              ring's coefficients still exactly 0.025; seconds per step,
              the loss ratio, one profiled step's device busy share and the
              tile and frames of each K2 program
  serve       each LM in turn at its published shapes, random weights from
              the seed, with the launch counters reset just before its
              serving run: BatchedServer(lanes=4, max_len=1024; 4112 for
              qwen1.5-0.5b), 8 requests of 512, 256, 128, 64, 512, 256, 192
              and 100 tokens (qwen1.5-0.5b: and one of 4096, which takes the
              flash scan in each of its 24 layers, counted), 16 new tokens
              each; then the MoE LMs and llama-3.2-vision the same way,
              depth cut to fit the card (``reduced``): qwen3-moe-235b-a22b 4
              of 94 layers, arctic-480b 1 of 35, llama-3.2-vision-90b 5 of
              100 (one superblock with its cross_attn layer; served without
              media, as the JAX server serves it); the counters must read
              exactly K7 = 7 x 32 = 224 (the 100-token prompt takes the
              sequential path), K6 = 8 x 18 = 144 and no kernel for the
              dense, MoE and vision LMs; every
              request finishes and every logit is finite; seconds per
              prefill by length, per decode step and per token, tokens/s
              and GB of parameters; then, at float32 (an MoE LM dropless:
              capacity factor 64), a 128-token prefill plus 64 decode steps
              against one 192-token prefill (last logits and every cache
              leaf within 1e-3 * max|.|; not for llama-vision, whose
              memory-less prefill attends to the whole prompt in its cross
              layers);
              then steady state: three synchronised 512-token prefills, 20
              decode tokens, and one torch.profiler window of each (device
              busy share, the six kernels with the most device time, and
              the device time of K6 / K7 themselves); the
              bytes a decode token's operations move, casts included, and
              their time at 3.35 TB/s, the decode token's floor, and the
              port's analytic bound of a 512-token prefill and a decode
              token (``analytic_bound``). llama-vision's media path
              (``serve_media``): every cross gate set to 0.5, at float32 a
              512-token prefill against memory (1, 1024, 8192) and 16
              decode tokens held to one 528-token prefill within 1e-3 *
              max|.|, other memory moving the logits by more than 1e-3 of
              their largest; then at bf16 the same, counted (no kernel),
              timed, profiled, with its bytes floor and bounds. Then
              starcoder2-3b (3.0 G parameters): one 4096-token prefill
              through the blocked local path (window 4096, 256-token blocks,
              counted in each of its 30 layers), finite logits, seconds
  encode      hubert-xlarge at its published widths and depth (48 layers,
              0.95 G parameters) from the seed, bf16 compute, frames from
              the seed: ``lm_forward`` at (4, 512) and (1, 4096) frames,
              three synchronised calls each with the counters reset just
              before (no kernel), the flash scan counted (48 calls a
              forward at 4096 frames, each without a causal mask; none at
              512), finite logits, a profiled call's busy share and the
              analytic bound; the bidirectional check at float32 (one
              channel of the last frame moves the first position's logits)
  obs         the port's metrics registry, enabled around the elementary
              phase's lower_cuda calls: call counters against the calls made
              and the launch counters, each timer's mean beside the device
              time per launch, CUDA-graph capture stepping aside, and
              runtime_metadata()
  timing      per kernel, at 64x256x256 / (16384, 256) and at 80x1024x1024 /
              (81920, 1024) (which exceed the 50 MB L2): device time per
              launch (a launch that moves under twice the L2 is timed cold:
              median of 25 event-timed launches, each after a 200 MB read
              that evicts L2, so the device-memory bound holds; a larger one
              by the median of 25 CUDA-graph replays of 10 launches, after
              warm-up; every row of the kernels line is held to be no faster
              than its bound), the plain version's time (median of 20
              event-timed calls), the least time the card could take (bytes over
              3.35 TB/s or operations over the peak rate, whichever is
              larger), the achieved bytes/s and, for K4/K5/K5', one library
              call computing the same interior (conv2d / conv1d, TF32 off);
              K5' at k = 1, 2 (what the elementary path launches) and 3;
              K7 at (1, 512, 40, 64) and (8, 4096, 40, 64) and K6 at
              (1, 512, 2560) and (8, 4096, 2560), with no library yardstick;
              K2's N-output form on hdiff_coupled's augmented forward and
              adjoint at the padded 64x260x260 and 80x1028x1028, their bytes
              bound counting each input an op reads, the ring of an input
              that only seeds an output's ring, and each output
  sharded     the rows x cols decomposition (``lower_sharded``) on the card.
              (a) In this process, K2's offset mode shard by shard: hdiff
              k = 1-3, shallow_water and hdiff_coupled at 64x256x256 on
              the 2x4 and 4x2 partitions, every slab that ``lower_sharded``
              launches on each shard (the halo-padded block with zeros past
              the grid edge; under overlap the interior and the four edge
              bands) launched with its global offsets, its kept region
              bit-equal to the plain version with the same offsets and to
              the same region of the unsharded launch; hdiff_coupled's
              augmented forward and adjoint on each 2x4 shard's padded
              block (the zero-boundary backward) bit-equal to their plain
              versions; one shard's padded-block launch timed by CUDA-graph
              replays, also at 80x1024x1024, against the bound of what the
              shard keeps (the slab read once, the kept region written once,
              each sweep's operations on the points later sweeps need).
              (b) Eight gloo ranks spawned
              after the build, all on the one card, each running
              ``lower_sharded`` over ``make_mesh((2, 4), ("rows", "cols"),
              backend="gloo")`` at 64x256x256 with the launch counters
              reset just before: hdiff k = 1-3 (overlap off, then on),
              shallow_water with the merged exchange, and two value-and-grad
              steps of ``build_backend(hdiff_coupled, "sharded-cuda",
              differentiable=True)``; every rank's K2 count must be exact.
              The gathered results must be bit-equal to single-process
              ``lower_cuda`` (gradients to single-process ``cuda``), overlap
              bit-equal to no overlap, and the bytes every rank sent per
              round equal to the wire models (1,060,864 B at hdiff k = 1).
              Also 3 ensemble members of hdiff k = 1 through
              ``lower_batched(backend="sharded-cuda", mesh_shape=(2, 4))``,
              folded into each block's depth: one K2 launch a step on every
              rank, each member bit-equal to the unbatched sharded call and
              to one-process ``lower_cuda``, 3 x 1,060,864 = 3,182,592 B a
              round; its shard's batched launch timed in this process.
              Host seconds per step and per exchange round are 8 gloo ranks
              time-sharing one H100 with the bands staged through host
              memory: not a multi-GPU figure
  forecast    ensemble batching and forecast serving. (a) Parity:
              ``lower_batched(backend="cuda")`` on hdiff k = 1 and 2,
              shallow_water and hdiff_coupled at N = 1, 3, 8 members of
              64x256x256 f32, N = 3 in bf16 and on 3x250x190: one K2 launch
              a call (N outputs for shallow_water), bit-equal to the plain
              version on the folded fields and, member by member, to
              unbatched launches; K1, K2 (hdiff x2, shallow_water), K3 and
              K4 at 65537x12x12, past the grid's 65535 planes: two launches
              each, bit-equal. (b) Serving, counted: ForecastServer(
              backend="cuda") serves 8 forecasts of repeat(hdiff, 2) at
              max_batch 1, 2, 4, 8 at the paper grid and at fig14's nowcast
              tile (1, 64, 64), rounds interleaving the batch sizes (best
              round each, every result released after its drain, then
              every result kept as the server keeps its retired requests:
              forecasts/s, ms per step, its device work (the batched K2
              launch's µs from CUDA-graph replays against its bytes bound,
              the stack's copy by CUDA events) and the host's, the rest;
              submit ms a forecast), then 8 members
              each of shallow_water and
              hdiff_coupled; K2 must count one launch a batch; every served
              result bit-equal to lower_cuda on that member alone. (c)
              fig14's cache schedule on a fresh cache: 4 misses, 4 hits,
              rate 0.5, 4 signatures, no kernel loaded or built in the warm
              wave. (d) 8 members, one NaN-poisoned: it fails alone with
              NumericsError, the other 7 bit-equal to a run without it;
              the probes make one field_stats launch and read seven
              scalars each. (e) The probe's kernel (field_stats) on a
              served COSMO-E member, (301, 390, 582) float32 as batch[1]:
              counts, min and max equal to its plain version's on the
              CPU, mean and L2 within 1e-6, two launches bit-equal; warm (graph
              replays) and cold µs beside its one-read bound, the plain
              version's ms; it joins the kernels line
  driver      the shallow-water weather driver
              (``examples/torch_weather_simulation.py``, M12) at 64x256x256,
              50 steps: (a) ``--devices 1 --inner cuda`` through its
              ``run`` entry point with the counters reset just before: one
              N-output K2 launch a step, exactly; the step it builds
              (``lower_sharded`` on a one-rank mesh) bit-equal to
              ``lower_cuda`` at every step (and to the plain version on the
              first two), its final fields equal; the 50 MB {u, v, h}
              checkpoint's write and read seconds. (b) The ``--health``
              drill of the reference test on 2 gloo ranks through the
              command line: exit 3, ``BLOWUP_DETECTED step=9 field=h
              nan_count=1``, a COMMITted step-6 checkpoint equal to the
              6-step state, probes of u, v, h and one blow-up in the flight
              recorder. (c) ``--devices 8``: 8 gloo ranks time-sharing the
              card, 50 K2 launches each (offset mode), the gathered fields
              equal to ``--devices 1``'s; host ms a step (one exchange round
              a step), and the round alone (posting, then waiting; median
              of 20 a rank) on the same 4x2 plan in 8 ranks of its own: not
              a multi-GPU figure
  release     the stencil, forecast and driver phases' tensors still named
              in ``main`` dropped (their names bound to None): what the
              garbage collector reaches on the card before and after
              (``live_cuda_tensors``)
  serve_full  ``glm4-9b`` and ``nemotron-4-15b`` served whole on the card at
              published widths and depth (9.4 G and 15.6 G float32
              parameters): at the published config a 512-token prefill and 8
              decode tokens, twice (the first warms up), the prefill's and
              the decode steps' peaks less the bytes held before the model
              was built against the dry run's one-card predictions within
              0.85-1.15, seconds per prefill and per decode token beside the
              analytic bound; then the same at float32 compute
  serve_tp    tensor-parallel serving (``lm_prefill`` / ``lm_decode`` under
              ``use_mesh``) on 4 gloo ranks time-sharing the card (TF32
              off), a (1, 4) ``("data", "model")`` mesh, at float32 compute:
              ``recurrentgemma-2b`` (K6 on 640 channels a rank, the ring
              cache split, 10 heads replicated), ``qwen1.5-0.5b``,
              ``glm4-9b`` (2 kv heads replicated), ``nemotron-4-15b``,
              ``llama-3.2-vision-90b`` at 5 of 100 layers with its media
              path (the cross cache's 1024 media tokens split) and
              ``rwkv6-3b`` (K7, the time mix whole on every rank), each at
              its published widths, cut to 3-5 layers (time; llama-vision:
              one superblock with its media path): each rank
              draws its pieces from the seed (one rank at a time), a
              512-token prefill and 8 decode tokens into a cache of 520
              positions; the logits within 1e-3 of max|.| of the one-process
              logits at the same depth (computed first, kept on the host),
              each rank's prefill peak against the dry run's prediction for
              that rank on (1, 4) within 0.85-1.15, a decode step's
              collectives equal to ``serve_wire_reckoning`` row for row, K6
              bit-equal and K7 within 1e-5 * max|y| + 1e-6 of their plain
              versions at every launch, exactly one K6 an RG-LRU layer and
              one K7 an RWKV-6 layer a rank (summed into the kernels line),
              seconds a prefill and a decode token a rank. Host times are
              ranks sharing one H100 through host memory: not a multi-GPU
              figure; NCCL is written and unmeasured (one card)
  train       LM training with K6 and K7 differentiable: (a) K6 under
              autograd at (4, 256, 2560) and (8, 4096, 2560): the forward
              bit-equal to the plain version, the backward (K6 on reversed,
              shifted time) bit-equal to the plain reverse recurrence and
              within 1e-5 relative of autograd through the plain forward,
              timed; K6 at 65537x4x32, K7 at batch and heads 65537 and K7's
              backward at batch 65537, two launches each; K7 and its
              backward timed cold at the trainer's (4, 256, 40, 64); (b) a
              RecurrentGemma, an RWKV-6 (128 tokens, two chunks), a
              llama-vision (memory in every batch, its gates at 0.5) and a
              hubert (frames) smoke-config train step at
              f32 on the card (the second, at the full learning rate) within
              2e-4 of the CPU's, each parameter's step delta within 1e-2 of
              its largest on the CPU; (c) ``train()`` on
              ``recurrentgemma-2b`` at its published widths (26 layers,
              f32 masters, bf16 compute, remat), 4 steps of batch 4 x 256
              tokens with the counters reset just before: K6 exactly 3
              launches per RG-LRU layer a step (forward, recompute,
              backward), finite losses and grad norms, host ms a step, peak
              memory, one profiled step's busy share; (d) the resume drill
              (6 steps, ``ckpt_every=2``, a rerun runs no step) and the
              SIGTERM drill (a checkpoint at step 3, the resumed run
              bit-equal to an uninterrupted one) at the smoke config; (e)
              ``train()`` on ``rwkv6-3b`` at its published widths (32
              layers, 3.1 G parameters, the time mix in f32), 4 steps of 4 x
              256 tokens, the RecurrentGemma trainer's state freed first:
              K7 exactly 64 launches a step (forward and remat recompute)
              and its backward 32, finite losses near ln 65536, peak
              memory, one profiled step's busy share; (f) ``train()`` on
              ``qwen1.5-0.5b`` at its published widths, the same schedule:
              no kernel launched, finite losses near ln 151936; (g)
              ``train()`` on ``qwen3-moe-235b-a22b`` at its published widths
              and 1 of 94 layers (3.70 G parameters), the same schedule: no
              kernel, finite losses near ln 151936, the profiled step's MoE
              aux loss above 0 (its peak: the in-place clip and the update
              slice by slice); (h) ``train()`` on ``arctic-480b`` at its
              published widths and 1 of 35 layers (14.1 G parameters, bf16
              weights and gradients, Adafactor), 3 steps: no kernel, finite
              losses near ln 32000, aux above 0, peak memory; (i)
              ``train()`` on ``hubert-xlarge`` at its published widths and
              depth (0.95 G parameters), 4 steps of 4 x 256 frames: no
              kernel, finite losses near ln 504. Each full-width trainer
              prints its step's analytic bound. llama-vision is not trained
              at published widths: one superblock's 6.38 G parameters need
              about 89 GB of f32 masters, f32 gradients, bf16 moments and
              the bf16 compute copy
  moe_sharded the expert-parallel MoE (``apply_moe_sharded``) on 4 gloo ranks
              time-sharing the one card (TF32 off), ``("data", "model")``
              meshes (1, 4) and (2, 2): (a) a smoke MoE layer of each arch,
              float32, dropless, each rank holding its ``shard_moe_params``
              pieces and its block of the batch, gathered output within
              2e-4 and aux within 1e-5 relative of the local path; (b) a
              qwen3-moe smoke LM's loss, aux loss and every gradient
              through the sharded path on (1, 4) within 2e-4 of the local
              path's; (c) one qwen3-moe MoE layer at published widths on (1,
              4) (32 experts a rank), bf16, 4 x 256 tokens: rank 0's output
              within 4 bf16 steps of max|y| of the local layer, each sum
              over ``model`` exactly T_loc x D x 2 bytes, its host ms and
              the layer's; (d) the same layer on one decode token a row (4
              x 1): the expert-parallel path, whose only gather is the
              router's pieces (D x E/4 x 4 x 3 bytes a rank) and only sum
              the outputs (4 x D x 2 bytes), where a whole layer's gather
              once moved 7.2 GB a rank; no kernel launched. Host times are
              ranks sharing one H100 through host memory: not a multi-GPU
              figure
  train_sharded
              the LM trainer sharded over gloo ranks time-sharing the one
              card (TF32 off; each rank holds its pieces of every parameter,
              gradient and moment by the JAX rules and computes its rows of
              the global batch, and where ``model`` has several ranks its
              share of heads, kv heads, ``mlp``, RG-LRU width and
              vocabulary, tensor-parallel): (a) 4 ranks, the
              smoke ``qwen1.5-0.5b``, ``recurrentgemma-2b`` (K6),
              ``rwkv6-3b`` (K7, K7's backward), ``qwen3-moe-235b-a22b``,
              ``arctic-480b``, ``llama-3.2-vision-90b`` (memory in every
              batch) and ``hubert-xlarge`` (frames) at f32 (MoE dropless),
              remat, 2 microbatches,
              ``-100`` labels spread unevenly, 2 steps on each of (4, 1),
              (2, 2), (1, 4) ``("data", "model")``: every rank's loss and
              grad norm equal, within 1e-5 relative of one process's steps
              on the whole batch on the card (the second grad norm 5e-5),
              every parameter and moment gathered within 2e-4 (a bf16
              leaf: and 2^-8 of its value), the port kernels' launches
              exactly 3 K6, 2 K7 and 1 K7' a layer a microbatch on every
              rank, summed over the ranks into the kernels line; (b)
              ``qwen1.5-0.5b`` at published widths, cut to 4 of 24 layers
              (time), on (4, 1), 4 steps of 4 x 256 tokens: losses within
              1e-2 of one device's at that depth (bf16 compute), host ms a step
              (median of the ranks, slowest), peak GB a rank and summed,
              the bytes of gathers and gradient sums a rank a step equal to
              ``shard_wire_reckoning`` from the shapes; (c)
              ``qwen3-moe-235b-a22b`` at published widths, 1 of 94 layers,
              on (1, 2) (64 experts a rank), 3 steps of 4 x 256 tokens: the
              same figures, aux above 0. In (b) and (c) each rank runs one
              step more under torch.profiler, split into its device kernel
              time, its device copy time and its host time inside gloo's
              collectives; (d) tensor-parallel at published widths, f32, 2
              steps of 4 x 256 tokens on 4 ranks: ``recurrentgemma-2b``
              on (1, 4) (K6 on 640 channels a rank), ``rwkv6-3b`` cut to
              16 of 32 layers on (1, 4) (K7 and K7' whole a rank) and
              ``qwen1.5-0.5b`` on (2, 2), each first in one process on
              the card (rank 0, alone): losses, grad norms and every
              updated parameter against it (TP_BOUNDS), each rank's peak
              of the second step less the bytes held before against the
              dry run's prediction within 0.85-1.15, the second step's
              collectives equal to ``shard_wire_reckoning`` row for row,
              every K6 launch of the first step bit-equal to its plain
              version and every K7 and K7' launch within 1e-5·max + 1e-6,
              host s a step, the launches. Host times are ranks sharing
              one H100 through host memory: not a multi-GPU figure
dryrun        the port's dry run (``repro_torch.launch.dryrun``: one rank
              traced on meta tensors, nothing computed) of every
              full-width step the script ran, same config, depth, batch
              and length, on a (1, 1) mesh, in spawned children (their fake
              process groups never meet this process): the six trainers
              of the train phase at 4 x 256 tokens and llama-vision's
              512-token media prefill at 5 layers (``serve_media``). One
              line: each step's predicted peak, its measured
              ``max_memory_allocated`` less the bytes held before the
              step was built, and their ratio, which must lie within
              0.85-1.15; and what the garbage collector finds of the
              bytes held before the trainers (``live_cuda_tensors``)

Then the card's ``nvidia-smi`` line, the ``{"kernels": [...]}`` line (each
kernel's launches from the path that runs it), and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result; it also exits non-zero, before
anything else, without a CUDA device or without the repository's ``src/``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAPER_GRID = (64, 256, 256)
GRID_SPEC = (None, "rows", "cols")  # a rank's block of a grid: depth whole
RAGGED_GRID = (3, 250, 190)
BIG_GRID = (80, 1024, 1024)
# fig11's 1-D layout of the same domain: (depth * rows, cols).
PAPER_ROWS = (PAPER_GRID[0] * PAPER_GRID[1], PAPER_GRID[2])
BIG_ROWS = (BIG_GRID[0] * BIG_GRID[1], BIG_GRID[2])
LONG_ROW = (4, 4_194_307)
SMALL_GRAD = (3, 70, 90)  # make_vjp and the fit, card against CPU (the CPU side is eager)
GRAD_K2 = "stencil_program_cuda (N outputs)"  # K2's adjoint and augmented launches
FIT_STEPS, FIT_K2_STEPS, FIT_LR = 20, 5, 3e-3
FIT_TOL = 1e-4  # card vs CPU loss trajectory: the mean and the global norm are reductions
DCOEFF_TOL = 1e-5  # hdiff_fused_ad's scalar cotangent: a sum over the grid
ELEMENTARY_2D = ("jacobi2d_3pt", "laplacian", "jacobi2d_5pt", "jacobi2d_9pt", "seidel2d")
COEFF = 0.025
TOL = 1e-6
ROUTE_TOL = 1e-5  # two summation orders meet (tests/test_kernels_stencil2d.py's bound)
SEED = 2024
TRACE_DIR = ROOT / "build" / "repro_torch" / "trace"
K7_SERVE = (1, 512, 40, 64)  # rwkv6-3b prefill of 512 tokens: (B, T, H, N)
K7_BIG = (8, 4096, 40, 64)
K7_CHUNK = 64  # rwkv6-3b's rwkv_chunk
K6_SERVE = (1, 512, 2560)  # recurrentgemma-2b prefill of 512 tokens: (B, T, W)
K6_BIG = (8, 4096, 2560)
K7_TOL = 1e-5  # times max|y|, plus 1e-6: summation order in the four products
H100_TF32_TENSOR = 495e12  # FLOP/s, TF32 on the tensor cores, dense (H100 SXM data sheet)
ORACLE_TOL = 3e-4  # the JAX package's bound for the chunked kernel vs wkv6_ref
SLICE_TOL = 1e-3  # times max|.|: the whole model, card vs CPU or decode vs prefill
VISION_ARCH = "llama-3.2-vision-90b"
SERVE_ARCHS = ("rwkv6-3b", "recurrentgemma-2b", "qwen1.5-0.5b", "qwen3-moe-235b-a22b",
               "arctic-480b", VISION_ARCH)
# Depth cuts at published widths: qwen3-moe's 94 layers are 9.8 GB each in
# float32 (4 layers and the head: 44.2 GB), arctic's 35 are 27.3 GB each in
# bfloat16 (1 layer: 28.2 GB, and its float32 check casts a 17.9 GB expert
# stack), llama-vision's 100 are 3.4 GB each in float32 (one superblock of 4
# attn layers and its cross_attn, the least depth that holds one, and the
# embedding and head: 25.5 GB).
SERVE_LAYERS = {"qwen3-moe-235b-a22b": 4, "arctic-480b": 1, VISION_ARCH: 5}
MOE_DROPLESS = 64.0  # capacity factor of an MoE arch's decode-vs-prefill checks
MEDIA_GATE = 0.5  # every cross-attention gate on the media path (zero at init: a dead path)
MEDIA_PROMPT, MEDIA_NEW = 512, 16  # the media path's prompt and decode tokens
ENCODE_ARCH = "hubert-xlarge"
ENCODE_SHAPES = ((4, 512), (1, 4096))  # (batch, frames); the second past FLASH_THRESHOLD
SLICE_LAYERS = {"rwkv6-3b": 2, "recurrentgemma-2b": 3, "qwen1.5-0.5b": 2, "starcoder2-3b": 2,
                ENCODE_ARCH: 2}
LONG_PROMPT = 4096  # past FLASH_THRESHOLD: the flash scan (qwen1.5) or blocked local path
LONG_ARCHS = {"qwen1.5-0.5b": "_flash_fwd_scan", "starcoder2-3b": "_local_attention_blocked"}
SERVE_PROMPTS = (512, 256, 128, 64, 512, 256, 192, 100)
SERVE_NEW = 16
SHARD_MESH = (2, 4)  # the 8-rank run's rows x cols mesh
SHARD_PARTITIONS = ((2, 4), (4, 2))  # the one-process offset-mode check's splits
SHARD_STEPS = 5  # timed calls of each forward case on every rank
SHARD_GRAD_STEPS = 2
SHARD_TIMEOUT = 600  # seconds for the 8-rank spawn, start-up included
SHARD_MEMBERS = 3  # ensemble members of the sharded batched case
NOWCAST_GRID = (1, 64, 64)  # fig14's nowcast tile: (1, rows / 4, cols / 4) of the paper grid
DEEP_GRID = (65537, 12, 12)  # past the grid's 65535 planes: two launches of K1-K4
FORECAST_K = 2  # fig14 serves repeat(hdiff, 2)
N_FORECASTS = 8
# A served COSMO-E member (portbench's cosmo-e-hdiff-ens: 60 levels x five
# fields, 390 x 582), where the probe's field_stats kernel is timed.
ENSEMBLE_MEMBER = (301, 390, 582)
BATCH_SIZES = (1, 2, 4, 8)
FORECAST_WARMUP, FORECAST_ROUNDS = 2, 20  # fig14: rounds interleave the batch sizes
FORECAST_MEMBERS = (1, 3, 8)  # the batched parity cells at the paper grid
GRAD_TOL = 1e-5  # tests/conformance.py's relative gradient bound
DRIVER_STEPS = 50  # the weather driver's default forecast length
DRIVER_RANKS = 8  # its default --devices: gloo ranks time-sharing the one card
DRILL = ("--steps", "12", "--health", "--health-every", "3", "--inject-nan", "7",
         "--health-policy", "checkpoint-then-abort")  # the reference test's drill
TRAIN_ARCH = "recurrentgemma-2b"
TRAIN_STEPS = 4  # full-width trainer steps; the first includes the warm-up
TRAIN_BATCH, TRAIN_SEQ = 4, 256
K6_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 2560)  # the trainer's RG-LRU scan: (B, T, rnn_width)
K6_WIDE = (65537, 4, 32)  # past the grid's 65535 batch rows: two launches
K7_WIDE = ((65537, 16, 1, 8), (1, 16, 65537, 4))  # batch, then heads, past 65535
K7_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 40, 64)  # rwkv6-3b's WKV on the trainer's path
RWKV_TRAIN_ARCH = "rwkv6-3b"
DENSE_TRAIN_ARCH = "qwen1.5-0.5b"
MOE_TRAIN_ARCH = "qwen3-moe-235b-a22b"
MOE_TRAIN_LAYERS = 1  # 3.70 G parameters: f32 masters, bf16 AdamW moments, f32 grads
MOE_RANKS = 4  # the moe_sharded phase's gloo ranks, time-sharing the one card
MOE_MESHES = ((1, 4), (2, 2))  # ("data", "model")
MOE_TOL = 2e-4  # float32, sharded against local (the JAX package's sharded check)
MOE_TIMEOUT = 600  # seconds for the moe_sharded spawn, start-up included
TRAIN_TOL = 2e-4  # a trainer step, card vs CPU at float32 (tests/test_torch_train_lm.py)
DELTA_TOL = 1e-2  # each leaf's step delta, as a share of its largest (the same file)
ARCTIC_TRAIN_ARCH = "arctic-480b"
ARCTIC_TRAIN_LAYERS = 1  # 14.1 G parameters: bf16 weights and grads, Adafactor, sliced update
ARCTIC_TRAIN_STEPS = 3
SHARDED_RANKS = 4  # the train_sharded phase's gloo ranks, time-sharing the one card
SHARDED_MESHES = ((4, 1), (2, 2), (1, 4))  # ("data", "model"), part (a)
AUDIO_TRAIN_ARCH = ENCODE_ARCH  # frames (4, 256, 1280) a step
SHARDED_SMOKE = ("qwen1.5-0.5b", "recurrentgemma-2b", "rwkv6-3b", "qwen3-moe-235b-a22b",
                 "arctic-480b", VISION_ARCH, AUDIO_TRAIN_ARCH)
SHARDED_SMOKE_SEQ = {"rwkv6-3b": 128}  # two 64-step chunks: K7 and its backward run
SHARDED_BATCH, SHARDED_MB, SHARDED_STEPS = 8, 2, 2  # part (a): 1 row a rank a microbatch
SHARDED_DENSE_MESH, SHARDED_DENSE_STEPS = (4, 1), 4  # part (b): qwen1.5-0.5b on 4 ranks
SHARDED_DENSE_LAYERS = 4  # of 24: part (d) runs it at full depth tensor-parallel (time)
SHARDED_MOE_MESH, SHARDED_MOE_STEPS = (1, 2), 3  # part (c): qwen3-moe, 64 experts a rank
SHARDED_MOE_BATCH = TRAIN_BATCH  # rows of 256 tokens
SHARDED_LOSS_REL = 1e-5  # both losses and the first grad norm (tests/test_torch_train_sharded.py)
SHARDED_NORM2_REL = 5e-5  # the second grad norm, ranks against one process (same file)
SHARDED_FULL_LOSS = 1e-2  # bf16 compute: 4 ranks' rows against one device's whole batch
SHARDED_TIMEOUT = 900  # seconds for each spawn, start-up included
# Part (d): tensor-parallel training at published widths, f32 compute
# (arch, ("data", "model") mesh, layers: None the published depth). rwkv6
# is cut to 16 of 32 layers: the dry run puts a rank of (1, 4) at 29.38 GB
# at full depth (the time mix whole on every rank), 117.5 GB for the four
# sharing the card; at 16 layers 15.95 GB, 63.8 GB for the four.
TP_CASES = (("recurrentgemma-2b", (1, 4), None), ("rwkv6-3b", (1, 4), 16),
            ("qwen1.5-0.5b", (2, 2), None))
TP_STEPS = 2  # of TRAIN_BATCH x TRAIN_SEQ tokens: the first checked, the second measured
# Part (d)'s bounds against the one-process run on the card (f32), each
# case: (loss of step 1, loss of step 2, grad norm of step 1, of step 2,
# share of the updated elements off by more than half an update), relative;
# None: reported, not held. recurrentgemma and qwen1.5 read 0-1.3e-7 and
# at most 3.5e-10 of the elements (measured on one H100). RWKV-6 at
# published widths is chaotic in f32: its grad norm went 577 -> 193204 in
# one process and 570 -> 589 tensor-parallel from the same first loss
# (the second loss 2.6e-4 off, 20 % of the elements flipped by a step),
# as its bf16 trainer's goes 10988 -> 199839 in four steps.
TP_BOUNDS = {"rwkv6-3b": (1e-5, 1e-3, 5e-2, None, None)}
TP_DEFAULT_BOUNDS = (1e-5, 1e-5, 1e-5, 1e-5, 1e-6)
L2_BYTES = 50 * 2**20  # the H100's L2 (data sheet)
SERVE_TP_RANKS = 4  # the serve_tp phase's gloo ranks, time-sharing the one card
SERVE_TP_MESH = (1, SERVE_TP_RANKS)  # ("data", "model"): tensor-parallel over 4
SERVE_FULL_ARCHS = ("glm4-9b", "nemotron-4-15b")  # served whole at published depth too
SERVE_TP_ARCHS = ("recurrentgemma-2b", "qwen1.5-0.5b") + SERVE_FULL_ARCHS + (VISION_ARCH,
                                                                               "rwkv6-3b")
# One superblock of llama-vision with its media path; the others cut to
# a few layers (time: the gloo phases run host-bound; serve_full serves
# glm4 and nemotron whole, the serve phase the other three).
SERVE_TP_LAYERS = {VISION_ARCH: 5, "glm4-9b": 4, "nemotron-4-15b": 4,
                   "recurrentgemma-2b": 3, "qwen1.5-0.5b": 4, "rwkv6-3b": 4}
SERVE_TP_PROMPT = 512
SERVE_TP_STEPS = 8
SERVE_TP_LEN = SERVE_TP_PROMPT + SERVE_TP_STEPS  # cache positions: 130 slots a rank
SERVE_TP_TIMEOUT = 900  # seconds for the serve_tp spawn, start-up included
DRYRUN_BAND = (0.85, 1.15)  # predicted over measured peak, each full-width step
DRYRUN_TIMEOUT = 300  # seconds for the dry run's children, start-up included
DRYRUN_WORKERS = 4  # spawned children tracing the steps side by side (the card idles)

T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def graph_ms(fn, launches_per_graph=10, replays=25):
    """Device ms per launch of ``fn``: median over ``replays`` of a CUDA
    graph of ``launches_per_graph`` launches, timed with CUDA events."""
    import torch

    fn()  # warm-up (and the one-time shared-memory opt-in) outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches_per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches_per_graph)
    del graph
    return statistics.median(times)


def cold_ms(fn, reps=25):
    """Device ms of one call of ``fn`` with nothing of its inputs in L2:
    the median over ``reps`` event-timed calls, each after a read of a
    buffer of four times the L2 (it leaves L2 holding clean lines of that
    buffer) and a spin of the card that outlasts the host's enqueueing of
    the call, so the events time the device alone. For launches whose
    inputs would otherwise stay in L2 between CUDA-graph replays, where the
    device-memory bound would not hold."""
    import torch

    flush = torch.empty(4 * L2_BYTES // 4, dtype=torch.float32, device="cuda").normal_()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.sum()
        torch.cuda._sleep(1_000_000)  # about 0.5 ms at the card's clock
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del flush
    return statistics.median(times)


def kernel_ms(fn, nbytes, **graph_kw):
    """Device ms per launch of a kernel that moves ``nbytes``: cold
    (:func:`cold_ms`) when they fit in twice the L2, so the time is one the
    device-memory bound holds for; else from CUDA-graph replays
    (:func:`graph_ms`), whose launches evict each other's inputs."""
    return cold_ms(fn) if nbytes < 2 * L2_BYTES else graph_ms(fn, **graph_kw)


def event_ms(fn, reps=20):
    """Median ms of ``reps`` event-timed calls of ``fn`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_kernels(prof) -> dict:
    """``{kernel name: {"calls", "device_us"}}`` of a finished torch.profiler run."""
    import torch

    seen = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            seen[e.key] = {"calls": e.count, "device_us": dev_us}
    return seen


def moved_bytes(fn) -> int:
    """Bytes that ``fn``'s PyTorch operations read and write, each reading its
    tensor inputs once and writing its outputs once, weight casts included.
    Views move nothing, a gather reads only the rows it returns, and a copy
    into a buffer does not read the buffer: the least traffic of the eager
    path as written, so over the card's memory rate a floor on its time."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    aten = torch.ops.aten
    free = {aten._unsafe_view.default, aten.alias.default}
    gathers = {aten.index.Tensor, aten.embedding.default, aten.index_select.default}

    def size(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view or func in free:
                return out
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if func in gathers:
                read = size(ins[1:]) + size(outs)  # the table's rows that come out
            elif func is aten.copy_.default:
                read = size(ins[1:])
            else:
                read = size(ins)
            Count.total += read + size(outs)
            return out

    with Count():
        fn()
    return Count.total


def shard_slabs(i, j, rows, cols, h):
    """Every K2 launch ``lower_sharded`` makes on shard ``(i, j)`` of
    ``rows x cols`` blocks in column mode, as ``(name, row0, col0, R, C)``:
    the slab's first global row and column and its extent. The halo-padded
    block, and under overlap the unpadded interior and the four edge bands
    (``_edge_bands``'s slices and offsets). Each keeps ``[h, R-h) x [h, C-h)``."""
    r0, c0 = i * rows, j * cols
    return [("block", r0 - h, c0 - h, rows + 2 * h, cols + 2 * h),
            ("interior", r0, c0, rows, cols),
            ("top", r0 - h, c0 - h, 3 * h, cols + 2 * h),
            ("bottom", r0 + rows - 2 * h, c0 - h, 3 * h, cols + 2 * h),
            ("left", r0, c0 - h, rows, 3 * h),
            ("right", r0, c0 + cols - 2 * h, rows, 3 * h)]


def shard_bound_work(prog, depth, slab, grid):
    """``(bytes, operations)`` that one K2 launch on ``slab`` (``shard_slabs``'s
    tuple, float32) must spend on the region the shard keeps: each input an
    op reads over the whole slab once, an input that only seeds an output's
    ring over the kept points on the grid's ring, each output over the kept
    region once; and each sweep's operations on the points later sweeps need
    (the kept region grown by the later sweeps' radii), less the grid's ring
    of that sweep, which copies its input."""
    _, row0, col0, rows, cols = slab
    h = prog.radius

    def span(lo, hi, a, b):
        return max(0, min(hi, b) - max(lo, a))

    kr = (row0 + h, row0 + rows - h)
    kc = (col0 + h, col0 + cols - h)
    kept = depth * (kr[1] - kr[0]) * (kc[1] - kc[0])
    kept_ring = kept - depth * span(*kr, h, grid[0] - h) * span(*kc, h, grid[1] - h)
    read = {r.field for op in prog.ops for r in op.reads}
    words = sum(depth * rows * cols if f in read else kept_ring if f in prog.outputs else 0
                for f in prog.inputs)
    ops, later = 0, h
    for q in prog.chain:
        later -= q.radius
        ops += (depth * span(kr[0] - later, kr[1] + later, q.radius, grid[0] - q.radius)
                * span(kc[0] - later, kc[1] + later, q.radius, grid[1] - q.radius)
                * q.spec().flops)
    return 4 * (words + kept * len(prog.outputs)), ops


def _driver_round_body(rank, world, store, rounds=20):
    """Host seconds of the weather driver's exchange round alone on ``world``
    gloo ranks: its partition plan's mesh, its {u, v, h} blocks of the
    paper grid stacked into one message a direction (``lower_sharded``'s
    merged exchange, all three at radius 1), posted (the stack, the bands'
    copies to host memory, the isend/irecv calls), then waited for and the
    received bands copied back, after a barrier each round."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    import repro_torch.ir as ir
    from repro_torch.dist import shard_param, start_exchange
    from repro_torch.dist.halo import program_exchange_radii
    from repro_torch.launch.mesh import make_mesh

    prog = ir.shallow_water_program()
    plan = ir.plan_partition(prog, *PAPER_GRID, world)
    mesh = make_mesh(plan.mesh_shape, ("rows", "cols"), backend="gloo")
    gen = torch.Generator().manual_seed(SEED)
    blocks = [shard_param(torch.randn(PAPER_GRID, generator=gen), mesh, GRID_SPEC)
              .to(mesh.device)
              for _ in prog.inputs]
    (radius,) = set(program_exchange_radii(prog).values())
    secs = {"post": [], "wait": []}
    try:
        for i in range(rounds + 2):  # two warm-up rounds
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rnd = start_exchange([(torch.stack(blocks), radius)], mesh, "rows", "cols",
                                 pad_cols=plan.col_shards > 1)
            t1 = time.perf_counter()
            rnd.wait()
            torch.cuda.synchronize()
            if i >= 2:
                secs["post"].append(t1 - t0)
                secs["wait"].append(time.perf_counter() - t1)
        return {"mesh": list(plan.mesh_shape), **secs}
    finally:
        dist.destroy_process_group()


def _sharded_rank_body(rank, world, store):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    import repro_torch.ir as ir
    from repro_torch.dist import (count_wire, gather_blocks, gradient_halo_exchange_bytes,
                                  program_halo_exchange_bytes, shard_param, start_exchange)
    from repro_torch.ir.lower_cuda import KERNEL_N_OUT
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(SHARD_MESH, ("rows", "cols"), backend="gloo")
    dev = mesh.device
    depth, rows, cols = PAPER_GRID
    # The global fields, the same on every rank (a CPU generator from the seed).
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(PAPER_GRID, generator=gen)
    sw_prog, hc_prog = ir.shallow_water_program(), ir.hdiff_coupled_program()
    sw = {f: torch.randn(PAPER_GRID, generator=gen) for f in sw_prog.inputs}
    hc = {"u": torch.randn(PAPER_GRID, generator=gen),
          "coeff": 0.025 * (1.0 + 0.25 * torch.tanh(torch.randn(PAPER_GRID, generator=gen)))}
    wgt = torch.randn(PAPER_GRID, generator=gen)

    def local(a):
        return shard_param(a, mesh, GRID_SPEC).to(dev)

    xl, wl = local(x), local(wgt)
    swl = {f: local(a) for f, a in sw.items()}
    hcl = {f: local(a) for f, a in hc.items()}
    hdiff = {k: ir.repeat(ir.hdiff_program(), k) for k in (1, 2, 3)}
    axes = dict(depth_axis=None, row_axis="rows", col_axis="cols")
    fwd = {(k, ov): ir.lower_sharded(hdiff[k], mesh, overlap=ov, **axes)
           for k in (1, 2, 3) for ov in (False, True)}
    sw_fn = ir.lower_sharded(sw_prog, mesh, merge_exchange=True, **axes)
    # The ensemble: SHARD_MEMBERS members of hdiff k = 1, folded into each
    # block's depth, through the mesh_shape route of lower_batched.
    members = torch.stack([torch.randn(PAPER_GRID, generator=gen)
                           for _ in range(SHARD_MEMBERS)])
    ml = local(members)
    batched_fn = ir.lower_batched(hdiff[1], backend="sharded-cuda", mesh_shape=SHARD_MESH)
    grad_fn = ir.build_backend(hc_prog, "sharded-cuda", mesh=mesh, differentiable=True)

    def grad_step():
        leaves = {f: a.clone().requires_grad_(True) for f, a in hcl.items()}
        (grad_fn(leaves) * wl).sum().backward()
        return {f: a.grad for f, a in leaves.items()}

    def timed(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        return y, time.perf_counter() - t0

    cases = [(f"hdiff k={k}" + (" overlap" if ov else ""), lambda f=f: f(xl), SHARD_STEPS)
             for (k, ov), f in fwd.items()]
    cases += [("shallow_water merged", lambda: sw_fn(swl), SHARD_STEPS),
              ("hdiff_coupled value-and-grad", grad_step, SHARD_GRAD_STEPS),
              (f"hdiff k=1 batched x{SHARD_MEMBERS}", lambda: batched_fn(ml), SHARD_STEPS)]
    for _, fn, _ in cases:  # warm-up: libraries loaded, gloo pairs connected
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    _build.reset_launches()
    secs, outs, by_case = {}, {}, {}
    for label, fn, n in cases:
        before = dict(_build.LAUNCHES)
        for _ in range(n):
            outs[label], sec = timed(fn)
            secs.setdefault(label, []).append(sec)
        by_case[label] = {key: c - before.get(key, 0) for key, c in _build.LAUNCHES.items()
                          if c != before.get(key, 0)}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)

    # Outside the count: bytes per round, exchange time, checks.
    wire = {}
    for label, fn, prog in [(f"hdiff k={k}", fwd[(k, False)], hdiff[k]) for k in (1, 2, 3)] + [
            ("shallow_water merged", sw_fn, sw_prog)]:
        arg = swl if prog is sw_prog else xl
        with count_wire() as c:
            fn(arg)
        t = torch.tensor([c.sent_bytes, c.sent_messages, c.host_staged_bytes])
        dist.all_reduce(t)
        wire[label] = {"sent_bytes": int(t[0]), "messages": int(t[1]),
                       "host_staged_bytes": int(t[2]),
                       "model_bytes": program_halo_exchange_bytes(
                           prog, depth, rows, cols, SHARD_MESH[0], col_shards=SHARD_MESH[1])}
    with count_wire() as c:
        grad_step()
    t = torch.tensor([c.sent_bytes, c.sent_messages, c.host_staged_bytes])
    dist.all_reduce(t)
    wire["hdiff_coupled value-and-grad"] = {
        "sent_bytes": int(t[0]), "messages": int(t[1]), "host_staged_bytes": int(t[2]),
        "model_bytes": gradient_halo_exchange_bytes(hc_prog, depth, rows, cols,
                                                    mesh_shape=SHARD_MESH)}
    # The batched round: every member's bands in the same messages.
    with count_wire() as c:
        batched_fn(ml)
    t = torch.tensor([c.sent_bytes, c.sent_messages, c.host_staged_bytes])
    dist.all_reduce(t)
    wire[f"hdiff k=1 batched x{SHARD_MEMBERS}"] = {
        "sent_bytes": int(t[0]), "messages": int(t[1]), "host_staged_bytes": int(t[2]),
        "model_bytes": program_halo_exchange_bytes(hdiff[1], SHARD_MEMBERS * depth, rows,
                                                   cols, SHARD_MESH[0],
                                                   col_shards=SHARD_MESH[1])}
    # Each member of the batched result against the unbatched sharded call.
    batched_out = outs[f"hdiff k=1 batched x{SHARD_MEMBERS}"]
    members_same = torch.tensor([int(all(torch.equal(batched_out[i], fwd[(1, False)](ml[i]))
                                         for i in range(SHARD_MEMBERS)))])
    dist.all_reduce(members_same, op=dist.ReduceOp.MIN)
    batched_g = gather_blocks(batched_out, mesh)
    # One round of hdiff's halo-2 exchange alone: posting it (the bands'
    # copies to pinned host memory, a stream sync, the isend/irecv calls),
    # then waiting for it and copying the received bands back; and the same
    # round on host copies of the blocks, which gloo moves without staging.
    exchange_s = {"total": [], "post": [], "wait": [], "host_blocks": []}
    xh = xl.cpu()
    for _ in range(10):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rnd = start_exchange([(xl, 2)], mesh, "rows", "cols", pad_cols=True)
        t1 = time.perf_counter()
        rnd.wait()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        exchange_s["total"].append(t2 - t0)
        exchange_s["post"].append(t1 - t0)
        exchange_s["wait"].append(t2 - t1)
        _, sec = timed(lambda: start_exchange([(xh, 2)], mesh, "rows", "cols",
                                              pad_cols=True).wait())
        exchange_s["host_blocks"].append(sec)
    same = torch.tensor([int(all(torch.equal(outs[f"hdiff k={k} overlap"], outs[f"hdiff k={k}"])
                                 for k in (1, 2, 3)))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    gathered = {k: gather_blocks(outs[f"hdiff k={k}"], mesh) for k in (1, 2, 3)}
    sw_g = {f: gather_blocks(a, mesh) for f, a in outs["shallow_water merged"].items()}
    grad_g = {f: gather_blocks(a, mesh) for f, a in outs["hdiff_coupled value-and-grad"].items()}
    found = {"launches": launches, "by_case": by_case, "secs": secs, "exchange_s": exchange_s}
    if rank == 0:
        checks = {"overlap_bit_equal": bool(same),
                  "batched members bit_equal to unbatched sharded": bool(members_same)}
        one = ir.lower_cuda(hdiff[1])
        checks["batched bit_equal to one-process lower_cuda"] = all(
            torch.equal(batched_g[i], one(members[i].to(dev))) for i in range(SHARD_MEMBERS))
        for k in (1, 2, 3):
            want = ir.lower_cuda(hdiff[k])(x.to(dev))
            checks[f"hdiff k={k} bit_equal"] = torch.equal(gathered[k], want)
        want = ir.lower_cuda(sw_prog)({f: a.to(dev) for f, a in sw.items()})
        checks["shallow_water bit_equal"] = all(torch.equal(sw_g[f], want[f]) for f in want)
        single = ir.build_backend(hc_prog, "cuda", differentiable=True)
        leaves = {f: a.to(dev).requires_grad_(True) for f, a in hc.items()}
        (single(leaves) * wgt.to(dev)).sum().backward()
        checks["grad bit_equal"] = all(torch.equal(grad_g[f], leaves[f].grad) for f in leaves)
        checks["grad max_rel_err"] = max(
            ((grad_g[f] - leaves[f].grad).abs().max() / leaves[f].grad.abs().max()).item()
            for f in leaves)
        checks["finite"] = all(bool(torch.isfinite(a).all()) for a in
                               (*gathered.values(), *sw_g.values(), *grad_g.values(),
                                batched_g))
        found.update(checks=checks, wire=wire, n_out_key=KERNEL_N_OUT)
    dist.barrier()
    dist.destroy_process_group()
    return found


def _moe_rank_body(rank, world, store):
    """The expert-parallel MoE on ``world`` gloo ranks time-sharing the one
    card, each on a ``("data", "model")`` mesh (TF32 off). (a) One smoke MoE
    layer of each arch (float32, dropless) through ``apply_moe`` under each
    of MOE_MESHES against the local path on the whole batch. (b) One
    qwen3-moe smoke LM's loss, aux loss and gradients through the sharded
    path on ``(1, 4)`` against the local path's. (c) One qwen3-moe MoE layer
    at its published widths on ``(1, 4)`` (32 experts a rank) at bfloat16,
    4 x 256 tokens, timed, its sums over ``model`` counted by the metrics
    registry; rank 0 also runs the local layer on the whole weights. (d)
    The same layer on one decode token a row (4 x 1): the expert-parallel
    path, its gathers' and sums' bytes counted (the router's pieces and
    the combined outputs; no expert weight), timed; rank 0 against the
    local layer. No launch of a port kernel anywhere."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.dist.sharding import gather_blocks, shard_param, spec_for, use_mesh
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_lm, lm_params
    from repro_torch.models import layers as L
    from repro_torch.models.lm import lm_loss
    from repro_torch.obs import MetricsRegistry, metrics
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    meshes = {shape: make_mesh(shape, ("data", "model"), backend="gloo") for shape in MOE_MESHES}
    dev = meshes[MOE_MESHES[0]].device

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    found = {"forward": {}, "lm": {}, "full_width": {}}
    _build.reset_launches()
    try:
        # (a) Forward, both archs, every mesh.
        for i, arch in enumerate(("qwen3-moe-235b-a22b", "arctic-480b")):
            cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                                      capacity_factor=MOE_DROPLESS)
            whole = L.init_moe(cfg, L.Init(gen(SEED + i), L.dt(cfg), dev))
            x = torch.randn((4, 8, cfg.d_model), generator=gen(SEED + 10 + i), device=dev)
            y_ref, aux_ref = L._apply_moe_local(cfg, whole, x)
            for shape, mesh in meshes.items():
                xspec = spec_for(("batch", "seq", "embed"), mesh, x.shape)
                with use_mesh(mesh):
                    y, aux = L.apply_moe(cfg, L.shard_moe_params(cfg, whole, mesh),
                                         shard_param(x, mesh, xspec))
                y = gather_blocks(y, mesh, xspec)
                found["forward"][f"{arch} {shape}"] = {
                    "max_abs_err": (y - y_ref).abs().max().item(),
                    "aux_rel_err": abs(aux.item() - aux_ref.item()) / aux_ref.item()}
        # (b) Loss and gradients of a smoke LM, sharded against local.
        arch = "qwen3-moe-235b-a22b"
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
        tree = tree_map(lambda t: t.detach().clone(), lm_params(build_lm(cfg, SEED, device=dev)))
        toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=gen(SEED + 20), device=dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        mesh = meshes[(1, 4)]

        def loss_and_grads(sharded):
            t = tree_map(lambda a: a.clone(), tree)
            if sharded:
                for blk in t["blocks"]:
                    blk["ffn"] = L.shard_moe_params(cfg, blk["ffn"], mesh)
            leaves, treedef = tree_flatten(t)
            work = [a.requires_grad_(True) for a in leaves]
            with use_mesh(mesh if sharded else None):
                loss, m = lm_loss(cfg, tree_unflatten(treedef, work), batch)
            grads = tree_unflatten(treedef, list(torch.autograd.grad(loss, work)))
            if sharded:
                with torch.no_grad():
                    for blk in grads["blocks"]:
                        blk["ffn"] = L.gather_moe_params(cfg, blk["ffn"], mesh)
            return loss.item(), m["aux_loss"].item(), tree_flatten(grads)[0]

        loss_s, aux_s, g_s = loss_and_grads(True)
        loss_l, aux_l, g_l = loss_and_grads(False)
        found["lm"] = {"loss": [loss_s, loss_l], "aux_loss": [aux_s, aux_l],
                       "loss_abs_err": abs(loss_s - loss_l),
                       "grad_max_abs_err": max((a - b).abs().max().item()
                                               for a, b in zip(g_s, g_l)),
                       "grad_leaves": len(g_s)}
        del tree, g_s, g_l
        # (c) One layer at published widths, bfloat16, 32 experts a rank.
        cfg = get_config(arch)
        torch.cuda.synchronize()
        whole = L.init_moe(cfg, L.Init(gen(SEED + 30), L.dt(cfg), dev))
        mine = L.shard_moe_params(cfg, whole, mesh)
        if rank:
            del whole
        torch.cuda.empty_cache()
        x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen(SEED + 31),
                        device=dev, dtype=L.dt(cfg, "compute"))
        reg, secs = MetricsRegistry(), []
        for i in range(4):  # the first call includes the groups' set-up
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with use_mesh(mesh), metrics.using(reg if i else None), torch.no_grad():
                y, aux = L.apply_moe(cfg, mine, x)
            torch.cuda.synchronize()
            if i:
                secs.append(time.perf_counter() - t0)
        sums = reg.timers["dist.sum_over"].as_dict()
        found["full_width"] = {
            "experts_per_rank": mine["w1"].shape[0], "tokens": TRAIN_BATCH * TRAIN_SEQ,
            "layer_s_calls_1_3": secs, "sum_over_model": {
                "calls": sums["count"], "host_ms_mean": sums["mean_s"] * 1e3,
                "host_ms_max": sums["max_s"] * 1e3,
                "bytes_each": reg.counters["dist.sum_over.bytes"] / sums["count"],
                "t_loc_d_2": TRAIN_BATCH * TRAIN_SEQ * cfg.d_model * 2},
            "aux": aux.item(), "finite": bool(torch.isfinite(y).all()),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if rank == 0:
            with torch.no_grad():
                y_ref, aux_ref = L._apply_moe_local(cfg, whole, x)
            found["full_width"].update(
                max_abs_err=(y.float() - y_ref.float()).abs().max().item(),
                max_abs_ref=y_ref.float().abs().max().item(),
                aux_rel_err=abs(aux.item() - aux_ref.item()) / aux_ref.item())
        # (d) One decode token a row, the layer's weights where they are.
        x1 = x[:, :1].contiguous()
        reg1, secs1 = MetricsRegistry(), []
        for i in range(4):  # call 1 counted; calls 1-3 timed
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with use_mesh(mesh), metrics.using(reg1 if i == 1 else None), torch.no_grad():
                y1, _ = L.apply_moe(cfg, mine, x1)
            torch.cuda.synchronize()
            if i:
                secs1.append(time.perf_counter() - t0)
        mp = mesh.axis_size("model")
        layer_bytes = sum(w.numel() * w.element_size() for w in mine.values()) * mp
        found["one_token"] = {
            "tokens": x1.shape[0], "layer_s_calls_1_3": secs1,
            "gather_bytes": reg1.counters.get("dist.gather.bytes", 0),
            "sum_over_bytes": reg1.counters.get("dist.sum_over.bytes", 0),
            "router_piece_bytes": cfg.d_model * (cfg.n_experts // mp) * 4 * (mp - 1),
            "outputs_bytes": x1.shape[0] * cfg.d_model * x1.element_size(),
            "whole_layer_gather_bytes": layer_bytes * (mp - 1) // mp,
            "finite": bool(torch.isfinite(y1).all())}
        if rank == 0:
            with torch.no_grad():
                y1_ref, _ = L._apply_moe_local(cfg, whole, x1)
            found["one_token"].update(
                max_abs_err=(y1.float() - y1_ref.float()).abs().max().item(),
                max_abs_ref=y1_ref.float().abs().max().item())
        found["launches"] = dict(_build.LAUNCHES)
        dist.barrier()
        return found
    finally:
        dist.destroy_process_group()


def sharded_smoke_cfg(arch):
    """Part (a)'s config: the arch's smoke config at float32 compute, remat
    on, and dropless for the MoE archs (each data rank routes its own
    tokens: a capacity from a rank's tokens would drop others than one from
    the whole batch)."""
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32", remat=True)
    return dataclasses.replace(cfg, capacity_factor=MOE_DROPLESS) if cfg.n_experts else cfg


def sharded_batches(cfg, seq, n, seed):
    """``n`` global batches of SHARDED_BATCH rows for ``cfg``, labels
    ``-100`` unevenly over the rows (so over the ranks and microbatches),
    with ``cfg``'s media (:func:`with_media`)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size, (SHARDED_BATCH, seq + 1)).astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[0, :seq // 3] = -100
        labels[1, :seq - 1] = -100
        labels[5, 3:seq // 2] = -100
        labels[6, i] = -100
        out.append(with_media(cfg, {"tokens": toks[:, :-1].copy(), "labels": labels},
                              seed + 1 + i))
    return out


def _dryrun_job(job):
    """One job of the dryrun phase, in a spawned child: ``trace_step`` of
    ``(arch, layers, kind, seq, batch)`` (``layers`` None: the published
    depth) on a (1, 1) mesh of meta tensors, or of ``(arch, layers, kind,
    seq, batch, overrides, mesh, rank)`` (config fields replaced, rank
    ``rank`` of ``mesh``); returns its peak, argument bytes, peak
    categories and trace seconds. Touches no card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import trace_step

    arch, layers, kind, seq, batch, over, mesh, rank = tuple(job) + ({}, (1, 1), 0)[len(job) - 5:]
    cfg = dataclasses.replace(get_config(arch), **over)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    r = trace_step(cfg, ShapeConfig(kind, seq, batch, kind), mesh, rank=rank)
    mem = r["memory_analysis"]
    return {"peak_bytes": mem["peak_bytes"], "argument_bytes": mem["argument_bytes"],
            "peak_bytes_by_category": mem["peak_bytes_by_category"],
            "microbatches": r["meta"].get("microbatches"), "trace_s": r["timings_s"]["trace"]}


def live_cuda_tensors(top: int = 6) -> dict:
    """The CUDA tensors the garbage collector reaches (each storage once):
    their bytes beside ``memory_allocated``, and the largest by shape and
    dtype. What it does not reach is held outside Python objects."""
    import torch

    found = {}
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.Tensor) and obj.is_cuda:  # type(): no proxy's __class__
            st = obj.untyped_storage()
            found[st.data_ptr()] = (st.nbytes(), list(obj.shape), str(obj.dtype))
    largest = sorted(found.values(), key=lambda v: -v[0])[:top]
    return {"allocated_bytes": torch.cuda.memory_allocated(),
            "reached_bytes": sum(v[0] for v in found.values()), "storages": len(found),
            "largest": [{"bytes": n, "shape": shp, "dtype": d} for n, shp, d in largest]}


def _train_sharded_rank_body(rank, world, store, job):
    """The sharded LM trainer on ``world`` gloo ranks time-sharing the one
    card (TF32 off), or on the CPU when ``job["device"]`` is ``"cpu"`` (a
    rehearsal). ``job["part"]``: ``"smoke"`` runs SHARDED_STEPS steps of
    each of ``job["archs"]``' smoke configs (:func:`sharded_smoke_cfg`) on
    each mesh of ``job["meshes"]``, SHARDED_MB microbatches, and returns
    each case's metrics, its port-kernel launches and (rank 0) the
    parameters and moments gathered whole; ``"full"`` runs ``job["steps"]``
    steps of ``job["cfg"]`` on ``job["mesh"]`` over SyntheticLM batches of
    ``job["batch"]`` x TRAIN_SEQ tokens and returns the metrics, host
    seconds a step, peak memory and the bytes of gathers and gradient sums
    a step (the metrics registry's counters), then one step more under
    torch.profiler (:func:`_split_step`)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    cuda = job["device"] is None
    if cuda:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import MetricsRegistry, metrics
    from repro_torch.optim import optimizer_config_from_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.loop import train_shardings
    from repro_torch.tree import tree_leaves, tree_map

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def mesh_of(shape):
        return make_mesh(tuple(shape), ("data", "model"), backend="gloo", device=job["device"])

    try:
        found = {}
        if job["part"] == "tp":
            return _train_tp_cases(rank, job, mesh_of, sync)
        if job["part"] == "smoke":
            meshes = {tuple(m): mesh_of(m) for m in job["meshes"]}
            for arch in job["archs"]:
                cfg = sharded_smoke_cfg(arch)
                opt = dataclasses.replace(optimizer_config_from_model(cfg), warmup_steps=1)
                batches = sharded_batches(cfg, SHARDED_SMOKE_SEQ.get(arch, 32),
                                          SHARDED_STEPS, SEED)
                for shape, mesh in meshes.items():
                    params, state = init_train_state(cfg, seed=SEED, mesh=mesh)
                    step = make_train_step(cfg, opt, microbatches=SHARDED_MB, mesh=mesh)
                    out = {"loss": [], "grad_norm": []}
                    _build.reset_launches()
                    for batch in batches:
                        batch = {k: v.reshape((SHARDED_MB, -1) + v.shape[1:])
                                 for k, v in batch.items()}
                        params, state, m = step(params, state, batch)
                        out["loss"].append(float(m["loss"]))
                        out["grad_norm"].append(float(m["grad_norm"]))
                    sync()
                    out["launches"] = dict(_build.LAUNCHES)
                    p_sh, o_sh = train_shardings(cfg, mesh, opt)
                    wholes = tree_map(lambda t, sh: sh.whole(t).to("cpu", torch.float32),
                                      (params, state), (p_sh, o_sh))
                    out["whole"] = tree_map(lambda t: t.numpy(), wholes) if rank == 0 else None
                    found[f"{arch} {shape}"] = out
                    del params, state, wholes
            return found
        cfg, mesh = job["cfg"], mesh_of(job["mesh"])
        ds = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ, global_batch=job["batch"],
                                    vocab_size=cfg.vocab_size, seed=SEED))
        sync()
        t0 = time.perf_counter()
        params, state = init_train_state(cfg, seed=SEED, mesh=mesh)
        sync()
        init_s = time.perf_counter() - t0
        step = make_train_step(cfg, optimizer_config_from_model(cfg), mesh=mesh)
        reg = MetricsRegistry()
        out = {"init_s": init_s, "loss": [], "grad_norm": [], "aux_loss": [], "host_s": [],
               "gather_bytes": [], "grad_sum_bytes": [],
               "piece_gb": sum(t.numel() * t.element_size()
                               for t in tree_leaves((params, state))) / 1e9}
        _build.reset_launches()
        for i in range(job["steps"]):
            before = dict(reg.counters)
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            with metrics.using(reg):
                params, state, m = step(params, state, ds.batch_at(i))
                loss = float(m["loss"])
            sync()
            out["host_s"].append(time.perf_counter() - t0)
            out["loss"].append(loss)
            out["grad_norm"].append(float(m["grad_norm"]))
            out["aux_loss"].append(float(m["aux_loss"]))
            for k in ("gather", "grad_sum"):
                name = f"dist.{k}.bytes"
                out[f"{k}_bytes"].append(reg.counters.get(name, 0) - before.get(name, 0))
        out["launches"] = dict(_build.LAUNCHES)
        out["finite"] = bool(np.all(np.isfinite(out["loss"] + out["grad_norm"])))
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        dist.barrier()
        sync()
        out["split"] = _split_step(lambda: step(params, state, ds.batch_at(job["steps"])), sync)
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def tp_train_cfg(arch, layers):
    """Part (d)'s config: ``arch`` at published widths, float32 compute,
    ``layers`` deep (None: the published depth)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _train_tp_cases(rank, job, mesh_of, sync):
    """Part (d) of the train_sharded phase, in each rank (on the card):
    for each ``(arch, mesh, layers)`` of ``job["cases"]`` (:func:`tp_train_cfg`;
    ``job["cfgs"]`` may replace the configs, for a rehearsal on the CPU),
    first rank 0 alone runs TP_STEPS steps of the one-process trainer on
    SyntheticLM batches of ``job["batch"]`` x TRAIN_SEQ tokens from SEED and
    keeps its losses, grad norms and updated parameters on the host; then
    every rank runs the same steps tensor-parallel on the mesh from the
    same seed: the first with every K6, K7 and K7' launch held against its
    plain version on the same inputs, the second timed, its collectives
    tallied, its peak taken (``max_memory_allocated`` less the bytes held
    before the state was built). Rank 0 gathers each updated leaf and
    takes its largest error against the one-process run. Returns per case
    the metrics of both runs, the errors, the launches, the tally, the
    peaks and the host seconds a step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import gather_to_host, tally_collectives
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import ops as k6_ops
    from repro_torch.kernels.rglru import rglru_seq_ref
    from repro_torch.kernels.wkv6 import ops as k7_ops
    from repro_torch.kernels.wkv6 import wkv6_backward_plain, wkv6_plain
    from repro_torch.optim import optimizer_config_from_model
    from repro_torch.optim.optimizers import schedule_lr
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.loop import train_shardings
    from repro_torch.tree import tree_flatten

    errs = {}
    scan, fwd, bwd = k6_ops.rglru_scan_cuda, k7_ops.wkv6_cuda, k7_ops.wkv6_bwd_cuda

    def worst(name, err, bound=None):
        """The largest error of ``name``'s launches and its share of the bound."""
        was = errs.get(name, (0.0, 0.0))
        errs[name] = (max(was[0], err), max(was[1], err / bound if bound else 0.0))

    def checked_scan(a, b, h0):  # K6 (forward, recompute, backward): bit for bit
        out = scan(a, b, h0)
        worst("rglru_scan_cuda", max((o - w).abs().max().item()
                                     for o, w in zip(out, rglru_seq_ref(a, b, h0))))
        return out

    def checked_fwd(*args, chunk=64):  # K7: within K7_TOL of max|y| plus 1e-6
        out = fwd(*args, chunk=chunk)
        want = wkv6_plain(*args, chunk=chunk)
        for o, w in zip(out, want):
            worst("wkv6_cuda", (o - w).abs().max().item(),
                  K7_TOL * w.abs().max().item() + 1e-6)
        return out

    def checked_bwd(*args, chunk=64):  # K7': the same bound, each gradient
        out = bwd(*args, chunk=chunk)
        for o, w in zip(out, wkv6_backward_plain(*args, chunk=chunk)):
            worst("wkv6_bwd_cuda", (o - w).abs().max().item(),
                  K7_TOL * w.abs().max().item() + 1e-6)
        return out

    cuda = job["device"] is None

    def allocated():
        return torch.cuda.memory_allocated() if cuda else 0

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else 0

    def reset_peak():
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    def release():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def host_step(fn):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    found = {}
    for arch, shape, layers in job["cases"]:
        cfg = job.get("cfgs", {}).get(arch) or tp_train_cfg(arch, layers)
        opt = optimizer_config_from_model(cfg)
        ds = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ, global_batch=job["batch"],
                                    vocab_size=cfg.vocab_size, seed=SEED))
        ref = {"loss": [], "grad_norm": []}
        if rank == 0:  # the one-process run, the other ranks waiting
            reset_peak()
            held = allocated()
            params, state = init_train_state(cfg, job["device"], seed=SEED)
            step = make_train_step(cfg, opt)
            for i in range(TP_STEPS):
                params, state, m = step(params, state, ds.batch_at(i))
                ref["loss"].append(float(m["loss"]))
                ref["grad_norm"].append(float(m["grad_norm"]))
            ref["peak_gb"] = (peak() - held) / 1e9
            ref_leaves = [t.to("cpu", copy=True) for t in tree_flatten(params)[0]]
            del params, state, step, m
            release()
        dist.barrier()
        sync()
        held = allocated()
        mesh = mesh_of(shape)
        params, state = init_train_state(cfg, seed=SEED, mesh=mesh)
        step = make_train_step(cfg, opt, mesh=mesh)
        out = {"loss": [], "grad_norm": [], "host_s": [], "held_gb": held / 1e9}
        _build.reset_launches()
        errs.clear()
        k6_ops.rglru_scan_cuda, k7_ops.wkv6_cuda, k7_ops.wkv6_bwd_cuda = (
            checked_scan, checked_fwd, checked_bwd)
        try:
            (params, state, m), dt = host_step(lambda: step(params, state, ds.batch_at(0)))
        finally:
            k6_ops.rglru_scan_cuda, k7_ops.wkv6_cuda, k7_ops.wkv6_bwd_cuda = scan, fwd, bwd
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["host_s"].append(dt)
        del m
        gc.collect()
        reset_peak()
        with tally_collectives() as tally:
            (params, state, m), dt = host_step(lambda: step(params, state, ds.batch_at(1)))
        out["peak_gb"] = (peak() - held) / 1e9
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["host_s"].append(dt)
        out["launches"] = dict(_build.LAUNCHES)
        out["kernel_errs"] = dict(errs)
        out["tally"] = list(tally)
        out["finite"] = bool(np.all(np.isfinite(out["loss"] + out["grad_norm"])))
        # An update moves an element by at most lr_t a step (Adam's first
        # steps are sign-like): an element whose gradient lies within the
        # rounding of zero may move the other way in one run, a fault
        # moves most elements of a leaf. The share off by half an update.
        half = 0.5 * sum(float(schedule_lr(opt, torch.tensor(i + 1))) for i in range(TP_STEPS))
        err, off, numel = 0.0, 0, 0
        p_sh = tree_flatten(train_shardings(cfg, mesh, opt)[0])[0]
        for i, (t, sh) in enumerate(zip(tree_flatten(params)[0], p_sh)):
            # A leaf every rank holds whole (RWKV-6's time mix) is rank 0's own.
            whole = (t.to("cpu") if rank == 0 else None) if sh.replicas == mesh.size \
                else gather_to_host(t, sh)
            if whole is not None:
                diff = (whole.float() - ref_leaves[i].float()).abs()
                err, off, numel = (max(err, diff.max().item()), off + int((diff > half).sum()),
                                   numel + diff.numel())
        if rank == 0:
            out.update(ref=ref, param_max_abs_err=err, param_off_share=off / numel,
                       half_update=half)
            del ref_leaves
        found[f"{arch} {tuple(shape)}"] = out
        del params, state, step, m
        release()
        dist.barrier()
    return found


def serve_tp_cfg(arch):
    """The config ``arch`` is served with in the serve_tp phase: published
    widths, float32 compute (both paths then differ only in summation
    order), depth cut by SERVE_TP_LAYERS."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    if arch in SERVE_TP_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_TP_LAYERS[arch])
    return cfg


def serve_tp_inputs(cfg, dev):
    """``(tokens (1, SERVE_TP_LEN), memory (1, M, D) or None)`` on ``dev``,
    from a numpy seed: the prompt, then the decode tokens, teacher-forced."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, SERVE_TP_LEN))).to(dev)
    mem = None
    if cfg.frontend == "vision":
        mem = torch.from_numpy(rng.standard_normal((1, cfg.num_media_tokens, cfg.d_model)).astype(
            np.float32)).to(dev)
    return toks, mem


def serve_tp_run(cfg, params, cache, toks, mem, sync, tally=None, after_prefill=None):
    """One prefill of SERVE_TP_PROMPT tokens and SERVE_TP_STEPS decode
    tokens (under the caller's mesh, if any): ``(logits (steps + 1, V) on
    the card, prefill seconds, [seconds a decode token])``; the first
    decode step's collectives into ``tally`` (a list) when given;
    ``after_prefill()`` called between the prefill and the first step."""
    import torch

    from repro_torch.dist.sharding import tally_collectives
    from repro_torch.models import lm_decode, lm_prefill

    sync()
    t0 = time.perf_counter()
    logits, cache = lm_prefill(cfg, params, toks[:, :SERVE_TP_PROMPT], cache, memory=mem)
    sync()
    prefill_s, decode_s, out = time.perf_counter() - t0, [], [logits]
    if after_prefill is not None:
        after_prefill()
    for t in range(SERVE_TP_PROMPT, SERVE_TP_LEN):
        t0 = time.perf_counter()
        with tally_collectives() as rows:
            logits, cache = lm_decode(cfg, params, toks[:, t], cache, t, memory=mem)
        sync()
        decode_s.append(time.perf_counter() - t0)
        if tally is not None and t == SERVE_TP_PROMPT:
            tally.extend(rows)
        out.append(logits)
    return torch.cat(out), prefill_s, decode_s


def _serve_tp_rank_body(rank, world, store, job):
    """Tensor-parallel serving on ``world`` gloo ranks time-sharing the one
    card (TF32 off), a ``(1, world)`` ``("data", "model")`` mesh, or on the
    CPU when ``job["device"]`` is ``"cpu"`` (a rehearsal). For each arch of
    ``job["archs"]`` (:func:`serve_tp_cfg`; ``job["cfgs"]`` may replace
    them): the rank's pieces of the weights ``build_lm`` draws from SEED
    (``build_lm_pieces``, one rank at a time, so one whole leaf at most is
    transient on the card), llama-vision's gates at MEDIA_GATE, its pieces
    of a fresh cache of SERVE_TP_LEN positions; then the counted path
    (:func:`serve_tp_run` under ``use_mesh``), every K6 and K7 launch held
    against its plain version on the same inputs, the first decode step's
    collectives tallied, the decode steps timed; then the prefill again,
    timed, unchecked, its peak taken. Returns per arch: the logits (rank 0), launches,
    the kernels' errors, the pieces' bytes, the held bytes and the
    prefill's peak, the tally and the seconds."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    cuda = job["device"] is None
    if cuda:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import rglru_seq_ref
    from repro_torch.kernels.wkv6 import wkv6_plain
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import recurrent
    from repro_torch.models.lm import (build_cache, build_lm_pieces, cache_shardings, lm_prefill,
                                       shard_tree)
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda" if cuda else "cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def allocated():
        return torch.cuda.memory_allocated() if cuda else 0

    mesh = make_mesh((1, world), ("data", "model"), backend="gloo", device=job["device"])
    scan, wkv = recurrent.rglru_scan, recurrent.wkv6
    errs = {}

    def checked_scan(a, b, h0=None):  # K6 against its plain version, bit for bit
        out = scan(a, b, h0)
        want = rglru_seq_ref(a, b, torch.zeros((a.shape[0], a.shape[2]), device=a.device)
                             if h0 is None else h0)
        err = max((o - w).abs().max().item() for o, w in zip(out, want))
        errs["rglru_scan_cuda"] = max(errs.get("rglru_scan_cuda", 0.0), err)
        return out

    def checked_wkv(r, k, v, w, u, state0=None, *, chunk=64):  # K7, to K7_TOL of max|y|
        out = wkv(r, k, v, w, u, state0, chunk=chunk)
        want = wkv6_plain(r, k, v, w, u, state0, chunk=chunk)
        err = max((o - p).abs().max().item() for o, p in zip(out, want))
        rel = err / (K7_TOL * want[0].abs().max().item() + 1e-6)
        worst = errs.get("wkv6_cuda", (0.0, 0.0))
        errs["wkv6_cuda"] = (max(worst[0], err), max(worst[1], rel))
        return out

    try:
        found = {}
        for arch in job["archs"]:
            cfg = job.get("cfgs", {}).get(arch) or serve_tp_cfg(arch)
            sync()
            held = allocated()
            toks, mem = serve_tp_inputs(cfg, dev)
            for turn in range(world):
                if turn == rank:
                    params = build_lm_pieces(cfg, mesh, SEED, device=dev)
                    if cfg.frontend == "vision":
                        set_gates(params["blocks"], MEDIA_GATE)
                    sync()
                    if cuda:
                        torch.cuda.empty_cache()
                dist.barrier()
            whole = build_cache(cfg, 1, SERVE_TP_LEN, device=dev)
            c_sh = cache_shardings(cfg, mesh, whole)
            cache = shard_tree(whole, c_sh)
            del whole
            out = {"piece_gb": sum(t.numel() * t.element_size()
                                   for t in tree_leaves(params)) / 1e9,
                   "cache_gb": sum(t.numel() * t.element_size()
                                   for t in tree_leaves(cache)) / 1e9}
            errs.clear()
            tally = []
            _build.reset_launches()
            recurrent.rglru_scan, recurrent.wkv6 = checked_scan, checked_wkv
            try:
                with use_mesh(mesh), torch.no_grad():
                    logits, _, out["decode_s"] = serve_tp_run(cfg, params, cache, toks, mem,
                                                              sync, tally)
            finally:
                recurrent.rglru_scan, recurrent.wkv6 = scan, wkv
            sync()
            out.update(launches=dict(_build.LAUNCHES), kernel_errs=dict(errs), tally=tally,
                       finite=bool(torch.isfinite(logits).all()))
            out["logits"] = logits.float().cpu().numpy() if rank == 0 else None
            del logits
            # The prefill again on a fresh cache, timed and unchecked: its
            # peak less the bytes held before the pieces were drawn (the dry
            # run's arguments and step). The decode steps above call no
            # checked kernel: their seconds stand.
            cache = shard_tree(build_cache(cfg, 1, SERVE_TP_LEN, device=dev), c_sh)
            dist.barrier()
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with use_mesh(mesh), torch.no_grad():
                lm_prefill(cfg, params, toks[:, :SERVE_TP_PROMPT], cache, memory=mem)
            sync()
            out["prefill_s"] = time.perf_counter() - t0
            out["peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9 if cuda else None
            out["held_gb"] = held / 1e9
            found[arch] = out
            del params, cache, toks, mem
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            dist.barrier()
        return found
    finally:
        dist.destroy_process_group()


def serve_full_phase(dev, smi, predicted) -> list:
    """glm4-9b and nemotron-4-15b served whole on the card at published
    widths and depth: at the published config (bf16 compute) a prefill of
    SERVE_TP_PROMPT tokens and SERVE_TP_STEPS decode tokens twice (the
    first warms up), the prefill's and the decode steps' peaks less the
    bytes held before the model was built against the dry run's (1, 1)
    predictions (``predicted``: futures by ``(arch, kind)``), seconds per
    prefill and per decode token beside the analytic bound; then the same
    at float32 compute. Returns the phase's lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_cache, build_lm

    lines = []
    for arch in SERVE_FULL_ARCHS:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = build_lm(cfg, SEED, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        toks, _ = serve_tp_inputs(cfg, dev)
        peaks = {}

        def peak(kind):
            peaks[kind] = torch.cuda.max_memory_allocated() - held
            torch.cuda.reset_peak_memory_stats()

        runs = []
        for i in range(2):
            cache = build_cache(cfg, 1, SERVE_TP_LEN, device=dev)
            torch.cuda.reset_peak_memory_stats()
            logits, prefill_s, decode_s = serve_tp_run(
                cfg, model, cache, toks, None, torch.cuda.synchronize,
                after_prefill=(lambda: peak("prefill")) if i == 0 else None)
            if i == 0:
                peak("decode")
            check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
            runs.append({"prefill_s": prefill_s, "decode_s": decode_s})
            del cache, logits
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        ref, ref_prefill_s, ref_decode_s = serve_tp_run(
            cfg32, model, build_cache(cfg32, 1, SERVE_TP_LEN, device=dev), toks, None,
            torch.cuda.synchronize)
        check(bool(torch.isfinite(ref).all()), f"{arch}: non-finite float32 logits")
        line = {"phase": "serve_full", "arch": arch, "device": smi, "reduced": None,
                "params_gb": sum(p.numel() * p.element_size()
                                 for p in model.parameters()) / 1e9,
                "build_s": build_s, "held_before_gb": held / 1e9,
                "prompt": SERVE_TP_PROMPT, "decode_tokens": SERVE_TP_STEPS,
                "cache_positions": SERVE_TP_LEN, "runs": runs,
                "prefill_s": runs[1]["prefill_s"],
                "decode_s_per_token": statistics.median(runs[1]["decode_s"]),
                "float32": {"prefill_s": ref_prefill_s,
                            "decode_s_per_token": statistics.median(ref_decode_s)},
                "analytic_bound": {
                    "prefill": analytic_bound(cfg, "prefill", SERVE_TP_PROMPT, 1),
                    "decode": analytic_bound(cfg, "decode", SERVE_TP_LEN, 1)}}
        for kind in ("prefill", "decode"):
            pred = predicted[(arch, kind)].result(timeout=DRYRUN_TIMEOUT)
            ratio = pred["peak_bytes"] / peaks[kind]
            line[f"{kind}_peak"] = {"measured_gb": peaks[kind] / 1e9,
                                    "predicted_gb": pred["peak_bytes"] / 1e9, "ratio": ratio}
            check(DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1],
                  f"serve_full {arch} {kind}: predicted {pred['peak_bytes']} B against "
                  f"{peaks[kind]} B measured (band {DRYRUN_BAND})")
        lines.append(line)
        del model, ref, toks
        gc.collect()
        torch.cuda.empty_cache()
    return lines


def serve_tp_phase(dev, smi, predicted, run_ranks) -> tuple[list, dict]:
    """Tensor-parallel serving on SERVE_TP_RANKS gloo ranks time-sharing the
    card on SERVE_TP_MESH (:func:`_serve_tp_rank_body`) for every arch of
    SERVE_TP_ARCHS, against the one-process logits at the same config and
    depth (computed here first, on the card, and kept on the host before
    the ranks start):
    the logits within SLICE_TOL of their largest, each rank's prefill peak
    against the dry run's prediction for that rank on the mesh
    (``predicted``: futures by ``(arch, rank)``) within DRYRUN_BAND, a
    decode step's collectives equal to ``serve_wire_reckoning`` row for
    row, K6 bit-equal and K7 within K7_TOL of their plain versions at every
    launch, and the launches: exactly one K6 an RG-LRU layer and one K7 an
    RWKV-6 layer a rank (the prefill; a decode step is plain tensor code).
    Returns ``(lines, launches summed over the ranks and archs)`` with the
    kernels' worst errors under ``"errors"``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import ring_wire_bytes, serve_wire_reckoning
    from repro_torch.models import build_cache, build_lm

    refs = {}
    for arch in SERVE_TP_ARCHS:
        cfg = serve_tp_cfg(arch)
        model = build_lm(cfg, SEED, device=dev)
        if cfg.frontend == "vision":
            set_gates(model.blocks, MEDIA_GATE)
        toks, mem = serve_tp_inputs(cfg, dev)
        ref, _, _ = serve_tp_run(cfg, model, build_cache(cfg, 1, SERVE_TP_LEN, device=dev),
                                 toks, mem, torch.cuda.synchronize)
        refs[arch] = ref.cpu().numpy()
        del model, ref, toks, mem
        gc.collect()
        torch.cuda.empty_cache()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(_serve_tp_rank_body, SERVE_TP_RANKS, ROOT / "build" / "repro_torch",
                      {"device": None, "archs": SERVE_TP_ARCHS}, timeout=SERVE_TP_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    lines, total, errors = [], {}, {"rglru_scan_cuda": 0.0, "wkv6_cuda": 0.0}
    for arch in SERVE_TP_ARCHS:
        cfg = serve_tp_cfg(arch)
        want = {k: n for k, n in (("rglru_scan_cuda", cfg.layer_kinds.count("rglru")),
                                  ("wkv6_cuda", cfg.layer_kinds.count("rwkv6"))) if n}
        got = [r[arch] for r in ranks]
        ref = refs[arch]
        err = float(np.abs(got[0]["logits"] - ref).max())
        rel = err / float(np.abs(ref).max())
        check(got[0]["logits"].shape == ref.shape and all(g["finite"] for g in got)
              and rel <= SLICE_TOL, f"serve_tp {arch}: logits {rel} of max off one process")
        reckoning = sorted(serve_wire_reckoning(cfg, "decode", SERVE_TP_MESH, 1, 1,
                                                SERVE_TP_LEN))
        for r, g in enumerate(got):
            check(g["launches"] == want,
                  f"serve_tp {arch} rank {r}: launches {g['launches']}")
            check(sorted(g["tally"]) == reckoning,
                  f"serve_tp {arch} rank {r}: a decode step's collectives differ from "
                  f"serve_wire_reckoning")
            for name, n in g["launches"].items():
                total[name] = total.get(name, 0) + n
        k6 = max(g["kernel_errs"].get("rglru_scan_cuda", 0.0) for g in got)
        k7 = [g["kernel_errs"]["wkv6_cuda"] for g in got if "wkv6_cuda" in g["kernel_errs"]]
        check(k6 == 0.0, f"serve_tp {arch}: K6 {k6} off its plain version")
        check(all(rel7 <= 1.0 for _, rel7 in k7), f"serve_tp {arch}: K7 past K7_TOL: {k7}")
        errors["rglru_scan_cuda"] = max(errors["rglru_scan_cuda"], k6)
        errors["wkv6_cuda"] = max([errors["wkv6_cuda"]] + [e for e, _ in k7])
        per_rank = []
        for r, g in enumerate(got):
            pred = predicted[(arch, r)].result(timeout=DRYRUN_TIMEOUT)
            ratio = pred["peak_bytes"] / (g["peak_gb"] * 1e9)
            per_rank.append({"piece_gb": g["piece_gb"], "cache_gb": g["cache_gb"],
                             "peak_gb": g["peak_gb"], "predicted_gb": pred["peak_bytes"] / 1e9,
                             "ratio": ratio, "prefill_s": g["prefill_s"],
                             "decode_s_per_token": statistics.median(g["decode_s"])})
            check(DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1],
                  f"serve_tp {arch} rank {r}: predicted {pred['peak_bytes']} B against "
                  f"{g['peak_gb']} GB measured (band {DRYRUN_BAND})")
        lines.append({
            "phase": "serve_tp", "arch": arch, "device": smi, "mesh": list(SERVE_TP_MESH),
            "reduced": ({"n_layers": [get_config(arch).n_layers, cfg.n_layers]}
                        if arch in SERVE_TP_LAYERS else None),
            "compute_dtype": cfg.compute_dtype, "prompt": SERVE_TP_PROMPT,
            "decode_tokens": SERVE_TP_STEPS, "cache_positions": SERVE_TP_LEN,
            "logits_max_abs_err": err, "logits_rel_err": rel,
            "launches_per_rank": got[0]["launches"],
            "kernel_errs": {"rglru_scan_cuda": k6, "wkv6_cuda": k7},
            "decode_step_collectives": {
                "calls": len(reckoning), "payload_bytes": sum(b for _, b, _ in reckoning),
                "wire_bytes": sum(ring_wire_bytes(k, b, n) for k, b, n in reckoning),
                "equal_to_serve_wire_reckoning": True},
            "ranks": per_rank, "peak_gb_summed": sum(p["peak_gb"] for p in per_rank),
            "note": "gloo ranks time-sharing one H100 through host memory: not a multi-GPU "
                    "figure (NCCL refuses two ranks on one card)"})
    lines[0]["spawn_s"] = spawn_s
    return lines, {"launches": total, "errors": errors}


def _split_step(run, sync) -> dict:
    """Where one sharded step's time goes on this rank: ``run()`` under
    torch.profiler, its wall time, the device time of its kernels and of
    its copies (``Memcpy`` / ``Memset``, the gloo staging among them), and
    the host time inside ``torch.distributed.all_reduce`` / ``all_gather``
    (gloo's work on host tensors, waiting for the other ranks included;
    the staging copies stand outside it)."""
    import torch
    import torch.distributed as dist

    inside = {"s": 0.0, "calls": 0}
    real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def timed(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                inside["s"] += time.perf_counter() - t0
                inside["calls"] += 1
        return call

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    for n, fn in real.items():
        setattr(dist, n, timed(fn))
    try:
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            wall_s = time.perf_counter() - t0
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)
    seen = device_kernels(prof)
    copy_us = sum(v["device_us"] for k, v in seen.items() if k.startswith(("Memcpy", "Memset")))
    return {"wall_ms": wall_s * 1e3,
            "device_kernel_ms": (sum(v["device_us"] for v in seen.values()) - copy_us) / 1e3,
            "device_copy_ms": copy_us / 1e3,
            "collective_host_ms": inside["s"] * 1e3, "collective_calls": inside["calls"]}


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def model_err(label, got, want):
    """Max over (logits, cache leaves) of |got - want| / max|want|;
    integer leaves (slot positions) must be equal."""
    import torch

    worst_rel = 0.0
    for g, w in zip(leaves(got), leaves(want)):
        g, w = g.cpu(), w.cpu()
        check(g.shape == w.shape and g.dtype == w.dtype, f"{label}: leaf shape/dtype")
        if not w.is_floating_point():
            check(torch.equal(g, w), f"{label}: integer leaf differs")
            continue
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite values")
        scale = w.abs().max().item()
        rel = (g - w).abs().max().item() / scale if scale else (g - w).abs().max().item()
        worst_rel = max(worst_rel, rel)
    check(worst_rel <= SLICE_TOL, f"{label}: relative error {worst_rel} > {SLICE_TOL}")
    return worst_rel


@contextlib.contextmanager
def counting(name):
    """The keyword arguments of each call of ``repro_torch.models.layers.<name>``
    (an attention path of plain tensor code, which no launch counter sees)
    while the block runs."""
    from repro_torch.models import layers as lm_layers

    orig, calls = getattr(lm_layers, name), []

    def counted(*args, **kw):
        calls.append(kw)
        return orig(*args, **kw)

    setattr(lm_layers, name, counted)
    try:
        yield calls
    finally:
        setattr(lm_layers, name, orig)


def synced(fn):
    """``(fn(), host seconds)``, the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profiled_window(fn, n):
    """``n`` calls of ``fn`` (after one warm-up) under torch.profiler: the
    window's host µs, the device's busy µs and share, the six kernels with
    the most device time and the port's own recurrence kernels (K6, K7),
    listed whether or not they are among those six."""
    import torch

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    seen = device_kernels(prof)
    busy = sum(v["device_us"] for v in seen.values())
    top = sorted(seen.items(), key=lambda kv: -kv[1]["device_us"])[:6]
    return {"calls": n, "window_us": window_us, "device_busy_us": busy,
            "busy_share": busy / window_us, "top_kernels": {k[:60]: v for k, v in top},
            "port_kernels": {k[:60]: v for k, v in seen.items()
                             if "rglru_kernel" in k or "wkv6_" in k}}


def analytic_bound(cfg, kind, seq, batch) -> dict:
    """The least time of one ``kind`` step (``"train"``, ``"prefill"`` or
    ``"decode"`` at context ``seq``) of ``cfg`` (its own depth) on ``batch``
    rows of ``seq`` tokens by the port's analytic model
    (``repro_torch.launch.analytic``): the larger of its bytes
    (``cell_hbm_bytes``) at 3.35 TB/s and its FLOPs (``cell_flops``) at the
    dense rate of the compute dtype (bf16 on the tensor cores, 989 TFLOP/s;
    f32 67 TFLOP/s, TF32 being off here)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import H100_SXM
    from repro_torch.launch.analytic import cell_flops, cell_hbm_bytes

    shape = ShapeConfig(f"{kind}_{seq}", seq, batch, kind)
    flops, nbytes = cell_flops(cfg, shape)["analytic"], cell_hbm_bytes(cfg, shape)
    rate = H100_SXM.peak_flops_bf16 if cfg.compute_dtype == "bfloat16" else H100_SXM.peak_flops_f32
    t_bytes, t_ops = nbytes / H100_SXM.hbm_bw, flops / rate
    return {"ms": max(t_bytes, t_ops) * 1e3, "by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


def with_media(cfg, batch, seed):
    """``batch`` (numpy tokens and labels) with what ``cfg``'s frontend reads,
    drawn from a numpy ``seed``: ``memory`` (rows, M, D) beside the tokens
    for the vision frontend, frames (rows, S, D) in their place for the
    audio one; unchanged for a text LM."""
    import numpy as np

    if not cfg.frontend:
        return batch
    rng = np.random.default_rng(seed)
    out = dict(batch)
    if cfg.frontend == "audio":
        out["tokens"] = rng.standard_normal(np.shape(batch["tokens"]) + (cfg.d_model,)).astype(
            np.float32)
    else:
        rows = np.shape(batch["tokens"])[:-1]
        out["memory"] = rng.standard_normal(rows + (cfg.num_media_tokens, cfg.d_model)).astype(
            np.float32)
    return out


class MediaData:
    """A dataset's batches with ``cfg``'s media (:func:`with_media`, seeded
    by the step)."""

    def __init__(self, cfg, base):
        self.cfg, self.base = cfg, base

    def batch_at(self, step):
        return with_media(self.cfg, self.base.batch_at(step), SEED + step)


def set_gates(blocks, value):
    """Every cross-attention ``gate`` of ``blocks`` (a model's or a parameter
    tree's) set to ``value``, in place; returns how many."""
    import torch

    n = 0
    with torch.no_grad():
        for b in blocks:
            if "gate" in b["mixer"]:
                b["mixer"]["gate"].fill_(value)
                n += 1
    return n


def serve_media(cfg, model, dev, held: int) -> dict:
    """llama-vision's media path on the served model (its gates set to
    MEDIA_GATE): at float32, a MEDIA_PROMPT-token prefill against ``memory``
    (1, num_media_tokens, D) and MEDIA_NEW decode tokens, the last logits
    and every cache leaf held to one prefill of the whole within SLICE_TOL,
    and other memory moving the prefill's logits; then at the published
    compute dtype, counted (no port kernel), timed and profiled, with the
    decode token's bytes floor and the analytic bounds. Last, the step the
    dryrun phase predicts: one such prefill into a cache of MEDIA_PROMPT
    positions, its peak less ``held``, the bytes held before the model was
    built."""
    import numpy as np
    import torch

    from repro_torch.core import H100_SXM
    from repro_torch.kernels import _build
    from repro_torch.models import build_cache, lm_decode, lm_prefill

    gates = set_gates(model.blocks, MEDIA_GATE)
    check(gates == cfg.layer_kinds.count("cross_attn") and gates > 0, f"{gates} gates set")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    shape = (1, cfg.num_media_tokens, cfg.d_model)
    memory = torch.randn(shape, generator=gen, device=dev)
    other = torch.randn(shape, generator=gen, device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, MEDIA_PROMPT + MEDIA_NEW))).to(dev)
    max_len = 1024

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    first, cache = lm_prefill(cfg32, model, toks[:, :MEDIA_PROMPT],
                              build_cache(cfg32, 1, max_len, device=dev), memory=memory)
    last = first
    for t in range(MEDIA_PROMPT, MEDIA_PROMPT + MEDIA_NEW):
        last, cache = lm_decode(cfg32, model, toks[:, t], cache, t)
    want = lm_prefill(cfg32, model, toks, build_cache(cfg32, 1, max_len, device=dev),
                      memory=memory)
    decode_err = model_err(f"{cfg.name} media decode vs prefill", (last, cache), want)
    moved, _ = lm_prefill(cfg32, model, toks[:, :MEDIA_PROMPT],
                          build_cache(cfg32, 1, max_len, device=dev), memory=other)
    memory_rel = ((moved - first).abs().max() / first.abs().max()).item()
    check(memory_rel > 1e-3, f"{cfg.name}: other memory moved the logits by {memory_rel}")
    del cache, want, moved, first, last

    torch.cuda.reset_peak_memory_stats()

    def prefill():
        return lm_prefill(cfg, model, toks[:, :MEDIA_PROMPT],
                          build_cache(cfg, 1, max_len, device=dev), memory=memory)

    _build.reset_launches()
    prefill_s = [synced(prefill)[1] for _ in range(3)]
    (logits, cache), _ = synced(prefill)
    decode_s, finite = [], [torch.isfinite(logits).all()]
    for i in range(MEDIA_NEW):
        (logits, cache), sec = synced(lambda i=i: lm_decode(
            cfg, model, logits.argmax(-1), cache, MEDIA_PROMPT + i))
        decode_s.append(sec)
        finite.append(torch.isfinite(logits).all())
    check(not _build.LAUNCHES, f"{cfg.name} media path launched {dict(_build.LAUNCHES)}")
    check(bool(torch.stack(finite).all()), f"{cfg.name}: non-finite media logits")
    pos = MEDIA_PROMPT + MEDIA_NEW
    tok = logits.argmax(-1)
    decode_bytes = moved_bytes(lambda: lm_decode(cfg, model, tok, cache, pos))
    windows = {"prefill_512": profiled_window(prefill, 1),
               "decode": profiled_window(lambda: lm_decode(cfg, model, tok, cache, pos), 5)}
    out = {"gates": gates, "gate": MEDIA_GATE, "memory_shape": list(shape),
            "prompt": MEDIA_PROMPT, "new_tokens": MEDIA_NEW,
            "decode_vs_prefill_rel_err_f32": decode_err, "other_memory_rel_change": memory_rel,
            "prefill_512_s": prefill_s, "decode_token_s": {
                "median": statistics.median(decode_s), "min": min(decode_s),
                "max": max(decode_s)},
            "decode_bytes_gb": decode_bytes / 1e9,
            "decode_bound_ms": decode_bytes / H100_SXM.hbm_bw * 1e3,
            "analytic_bound": {"prefill_512": analytic_bound(cfg, "prefill", MEDIA_PROMPT, 1),
                               "decode": analytic_bound(cfg, "decode", pos, 1)},
            "profiled": windows, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "dryrun_step": None}
    del logits, cache
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm_prefill(cfg, model, toks[:, :MEDIA_PROMPT], build_cache(cfg, 1, MEDIA_PROMPT, device=dev),
               memory=memory)
    torch.cuda.synchronize()
    out["dryrun_step"] = {"peak_bytes": torch.cuda.max_memory_allocated(), "held_bytes": held}
    return out


def encode_phase(dev) -> dict:
    """hubert-xlarge at its published widths and depth from the seed,
    frames from the seed, with the launch counters reset just before each
    shape: ``lm_forward`` at each of ENCODE_SHAPES (bf16 compute), three
    synchronised calls; the flash scan's calls counted (one a layer a call
    past FLASH_THRESHOLD, each without a causal mask), no port kernel;
    finite logits; a profiled call's busy share; the analytic bound; then
    the bidirectional check at float32: one channel of the last frame
    moves the first position's logits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_lm, lm_forward
    from repro_torch.models import layers as lm_layers

    cfg = get_config(ENCODE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, build_s = synced(lambda: build_lm(cfg, SEED, device=dev))
    params_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    runs = {}
    for b, s in ENCODE_SHAPES:
        frames = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
        _build.reset_launches()
        secs = []
        with counting("_flash_fwd_scan") as calls:
            for _ in range(3):
                (logits, _), sec = synced(lambda: lm_forward(cfg, model, frames))
                secs.append(sec)
        want_calls = 3 * cfg.n_layers if s > lm_layers.FLASH_THRESHOLD else 0
        check(len(calls) == want_calls and not any(c["causal"] for c in calls),
              f"{cfg.name} {b}x{s}: {len(calls)} flash calls (want {want_calls}), causal "
              f"{[c['causal'] for c in calls][:1]}")
        check(not _build.LAUNCHES, f"{cfg.name} launched {dict(_build.LAUNCHES)}")
        check(tuple(logits.shape) == (b, s, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), f"{cfg.name} {b}x{s}: logits")
        runs[f"{b}x{s}"] = {"batch": b, "frames": s, "forward_s": secs,
                            "frames_per_s": b * s / min(secs),
                            "flash_scan_calls_per_forward": len(calls) // 3,
                            "analytic_bound": analytic_bound(cfg, "prefill", s, b),
                            "profiled": profiled_window(lambda: lm_forward(cfg, model, frames),
                                                        1)}
        del frames, logits
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    x = torch.randn((1, 64, cfg.d_model), generator=gen, device=dev)
    x2 = x.clone()
    x2[:, -1, 0] += 1.0
    l1, _ = lm_forward(cfg32, model, x)
    l2, _ = lm_forward(cfg32, model, x2)
    first_change = (l2[:, 0] - l1[:, 0]).abs().max().item()
    check(first_change > 1e-6, f"{cfg.name}: the last frame did not move the first position")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model
    return {"arch": cfg.name, "layers": cfg.n_layers, "params_gb": params_gb,
            "build_s": build_s, "compute": cfg.compute_dtype, "runs": runs,
            "bidirectional_first_position_change": first_change, "peak_gb": peak_gb}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; run on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import repro_torch.ir as ir
    from repro_torch.core import (
        ELEMENTARY_SPECS,
        H100_SXM,
        H100_SXM_INT32_OPS,
        make_hdiff_compound,
        make_initial_field,
        run_simulation,
    )
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import shard_wire_reckoning
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.kernels.hdiff import hdiff_fixed, hdiff_fused, hdiff_fused_ad, hdiff_twostep
    from repro_torch.kernels.hdiff import hdiff_fixed_point_ref
    from repro_torch.kernels.hdiff import kernel as k13
    from repro_torch.kernels.stencil2d import jacobi1d, stencil2d, weights_for
    from repro_torch.kernels.stencil2d import kernel as k45
    from repro_torch.ir.lower_cuda import KERNEL_N_OUT, kernel_source, tile_for
    from repro_torch.kernels.rglru import kernel as k6
    from repro_torch.kernels.rglru import rglru_seq_ref
    from repro_torch.kernels.wkv6 import kernel as k7
    from repro_torch.kernels.wkv6 import wkv6_backward_plain, wkv6_plain, wkv6_ref
    from repro_torch.models import layers as lm_layers
    from repro_torch.configs import get_config
    from repro_torch.models import build_cache, build_lm, lm_decode, lm_forward, lm_prefill
    from repro_torch.obs import MetricsRegistry, metrics, profiler_trace, runtime_metadata
    from repro_torch.ir.lower_cuda import _KERNELS
    from repro_torch.obs.health import HealthMonitor, NumericsError, field_stats, host_stats
    from repro_torch.kernels.stats import field_stats_cuda, field_stats_plain
    from repro_torch.serve import BatchedServer, CompileCache, ForecastServer
    from repro_torch.train import (AssimilationConfig, fit_coefficient_field, forward_model,
                                   synthetic_observations, true_coefficients)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "python": sys.version.split()[0]})

    # -- programs and inputs -----------------------------------------------------
    # K2's conformance set: every 2-D program of tests/conformance.py, 1-3 sweeps.
    conformance_2d = {
        "hdiff": ir.hdiff_program, "hdiff_simple": lambda: ir.hdiff_program(limit=False),
        "jacobi2d_3pt": ir.jacobi2d_3pt_program, "laplacian": ir.laplacian_program,
        "jacobi2d_5pt": ir.jacobi2d_5pt_program, "jacobi2d_9pt": ir.jacobi2d_9pt_program,
        "seidel2d": ir.seidel2d_program, "vadvc": ir.vadvc_program,
        "hdiff_coupled": ir.hdiff_coupled_program, "shallow_water": ir.shallow_water_program,
        "advection_diffusion": ir.advection_diffusion_program,
    }
    k2_cases = [(n, k, ir.repeat(make(), k)) for n, make in conformance_2d.items()
                for k in (1, 2, 3)]
    # The gradient path's K2 programs: each conformance sweep's adjoint and
    # augmented forward (repeat(p, k) chains one sweep k times, so these are
    # every k's), run by make_vjp on the grid padded by the sweep's radius.
    grad_progs = {}
    for n, make in conformance_2d.items():
        q = make()
        grad_progs[f"{n}.adj"] = (q, ir.adjoint(q))
        if ir.cache_fields(q):
            grad_progs[f"{n}.aug"] = (q, ir.augmented_forward(q))

    def padded(shape, q):
        (lo, hi), (clo, chi) = ir.pad_widths(q, shape[1:])
        return (shape[0], shape[1] + lo + hi, shape[2] + clo + chi)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def fields(prog, shape, dtype=torch.float32):
        out = {}
        for f in prog.inputs:
            a = randn(shape)
            out[f] = (0.025 * (1.0 + 0.25 * torch.tanh(a)) if f == "coeff" else a).to(dtype)
        return out

    def near_wrap(shape):
        mag = torch.randint(2**29 - 2**20, 2**29, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        sign = torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.int32)
        return mag * (2 * sign - 1)

    # -- build -------------------------------------------------------------------
    sources = [k13.source()]
    for shape in (PAPER_GRID, RAGGED_GRID):
        for _, _, prog in k2_cases:
            for dtype in ("float32", "bfloat16"):
                sources.append(kernel_source(prog, (dtype,) * len(prog.inputs),
                                             tile_for(prog, *shape[1:])))
    for shape in (PAPER_GRID, RAGGED_GRID, SMALL_GRAD, BIG_GRID):
        for q, prog in grad_progs.values():
            sources.append(kernel_source(q, ("float32",) * len(q.inputs), tile_for(q, *shape[1:])))
            for dtype in ("float32", "bfloat16"):
                sources.append(kernel_source(prog, (dtype,) * len(prog.inputs),
                                             tile_for(prog, *padded(shape, q)[1:])))
    hdiff2 = ir.repeat(ir.hdiff_program(), 2)
    for prog in (hdiff2, ir.hdiff_coupled_program()):
        sources.append(kernel_source(prog, ("float32",) * len(prog.inputs),
                                     tile_for(prog, *BIG_GRID[1:])))
    sources.append(k45.source())
    elementary = {name: ir.ELEMENTARY_PROGRAMS[name]() for name in ELEMENTARY_2D}
    for prog in elementary.values():
        sources.append(kernel_source(prog, ("float32",), tile_for(prog, *PAPER_GRID[1:])))
    jac = {k: ir.repeat(ir.jacobi1d_program(), k) for k in (1, 2, 3)}
    # K5''s other chains: intermediates read at non-zero offsets (parity only).
    chains_1d = {f"{name}/k={k}": ir.repeat(make(), k) for k in (1, 2, 3)
                 for name, make in (("hdiff1d", ir.hdiff1d_program),
                                    ("smooth1d", ir.smooth1d_program))}
    for prog in (*jac.values(), *chains_1d.values()):
        for dtype in ("float32", "bfloat16"):  # one span for every row length
            sources.append(kernel_source(prog, (dtype,), tile_for(prog, *PAPER_ROWS)))
    # The sharded phase's K2 launches: every block shape lower_sharded
    # gives K2 on each partition (padded blocks, overlap's interiors and
    # edge bands), and the gradient's zero-boundary sweeps on the 2x4 mesh.
    coupled = ir.hdiff_coupled_program()
    shard_progs = {f"hdiff k={k}": ir.repeat(ir.hdiff_program(), k) for k in (1, 2, 3)}
    shard_progs.update({"shallow_water": ir.shallow_water_program(), "hdiff_coupled": coupled})
    for grid in (PAPER_GRID, BIG_GRID):
        for n_row, n_col in SHARD_PARTITIONS:
            for prog in shard_progs.values():
                for *_, rr, cc in shard_slabs(0, 0, grid[1] // n_row, grid[2] // n_col,
                                              prog.radius):
                    sources.append(kernel_source(prog, ("float32",) * len(prog.inputs),
                                                 tile_for(prog, rr, cc)))
    for q in (ir.augmented_forward(coupled), ir.adjoint(coupled)):
        rr, cc = PAPER_GRID[1] // SHARD_MESH[0], PAPER_GRID[2] // SHARD_MESH[1]
        sources.append(kernel_source(q, ("float32",) * len(q.inputs),
                                     tile_for(q, rr + 2 * q.radius, cc + 2 * q.radius)))
    # The forecast phase's K2 programs beyond the parity set: fig14's nowcast
    # tile, and the grid past 65535 planes (a member fold gives the same
    # rows and columns, so the batched launches reuse the unbatched kernels).
    sources.append(kernel_source(hdiff2, ("float32",), tile_for(hdiff2, *NOWCAST_GRID[1:])))
    for prog in (hdiff2, ir.shallow_water_program()):
        sources.append(kernel_source(prog, ("float32",) * len(prog.inputs),
                                     tile_for(prog, *DEEP_GRID[1:])))
    # The driver phase's shallow_water blocks: each plan_partition split it
    # runs (rows x cols blocks, padded by the halo on every split axis).
    sw = ir.shallow_water_program()
    for n in (2, DRIVER_RANKS):
        plan = ir.plan_partition(sw, *PAPER_GRID, n)
        rr = PAPER_GRID[1] // plan.row_shards + (2 * sw.radius if plan.row_shards > 1 else 0)
        cc = PAPER_GRID[2] // plan.col_shards + (2 * sw.radius if plan.col_shards > 1 else 0)
        sources.append(kernel_source(sw, ("float32",) * len(sw.inputs), tile_for(sw, rr, cc)))
    sources += [k6.source(), k7.source(), k7.bwd_source()]
    sources = list(dict.fromkeys(sources))
    t0 = time.perf_counter()
    _build.build(sources)
    emit({"phase": "build", "sources": len(sources),
          "seconds": round(time.perf_counter() - t0, 3)})

    # -- parity: every kernel against its plain version --------------------------
    worst: dict[str, float] = {"hdiff_cuda": 0.0, "hdiff_fixed_cuda": 0.0,
                               "stencil_program_cuda": 0.0, "stencil2d_cuda": 0.0,
                               "jacobi1d_cuda": 0.0, "stencil_program_1d_cuda": 0.0,
                               "rglru_scan_cuda": 0.0, "wkv6_cuda": 0.0,
                               "wkv6_bwd_cuda": 0.0, GRAD_K2: 0.0}
    results = []

    def compare(kernel, label, got, want, exact=False, record=True):
        got = got if isinstance(got, dict) else {"": got}
        want = want if isinstance(want, dict) else {"": want}
        torch.cuda.synchronize()
        err, equal = 0.0, True
        for f in want:
            check(got[f].dtype == want[f].dtype and got[f].shape == want[f].shape,
                  f"{label}[{f}] dtype/shape")
            d = (got[f].to(torch.float64) - want[f].to(torch.float64)).abs().max().item()
            err, equal = max(err, d), equal and torch.equal(got[f], want[f])
        check(equal if exact else err <= TOL, f"{label}: max abs error {err}")
        worst[kernel] = max(worst[kernel], err)
        if record:
            results.append({"kernel": kernel, "case": label, "max_abs_err": err,
                            "bit_equal": equal})

    for shape in (PAPER_GRID, RAGGED_GRID):
        tag = "x".join(map(str, shape))
        x = randn(shape)
        for limit in (True, False):
            compare("hdiff_cuda", f"{tag}/f32/limit={limit}",
                    k13.hdiff_cuda(x, COEFF, limit=limit), k13.hdiff_plain(x, COEFF, limit=limit),
                    exact=True)
        xb = x.to(torch.bfloat16)
        for limit in (True, False):
            compare("hdiff_cuda", f"{tag}/bf16/limit={limit}",
                    k13.hdiff_cuda(xb, COEFF, limit=limit),
                    k13.hdiff_plain(xb, COEFF, limit=limit), exact=True)
        for wrap in (False, True):
            xq = near_wrap(shape) if wrap else torch.randint(
                -1000, 1000, shape, generator=gen, device=dev, dtype=torch.int32)
            compare("hdiff_fixed_cuda", f"{tag}/i32/wrap={wrap}", k13.hdiff_fixed_cuda(xq),
                    hdiff_fixed_point_ref(xq, 26, 10), exact=True)
        # The limiter's sign test at its edges: zeros, INT32_MIN/MAX, +-2**30
        # (wrapping Laplacians), and runs of equal neighbours.
        pool = torch.tensor([0, -(2**31), 2**31 - 1, 2**30, -(2**30), 2**30 - 1, 1, -1],
                            dtype=torch.int32, device=dev)
        xq = pool[torch.randint(0, len(pool), shape, generator=gen, device=dev)]
        xq[:, ::3, :] = xq[:, ::3, :1]
        compare("hdiff_fixed_cuda", f"{tag}/i32/sign edges", k13.hdiff_fixed_cuda(xq),
                hdiff_fixed_point_ref(xq, 26, 10), exact=True)
        # K2: every conformance program and k, float32 and bfloat16, bit for bit.
        for dtype in (torch.float32, torch.bfloat16):
            for name, k, prog in k2_cases:
                arrays = tuple(fields(prog, shape, dtype).values())
                compare("stencil_program_cuda", f"{tag}/{name}/k={k}/{str(dtype)[6:]}",
                        ir.stencil_program_cuda(prog, arrays),
                        ir.stencil_program_plain(prog, arrays), exact=True, record=False)
            results.append({"kernel": "stencil_program_cuda",
                            "case": f"{tag}/{len(k2_cases)} programs x k/{str(dtype)[6:]}",
                            "max_abs_err": worst["stencil_program_cuda"], "bit_equal": True})
    # K2 on the gradient path's programs, at each sweep's padded paper and
    # ragged grids, float32 and bfloat16, bit for bit (the augmented
    # programs' cache inputs random, not zero: their ring is copied through).
    for shape in (PAPER_GRID, RAGGED_GRID):
        tag = "x".join(map(str, shape))
        for dtype in (torch.float32, torch.bfloat16):
            for name, (q, prog) in grad_progs.items():
                arrays = tuple(fields(prog, padded(shape, q), dtype).values())
                compare(GRAD_K2, f"{tag}+pad/{name}/{str(dtype)[6:]}",
                        ir.stencil_program_cuda(prog, arrays),
                        ir.stencil_program_plain(prog, arrays), exact=True, record=False)
            results.append({"kernel": GRAD_K2, "case": f"{tag}+pad/{len(grad_progs)} adjoint "
                            f"and augmented programs/{str(dtype)[6:]}",
                            "max_abs_err": worst[GRAD_K2], "bit_equal": True})
    # The whole backward, card against CPU, bit for bit: make_vjp through K2
    # (its plain version on the CPU); pad, mask, crop and add are elementwise.
    for name, _, prog in k2_cases:
        x = fields(prog, SMALL_GRAD)
        g = {f: randn(SMALL_GRAD) for f in prog.outputs}
        g = g if len(g) > 1 else g[prog.passthrough]
        vjp = ir.make_vjp(prog, lambda p: ir.build_backend(p, "cuda"))
        got = vjp(x, g)
        want = vjp({f: a.cpu() for f, a in x.items()},
                   {f: a.cpu() for f, a in g.items()} if isinstance(g, dict) else g.cpu())
        compare(GRAD_K2, f"make_vjp/{name}/k={prog.steps}", {f: a.cpu() for f, a in got.items()},
                want, exact=True, record=False)
    results.append({"kernel": GRAD_K2, "case": f"{'x'.join(map(str, SMALL_GRAD))}/make_vjp card "
                    f"vs cpu/{len(k2_cases)} programs x k", "max_abs_err": 0.0, "bit_equal": True})
    # hdiff_fused_ad at the paper grid: K1 forward, K2 backward, card vs CPU.
    x, gx = randn(PAPER_GRID), randn(PAPER_GRID)
    ad = []
    for where in (dev, torch.device("cpu")):
        xp = x.detach().to(where).requires_grad_(True)
        cp = torch.tensor(COEFF, device=where, requires_grad=True)
        hdiff_fused_ad(xp, cp).backward(gx.to(where))
        ad.append((xp.grad.cpu(), cp.grad.cpu()))
    check(torch.equal(ad[0][0], ad[1][0]), "hdiff_fused_ad dpsi: card != cpu")
    dcoeff_rel = abs(float(ad[0][1]) - float(ad[1][1])) / abs(float(ad[1][1]))
    check(dcoeff_rel <= DCOEFF_TOL, f"hdiff_fused_ad dcoeff: card vs cpu {dcoeff_rel}")
    results.append({"kernel": GRAD_K2, "case": "64x256x256/hdiff_fused_ad card vs cpu",
                    "dpsi_bit_equal": True, "dcoeff_rel_err": dcoeff_rel})
    # The trainer at a reduced grid, card against CPU: the first step's
    # gradient bit for bit (the loss's backward is elementwise), then the
    # loss trajectory within FIT_TOL (the mean and the clip's global norm are
    # reductions, rounded in another order on the card).
    small_cfg = AssimilationConfig(steps=5, learning_rate=FIT_LR)
    us, cs = randn(SMALL_GRAD), true_coefficients(SMALL_GRAD, seed=1, device=dev)
    fit_runs, step0 = [], []
    for where in (dev, torch.device("cpu")):
        u_w, fwd = us.to(where), forward_model(small_cfg)
        obs_w = fwd({"u": u_w, "coeff": cs.to(where)}).detach()
        leaf = torch.full_like(u_w, 0.025).requires_grad_(True)
        torch.mean(torch.square(fwd({"u": u_w, "coeff": leaf}) - obs_w)).backward()
        step0.append((obs_w.cpu(), leaf.grad.cpu()))
        fit_runs.append(fit_coefficient_field(u_w, obs_w, small_cfg).losses)
    check(torch.equal(step0[0][0], step0[1][0]), "observations: card != cpu")
    check(torch.equal(step0[0][1], step0[1][1]), "first step's gradient: card != cpu")
    traj = max(abs(a - b) / b for a, b in zip(*fit_runs))
    check(traj <= FIT_TOL, f"fit card vs cpu: loss trajectory off by {traj}")
    results.append({"kernel": GRAD_K2, "case": f"{'x'.join(map(str, SMALL_GRAD))}/fit card vs "
                    "cpu: first gradient bit-equal, 5-step losses", "max_rel_err": traj})
    del x, gx, ad, us, cs, fit_runs, step0
    # K2 on the five elementary programs (this also loads their kernels, so
    # the counted elementary path pays no first-use cost).
    x = randn(PAPER_GRID)
    for name, prog in elementary.items():
        compare("stencil_program_cuda", f"64x256x256/{name}/k=1",
                ir.stencil_program_cuda(prog, (x,)), ir.stencil_program_plain(prog, (x,)))
    masks = {name: weights_for(name) for name in ELEMENTARY_2D}
    masks["random"] = torch.randn((3, 3), generator=torch.Generator().manual_seed(SEED)).numpy()
    for shape in (PAPER_GRID, RAGGED_GRID):
        tag = "x".join(map(str, shape))
        x = randn(shape)
        for mname, w in masks.items():
            compare("stencil2d_cuda", f"{tag}/{mname}", k45.stencil2d_cuda(x, w),
                    k45.stencil2d_plain(x, w), exact=True)
    for shape in (PAPER_GRID, RAGGED_GRID):
        tag = "x".join(map(str, shape))
        xb = randn(shape, torch.bfloat16)
        for mname, w in masks.items():
            compare("stencil2d_cuda", f"{tag}/{mname}/bf16", k45.stencil2d_cuda(xb, w),
                    k45.stencil2d_plain(xb, w), exact=True)
    for shape in (PAPER_ROWS, LONG_ROW):
        tag = "x".join(map(str, shape))
        y = randn(shape)
        compare("jacobi1d_cuda", f"{tag}/f32", k45.jacobi1d_cuda(y), k45.jacobi1d_plain(y))
        # K5' (flat spans, whatever rows they cross), bit for bit: jacobi1d
        # and the chains, k = 1-3 (warp and block spans), float32 and bfloat16.
        for yd in (y, y.to(torch.bfloat16)):
            for label, prog in [(f"jacobi1d/k={k}", p) for k, p in jac.items()] + \
                    list(chains_1d.items()):
                compare("stencil_program_1d_cuda", f"{tag}/{label}/{str(yd.dtype)[6:]}",
                        ir.stencil_program_1d_cuda(prog, yd),
                        ir.stencil_program_1d_plain(prog, yd), exact=True)
    yb = randn(PAPER_ROWS, torch.bfloat16)
    compare("jacobi1d_cuda", "16384x256/bf16", k45.jacobi1d_cuda(yb), k45.jacobi1d_plain(yb))
    del x, xb, y, yb, yd
    # The card against the CPU path, whose float32 steps the CPU tests hold
    # bit-identical to the JAX package's eager steps.
    # (Its diagnostics also load the reduction kernels the main path's
    # diagnostics use, so the timed main path pays no first-use cost.)
    small = make_initial_field(4, 64, 64, kind="gaussian")
    on_card, diag_card = run_simulation(small, COEFF, step_fn=hdiff_fused, n_steps=20,
                                        collect_every=5)
    on_host, diag_host = run_simulation(small.cpu(), COEFF, step_fn=hdiff_fused, n_steps=20,
                                        collect_every=5)
    compare("hdiff_cuda", "4x64x64/20 steps card vs cpu", on_card.cpu(), on_host)
    diag_err = (diag_card.cpu() - diag_host).abs().max().item()
    check(diag_err <= TOL, f"card vs cpu diagnostics: {diag_err}")
    # The i32 datapath tracks the float one with coeff = 26/1024 (paper
    # §5.1.1; the JAX package's test_hdiff_fixed_point_tracks_float bound).
    xf = torch.rand((2, 32, 32), generator=gen, device=dev)
    one_q = k13.hdiff_fixed_cuda((xf * 2**16).to(torch.int32)).to(torch.float64) / 2**16
    track = (one_q - k13.hdiff_cuda(xf, 26 / 1024).to(torch.float64)).abs().max().item()
    check(track <= 2e-3, f"int32 step drifted from the float step: {track}")
    results.append({"kernel": "hdiff_fixed_cuda", "case": "2x32x32/i32 vs f32 step",
                    "max_abs_err": track, "bit_equal": False})

    # K7 against its plain chunked version (to K7_TOL) and the sequential
    # oracle (to ORACLE_TOL), inputs distributed as in tests/test_kernels_wkv6.py.
    def wkv_inputs(shape):
        b, t, h, n = shape
        return (0.5 * randn(shape), 0.5 * randn(shape), randn(shape),
                0.6 + 0.399 * torch.rand(shape, generator=gen, device=dev),
                0.3 * randn((h, n)), 0.1 * randn((b, h, n, n)))

    for shape in (K7_SERVE, (2, 128, 3, 16)):
        r, k, v, w, u, s0 = wkv_inputs(shape)
        for state in (torch.zeros_like(s0), s0):
            tag = f"{'x'.join(map(str, shape))}/{'state' if state is s0 else 'zero state'}"
            got = k7.wkv6_cuda(r, k, v, w, u, state, chunk=K7_CHUNK)
            plain = wkv6_plain(r, k, v, w, u, state, chunk=K7_CHUNK)
            oracle = wkv6_ref(r, k, v, w, u, state)
            torch.cuda.synchronize()
            err = max((g - p).abs().max().item() for g, p in zip(got, plain))
            bound = K7_TOL * plain[0].abs().max().item() + 1e-6
            oracle_err = max((g - o).abs().max().item() for g, o in zip(got, oracle))
            check(err <= bound, f"K7 {tag}: {err} from its plain version (bound {bound})")
            check(oracle_err <= ORACLE_TOL, f"K7 {tag}: {oracle_err} from wkv6_ref")
            worst["wkv6_cuda"] = max(worst["wkv6_cuda"], err)
            results.append({"kernel": "wkv6_cuda", "case": tag, "max_abs_err": err,
                            "bound": bound, "oracle_max_abs_err": oracle_err,
                            "bit_equal": all(torch.equal(g, p) for g, p in zip(got, plain))})
    # K6 at the serving shape, small tiles, a width that is not whole 16-byte
    # groups (one-word copies) with T not a multiple of the 64-step stage,
    # bfloat16, and replayed from a CUDA graph.
    for shape, dtype in ((K6_SERVE, torch.float32), ((3, 64, 128), torch.float32),
                         ((2, 100, 2562), torch.float32), (K6_SERVE, torch.bfloat16),
                         ((2, 100, 2562), torch.bfloat16)):
        a = (0.5 + 0.499 * torch.rand(shape, generator=gen, device=dev)).to(dtype)
        b = randn(shape, dtype)
        h0 = randn((shape[0], shape[2]))
        compare("rglru_scan_cuda", f"{'x'.join(map(str, shape))}/{str(dtype)[6:]}",
                dict(zip("hl", k6.rglru_scan_cuda(a, b, h0))),
                dict(zip("hl", rglru_seq_ref(a, b, h0))), exact=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = k6.rglru_scan_cuda(a, b, h0)
    graph.replay()
    compare("rglru_scan_cuda", "2x100x2562/bf16/graph replay", dict(zip("hl", replayed)),
            dict(zip("hl", rglru_seq_ref(a, b, h0))), exact=True)
    del r, k, v, w, u, s0, a, b, h0, graph, replayed
    # K7's backward against its plain version (to K7_TOL of each gradient's
    # largest entry: the scans and the dlogw sums run in other orders), and
    # the plain version against autograd through wkv6_plain (GRAD_TOL),
    # with a non-zero initial state and state cotangent.
    for shape, chunk in ((K7_SERVE, K7_CHUNK), (K7_TRAIN, K7_CHUNK), ((2, 128, 3, 16), 16)):
        bwd_in = (*wkv_inputs(shape), randn(shape), randn((shape[0], *shape[2:], shape[3])))
        got = k7.wkv6_bwd_cuda(*bwd_in, chunk=chunk)
        plain = wkv6_backward_plain(*bwd_in, chunk=chunk)
        xs = [x.clone().requires_grad_() for x in bwd_in[:6]]
        y_p, s_p = wkv6_plain(*xs, chunk=chunk)
        auto = torch.autograd.grad((y_p * bwd_in[6]).sum() + (s_p * bwd_in[7]).sum(), xs)
        torch.cuda.synchronize()
        tag = f"{'x'.join(map(str, shape))}/chunk {chunk}"
        grads = {}
        for name, g, p_, a_ in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, plain, auto):
            err = (g - p_).abs().max().item()
            bound = K7_TOL * p_.abs().max().item() + 1e-6
            rel = ((p_ - a_).abs().max() / a_.abs().max()).item()
            check(err <= bound, f"K7 backward {tag} {name}: {err} from its plain version "
                  f"(bound {bound})")
            check(rel <= GRAD_TOL, f"K7 backward {tag} {name}: the plain version {rel} "
                  "relative to autograd")
            worst["wkv6_bwd_cuda"] = max(worst["wkv6_bwd_cuda"], err)
            grads[name] = {"max_abs_err": err, "bound": bound, "plain_vs_autograd_rel": rel}
        results.append({"kernel": "wkv6_bwd_cuda", "case": tag, "grads": grads})
        del bwd_in, got, plain, xs, y_p, s_p, auto

    # The slice at full width and reduced depth, card against CPU: a
    # 128-token prefill (the encoder: a forward over 128 frames), and for
    # the dense LMs one of LONG_PROMPT tokens through the flash scan or the
    # blocked local path (plain tensor code, which no launch counter sees:
    # its calls are counted, one a layer).
    slices, long_paths = {}, {}
    for arch in SLICE_LAYERS:
        cfg = dataclasses.replace(get_config(arch), n_layers=SLICE_LAYERS[arch],
                                  compute_dtype="float32")
        model = build_lm(cfg, SEED, device="cpu")
        lengths = (128, LONG_PROMPT) if arch in LONG_ARCHS else (128,)
        toks = {n: torch.from_numpy(
            np.random.default_rng(SEED).standard_normal((1, n, cfg.d_model)).astype(np.float32)
            if cfg.frontend == "audio"
            else np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, n)))
            for n in lengths}

        def prefill(n, device):
            with counting(LONG_ARCHS.get(arch, "_flash_fwd_scan")) as long_calls:
                if cfg.frontend == "audio":
                    out = lm_forward(cfg, model, toks[n].to(device))
                else:
                    out = lm_prefill(cfg, model, toks[n].to(device),
                                     build_cache(cfg, 1, max(256, n + 16), device=device))
            check(len(long_calls) == (cfg.n_layers if n > lm_layers.FLASH_THRESHOLD else 0),
                  f"{arch} {n}-token prefill on {device}: {len(long_calls)} long-path calls")
            return out, len(long_calls)

        want = {n: prefill(n, "cpu")[0] for n in lengths}
        model.to(dev)
        for n in lengths:
            got, n_calls = prefill(n, dev)
            slices[f"{arch}/{n}"] = model_err(f"{arch} x{cfg.n_layers} {n} tokens card vs cpu",
                                              got, want[n])
            if n > lm_layers.FLASH_THRESHOLD:
                long_paths[arch] = {"path": LONG_ARCHS[arch], "calls": n_calls}
        del model, got, want
        gc.collect()
    results.append({"case": "slice card vs cpu, max relative error", **slices,
                    "long_paths": long_paths})
    emit({"phase": "parity", "checks": len(results), "results": results})

    # -- main path, counted ----------------------------------------------------
    psi = make_initial_field(*PAPER_GRID, kind="gaussian")
    stencil = make_hdiff_compound(COEFF)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    by_policy = {p: stencil.apply(psi, p) for p in stencil.POLICIES}
    torch.cuda.synchronize()
    t_compound = time.perf_counter() - t0
    check(dict(_build.LAUNCHES) == {"stencil_program_cuda": 1},
          f"compound launches {_build.LAUNCHES}")
    policy_err = {
        p: (by_policy["fused-cuda"] - by_policy[p]).abs().max().item()
        for p in ("fused-eager", "staged")
    }
    check(max(policy_err.values()) <= TOL, f"policies disagree: {policy_err}")

    t0 = time.perf_counter()
    final, diags = run_simulation(psi, COEFF, step_fn=hdiff_fused, n_steps=100,
                                  collect_every=10)
    torch.cuda.synchronize()
    t_k1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = psi
    for _ in range(50):
        two = hdiff_twostep(two, COEFF)
    torch.cuda.synchronize()
    t_k2 = time.perf_counter() - t0
    twostep_err = (final - two).abs().max().item()
    check(twostep_err <= TOL, f"100 x hdiff_fused vs 50 x hdiff_twostep: {twostep_err}")

    scale = 2**16
    psi_q = (psi * scale).to(torch.int32)  # the paper's i32 datapath, 16 fraction bits
    t0 = time.perf_counter()
    final_q, _ = run_simulation(psi_q, None, step_fn=lambda p, _: hdiff_fixed(p),
                                n_steps=100)
    torch.cuda.synchronize()
    t_k3 = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    want = {"hdiff_cuda": 100, "stencil_program_cuda": 51, "hdiff_fixed_cuda": 100}
    check(launches == want, f"main-path launches {launches} != {want}")

    # What comes out is right: shapes, finite values, the ring passed
    # through, the 100 steps equal to the same steps of the plain versions,
    # and the diffusion's peak and L2 norm not growing. (The quickstart's
    # roughness check is reported, not asserted: mean |d psi / d col| GROWS
    # on this field in the JAX package too, ROADMAP Queue 3.)
    for name, t in (("final", final), ("twostep", two), ("fixed", final_q)):
        check(tuple(t.shape) == PAPER_GRID, f"{name} shape {tuple(t.shape)}")
    check(bool(torch.isfinite(final).all()), "non-finite values in the 100-step field")
    check(torch.equal(final[:, :2, :], psi[:, :2, :]), "boundary ring moved")
    ref, ref_q = psi, psi_q
    for _ in range(100):
        ref = k13.hdiff_plain(ref, COEFF)
        ref_q = hdiff_fixed_point_ref(ref_q, 26, 10)
    plain_err = (final - ref).abs().max().item()
    check(plain_err <= TOL, f"100 kernel steps vs 100 plain steps: {plain_err}")
    check(torch.equal(final_q, ref_q), "100 int32 kernel steps != 100 plain int32 steps")
    peak0 = psi[:, 2:-2, 2:-2].abs().max().item()
    peak1 = final[:, 2:-2, 2:-2].abs().max().item()
    norm0, norm1 = psi.norm().item(), final.norm().item()
    check(peak1 <= peak0 and norm1 <= norm0,
          f"diffusion grew the field: peak {peak0} -> {peak1}, L2 {norm0} -> {norm1}")
    rough0 = psi.diff(dim=-1).abs().mean().item()
    rough1 = final.diff(dim=-1).abs().mean().item()
    emit({"phase": "main", "grid": list(PAPER_GRID), "launches": launches,
          "policy_max_abs_err": policy_err, "twostep_max_abs_err": twostep_err,
          "plain_100_step_max_abs_err": plain_err, "interior_peak": [peak0, peak1],
          "l2_norm": [norm0, norm1], "roughness": [rough0, rough1],
          "diag_rows": int(diags.shape[0]),
          "seconds": {"compound_3_policies": t_compound, "run_simulation_100_k1": t_k1,
                      "twostep_50_k2": t_k2, "fixed_100_k3": t_k3}})

    # -- elementary path (fig11 on the card), counted ------------------------------
    # The paper's 64x256x256 f32 domain and fig11's (depth*rows, cols) layout
    # of it for jacobi1d. laplacian amplifies the field ~8x per sweep, so it
    # runs one sweep; every other stencil runs ten.
    x3, x1 = randn(PAPER_GRID), randn(PAPER_ROWS)
    sweeps = {name: 1 if name == "laplacian" else 10 for name in ELEMENTARY_2D}
    reg = MetricsRegistry()
    lowered = {name: ir.lower_cuda(prog) for name, prog in elementary.items()}
    lowered["jacobi1d"] = ir.lower_cuda(jac[1])
    lowered["jacobi1d_x2"] = ir.lower_cuda(jac[2])
    calls = {f"{fn.metric_name}.calls": 0 for fn in lowered.values()}
    legs: dict[str, dict] = {}

    def leg(label, fn, x, n, *, instrumented=False):
        """``n`` chained calls of ``fn`` from ``x``; returns (result, result
        of the first call) and records the synchronised host seconds."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with metrics.using(reg) if instrumented else contextlib.nullcontext():
            y = first = fn(x)
            for _ in range(n - 1):
                y = fn(y)
        torch.cuda.synchronize()
        legs[label] = {"calls": n, "seconds": time.perf_counter() - t0}
        return y, first

    torch.cuda.synchronize()
    _build.reset_launches()
    out, firsts = {}, {}
    for name in ELEMENTARY_2D:
        out[("k4", name)], firsts[("k4", name)] = leg(
            f"{name}/stencil2d", lambda a, m=name: stencil2d(a, m), x3, sweeps[name])
        out[("k2", name)], firsts[("k2", name)] = leg(
            f"{name}/lower_cuda", lowered[name], x3, sweeps[name], instrumented=True)
        calls[f"{lowered[name].metric_name}.calls"] += sweeps[name]
    out[("k5", "jacobi1d")], firsts[("k5", "jacobi1d")] = leg(
        "jacobi1d/jacobi1d", jacobi1d, x1, 10)
    out[("k5p", "jacobi1d")], firsts[("k5p", "jacobi1d")] = leg(
        "jacobi1d/lower_cuda", lowered["jacobi1d"], x1, 10, instrumented=True)
    out[("k5p2", "jacobi1d")], _ = leg(
        "jacobi1d_x2/lower_cuda", lowered["jacobi1d_x2"], x1, 5, instrumented=True)
    calls[f"{lowered['jacobi1d'].metric_name}.calls"] += 10
    calls[f"{lowered['jacobi1d_x2'].metric_name}.calls"] += 5
    elem_launches = dict(_build.LAUNCHES)
    want = {"stencil2d_cuda": 41, "stencil_program_cuda": 41, "jacobi1d_cuda": 10,
            "stencil_program_1d_cuda": 15}
    check(elem_launches == want, f"elementary launches {elem_launches} != {want}")
    # The same lower_cuda legs uninstrumented, after the count (the counted
    # legs above are the path): an instrumented call synchronises the card
    # (obs/metrics.py), so only these compare with the stencil2d and jacobi1d
    # legs' host time per sweep. Each equals its instrumented leg bit for bit.
    for name in ELEMENTARY_2D:
        y, _ = leg(f"{name}/lower_cuda uninstrumented", lowered[name], x3, sweeps[name])
        check(torch.equal(y, out[("k2", name)]), f"{name}: uninstrumented K2 leg differs")
    for key, label, n in (("k5p", "jacobi1d", 10), ("k5p2", "jacobi1d_x2", 5)):
        y, _ = leg(f"{label}/lower_cuda uninstrumented", lowered[label], x1, n)
        check(torch.equal(y, out[(key, "jacobi1d")]), f"{label}: uninstrumented K5' leg differs")

    def repeated(fn, x, n):
        for _ in range(n):
            x = fn(x)
        return x

    leg_checks = []

    def leg_check(label, got, want_, tol=TOL):
        torch.cuda.synchronize()
        err = (got.to(torch.float64) - want_.to(torch.float64)).abs().max().item()
        check(got.shape == want_.shape and err <= tol, f"{label}: max abs error {err}")
        leg_checks.append({"case": label, "max_abs_err": err,
                           "bit_equal": torch.equal(got, want_)})

    def within_routes(label, a, b):
        torch.cuda.synchronize()
        excess = ((a - b).abs() - ROUTE_TOL * (1 + b.abs())).max().item()
        err = (a - b).abs().max().item()
        check(excess <= 0, f"{label}: routes differ by {err} (rtol = atol = {ROUTE_TOL})")
        leg_checks.append({"case": label, "max_abs_err": err, "bit_equal": torch.equal(a, b)})

    for name in ELEMENTARY_2D:
        n, prog, w = sweeps[name], elementary[name], masks[name]
        leg_check(f"{name}/K4 x{n} vs plain",
                  out[("k4", name)], repeated(lambda a: k45.stencil2d_plain(a, w), x3, n))
        leg_check(f"{name}/K2 x{n} vs plain", out[("k2", name)],
                  repeated(lambda a: ir.stencil_program_plain(prog, (a,)), x3, n))
        ref1 = ir.lower_reference(prog)(x3)
        within_routes(f"{name}/1 sweep: K4 vs lower_reference", firsts[("k4", name)], ref1)
        within_routes(f"{name}/1 sweep: K2 vs lower_reference", firsts[("k2", name)], ref1)
    plain1 = lambda a: ir.stencil_program_1d_plain(jac[1], a)  # noqa: E731
    leg_check("jacobi1d/K5 x10 vs plain", out[("k5", "jacobi1d")],
              repeated(k45.jacobi1d_plain, x1, 10))
    leg_check("jacobi1d/K5' x10 vs plain", out[("k5p", "jacobi1d")], repeated(plain1, x1, 10))
    leg_check("jacobi1d/K5' k=2 x5 vs plain", out[("k5p2", "jacobi1d")],
              repeated(lambda a: ir.stencil_program_1d_plain(jac[2], a), x1, 5))
    check(torch.equal(out[("k5p2", "jacobi1d")], out[("k5p", "jacobi1d")]),
          "K5' k=2 x5 is not bit-equal to K5' x10")
    ref1 = ir.lower_reference(jac[1])(x1)
    within_routes("jacobi1d/1 sweep: K5 vs lower_reference", firsts[("k5", "jacobi1d")], ref1)
    within_routes("jacobi1d/1 sweep: K5' vs lower_reference", firsts[("k5p", "jacobi1d")], ref1)
    specs = {}
    for name in ("jacobi1d",) + ELEMENTARY_2D:
        derived, hand = ir.ELEMENTARY_PROGRAMS[name]().spec(), ELEMENTARY_SPECS[name]
        pair = [(s.macs, s.other_ops, s.reads, s.radius) for s in (derived, hand)]
        check(pair[0] == pair[1], f"{name}: derived op counts {pair[0]} != {pair[1]}")
        specs[name] = {"macs": derived.macs, "other_ops": derived.other_ops,
                       "reads": derived.reads, "radius": derived.radius}
    for name, t in out.items():
        check(bool(torch.isfinite(t).all()), f"non-finite values after {name}")
    emit({"phase": "elementary", "grid": list(PAPER_GRID), "rows": list(PAPER_ROWS),
          "launches": elem_launches, "legs": legs, "checks": leg_checks,
          "derived_op_counts": specs})

    # -- trace: torch.profiler over a short steady window -------------------------
    for fn in (lambda: hdiff_fused(psi, COEFF), lambda: hdiff_twostep(psi, COEFF),
               lambda: stencil2d(x3, "jacobi2d_9pt")):
        fn()  # warm-up outside the window
    torch.cuda.synchronize()
    with profiler_trace(TRACE_DIR) as prof:
        check(prof is not None, "torch.profiler could not start a trace")
        t0 = time.perf_counter()
        # One launch of each, synchronised, before the loops, so a late start
        # of the device-side tracing loses one of these, not the loops'.
        hdiff_fused(psi, COEFF), hdiff_twostep(psi, COEFF), stencil2d(x3, "jacobi2d_9pt")
        torch.cuda.synchronize()
        a, b, c = psi, psi, x3
        for _ in range(10):
            a = hdiff_fused(a, COEFF)
        for _ in range(5):
            b = hdiff_twostep(b, COEFF)
        for _ in range(10):
            c = stencil2d(c, "jacobi2d_9pt")
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    check((TRACE_DIR / "trace.json").is_file(), "no trace.json written")
    kernels_seen = device_kernels(prof)
    starts, ends = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            starts.append(e.time_range.start)
            ends.append(e.time_range.end)
    busy_us = sum(v["device_us"] for v in kernels_seen.values())
    found = {}
    for label, pattern in (("K1 hdiff_cuda", r"hdiff_kernel"),
                           ("K2 stencil_program_cuda", r"stencil_program(?!_1d)"),
                           ("K4 stencil2d_cuda", r"stencil2d_kernel")):
        hits = [k for k in kernels_seen if re.search(pattern, k)]
        check(bool(hits), f"trace shows no device time for {label} ({pattern}); "
              f"kernels seen: {sorted(kernels_seen)}")
        found[label] = {"calls": sum(kernels_seen[k]["calls"] for k in hits),
                        "device_us": sum(kernels_seen[k]["device_us"] for k in hits)}
    emit({"phase": "trace", "dir": str(TRACE_DIR.relative_to(ROOT)), "kernels": found,
          "all_kernels": kernels_seen, "device_busy_us": busy_us, "window_us": window_us,
          "busy_share_of_window": busy_us / window_us,
          "busy_share_of_kernel_span": busy_us / (max(ends) - min(starts)) if starts else None})
    del a, b, c, out, firsts
    torch.cuda.empty_cache()

    # -- grad: the assimilation trainer at the paper grid, counted ---------------
    # fit_coefficient_field through build_backend(hdiff_coupled, "cuda",
    # differentiable=True): per step one forward, then the backward's
    # augmented forward and adjoint (two each a step at k = 2), all K2; then
    # hdiff_fused_ad, K1 forward and K2 backward. Counters reset once, read
    # after each part.
    u0 = randn(PAPER_GRID)
    coeff_true = true_coefficients(PAPER_GRID, seed=1, device=dev)
    cfg1 = AssimilationConfig(steps=FIT_STEPS, learning_rate=FIT_LR)
    cfg2 = dataclasses.replace(cfg1, steps=FIT_K2_STEPS, k=2)
    xad, gad = randn(PAPER_GRID), randn(PAPER_GRID)
    grad_parts, fits, fit_s, obs = {}, {}, {}, {}
    torch.cuda.synchronize()
    _build.reset_launches()
    for label, cfg in (("k=1", cfg1), ("k=2", cfg2)):
        before = dict(_build.LAUNCHES)
        obs[label] = synthetic_observations(u0, coeff_true, cfg).detach()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits[label] = fit_coefficient_field(u0, obs[label], cfg)
        torch.cuda.synchronize()
        fit_s[label] = (time.perf_counter() - t0) / cfg.steps
        grad_parts[label] = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                             if v - before.get(k, 0)}
    before = dict(_build.LAUNCHES)
    xp = xad.clone().requires_grad_(True)
    cp = torch.tensor(COEFF, device=dev, requires_grad=True)
    hdiff_fused_ad(xp, cp).backward(gad)
    torch.cuda.synchronize()
    grad_parts["hdiff_fused_ad"] = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                                    if v - before.get(k, 0)}
    grad_launches = dict(_build.LAUNCHES)
    # K2 in all (one-output forwards and N-output augmented forwards and
    # adjoints), and the N-output launches among them.
    want = {"k=1": {"stencil_program_cuda": 1 + 3 * FIT_STEPS, KERNEL_N_OUT: 2 * FIT_STEPS},
            "k=2": {"stencil_program_cuda": 1 + 5 * FIT_K2_STEPS, KERNEL_N_OUT: 4 * FIT_K2_STEPS},
            "hdiff_fused_ad": {"hdiff_cuda": 1, "stencil_program_cuda": 2, KERNEL_N_OUT: 2}}
    check(grad_parts == want, f"grad-path launches {grad_parts} != {want}")
    ring = torch.ones(PAPER_GRID[1:], dtype=torch.bool, device=dev)
    ring[2:-2, 2:-2] = False
    fit_out = {}
    for label, res in fits.items():
        check(all(np.isfinite(res.losses)), f"fit {label}: non-finite loss {res.losses}")
        check(min(res.losses) < res.losses[0], f"fit {label}: no loss below the first")
        check(bool((res.coeff[:, ring] == 0.025).all()), f"fit {label}: ring coefficients moved")
        check(bool(torch.isfinite(res.coeff).all()), f"fit {label}: non-finite coefficients")
        fit_out[label] = {"steps": len(res.losses), "s_per_step": fit_s[label],
                          "loss_first": res.losses[0], "loss_best": min(res.losses),
                          "loss_ratio": res.loss_ratio, "spikes": res.spikes}
    check(bool(torch.isfinite(xp.grad).all()) and bool(torch.isfinite(cp.grad)),
          "hdiff_fused_ad: non-finite gradients")
    # One step more, profiled: the device's busy share of a trainer step.
    step_cfg = dataclasses.replace(cfg1, steps=1)
    fit_coefficient_field(u0, obs["k=1"], step_cfg, coeff_init=fits["k=1"].coeff)  # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_coefficient_field(u0, obs["k=1"], step_cfg, coeff_init=fits["k=1"].coeff)
        torch.cuda.synchronize()
        step_us = (time.perf_counter() - t0) * 1e6
    seen = device_kernels(prof)
    step_busy = sum(v["device_us"] for v in seen.values())
    k2_us = sum(v["device_us"] for k, v in seen.items() if re.search(r"stencil_program(?!_1d)", k))
    coupled = ir.hdiff_coupled_program()
    pgrid = padded(PAPER_GRID, coupled)
    tiles = {}
    for label, prog, shape in (("hdiff_coupled", coupled, PAPER_GRID),
                               ("hdiff_coupled.aug", ir.augmented_forward(coupled), pgrid),
                               ("hdiff_coupled.adj", ir.adjoint(coupled), pgrid),
                               ("hdiff_coupled x2", ir.repeat(coupled, 2), PAPER_GRID)):
        t = tile_for(prog, *shape[1:])
        tiles[label] = {"grid": "x".join(map(str, shape)), "tile": f"{t.rows}x{t.cols}",
                        "frames": t.buffers, "inputs": len(prog.inputs),
                        "outputs": len(prog.outputs), "ops": len(prog.ops)}
    emit({"phase": "grad", "grid": list(PAPER_GRID), "launches": grad_launches,
          "launches_by_part": grad_parts, "fits": fit_out,
          "profiled_step": {"window_us": step_us, "device_busy_us": step_busy,
                            "busy_share": step_busy / step_us, "k2_device_us": k2_us,
                            "device_kernel_calls": sum(v["calls"] for v in seen.values()),
                            "top_kernels": {k[:60]: v for k, v in sorted(
                                seen.items(), key=lambda kv: -kv[1]["device_us"])[:6]}},
          "tiles": tiles})
    del u0, coeff_true, obs, fits, xp, cp, xad, gad, prof
    torch.cuda.empty_cache()

    # -- serve: the recurrent LMs at their published shapes, counted ------------
    serve_launches: dict[str, int] = {}
    dryrun_measured: dict[str, dict] = {}  # the dryrun phase's measured steps
    want_launches = {"rwkv6-3b": {"wkv6_cuda": 7 * 32},
                     "recurrentgemma-2b": {"rglru_scan_cuda": 8 * 18},
                     # dense attention, cross-attention and the MoE are plain tensor code
                     "qwen1.5-0.5b": {}, "qwen3-moe-235b-a22b": {}, "arctic-480b": {},
                     VISION_ARCH: {}}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        reduced = None
        if arch in SERVE_LAYERS:
            reduced = {"n_layers": [cfg.n_layers, SERVE_LAYERS[arch]]}
            cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = build_lm(cfg, SEED, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        params_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
        long = arch in LONG_ARCHS  # one more request, past FLASH_THRESHOLD
        srv = BatchedServer(cfg, model, lanes=4, max_len=LONG_PROMPT + 16 if long else 1024)
        finite = []  # one device flag per prefill / decode; read after the run

        def watched(fn):
            def call(*args):
                logits, cache = fn(*args)
                finite.append(torch.isfinite(logits).all())
                return logits, cache
            return call

        srv.prefill, srv.decode = watched(srv.prefill), watched(srv.decode)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size, n)
                   for n in SERVE_PROMPTS + ((LONG_PROMPT,) if long else ())]
        serve_reg = MetricsRegistry()
        torch.cuda.synchronize()
        _build.reset_launches()
        with (metrics.using(serve_reg),
              counting(LONG_ARCHS.get(arch, "_flash_fwd_scan")) as long_calls):
            for prompt in prompts:
                srv.submit(prompt, SERVE_NEW)
            t0 = time.perf_counter()
            done = srv.run_until_idle()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches_here = dict(_build.LAUNCHES)
        check(launches_here == want_launches[arch],
              f"{arch} serve launches {launches_here} != {want_launches[arch]}")
        check(len(long_calls) == (cfg.n_layers if long else 0),
              f"{arch}: {len(long_calls)} long-prefill path calls while serving")
        serve_launches.update(launches_here)
        check(len(done) == len(prompts) and all(len(r.out_tokens) == SERVE_NEW for r in done),
              f"{arch}: {len(done)} of {len(prompts)} requests finished")
        check(bool(torch.stack(finite).all()), f"{arch}: non-finite logits while serving")
        decode_t = serve_reg.timers["serve.decode_step"].as_dict()
        prefill_t = serve_reg.timers["serve.prefill"].as_dict()
        tokens = srv.stats["tokens_out"]

        # Decode against prefill, float32, on the card; an MoE arch dropless
        # (capacity drops tokens at prefill shapes and never at decode). A
        # vision LM's memory-less prefill attends to the whole prompt in its
        # cross layers, so its decode matches no longer prefill: it is held
        # on the media path (serve_media) instead.
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        if cfg.n_experts:
            cfg32 = dataclasses.replace(cfg32, capacity_factor=MOE_DROPLESS)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 192))).to(dev)
        decode_err = last = want = None
        if cfg.frontend != "vision":
            last, cache = lm_prefill(cfg32, model, toks[:, :128],
                                     build_cache(cfg32, 1, 1024, device=dev))
            for t in range(128, 192):
                last, cache = lm_decode(cfg32, model, toks[:, t], cache, t)
            want = lm_prefill(cfg32, model, toks, build_cache(cfg32, 1, 1024, device=dev))
            decode_err = model_err(f"{arch} decode vs prefill", (last, cache), want)

        # Steady state, one lane, every kernel already loaded: synchronised
        # 512-token prefills and decode tokens, then a profiled window of
        # each for the device's busy share and the kernels that fill it.
        prompt = torch.from_numpy(prompts[0][None]).to(dev)

        def one_prefill():
            return lm_prefill(cfg, model, prompt, build_cache(cfg, 1, 1024, device=dev))

        warm_prefill = [synced(one_prefill)[1] for _ in range(3)]
        (logits, cache), _ = synced(one_prefill)
        warm_decode = []
        for i in range(20):
            (logits, cache), sec = synced(lambda i=i: lm_decode(
                cfg, model, logits.argmax(-1), cache, 512 + i))
            warm_decode.append(sec)
        # The decode token's floor: the bytes its operations move (the
        # weights, and every cast copy written and read again) at 3.35 TB/s.
        tok = logits.argmax(-1)
        decode_bytes = moved_bytes(lambda: lm_decode(cfg, model, tok, cache, 600))
        windows = {"prefill_512": profiled_window(one_prefill, 1),
                   "decode": profiled_window(lambda: lm_decode(cfg, model, logits.argmax(-1),
                                                               cache, 600), 5)}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        media = serve_media(cfg, model, dev, held) if cfg.frontend == "vision" else None
        if media is not None:
            dryrun_measured[arch] = media["dryrun_step"]
        emit({"phase": "serve", "arch": arch, "reduced": reduced, "device": smi,
              "params_gb": params_gb, "build_s": build_s,
              "launches": launches_here, "long_prefill_path_calls": len(long_calls),
              "max_len": srv.max_len, "requests": len(done), "tokens_out": tokens,
              "prefill_s_by_len": [[len(r.prompt), r.prefill_s] for r in done],
              "prefill_mean_s": prefill_t["mean_s"], "decode_steps": decode_t["count"],
              "decode_step_mean_s": decode_t["mean_s"],
              "decode_s_per_token": decode_t["total_s"] / tokens,
              "decode_tokens_per_s": tokens / decode_t["total_s"],
              "tokens_per_s": (tokens + len(done)) / wall, "wall_s": wall,
              "decode_vs_prefill_rel_err": decode_err,
              "decode_check_capacity_factor": cfg32.capacity_factor if cfg.n_experts else None,
              "warm_prefill_512_s": warm_prefill, "warm_decode_token_s": {
                  "median": statistics.median(warm_decode), "min": min(warm_decode),
                  "max": max(warm_decode)},
              "decode_bytes_gb": decode_bytes / 1e9,
              "decode_bound_ms": decode_bytes / H100_SXM.hbm_bw * 1e3,
              "analytic_bound": {"prefill_512": analytic_bound(cfg, "prefill", 512, 1),
                                 "decode": analytic_bound(cfg, "decode", 600, 1),
                                 "prefill_long": analytic_bound(cfg, "prefill", LONG_PROMPT, 1)
                                 if long else None},
              "profiled": windows, "peak_gb": peak_gb, "media": media})
        del model, srv, cache, last, want, finite
        gc.collect()
        torch.cuda.empty_cache()
    # starcoder2-3b at its published shapes: one LONG_PROMPT-token prefill
    # through the blocked local path (window 4096), counted a layer.
    arch = "starcoder2-3b"
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    model = build_lm(cfg, SEED, device=dev)
    params_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, LONG_PROMPT))).to(dev)
    long_s = []
    for _ in range(2):  # the first call includes the allocator's warm-up
        cache = build_cache(cfg, 1, LONG_PROMPT + 16, device=dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with counting("_local_attention_blocked") as long_calls:
            logits, cache = lm_prefill(cfg, model, toks, cache)
        torch.cuda.synchronize()
        long_s.append(time.perf_counter() - t0)
        check(len(long_calls) == cfg.n_layers and not _build.LAUNCHES,
              f"{arch}: {len(long_calls)} blocked-local calls, launches {dict(_build.LAUNCHES)}")
        check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    emit({"phase": "serve", "arch": arch, "params_gb": params_gb, "prefill_tokens": LONG_PROMPT,
          "block_size": lm_layers._pick_block_size(LONG_PROMPT, cfg.window),
          "long_prefill_path_calls": len(long_calls), "prefill_s": long_s,
          "analytic_bound": analytic_bound(cfg, "prefill", LONG_PROMPT, 1),
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del model, cache, logits, toks
    gc.collect()
    torch.cuda.empty_cache()

    # -- encode: the audio encoder at its published shapes, counted ---------------
    t_phase = time.perf_counter()
    emit({"phase": "encode", "device": smi, **encode_phase(dev),
          "seconds": time.perf_counter() - t_phase})
    gc.collect()
    torch.cuda.empty_cache()

    # -- obs: the registry around the elementary lower_cuda calls -----------------
    counters = {k: v for k, v in reg.counters.items() if k.endswith(".calls")}
    check(counters == {k: float(v) for k, v in calls.items()},
          f"lower_cuda call counters {counters} != calls made {calls}")
    n_2d = sum(v for k, v in counters.items() if not k.startswith("ir.lower_cuda.jacobi1d"))
    n_1d = sum(v for k, v in counters.items() if k.startswith("ir.lower_cuda.jacobi1d"))
    check((n_2d, n_1d) == (elem_launches.get("stencil_program_cuda"),
                           elem_launches.get("stencil_program_1d_cuda")),
          f"counters ({n_2d}, {n_1d}) != launch-counter increments")
    timers = []
    with metrics.using(reg):
        for name, fn in lowered.items():
            key = fn.metric_name
            stat = reg.timers[key].as_dict()
            arg = x1 if name.startswith("jacobi1d") else x3
            device_ms = graph_ms(lambda f=fn, a=arg: f(a))
            # graph_ms makes one warm-up call, then captures 10: capture steps aside.
            check(reg.counters[f"{key}.calls"] == stat["count"] + 1,
                  f"{key}: calls inside CUDA-graph capture were counted")
            timers.append({"timer": key, "calls": stat["count"],
                           "host_mean_ms": stat["mean_s"] * 1e3,
                           "device_ms_per_launch": device_ms})
    emit({"phase": "obs", "counters": counters, "timers": timers,
          "runtime_metadata": runtime_metadata(str(ROOT))})

    # -- timing --------------------------------------------------------------
    def bound(nbytes, ops, peak):
        t_bytes, t_ops = nbytes / H100_SXM.hbm_bw, ops / peak
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    def interior(shape, r, sweeps=1):
        d, rows, cols = shape
        return sum(d * max(rows - 2 * r, 0) * max(cols - 2 * r, 0) for _ in range(sweeps))

    def k2_bytes(prog, shape):
        """Compulsory bytes of one K2 launch (float32): each input an op
        reads, the ring of an input that only seeds an output's ring, each
        output."""
        n = shape[0] * shape[1] * shape[2]
        ring = n - interior(shape, prog.radius)
        read = {r.field for op in prog.ops for r in op.reads}
        words = sum(n if f in read else ring if f in prog.outputs else 0 for f in prog.inputs)
        return 4 * (words + n * len(prog.outputs))

    flops_pt = ir.hdiff_program().spec().flops  # 72: 26 MACs + 20 other ops
    mask_flops = 18  # K4 evaluates all nine taps: 9 multiplies + 9 adds per point
    jac_flops = 3  # coeff * ((a + b) + c) per point and sweep
    third = float(torch.tensor(1.0 / 3.0))
    # The library yardsticks (never called by the port) compute the interior
    # only: conv2d of the (D, 1, R, C) view with the 3x3 mask, conv1d of the
    # (B, 1, n) view with [c, c, c] (for k sweeps, the composed filter: c^2
    # [1, 2, 3, 2, 1], c^3 [1, 3, 6, 7, 6, 3, 1]); no padding, TF32 off.
    library_w = {name: torch.tensor(weights_for(name), device=dev).view(1, 1, 3, 3)
                 for name in ("jacobi2d_9pt", "laplacian")}
    library_c = {k: (third**k * torch.tensor(taps, device=dev)).view(1, 1, -1)
                 for k, taps in ((1, [1.0, 1, 1]), (2, [1.0, 2, 3, 2, 1]),
                                 (3, [1.0, 3, 6, 7, 6, 3, 1]))}
    timing = {}
    for shape, rshape in ((PAPER_GRID, PAPER_ROWS), (BIG_GRID, BIG_ROWS)):
        tag, rtag = "x".join(map(str, shape)), "x".join(map(str, rshape))
        n = shape[0] * shape[1] * shape[2]
        x = randn(shape)
        y = randn(rshape)
        x4 = x.view(shape[0], 1, shape[1], shape[2])
        y3 = y.view(rshape[0], 1, rshape[1])
        jac_pts = rshape[0] * max(rshape[1] - 2, 0)
        xq = (x * scale).to(torch.int32)
        coupled = ir.hdiff_coupled_program()
        xc = tuple(fields(coupled, shape).values())
        cases = [
            ("hdiff_cuda", "hdiff f32", lambda: k13.hdiff_cuda(x, COEFF),
             lambda: k13.hdiff_plain(x, COEFF), 2 * n * 4,
             interior(shape, 2) * flops_pt, H100_SXM.peak_flops_vpu_f32),
            ("hdiff_fixed_cuda", "hdiff i32", lambda: k13.hdiff_fixed_cuda(xq),
             lambda: hdiff_fixed_point_ref(xq, 26, 10), 2 * n * 4,
             interior(shape, 2) * flops_pt, H100_SXM_INT32_OPS),
            ("stencil_program_cuda", "hdiff x2", lambda: ir.stencil_program_cuda(hdiff2, (x,)),
             lambda: ir.stencil_program_plain(hdiff2, (x,)), 2 * n * 4,
             interior(shape, 2, sweeps=2) * flops_pt, H100_SXM.peak_flops_vpu_f32),
            ("stencil_program_cuda", "hdiff_coupled",
             lambda: ir.stencil_program_cuda(coupled, xc),
             lambda: ir.stencil_program_plain(coupled, xc), 3 * n * 4,
             interior(shape, 2) * coupled.spec().flops, H100_SXM.peak_flops_vpu_f32),
        ]
        cases = [(*c, tag, None) for c in cases]
        # K2's N-output site on the gradient path: hdiff_coupled's augmented
        # forward (6 outputs) and adjoint (2), on the grid padded by 2. Bytes:
        # every input an op reads, the ring of one that only seeds an output's
        # ring (the augmented forward's zero cache slots), every output.
        pshape = padded(shape, coupled)
        ptag = "x".join(map(str, pshape))
        for gname in ("hdiff_coupled.aug", "hdiff_coupled.adj"):
            prog = grad_progs[gname][1]
            args = tuple(torch.zeros(pshape, device=dev) if f.startswith("c~") and
                         gname.endswith(".aug") else a
                         for f, a in fields(prog, pshape).items())
            cases.append((GRAD_K2, gname, lambda p=prog, a=args: ir.stencil_program_cuda(p, a),
                          lambda p=prog, a=args: ir.stencil_program_plain(p, a),
                          k2_bytes(prog, pshape), interior(pshape, 2) * prog.spec().flops,
                          H100_SXM.peak_flops_vpu_f32, ptag, None))
        for mname in ("jacobi2d_9pt", "laplacian"):
            w = masks[mname]
            cases.append((
                "stencil2d_cuda", f"stencil2d {mname}", lambda w=w: k45.stencil2d_cuda(x, w),
                lambda w=w: k45.stencil2d_plain(x, w), 2 * n * 4,
                interior(shape, 1) * mask_flops, H100_SXM.peak_flops_vpu_f32, tag,
                lambda m=mname: torch.nn.functional.conv2d(x4, library_w[m])))
        ny = rshape[0] * rshape[1]
        cases.append((
            "jacobi1d_cuda", "jacobi1d", lambda: k45.jacobi1d_cuda(y),
            lambda: k45.jacobi1d_plain(y), 2 * ny * 4, jac_pts * jac_flops,
            H100_SXM.peak_flops_vpu_f32, rtag,
            lambda: torch.nn.functional.conv1d(y3, library_c[1])))
        for k in (1, 2, 3):
            cases.append((
                "stencil_program_1d_cuda", f"jacobi1d x{k}",
                lambda k=k: ir.stencil_program_1d_cuda(jac[k], y),
                lambda k=k: ir.stencil_program_1d_plain(jac[k], y), 2 * ny * 4,
                k * jac_pts * jac_flops, H100_SXM.peak_flops_vpu_f32, rtag,
                lambda k=k: torch.nn.functional.conv1d(y3, library_c[k])))
        for kernel, label, fn, plain, nbytes, ops, peak, grid, library in cases:
            ms = kernel_ms(fn, nbytes)
            plain_ms = event_ms(plain)
            library_ms = event_ms(library) if library is not None else None
            bound_ms, bound_by = bound(nbytes, ops, peak)
            row = {"kernel": kernel, "case": label, "grid": grid, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "achieved_gbps": nbytes / (ms * 1e-3) / 1e9, "library_ms": library_ms}
            timing[(kernel, label, grid)] = row
            emit({"phase": "timing", **row})
        del x, xq, xc, y, x4, y3, args, cases
        torch.cuda.empty_cache()

    # K7 and K6. K7's operations, per chunk of C steps and head, 2 flops a
    # MAC: r_dec S and k_tail^T v (C N^2 MACs each), and the strictly-lower
    # r_dec k_dec^T and att v (C (C - 1) / 2 * N MACs each); bytes: r, k, v,
    # w, y once, the state in and out, u. K6: a multiply and an add per
    # element; bytes: a, b (their dtype) and h once, h0, h_last.
    def time_row(kernel, label, shape, fn, plain, nbytes, ops):
        big = shape in (K7_BIG, K6_BIG)
        ms = kernel_ms(fn, nbytes, replays=10 if big else 25)
        bound_ms, bound_by = bound(nbytes, ops, H100_SXM.peak_flops_vpu_f32)
        row = {"kernel": kernel, "case": label, "grid": "x".join(map(str, shape)), "ms": ms,
               "plain_ms": event_ms(plain, reps=5 if big else 20), "bound_ms": bound_ms,
               "bound_by": bound_by, "achieved_gbps": nbytes / (ms * 1e-3) / 1e9,
               "achieved_tflops": ops / (ms * 1e-3) / 1e12, "library_ms": None}
        timing[(kernel, label, row["grid"])] = row
        emit({"phase": "timing", **row})

    for shape in (K7_SERVE, K7_BIG):
        b, t, h, n = shape
        r, k, v, w, u, s0 = wkv_inputs(shape)
        c = min(K7_CHUNK, t)
        ops, nbytes = k7.call_work(b, t, h, n, c)
        time_row("wkv6_cuda", "wkv6", shape, lambda: k7.wkv6_cuda(r, k, v, w, u, s0, chunk=c),
                 lambda: wkv6_plain(r, k, v, w, u, s0, chunk=c), nbytes, ops)
        del r, k, v, w, u, s0
        torch.cuda.empty_cache()
    for shape in (K6_SERVE, K6_BIG):
        a = 0.5 + 0.499 * torch.rand(shape, generator=gen, device=dev)
        b = randn(shape)
        h0 = randn((shape[0], shape[2]))
        ops, nbytes = k6.launch_work(*shape, 4)
        time_row("rglru_scan_cuda", "rglru f32", shape, lambda: k6.rglru_scan_cuda(a, b, h0),
                 lambda: rglru_seq_ref(a, b, h0), nbytes, ops)
        del a, b, h0
        torch.cuda.empty_cache()

    # -- sharded: the rows x cols decomposition ------------------------------------
    # (a) K2's offset mode, shard by shard, in this process: every slab that
    # lower_sharded hands K2 on each shard (the halo-padded block, with zeros
    # past the grid edge as the exchange gives an edge rank; under overlap the
    # unpadded interior and the four edge bands), launched with its global
    # offsets. Each slab's kept region must be bit-equal to the plain version
    # on the same slab and to the same region of the unsharded launch. Then
    # the gradient's zero-boundary launches (hdiff_coupled's augmented forward
    # and adjoint, on each 2x4 shard's padded block, no offsets) against their
    # plain versions. Errors are kept apart for the one- and N-output sites.
    offset_checks, shard_timing = 0, {}
    offset_err = {"stencil_program_cuda": 0.0, GRAD_K2: 0.0}

    def hold(site, label, got, want):
        nonlocal offset_checks
        err = (got.double() - want.double()).abs().max().item()
        offset_err[site] = max(offset_err[site], err)
        check(torch.equal(got, want), f"K2 offset mode {label}: max abs error {err}")
        offset_checks += 1

    for grid in (PAPER_GRID, BIG_GRID):
        gtag = "x".join(map(str, grid))
        for label, prog in shard_progs.items():
            arrays = tuple(fields(prog, grid).values())
            outs = tuple(prog.outputs) if len(prog.outputs) > 1 else (prog.passthrough,)
            site = GRAD_K2 if len(prog.outputs) > 1 else "stencil_program_cuda"

            def by_field(y, outs=outs):
                return y if isinstance(y, dict) else {outs[0]: y}

            whole = by_field(ir.stencil_program_cuda(prog, arrays))
            h = prog.radius
            padded_g = [torch.nn.functional.pad(a, (h, h, h, h)) for a in arrays]
            for n_row, n_col in SHARD_PARTITIONS:
                r, c = grid[1] // n_row, grid[2] // n_col
                # Every shard and slab at the paper grid; the timed block at the large.
                slabs = ([(i, j, sl) for i in range(n_row) for j in range(n_col)
                          for sl in shard_slabs(i, j, r, c, h)] if grid == PAPER_GRID
                         else [(1, 1, shard_slabs(1, 1, r, c, h)[0])])
                for i, j, sl in slabs:
                    name, row0, col0, rr, cc = sl
                    slab = tuple(a[:, row0 + h : row0 + h + rr, col0 + h : col0 + h + cc]
                                 .contiguous() for a in padded_g)
                    kw = dict(row_offset=row0, rows_global=grid[1], col_offset=col0,
                              cols_global=grid[2])
                    got = by_field(ir.stencil_program_cuda(prog, slab, **kw))
                    plain = by_field(ir.stencil_program_plain(prog, slab, **kw))
                    torch.cuda.synchronize()
                    for f in outs:
                        kept = got[f][:, h : rr - h, h : cc - h]
                        tag = f"{gtag}/{label}/{n_row}x{n_col} shard ({i}, {j}) {name}[{f}]"
                        hold(site, tag, kept, plain[f][:, h : rr - h, h : cc - h])
                        hold(site, tag + " vs unsharded", kept,
                             whole[f][:, row0 + h : row0 + rr - h, col0 + h : col0 + cc - h])
                    if (i, j, name) == (1, 1, "block"):
                        nbytes, ops = shard_bound_work(prog, grid[0], sl, grid[1:])
                        bound_ms, bound_by = bound(nbytes, ops, H100_SXM.peak_flops_vpu_f32)
                        row = {"kernel": "stencil_program_cuda", "case": f"{label} shard",
                               "grid": gtag, "mesh": f"{n_row}x{n_col}",
                               "block": "x".join(map(str, slab[0].shape)),
                               "ms": kernel_ms(lambda p=prog, b=slab, kw=kw:
                                               ir.stencil_program_cuda(p, b, **kw), nbytes),
                               "plain_ms": event_ms(lambda p=prog, b=slab, kw=kw:
                                                    ir.stencil_program_plain(p, b, **kw)),
                               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
                        shard_timing[(label, f"{n_row}x{n_col}", gtag)] = row
            del arrays, whole, padded_g, slab, got, plain
            torch.cuda.empty_cache()
    rr, cc = PAPER_GRID[1] // SHARD_MESH[0], PAPER_GRID[2] // SHARD_MESH[1]
    for q in (ir.augmented_forward(coupled), ir.adjoint(coupled)):
        h = q.radius
        padded_g = [torch.nn.functional.pad(a, (h, h, h, h))
                    for a in fields(q, PAPER_GRID).values()]
        for i in range(SHARD_MESH[0]):
            for j in range(SHARD_MESH[1]):
                slab = tuple(a[:, i * rr : i * rr + rr + 2 * h, j * cc : j * cc + cc + 2 * h]
                             .contiguous() for a in padded_g)
                got, plain = ir.stencil_program_cuda(q, slab), ir.stencil_program_plain(q, slab)
                torch.cuda.synchronize()
                for f in q.outputs:
                    hold(GRAD_K2, f"{q.name} 2x4 shard ({i}, {j}) zero boundary[{f}]",
                         got[f][:, h : h + rr, h : h + cc], plain[f][:, h : h + rr, h : h + cc])
        del padded_g, slab, got, plain
    # The batched ensemble's launch on shard (1, 1) of 2x4: SHARD_MEMBERS
    # members of hdiff k = 1 folded into the padded block's depth.
    prog, h = shard_progs["hdiff k=1"], shard_progs["hdiff k=1"].radius
    rr, cc = PAPER_GRID[1] // SHARD_MESH[0], PAPER_GRID[2] // SHARD_MESH[1]
    sl = shard_slabs(1, 1, rr, cc, h)[0]
    slab = (randn((SHARD_MEMBERS * PAPER_GRID[0], sl[3], sl[4])),)
    kw = dict(row_offset=sl[1], rows_global=PAPER_GRID[1], col_offset=sl[2],
              cols_global=PAPER_GRID[2])
    hold("stencil_program_cuda", f"batched x{SHARD_MEMBERS} shard (1, 1) block",
         ir.stencil_program_cuda(prog, slab, **kw)[:, h:-h, h:-h],
         ir.stencil_program_plain(prog, slab, **kw)[:, h:-h, h:-h])
    nbytes, ops = shard_bound_work(prog, SHARD_MEMBERS * PAPER_GRID[0], sl, PAPER_GRID[1:])
    bound_ms, bound_by = bound(nbytes, ops, H100_SXM.peak_flops_vpu_f32)
    shard_timing[(f"hdiff k=1 batched x{SHARD_MEMBERS}", "2x4", "x".join(map(str, PAPER_GRID)))] = {
        "kernel": "stencil_program_cuda", "case": f"hdiff k=1 batched x{SHARD_MEMBERS} shard",
        "grid": "x".join(map(str, PAPER_GRID)), "mesh": "2x4",
        "block": "x".join(map(str, slab[0].shape)),
        "ms": kernel_ms(lambda: ir.stencil_program_cuda(prog, slab, **kw), nbytes),
        "plain_ms": event_ms(lambda: ir.stencil_program_plain(prog, slab, **kw)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    del slab
    # (b) Eight gloo ranks on the one card, spawned now that every kernel is built.
    world = SHARD_MESH[0] * SHARD_MESH[1]
    work = ROOT / "build" / "repro_torch"
    t0 = time.perf_counter()
    ranks = run_ranks(_sharded_rank_body, world, work, timeout=SHARD_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    chk = ranks[0]["checks"]
    for key in ("overlap_bit_equal", "hdiff k=1 bit_equal", "hdiff k=2 bit_equal",
                "hdiff k=3 bit_equal", "shallow_water bit_equal", "finite",
                "batched members bit_equal to unbatched sharded",
                "batched bit_equal to one-process lower_cuda"):
        check(chk[key], f"sharded 8-rank run: {key} is false")
    check(chk["grad bit_equal"] or chk["grad max_rel_err"] <= GRAD_TOL,
          f"sharded gradient off by {chk['grad max_rel_err']} (relative)")
    for label, w in ranks[0]["wire"].items():
        check(w["sent_bytes"] == w["model_bytes"],
              f"sharded {label}: {w['sent_bytes']} bytes sent != model {w['model_bytes']}")
    check(ranks[0]["wire"]["hdiff k=1"]["sent_bytes"] == 1_060_864,
          "hdiff k=1 round on 2x4 at 64x256x256 is not 1,060,864 bytes")
    batched_label = f"hdiff k=1 batched x{SHARD_MEMBERS}"
    check(ranks[0]["wire"][batched_label]["sent_bytes"] == SHARD_MEMBERS * 1_060_864,
          f"the batched round is not {SHARD_MEMBERS} x 1,060,864 bytes")
    # Per rank: hdiff k = 1-3 one launch a call, five under overlap (the
    # interior, then four edge bands); shallow_water one (three outputs);
    # a value-and-grad step three (forward, then the augmented forward and
    # the adjoint, both N-output); the batched ensemble one (its members
    # folded into the block's depth).
    per_rank = {"stencil_program_cuda": 3 * SHARD_STEPS * (1 + 5) + SHARD_STEPS
                + 3 * SHARD_GRAD_STEPS + SHARD_STEPS,
                KERNEL_N_OUT: SHARD_STEPS + 2 * SHARD_GRAD_STEPS}
    for r, res in enumerate(ranks):
        check(res["launches"] == per_rank, f"rank {r} launches {res['launches']} != {per_rank}")
        check(res["by_case"][batched_label] == {"stencil_program_cuda": SHARD_STEPS},
              f"rank {r}: batched launches {res['by_case'][batched_label]}")
    batched_sharded = sum(res["by_case"][batched_label]["stencil_program_cuda"]
                          for res in ranks)
    # Summed over the ranks: every launch, and the N-output ones (which
    # replace lower_pallas.py:273, the rest :263).
    sharded_launches = {k: sum(res["launches"][k] for res in ranks) for k in per_rank}
    host_label = ("8 gloo ranks time-sharing one H100, bands staged through host memory: "
                  "not a multi-GPU figure")
    step_s = {label: {"median_of_rank_medians": statistics.median(
                          statistics.median(res["secs"][label]) for res in ranks),
                      "slowest_rank_median": max(statistics.median(res["secs"][label])
                                                 for res in ranks)}
              for label in ranks[0]["secs"]}
    exchange_s = {part: {"median_of_rank_medians": statistics.median(
                             statistics.median(res["exchange_s"][part]) for res in ranks),
                         "slowest_rank_median": max(statistics.median(res["exchange_s"][part])
                                                    for res in ranks)}
                  for part in ranks[0]["exchange_s"]}
    emit({"phase": "sharded", "offset_mode": {
              "checks_bit_equal": offset_checks, "max_abs_err": offset_err,
              "partitions": ["x".join(map(str, m)) for m in SHARD_PARTITIONS],
              "timing": list(shard_timing.values())},
          "ranks": {"mesh": "x".join(map(str, SHARD_MESH)), "grid": list(PAPER_GRID),
                    "backend": "gloo", "spawn_s": spawn_s, "k2_launches": sharded_launches,
                    "k2_launches_batched": batched_sharded,
                    "checks": chk, "wire_per_round": ranks[0]["wire"],
                    "host_s_per_step": {"label": host_label, **step_s},
                    "exchange_s_per_round": {"label": host_label, "case": "hdiff halo 2",
                                             **exchange_s}}})

    # -- forecast: ensemble batching and forecast serving (M10) ---------------------
    # (a) Parity: a batched K2 launch (lower_batched, members folded into
    # depth) bit-equal to its plain version on the folded fields and, member
    # by member, to unbatched launches; one launch a batched call. Then K1-K4
    # past the grid's 65535 planes: two launches each, bit-equal.
    t_phase = time.perf_counter()
    fprog = ir.repeat(ir.hdiff_program(), FORECAST_K)
    batched_progs = {"hdiff k=1": ir.hdiff_program(), "hdiff k=2": fprog,
                     "shallow_water": ir.shallow_water_program(), "hdiff_coupled": coupled}
    fc_err = {"stencil_program_cuda": 0.0, GRAD_K2: 0.0}
    fc_checks = 0

    def counted(fn):
        """``fn()`` and the launches it made, by counter."""
        before = dict(_build.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {key: c - before.get(key, 0) for key, c in _build.LAUNCHES.items()
                     if c != before.get(key, 0)}

    def fc_hold(site, label, got, want):
        nonlocal fc_checks
        for f in want:
            err = (got[f].double() - want[f].double()).abs().max().item()
            fc_err[site] = max(fc_err[site], err)
            check(got[f].dtype == want[f].dtype and torch.equal(got[f], want[f]),
                  f"{label}[{f}]: max abs error {err}")
            fc_checks += 1

    def one_launch(prog):
        return {"stencil_program_cuda": 1, **({KERNEL_N_OUT: 1} if len(prog.outputs) > 1 else {})}

    cells = [(name, n, PAPER_GRID, torch.float32) for name in batched_progs
             for n in FORECAST_MEMBERS]
    cells += [(name, 3, shape, dtype) for name in batched_progs
              for shape, dtype in ((PAPER_GRID, torch.bfloat16), (RAGGED_GRID, torch.float32))]
    for name, n, shape, dtype in cells:
        prog = batched_progs[name]
        outs = tuple(prog.outputs) if len(prog.outputs) > 1 else (prog.passthrough,)
        site = GRAD_K2 if len(prog.outputs) > 1 else "stencil_program_cuda"

        def by_field(y, outs=outs):
            return y if isinstance(y, dict) else {outs[0]: y}

        x = fields(prog, (n, *shape), dtype)
        arg = x if len(prog.inputs) > 1 else x[prog.inputs[0]]
        label = f"{'x'.join(map(str, shape))}/{name}/N={n}/{str(dtype)[6:]}"
        got, used = counted(lambda: ir.lower_batched(prog, backend="cuda")(arg))
        check(used == one_launch(prog), f"batched {label}: launches {used}")
        got = by_field(got)
        plain = by_field(ir.stencil_program_plain(
            prog, tuple(a.reshape(-1, *shape[1:]) for a in x.values())))
        fc_hold(site, f"batched {label} vs plain", got,
                {f: v.reshape(n, *shape) for f, v in plain.items()})
        single = ir.lower_cuda(prog)
        for i in range(n):
            xi = {f: a[i] for f, a in x.items()}
            fc_hold(site, f"batched {label} member {i} vs unbatched",
                    {f: v[i] for f, v in got.items()},
                    by_field(single(xi if len(prog.inputs) > 1 else xi[prog.inputs[0]])))
        del x, arg, got, plain
    torch.cuda.empty_cache()
    xd = randn(DEEP_GRID)
    xq = (xd * scale).to(torch.int32)
    w9 = masks["jacobi2d_9pt"]
    sw_prog = ir.shallow_water_program()
    sw_deep = tuple(randn(DEEP_GRID) for _ in sw_prog.inputs)
    deep_cases = [
        ("hdiff_cuda", "K1", lambda: k13.hdiff_cuda(xd, COEFF), lambda: k13.hdiff_plain(xd, COEFF)),
        ("hdiff_fixed_cuda", "K3", lambda: k13.hdiff_fixed_cuda(xq),
         lambda: hdiff_fixed_point_ref(xq, 26, 10)),
        ("stencil2d_cuda", "K4 jacobi2d_9pt", lambda: k45.stencil2d_cuda(xd, w9),
         lambda: k45.stencil2d_plain(xd, w9)),
        ("stencil_program_cuda", "K2 hdiff", lambda: ir.stencil_program_cuda(hdiff2, (xd,)),
         lambda: ir.stencil_program_plain(hdiff2, (xd,))),
        ("stencil_program_cuda", "K2 shallow_water",
         lambda: ir.stencil_program_cuda(sw_prog, sw_deep),
         lambda: ir.stencil_program_plain(sw_prog, sw_deep)),
    ]
    deep = {}
    for key, label, kernel, plain in deep_cases:
        got, used = counted(kernel)
        want = {key: 2, **({KERNEL_N_OUT: 2} if label.endswith("shallow_water") else {})}
        check(used == want, f"{label} at {DEEP_GRID}: launches {used} != {want}")
        got, ref = (got, plain()) if isinstance(got, dict) else ({"": got}, {"": plain()})
        check(all(torch.equal(got[f], ref[f]) for f in ref),
              f"{label} at {DEEP_GRID} differs from its plain version")
        deep[label] = {"launches": used[key], "bit_equal": True}
    del xd, xq, sw_deep, got, ref
    torch.cuda.empty_cache()

    # (b) Serving, counted: ForecastServer(backend="cuda") serves 8 forecasts
    # of repeat(hdiff, 2) at max_batch 1, 2, 4 and 8, at the paper grid and at
    # fig14's nowcast tile; rounds interleave the batch sizes, each reports its
    # best round (fig14_serving.py). Then 8 members each of shallow_water (K2's
    # N-output site) and hdiff_coupled (multi-field) at max_batch 8. The
    # counters must read one K2 launch a batch.
    def drain(srv, prog, members):
        """Submits ``members`` and drains the server: (wall s, {rid:
        request}, rids, s of the submits)."""
        t0 = time.perf_counter()
        rids = [srv.submit(prog, m) for m in members]
        t1 = time.perf_counter()
        done = srv.run_until_idle()
        dt = time.perf_counter() - t0
        check(sorted(r.rid for r in done) == sorted(rids) and not any(r.failed for r in done),
              "a served forecast failed or went missing")
        return dt, {r.rid: r for r in done}, rids, t1 - t0

    serve_grids = {"paper": PAPER_GRID, "nowcast": NOWCAST_GRID}
    serve_members = {g: [randn(shape) for _ in range(N_FORECASTS)]
                     for g, shape in serve_grids.items()}
    servers = {}
    for g in serve_grids:
        shared = CompileCache(capacity=16)  # the batch size is part of the key
        servers[g] = {n: ForecastServer(backend="cuda", max_batch=n, cache=shared)
                      for n in BATCH_SIZES}
    coupled_members = {name: [fields(batched_progs[name], PAPER_GRID)
                              for _ in range(N_FORECASTS)]
                       for name in ("shallow_water", "hdiff_coupled")}
    coupled_srv = ForecastServer(backend="cuda", max_batch=N_FORECASTS)
    for _ in range(FORECAST_WARMUP):  # lowering and kernel loads land here
        for g in serve_grids:
            for srv in servers[g].values():
                drain(srv, fprog, serve_members[g])
        for name, ms in coupled_members.items():
            drain(coupled_srv, batched_progs[name], ms)
    # Each curve twice: with every result released after its drain (a client
    # that takes its forecasts), then kept, as the server keeps every retired
    # request in ``completed``: each step then allocates fresh device memory.
    for srv in (*servers["paper"].values(), *servers["nowcast"].values(), coupled_srv):
        srv.completed.clear()
    torch.cuda.synchronize()
    _build.reset_launches()
    best = {(g, n, kept): float("inf") for g in serve_grids for n in BATCH_SIZES
            for kept in (False, True)}
    best_submit = dict(best)
    for g in serve_grids:
        for kept in (False, True):
            for _ in range(FORECAST_ROUNDS):
                for n, srv in servers[g].items():
                    dt, _, _, submit_s = drain(srv, fprog, serve_members[g])
                    if not kept:
                        srv.completed.clear()
                    best[(g, n, kept)] = min(best[(g, n, kept)], dt)
                    best_submit[(g, n, kept)] = min(best_submit[(g, n, kept)], submit_s)
            for srv in servers[g].values():
                srv.completed.clear()
    coupled_s = {name: drain(coupled_srv, batched_progs[name], ms)[0]
                 for name, ms in coupled_members.items()}
    torch.cuda.synchronize()
    forecast_launches = dict(_build.LAUNCHES)
    steps = {n: -(-N_FORECASTS // n) for n in BATCH_SIZES}
    want = {"stencil_program_cuda": 2 * len(serve_grids) * FORECAST_ROUNDS
            * sum(steps.values()) + len(coupled_members), KERNEL_N_OUT: 1}
    check(forecast_launches == want, f"forecast launches {forecast_launches} != {want}")
    # Outside the count: every served result bit-equal to lower_cuda on that
    # member alone; a step's device work timed apart, its K2 launch from
    # graph replays and its stack's copy by CUDA events (at the nowcast tile
    # that is the copy's launch latency more than its work), the rest of a
    # step's wall time being the host's.
    single = ir.lower_cuda(fprog)
    serving = {}
    for g, shape in serve_grids.items():
        singles = [single(m) for m in serve_members[g]]
        rows = []
        for n, srv in servers[g].items():
            _, done, rids, _ = drain(srv, fprog, serve_members[g])
            for rid, want_i in zip(rids, singles):
                check(torch.equal(done[rid].result, want_i),
                      f"served {g} max_batch={n} rid {rid} != lower_cuda on that member")
            xb = torch.stack(serve_members[g][:n]).reshape(n * shape[0], *shape[1:])
            k2_ms = graph_ms(lambda xb=xb: ir.stencil_program_cuda(fprog, (xb,)))
            bound_ms, bound_by = bound(2 * xb.numel() * 4,
                                       n * interior(shape, 2, sweeps=FORECAST_K) * flops_pt,
                                       H100_SXM.peak_flops_vpu_f32)
            stack_ms = event_ms(lambda n=n: torch.stack(serve_members[g][:n]))
            ms_step = best[(g, n, False)] * 1e3 / steps[n]
            rows.append({"max_batch": n, "steps": steps[n],
                         "forecasts_per_s": N_FORECASTS / best[(g, n, False)],
                         "forecasts_per_s_results_kept": N_FORECASTS / best[(g, n, True)],
                         "ms_per_step": ms_step,
                         "ms_per_step_results_kept": best[(g, n, True)] * 1e3 / steps[n],
                         "device_ms_per_step": k2_ms + stack_ms,
                         "host_ms_per_step": ms_step - k2_ms - stack_ms,
                         "submit_ms_per_forecast":
                             best_submit[(g, n, False)] * 1e3 / N_FORECASTS,
                         "stack_us": stack_ms * 1e3,
                         "k2_us": k2_ms * 1e3, "k2_bound_us": bound_ms * 1e3,
                         "k2_bound_by": bound_by, "k2_us_per_member": k2_ms * 1e3 / n})
            del xb
            srv.completed.clear()
        serving[g] = {"grid": list(shape), "rows": rows,
                      "speedup_8_vs_1": rows[-1]["forecasts_per_s"] / rows[0]["forecasts_per_s"]}
    for name, ms in coupled_members.items():
        prog = batched_progs[name]
        srv = ForecastServer(backend="cuda", max_batch=N_FORECASTS)
        _, done, rids, _ = drain(srv, prog, ms)
        one = ir.lower_cuda(prog)
        for rid, m in zip(rids, ms):
            got = done[rid].result
            fc_hold(GRAD_K2 if len(prog.outputs) > 1 else "stencil_program_cuda",
                    f"served {name} rid {rid}", got if isinstance(got, dict) else {"": got},
                    one(m) if isinstance(got, dict) else {"": one(m)})
    # The kernels line's batched rows: K2 at N = 8 on the paper grid, hdiff x2
    # (one output) and shallow_water (N outputs), against their plain versions.
    fc_timing = {}
    for name, prog in (("hdiff k=2", fprog), ("shallow_water", sw_prog)):
        x8 = tuple(a.reshape(-1, *PAPER_GRID[1:]) for a in fields(
            prog, (N_FORECASTS, *PAPER_GRID)).values())
        shape8 = x8[0].shape
        bound_ms, bound_by = bound(k2_bytes(prog, shape8),
                                   interior(shape8, prog.chain[0].radius, sweeps=prog.steps)
                                   * prog.chain[0].spec().flops, H100_SXM.peak_flops_vpu_f32)
        fc_timing[name] = {
            "ms": kernel_ms(lambda p=prog, a=x8: ir.stencil_program_cuda(p, a),
                            k2_bytes(prog, shape8)),
            "plain_ms": event_ms(lambda p=prog, a=x8: ir.stencil_program_plain(p, a), reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by, "grid": "x".join(map(str, shape8))}
        del x8
    torch.cuda.empty_cache()

    # (c) The compile cache on fig14's deterministic schedule (two waves over
    # the four batch sizes, a fresh cache): 4 misses, then 4 hits; one
    # signature an entry; the warm wave loads no kernel and runs no nvcc.
    cache = CompileCache(capacity=16)
    sched = [randn(NOWCAST_GRID) for _ in range(max(BATCH_SIZES))]
    waves = []
    for _ in range(2):
        k0, b0 = len(_KERNELS), len(_build.NVCC_RUNS)
        for n in BATCH_SIZES:
            drain(ForecastServer(backend="cuda", max_batch=n, cache=cache), fprog, sched[:n])
        waves.append({"kernels_loaded": len(_KERNELS) - k0,
                      "nvcc_builds": len(_build.NVCC_RUNS) - b0})
    stats = cache.stats()
    check(stats == {"hits": 4, "misses": 4, "evictions": 0, "size": 4, "capacity": 16},
          f"cache schedule: {stats}")
    check(cache.hit_rate == 0.5 and cache.total_traces() == 4,
          f"cache: hit rate {cache.hit_rate}, signatures {cache.total_traces()}")
    check(waves[1] == {"kernels_loaded": 0, "nvcc_builds": 0}, f"warm wave built {waves[1]}")

    # (d) The NaN drill: 8 members, one poisoned; it fails alone and the
    # other 7 equal a run without it. Each member's probe is one field_stats
    # launch and one read of its seven scalars.
    clean = [randn(PAPER_GRID) for _ in range(N_FORECASTS)]
    poisoned = clean[3].clone()
    poisoned[0, 100, 100] = float("nan")
    srv = ForecastServer(backend="cuda", max_batch=N_FORECASTS,
                         monitor=HealthMonitor(policy="abort"))
    rids = [srv.submit(fprog, poisoned if i == 3 else m) for i, m in enumerate(clean)]
    done, drill_launches = counted(srv.run_until_idle)
    done = {r.rid: r for r in done}
    check(srv.stats == {"batches": 1, "members": 8, "completed": 7, "failed": 1,
                        "syncs": 1},
          f"NaN drill: {srv.stats}")
    check(drill_launches == {"stencil_program_cuda": 1, "field_stats": N_FORECASTS}
          and srv.monitor.reads == 7 * srv.monitor.probes == 7 * N_FORECASTS,
          f"NaN drill: launches {drill_launches}, {srv.monitor.reads} reads in "
          f"{srv.monitor.probes} probes")
    check(isinstance(done[rids[3]].error, NumericsError) and done[rids[3]].result is None,
          "the poisoned member did not fail with NumericsError")
    _, ref, ref_rids, _ = drain(ForecastServer(backend="cuda", max_batch=N_FORECASTS), fprog,
                                [m for i, m in enumerate(clean) if i != 3])
    for rid, ref_rid in zip([r for i, r in enumerate(rids) if i != 3], ref_rids):
        check(torch.equal(done[rid].result, ref[ref_rid].result),
              f"NaN drill: member {rid} differs from the run without the poison")
    # (e) The probe's kernel at a served COSMO-E member (batch[i], contiguous),
    # against its plain version, warm (CUDA-graph replays: 273 MB leaves
    # nothing in L2 between launches) and cold, beside its one-read bound.
    batch = randn((3, *ENSEMBLE_MEMBER))
    member = batch[1]
    member.view(-1)[4_000_000] = float("nan")
    check(torch.equal(field_stats_cuda(member), field_stats_cuda(member)),
          f"field_stats at {ENSEMBLE_MEMBER}: two launches differ")
    got_s, want_s = host_stats(field_stats(member)), host_stats(field_stats(member.cpu()))
    fs_err = max(abs(got_s[k] - want_s[k]) for k in ("mean", "l2"))
    check(all(got_s[k] == want_s[k] for k in ("size", "nan_count", "inf_count", "min", "max"))
          and all(abs(got_s[k] - want_s[k]) <= 1e-6 * abs(want_s[k]) for k in ("mean", "l2")),
          f"field_stats at {ENSEMBLE_MEMBER}: {got_s} against the plain version's {want_s}")
    fs_bytes = member.numel() * member.element_size()
    fs_timing = {"ms": graph_ms(lambda: field_stats_cuda(member)),
                 "cold_ms": cold_ms(lambda: field_stats_cuda(member)),
                 "plain_ms": event_ms(lambda: field_stats_plain(member), reps=5),
                 "bound_ms": fs_bytes / H100_SXM.hbm_bw * 1e3, "bound_by": "bytes",
                 "grid": "x".join(map(str, ENSEMBLE_MEMBER))}
    del batch, member
    torch.cuda.empty_cache()
    emit({"phase": "forecast", "program": f"repeat(hdiff, {FORECAST_K})",
          "parity": {"cells": len(cells), "checks_bit_equal": fc_checks,
                     "max_abs_err": fc_err, "deep": {"grid": list(DEEP_GRID), **deep}},
          "launches": forecast_launches, "serving": serving,
          "coupled_drain_s": coupled_s, "k2_batched_n8": fc_timing,
          "cache": {**stats, "hit_rate": cache.hit_rate, "signatures": cache.total_traces(),
                    "waves": waves},
          "nan_drill": {"failed": [r for r in rids if done[r].failed], "completed": 7,
                        "bit_equal_to_clean_run": True, "launches": drill_launches,
                        "reads": srv.monitor.reads},
          "field_stats": {**fs_timing, "max_abs_err": fs_err},
          "seconds": time.perf_counter() - t_phase})

    # -- driver: the shallow-water weather driver (M12) -----------------------------
    # (a) --devices 1 --inner cuda on the paper grid, through the example's
    # own entry point, counted: one N-output K2 launch a step. Then the
    # step it builds (lower_sharded on a one-rank mesh) held step by step
    # against lower_cuda (and the first steps against the plain version),
    # the final fields against the driver's, and the 50 MB {u, v, h}
    # checkpoint's write and read-back timed. (b) The --health drill on 2
    # gloo ranks through the command line, its lines and checkpoint held to
    # the reference test's. (c) --devices 8: gloo ranks time-sharing the
    # card, their host ms a step and round (one exchange round a step).
    import shutil
    import signal

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_weather_simulation as drv
    from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    work = ROOT / "build" / "repro_torch" / f"driver.{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    depth, size = PAPER_GRID[0], PAPER_GRID[1]
    grid_args = ["--depth", str(depth), "--size", str(size)]
    torch.cuda.synchronize()
    _build.reset_launches()
    one = drv.run(drv.parse_args([*grid_args, "--steps", str(DRIVER_STEPS), "--devices", "1",
                                  "--inner", "cuda"]))
    torch.cuda.synchronize()
    driver_launches = dict(_build.LAUNCHES)
    check(one["code"] == 0, f"driver --devices 1 exited {one['code']}")
    check(driver_launches == {"stencil_program_cuda": DRIVER_STEPS, KERNEL_N_OUT: DRIVER_STEPS},
          f"driver --devices 1 launches {driver_launches}")
    h0 = make_initial_field(depth, size, size, kind="gaussian", device=dev)
    state = {"u": torch.zeros_like(h0), "v": torch.zeros_like(h0), "h": h0}
    dist.init_process_group("gloo", store=dist.FileStore(str(work / "store"), 1), rank=0,
                            world_size=1)
    drv_step = ir.lower_sharded(sw, make_mesh((1, 1), ("rows", "cols"), backend="gloo",
                                              device=dev),
                                depth_axis=None, row_axis="rows", col_axis="cols", inner="cuda")
    lc = ir.lower_cuda(sw)
    driver_err, at_step = 0.0, {}
    for i in range(DRIVER_STEPS):
        got, want = drv_step(state), lc(state)
        for f in sw.outputs:
            check(torch.equal(got[f], want[f]), f"driver step {i + 1} field {f} != lower_cuda")
        if i < 2:
            plain = ir.stencil_program_plain(sw, tuple(state[f] for f in sw.inputs))
            for f in sw.outputs:
                driver_err = max(driver_err, (got[f] - plain[f]).abs().max().item())
                check(torch.equal(got[f], plain[f]), f"driver step {i + 1} {f}: K2 != plain")
        state = want
        at_step[i + 1] = state
    dist.destroy_process_group()
    for f in sw.outputs:
        check(np.array_equal(one["final"][f], state[f].cpu().numpy()),
              f"driver final {f} != {DRIVER_STEPS} lower_cuda steps")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(work / "ckpt", DRIVER_STEPS, state, {"step": DRIVER_STEPS})
    ckpt_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = restore_checkpoint(work / "ckpt", None, state)
    torch.cuda.synchronize()
    ckpt_read_s = time.perf_counter() - t0
    check(all(torch.equal(back[f], state[f]) for f in sw.outputs), "checkpoint round trip")
    ckpt_mb = sum(a.numel() * a.element_size() for a in state.values()) / 1e6
    # (b) The drill, as the reference test runs it, at the paper grid.
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    log = work / "events.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_weather_simulation.py"), *grid_args,
         "--devices", "2", *DRILL, "--ckpt-dir", str(work / "drill"), "--event-log", str(log)],
        capture_output=True, text=True, env=env, timeout=600)
    drill_s = time.perf_counter() - t0
    check(proc.returncode == 3, f"drill exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    check("BLOWUP_DETECTED step=9 field=h nan_count=1" in proc.stdout, proc.stdout)
    check(latest_step(work / "drill") == 6, "drill: latest step != 6")
    saved, extra = restore_checkpoint(work / "drill", 6, {f: torch.zeros(PAPER_GRID)
                                                          for f in sw.outputs})
    check(extra["fields"] == list(sw.outputs), f"drill checkpoint extra {extra}")
    for f in sw.outputs:
        check(torch.equal(saved[f], at_step[6][f].cpu()), f"drill checkpoint {f} != step 6")
    kinds = [json.loads(line) for line in log.read_text().splitlines()]
    check({e["data"]["field"] for e in kinds if e["kind"] == "health.probe"} == set(sw.outputs)
          and [e["data"]["step"] for e in kinds if e["kind"] == "health.blowup"] == [9],
          "drill flight recorder")
    # (c) --devices 8 on the one card.
    eight = drv.run(drv.parse_args([*grid_args, "--steps", str(DRIVER_STEPS), "--devices",
                                    str(DRIVER_RANKS), "--inner", "cuda"]))
    check(eight["code"] == 0, f"driver --devices {DRIVER_RANKS} exited {eight['code']}")
    for r, rank_counts in enumerate(eight["launches"]):
        check(rank_counts == driver_launches, f"driver rank {r} launches {rank_counts}")
    for f in sw.outputs:
        check(np.array_equal(eight["final"][f], one["final"][f]),
              f"driver --devices {DRIVER_RANKS} {f} != --devices 1")
    driver_ranks_n_out = sum(rank_counts[KERNEL_N_OUT] for rank_counts in eight["launches"])
    # The exchange round alone, on the same plan, in ranks of its own.
    rounds = run_ranks(_driver_round_body, DRIVER_RANKS, work, timeout=SHARD_TIMEOUT)
    round_ms = {k: [statistics.median(r[k]) * 1e3 for r in rounds] for k in ("post", "wait")}
    round_ms["total"] = [p + w for p, w in zip(round_ms["post"], round_ms["wait"])]
    one_ms, rank_ms = one["ms_per_step"], eight["rank_ms_per_step"]
    shutil.rmtree(work, ignore_errors=True)
    del state, at_step, back, saved, one, eight, h0
    # The driver's N-output launch on the whole paper grid, timed.
    swx = tuple(fields(sw, PAPER_GRID).values())
    n_pts = PAPER_GRID[0] * PAPER_GRID[1] * PAPER_GRID[2]
    sw_bound, sw_by = bound(k2_bytes(sw, PAPER_GRID), interior(PAPER_GRID, 1) * sw.spec().flops,
                            H100_SXM.peak_flops_vpu_f32)
    sw_timing = {"ms": kernel_ms(lambda: ir.stencil_program_cuda(sw, swx),
                                 k2_bytes(sw, PAPER_GRID)),
                 "plain_ms": event_ms(lambda: ir.stencil_program_plain(sw, swx)),
                 "bound_ms": sw_bound, "bound_by": sw_by, "library_ms": None}
    del swx
    emit({"phase": "driver", "grid": list(PAPER_GRID), "steps": DRIVER_STEPS,
          "program": sw.name, "points": n_pts,
          "devices_1": {"launches": driver_launches, "host_us_per_step": one_ms * 1e3,
                        "bit_equal_to_lower_cuda_each_step": True,
                        "k2_n_out_us": sw_timing["ms"] * 1e3,
                        "k2_n_out_bound_us": sw_bound * 1e3},
          "checkpoint": {"mb": ckpt_mb, "write_s": ckpt_write_s, "read_s": ckpt_read_s},
          "drill": {"ranks": 2, "seconds": drill_s, "blowup_line": "BLOWUP_DETECTED step=9 "
                    "field=h nan_count=1", "exit_code": 3, "latest_step": 6,
                    "checkpoint_equals_step_6": True},
          "devices_8": {"ranks": DRIVER_RANKS, "backend": "gloo",
                        "host_ms_per_step_by_rank": rank_ms,
                        "host_ms_per_step_median": statistics.median(rank_ms),
                        "mesh": rounds[0]["mesh"],
                        "round_ms_by_rank": round_ms,
                        "round_ms_median": {k: statistics.median(v)
                                            for k, v in round_ms.items()},
                        "k2_n_out_launches": driver_ranks_n_out,
                        "note": "gloo ranks time-sharing one card, bands staged through host "
                                "memory: not a multi-GPU figure; one exchange round a step, "
                                "timed alone (median of 20 a rank) in ranks of its own"},
          "seconds": time.perf_counter() - t_phase})

    # -- release: the stencil phases' tensors, before the LM serving phases -----------
    # main's names still bind the stencil, forecast and driver phases' fields,
    # ensembles and servers (PR 27 found 2.07 GB held by them before the
    # trainers); none is read from here on.
    held_before = live_cuda_tensors()
    mag = sign = on_card = diag_card = on_host = diag_host = xf = one_q = oracle = psi = \
        stencil = by_policy = final = diags = two = psi_q = final_q = ref_q = x3 = x1 = \
        lowered = legs = ref1 = library_w = library_c = serve_members = servers = shared = \
        coupled_members = coupled_srv = serving = singles = done = sched = clean = \
        poisoned = drv_step = lc = single = xi = deep = small = pool = got = plain = ref = \
        want = first = g = slices = long_paths = out = fit_out = tiles = windows = None
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "release", "before": held_before, "after": live_cuda_tensors()})

    # -- serve_full and serve_tp: glm4 and nemotron whole on the card, then every
    # serving LM tensor-parallel over 4 gloo ranks, each peak against the dry run
    t_phase = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            DRYRUN_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        predicted = {}
        for arch in SERVE_FULL_ARCHS:
            for kind, seq in (("prefill", SERVE_TP_PROMPT), ("decode", SERVE_TP_LEN)):
                predicted[(arch, kind)] = pool.submit(_dryrun_job, (arch, None, kind, seq, 1))
        for arch in SERVE_TP_ARCHS:
            for r in range(SERVE_TP_RANKS):
                predicted[(arch, r)] = pool.submit(_dryrun_job, (
                    arch, SERVE_TP_LAYERS.get(arch), "prefill", SERVE_TP_PROMPT, 1,
                    {"compute_dtype": "float32"}, SERVE_TP_MESH, r))
        full_lines = serve_full_phase(dev, smi, predicted)
        for line in full_lines:
            emit(line)
        tp_lines, serve_tp = serve_tp_phase(dev, smi, predicted, run_ranks)
    for line in tp_lines:
        emit(line)
    del predicted
    emit({"phase": "serve_tp", "seconds": time.perf_counter() - t_phase,
          "launches_summed": serve_tp["launches"], "kernel_errs": serve_tp["errors"]})

    # -- train: LM training, K6 and K7 forward and backward ---------------------------
    # (a) K6 under autograd at the trainer's shape and the large one: the
    # forward bit-equal to the plain version, the backward (K6 on reversed,
    # shifted time) bit-equal to the plain reverse recurrence on the same
    # glue and within GRAD_TOL of autograd through the plain forward; K6, K7
    # and K7's backward past 65535 batch rows (and K7's heads), two launches
    # each; K7 and its backward timed at the trainer's shape. (b) Smoke-config
    # steps at f32 on the card against the CPU's. (c) The RecurrentGemma
    # trainer at full width, counted. (d) The resume and SIGTERM drills at
    # the smoke config. (e) RWKV-6 and (f) qwen1.5 at full width, counted.
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.rglru import rglru_backward, rglru_reverse_ref, rglru_scan
    from repro_torch.models import lm_loss
    from repro_torch.tree import tree_flatten, tree_map
    from repro_torch.optim import optimizer_config_from_model
    from repro_torch.train import TrainConfig, init_train_state, make_train_step, train

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    k6_err, k6_autograd = 0.0, {}

    def plain_backward(a, h, h0, dh, dlast):
        d = torch.cat([dh[:, :-1], (dh[:, -1] + dlast)[:, None]], dim=1)
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = rglru_reverse_ref(a_next, d)
        h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
        return g * h_prev, g, a[:, 0] * g[:, 0]

    for shape in (K6_TRAIN, K6_BIG):
        a = (0.5 + 0.499 * torch.rand(shape, generator=gen, device=dev)).requires_grad_()
        b, h0 = randn(shape).requires_grad_(), randn((shape[0], shape[2])).requires_grad_()
        dh, dlast = randn(shape), randn((shape[0], shape[2]))
        h, last = rglru_scan(a, b, h0)
        h_p, last_p = rglru_seq_ref(a, b, h0)
        check(torch.equal(h, h_p) and torch.equal(last, last_p), f"K6 forward {shape}")
        got = torch.autograd.grad((h * dh).sum() + (last * dlast).sum(), (a, b, h0))
        ref = plain_backward(a.detach(), h.detach(), h0.detach(), dh, dlast)
        for x, y in zip(got, ref):
            k6_err = max(k6_err, (x - y).abs().max().item())
            check(torch.equal(x, y), f"K6 backward {shape} != plain reverse recurrence")
        want = torch.autograd.grad((h_p * dh).sum() + (last_p * dlast).sum(), (a, b, h0))
        rel = max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(got, want))
        check(rel <= GRAD_TOL, f"K6 backward {shape}: {rel} relative to autograd")
        args = (a.detach(), h.detach(), h0.detach(), dh, dlast)
        k6_autograd["x".join(map(str, shape))] = {
            "relative_to_autograd": rel, "bit_equal_to_plain_reverse": True,
            "backward_ms": event_ms(lambda: rglru_backward(*args), reps=5),
            "plain_backward_ms": event_ms(lambda: plain_backward(*args), reps=2)}
        del a, b, h0, dh, dlast, h, last, h_p, last_p, got, ref, want, args
    wide = {}
    a = 0.5 + 0.499 * torch.rand(K6_WIDE, generator=gen, device=dev)
    b, h0 = randn(K6_WIDE), randn((K6_WIDE[0], K6_WIDE[2]))
    _build.reset_launches()
    got = k6.rglru_scan_cuda(a, b, h0)
    torch.cuda.synchronize()
    wide["rglru_scan_cuda"] = dict(_build.LAUNCHES)
    for x, y in zip(got, rglru_seq_ref(a, b, h0)):
        check(torch.equal(x, y), f"K6 at {K6_WIDE}")
    for shape in K7_WIDE:
        r, k, v, w, u, s0 = wkv_inputs(shape)
        _build.reset_launches()
        got = k7.wkv6_cuda(r, k, v, w, u, s0, chunk=16)
        torch.cuda.synchronize()
        wide["x".join(map(str, shape))] = dict(_build.LAUNCHES)
        for x, y in zip(got, wkv6_plain(r, k, v, w, u, s0, chunk=16)):
            check((x - y).abs().max().item() <= K7_TOL * y.abs().max().item() + 1e-6,
                  f"K7 at {shape}")
    # K7's backward past 65535 batch rows.
    bwd_in = (*wkv_inputs(K7_WIDE[0]), randn(K7_WIDE[0]),
              randn((K7_WIDE[0][0], *K7_WIDE[0][2:], K7_WIDE[0][3])))
    _build.reset_launches()
    got = k7.wkv6_bwd_cuda(*bwd_in, chunk=16)
    torch.cuda.synchronize()
    wide["backward " + "x".join(map(str, K7_WIDE[0]))] = dict(_build.LAUNCHES)
    for x, y in zip(got, wkv6_backward_plain(*bwd_in, chunk=16)):
        err = (x - y).abs().max().item()
        check(err <= K7_TOL * y.abs().max().item() + 1e-6, f"K7 backward at {K7_WIDE[0]}")
        worst["wkv6_bwd_cuda"] = max(worst["wkv6_bwd_cuda"], err)
    check(wide == {"rglru_scan_cuda": {"rglru_scan_cuda": 2},
                   **{"x".join(map(str, sh)): {"wkv6_cuda": 2} for sh in K7_WIDE},
                   "backward " + "x".join(map(str, K7_WIDE[0])): {"wkv6_bwd_cuda": 2}},
          f"launches past 65535: {wide}")
    del a, b, h0, got, r, k, v, w, u, s0, bwd_in
    # K6 at the trainer's shape, timed cold (the train path's row: its 31 MB
    # would stay in L2 between graph replays).
    a = 0.5 + 0.499 * torch.rand(K6_TRAIN, generator=gen, device=dev)
    b, h0 = randn(K6_TRAIN), randn((K6_TRAIN[0], K6_TRAIN[2]))
    k6_train_ops, k6_train_nbytes = k6.launch_work(*K6_TRAIN, 4)
    k6_train_bound = bound(k6_train_nbytes, k6_train_ops, H100_SXM.peak_flops_vpu_f32)
    k6_train_timing = {"ms": kernel_ms(lambda: k6.rglru_scan_cuda(a, b, h0), k6_train_nbytes),
                       "plain_ms": event_ms(lambda: rglru_seq_ref(a, b, h0), reps=5),
                       "bound_ms": k6_train_bound[0], "bound_by": k6_train_bound[1],
                       "library_ms": None}
    del a, b, h0
    # K7 and its backward at the trainer's shape, timed cold: their
    # operations and bytes by ``k7.call_work`` and ``k7.bwd_call_work``. Of
    # the backward's operations (2 flops a multiply-add, per chunk, head and
    # batch row), all but sum_j G S (N^2) are the products k^T v, r~^T dy,
    # k^ G, dy S^T and v G^T (C N^2 each), the triangular products A, A^T
    # dy, tril(P) k~, tril(P)^T r~ (C (C - 1) / 2 * N each) and P with its
    # diagonal (C (C + 1) / 2 * N). The products at FP32 accuracy take least
    # on the tensor cores in 3xTF32, three TF32 multiply-adds a product
    # term: about 15 us at the data sheet's 495 TFLOP/s (the kernel keeps P
    # and the two products with tril(P) in FP32 on the CUDA cores, about
    # 7.5 us more at 67 TFLOP/s), sum_j G S at the FP32 rate. Either way the
    # bytes take longer (30.5 us), so "bound_by" reads "bytes".
    b, t, h, n = K7_TRAIN
    c = K7_CHUNK
    fwd_in = wkv_inputs(K7_TRAIN)
    bwd_in = (*fwd_in, randn(K7_TRAIN), randn((b, h, n, n)))
    bwd_simt = 2 * b * h * (t // c) * n * n
    bwd_ops, bwd_bytes = k7.bwd_call_work(b, t, h, n, c)
    bwd_mma = bwd_ops - bwd_simt
    fwd_ops, fwd_bytes = k7.call_work(b, t, h, n, c)
    t_bytes = bwd_bytes / H100_SXM.hbm_bw
    t_ops = 3 * bwd_mma / H100_TF32_TENSOR + bwd_simt / H100_SXM.peak_flops_vpu_f32
    bwd_bound = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    k7_train_timing = {}
    for name, fn, plain, nbytes, (bound_ms, bound_by) in (
            ("wkv6_cuda", lambda: k7.wkv6_cuda(*fwd_in, chunk=c),
             lambda: wkv6_plain(*fwd_in, chunk=c), fwd_bytes,
             bound(fwd_bytes, fwd_ops, H100_SXM.peak_flops_vpu_f32)),
            ("wkv6_bwd_cuda", lambda: k7.wkv6_bwd_cuda(*bwd_in, chunk=c),
             lambda: wkv6_backward_plain(*bwd_in, chunk=c), bwd_bytes, bwd_bound)):
        k7_train_timing[name] = {"ms": kernel_ms(fn, nbytes), "plain_ms": event_ms(plain, reps=5),
                                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    k7_train_timing["wkv6_bwd_cuda"].update(bytes=bwd_bytes, flops=bwd_ops)
    del fwd_in, bwd_in
    # (b) One smoke-config step, card against CPU, at float32 compute: the
    # second step (a first on the CPU gives both a non-zero state), with a
    # one-step warmup so it moves every parameter at the full learning rate;
    # the state within TRAIN_TOL and each parameter's step delta within
    # DELTA_TOL of its largest on the CPU.
    # RecurrentGemma at 32 tokens; RWKV-6 at 128, two 64-step chunks (K7 and
    # its backward on the card). RWKV-6's step deltas are held to the same
    # step on the card with K7's plain versions in place of the kernels: the
    # card's own f32 rounding moves its Adam-normalised updates of
    # near-zero gradients by about 6 % of a leaf's largest against the CPU
    # (K7 plays no part in that: the plain versions on the card do the same),
    # and the kernels may add at most DELTA_TOL to it.
    from repro_torch.kernels.wkv6 import ops as wkv6_ops

    @contextlib.contextmanager
    def plain_wkv6():
        kernels = wkv6_ops.wkv6_cuda, wkv6_ops.wkv6_bwd_cuda
        wkv6_ops.wkv6_cuda = lambda *a, chunk: wkv6_plain(*a, chunk=chunk)
        wkv6_ops.wkv6_bwd_cuda = lambda *a, chunk: wkv6_backward_plain(*a, chunk=chunk)
        try:
            yield
        finally:
            wkv6_ops.wkv6_cuda, wkv6_ops.wkv6_bwd_cuda = kernels

    # llama-vision with memory in every batch and its gates at MEDIA_GATE (at
    # their zero init the cross layers would train nothing), hubert on frames.
    step_err, delta_err = {}, {}
    smoke_launches = {TRAIN_ARCH: {"rglru_scan_cuda"},
                      RWKV_TRAIN_ARCH: {"wkv6_cuda", "wkv6_bwd_cuda"}}
    for arch, seq in ((TRAIN_ARCH, 32), (RWKV_TRAIN_ARCH, 128), (VISION_ARCH, 32),
                      (AUDIO_TRAIN_ARCH, 32)):
        small = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
        sdata = MediaData(small, SyntheticLM(DataConfig(
            seq_len=seq, global_batch=4, vocab_size=small.vocab_size, seed=SEED)))
        sstep = make_train_step(small, dataclasses.replace(optimizer_config_from_model(small),
                                                           warmup_steps=1))
        state0 = init_train_state(small, "cpu", seed=SEED)
        set_gates(state0[0]["blocks"], MEDIA_GATE)
        host_state = sstep(*state0, sdata.batch_at(0))[:2]
        before = [t.clone() for t in tree_flatten(host_state[0])[0]]
        start_state = tree_map(lambda t: t.clone(), host_state)  # the step updates in place

        def card_step():
            *state, metrics_ = sstep(*tree_map(lambda t: t.to(dev), start_state),
                                     sdata.batch_at(1))
            return state, metrics_

        _build.reset_launches()
        card_state, m_card = card_step()
        check(set(_build.LAUNCHES) == smoke_launches.get(arch, set()),
              f"{arch} smoke step launches {dict(_build.LAUNCHES)}")
        *host_state, m_host = sstep(*host_state, sdata.batch_at(1))
        step_err[arch] = max([abs(float(m_card["loss"]) - float(m_host["loss"]))] + [
            (x.cpu() - y).abs().max().item()
            for x, y in zip(tree_flatten(card_state)[0], tree_flatten(host_state)[0])])
        check(step_err[arch] <= TRAIN_TOL, f"{arch} smoke train step, card vs CPU: "
              f"{step_err[arch]}")

        def worst_delta(params):
            worst = 0.0
            for p0, pc, ph in zip(before, tree_flatten(params)[0],
                                  tree_flatten(host_state[0])[0]):
                want = ph - p0
                check(want.abs().max().item() > 0, f"{arch} smoke train step moved no "
                      "parameter of a leaf")
                worst = max(worst, ((pc.cpu() - p0) - want).abs().max().item()
                            / want.abs().max().item())
            return worst

        delta_err[arch] = worst_delta(card_state[0])
        allowed = DELTA_TOL
        if arch == RWKV_TRAIN_ARCH:
            _build.reset_launches()
            with plain_wkv6():
                plain_state, _ = card_step()
            check(not _build.LAUNCHES, f"plain K7 step launched {dict(_build.LAUNCHES)}")
            delta_err[f"{arch} plain versions"] = worst_delta(plain_state[0])
            allowed += delta_err[f"{arch} plain versions"]
            del plain_state
        check(delta_err[arch] <= allowed, f"{arch} smoke train step deltas, card vs CPU: "
              f"{delta_err[arch]} (allowed {allowed})")
        del card_state, host_state, before, start_state
    # (c) The full-width trainers, counted: RecurrentGemma here, RWKV-6 and
    # qwen1.5 after the drills.
    def full_width_train(arch, want, layers=None, steps=TRAIN_STEPS):
        """``train()`` on ``arch`` at its published widths (``layers`` deep
        when given), ``steps`` steps of TRAIN_BATCH x TRAIN_SEQ tokens with
        the counters reset just before (they must read ``want``), then one
        step more, profiled (its aux loss: the MoE's, summed over layers).
        The state is freed before it returns."""
        full = get_config(arch)
        reduced = None
        if layers:
            reduced = {"n_layers": [full.n_layers, layers]}
            full = dataclasses.replace(full, n_layers=layers)
        ds = MediaData(full, SyntheticLM(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                                    vocab_size=full.vocab_size, seed=SEED)))
        logs = []
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        held = live_cuda_tensors()  # earlier phases' tensors still alive, and what they are
        held_gb = held["allocated_bytes"] / 1e9
        _build.reset_launches()
        t0 = time.perf_counter()
        params, opt_state, hist = train(full, TrainConfig(steps=steps, log_every=1), ds,
                                        device=dev, seed=SEED, log_fn=logs.append)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak_bytes = torch.cuda.max_memory_allocated()
        peak_gb = peak_bytes / 1e9
        check(launches == want, f"{arch} trainer launches {launches} != {want}")
        gnorms = [float(m) for m in re.findall(r"gnorm ([-+0-9.eEnaif]+)", " ".join(logs))]
        losses = [h["loss"] for h in hist]
        check(len(losses) == steps and all(np.isfinite(losses))
              and len(gnorms) == steps and all(np.isfinite(gnorms)),
              f"{arch} trainer: losses {losses}, grad norms {gnorms}")
        # A random head's first loss is ln(vocab) plus the logits' spread.
        check(abs(losses[0] - np.log(full.vocab_size)) <= 2.0,
              f"{arch} trainer: first loss {losses[0]}, ln(vocab) {np.log(full.vocab_size)}")
        n_params = sum(p.numel() for p in tree_flatten(params)[0])
        # One step more, profiled: the device's busy share of a full-width step.
        fstep = make_train_step(full, optimizer_config_from_model(full))
        fbatch = ds.batch_at(steps)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt_state, fmetrics = fstep(params, opt_state, fbatch)
            torch.cuda.synchronize()
            prof_us = (time.perf_counter() - t0) * 1e6
        aux_loss = float(fmetrics["aux_loss"])
        check(np.isfinite(aux_loss) and (aux_loss > 0) == bool(full.n_experts),
              f"{arch} trainer: aux loss {aux_loss}")
        seen = device_kernels(prof)
        busy_us = sum(v["device_us"] for v in seen.values())
        top = sorted(seen.items(), key=lambda kv: -kv[1]["device_us"])[:6]
        port_us = {key[:60]: v for key, v in seen.items() if "rglru" in key or "wkv6" in key}
        del params, opt_state, fstep, prof, seen
        gc.collect()
        torch.cuda.empty_cache()
        return {"layers": full.n_layers, "reduced": reduced, "params": n_params,
                "batch": TRAIN_BATCH, "aux_loss_profiled_step": aux_loss,
                "analytic_bound_per_step": analytic_bound(full, "train", TRAIN_SEQ, TRAIN_BATCH),
                "seq": TRAIN_SEQ, "compute": full.compute_dtype, "remat": full.remat,
                "steps": steps, "losses": losses, "grad_norms": gnorms,
                "host_ms_per_step": [h["dt"] * 1e3 for h in hist], "train_s": train_s,
                "launches": launches,
                "launches_per_step": {k: v / steps for k, v in launches.items()},
                "peak_memory_gb": peak_gb, "held_before_gb": held_gb,
                "peak_bytes": peak_bytes, "held_before": held,
                "profiled_step": {"window_us": prof_us, "device_busy_us": busy_us,
                                  "busy_share": busy_us / prof_us, "port_kernels": port_us,
                                  "top": {k: v for k, v in top}}}

    n_rglru = get_config(TRAIN_ARCH).layer_kinds.count("rglru")
    trainers = {TRAIN_ARCH: full_width_train(  # forward, recompute and backward
        TRAIN_ARCH, {"rglru_scan_cuda": 3 * n_rglru * TRAIN_STEPS})}
    # (d) Resume and SIGTERM drills at the smoke config (bf16 compute, as published).
    small = get_smoke_config(TRAIN_ARCH)
    sds = SyntheticLM(DataConfig(seq_len=32, global_batch=4, vocab_size=small.vocab_size,
                                 seed=SEED))

    def quiet(*_):
        return None

    ref_state = train(small, TrainConfig(steps=6, log_every=100), sds, device=dev, seed=SEED,
                      log_fn=quiet)[:2]
    work = ROOT / "build" / "repro_torch" / f"train.{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    tc = TrainConfig(steps=6, ckpt_every=2, ckpt_dir=str(work / "resume"), log_every=100)
    first = train(small, tc, sds, device=dev, seed=SEED, log_fn=quiet)[2]
    again = train(small, tc, sds, device=dev, seed=SEED, log_fn=quiet)[2]
    check([h["step"] for h in first] == list(range(6)) and again == []
          and latest_step(work / "resume") == 5, "resume drill")

    def preempt(msg):
        if "step 3 " in msg:
            os.kill(os.getpid(), signal.SIGTERM)

    tc = TrainConfig(steps=6, ckpt_every=2, ckpt_dir=str(work / "sigterm"), log_every=1)
    cut = train(small, tc, sds, device=dev, seed=SEED, log_fn=preempt)[2]
    check([h["step"] for h in cut] == [0, 1, 2, 3] and latest_step(work / "sigterm") == 3,
          f"SIGTERM drill: steps {[h['step'] for h in cut]}")
    *resumed, rest = train(small, tc, sds, device=dev, seed=SEED, log_fn=preempt)
    check([h["step"] for h in rest] == [4, 5], "SIGTERM drill: resume")
    resume_err = max((x - y).abs().max().item() for x, y in
                     zip(tree_flatten(resumed)[0], tree_flatten(ref_state)[0]))
    check(resume_err == 0.0, f"resumed run differs from the uninterrupted one by {resume_err}")
    shutil.rmtree(work, ignore_errors=True)
    # (e) RWKV-6 at its published widths: K7 forward and remat recompute, and
    # its backward, once a layer each a step. (f) qwen1.5: no kernel.
    n_rwkv = get_config(RWKV_TRAIN_ARCH).n_layers
    trainers[RWKV_TRAIN_ARCH] = full_width_train(
        RWKV_TRAIN_ARCH, {"wkv6_cuda": 2 * n_rwkv * TRAIN_STEPS,
                          "wkv6_bwd_cuda": n_rwkv * TRAIN_STEPS})
    trainers[DENSE_TRAIN_ARCH] = full_width_train(DENSE_TRAIN_ARCH, {})
    # (g) qwen3-moe at its published widths, one layer: the MoE (plain
    # tensor code) forward, remat recompute and backward; no kernel.
    trainers[MOE_TRAIN_ARCH] = full_width_train(MOE_TRAIN_ARCH, {}, layers=MOE_TRAIN_LAYERS)
    # (h) arctic at its published widths, one layer, one process: Adafactor
    # on 28.2 GB of bf16 weights and 28.2 GB of bf16 gradients, the clip
    # and the update slice by slice (no float32 copy of a leaf); no kernel.
    trainers[ARCTIC_TRAIN_ARCH] = full_width_train(ARCTIC_TRAIN_ARCH, {},
                                                   layers=ARCTIC_TRAIN_LAYERS,
                                                   steps=ARCTIC_TRAIN_STEPS)
    # (i) hubert at its published widths and depth (48 layers, 0.95 G), on
    # frames of 4 x 256: no kernel, finite losses near ln 504. (llama-vision
    # is not trained at published widths: one superblock's 6.38 G
    # parameters need about 89 GB of masters, gradients, moments and the
    # compute copy, more than the card's 80 GB.)
    trainers[AUDIO_TRAIN_ARCH] = full_width_train(AUDIO_TRAIN_ARCH, {})
    emit({"phase": "train", "device": smi, "archs": list(trainers),
          "k6_autograd": k6_autograd, "k6_k7_past_65535": wide,
          "smoke_step_card_vs_cpu_max_err": step_err,
          "smoke_step_card_vs_cpu_delta_err": delta_err,
          "k7_train_timing": k7_train_timing,
          "full_width": trainers,
          "resume": {"steps": 6, "ckpt_every": 2, "rerun_steps": 0, "sigterm_at": 3,
                     "resumed_max_abs_diff": resume_err},
          "seconds": time.perf_counter() - t_phase})

    # -- moe_sharded: the expert-parallel MoE on gloo ranks sharing the card --------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe = run_ranks(_moe_rank_body, MOE_RANKS, ROOT / "build" / "repro_torch",
                    timeout=MOE_TIMEOUT)
    moe_s = time.perf_counter() - t0
    mp = MOE_MESHES[0][1]
    for rank, found in enumerate(moe):
        check(not found["launches"], f"moe_sharded rank {rank} launched {found['launches']}")
        for case, e in found["forward"].items():
            check(e["max_abs_err"] <= MOE_TOL and e["aux_rel_err"] <= 1e-5,
                  f"moe_sharded rank {rank} {case}: {e} (bounds {MOE_TOL}, 1e-5)")
        lm = found["lm"]
        check(lm["loss_abs_err"] <= MOE_TOL and lm["grad_max_abs_err"] <= MOE_TOL
              and abs(lm["aux_loss"][0] - lm["aux_loss"][1]) <= 1e-5 * lm["aux_loss"][1],
              f"moe_sharded rank {rank} LM loss and gradients, sharded vs local: {lm}")
        fw = found["full_width"]["sum_over_model"]
        check(found["full_width"]["finite"] and fw["bytes_each"] == fw["t_loc_d_2"],
              f"moe_sharded rank {rank} full width: {found['full_width']}")
    # bfloat16: each model rank rounds its partial output before the bf16 sum,
    # as the JAX psum in the compute dtype does: one bf16 step of max|y| a rank.
    full0 = moe[0]["full_width"]
    moe_bound = mp * 2.0**-7 * full0["max_abs_ref"]
    check(full0["max_abs_err"] <= moe_bound and full0["aux_rel_err"] <= 1e-5,
          f"moe_sharded full width bf16 vs local: {full0} (bound {moe_bound})")
    # (d) A decode token moves tokens, not weights: the router's pieces and
    # the combined outputs alone cross ``model``.
    for rank, found in enumerate(moe):
        one = found["one_token"]
        check(one["finite"] and one["gather_bytes"] == one["router_piece_bytes"]
              and one["sum_over_bytes"] == one["outputs_bytes"],
              f"moe_sharded rank {rank} one-token step wire: {one}")
    one0 = moe[0]["one_token"]
    check(one0["max_abs_err"] <= mp * 2.0**-7 * one0["max_abs_ref"],
          f"moe_sharded one-token step bf16 vs local: {one0}")
    emit({"phase": "moe_sharded", "device": smi,
          "note": f"{MOE_RANKS} gloo ranks time-sharing one card, sums staged through host "
                  "memory: not a multi-GPU figure",
          "meshes": [list(m) for m in MOE_MESHES], "tolerance_f32": MOE_TOL,
          "full_width_bf16_bound": moe_bound, "spawn_s": moe_s,
          "ranks": [{k: found[k] for k in ("forward", "lm", "full_width", "one_token")}
                    for found in moe]})

    # -- train_sharded: the LM trainer sharded over gloo ranks sharing the card ----
    from repro_torch.train import shape_for_microbatches

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work_dir = ROOT / "build" / "repro_torch"
    # Part (d)'s peaks, predicted by the dry run in spawned children (no
    # card) while parts (a)-(c) run: rank 0 of each case's mesh (every rank
    # holds pieces of one shape).
    tp_pool = concurrent.futures.ProcessPoolExecutor(
        len(TP_CASES), mp_context=multiprocessing.get_context("spawn"))
    tp_predicted = [tp_pool.submit(_dryrun_job, (arch, layers, "train", TRAIN_SEQ, TRAIN_BATCH,
                                                 {"compute_dtype": "float32"}, shape, 0))
                    for arch, shape, layers in TP_CASES]
    # (a) Smoke LMs at float32, every mesh, against one process on the card.
    smoke = run_ranks(_train_sharded_rank_body, SHARDED_RANKS, work_dir,
                      {"part": "smoke", "device": None, "archs": SHARDED_SMOKE,
                       "meshes": SHARDED_MESHES}, timeout=SHARDED_TIMEOUT)
    smoke_s = time.perf_counter() - t_phase
    sharded_train_launches = {}
    smoke_err = {}
    for arch in SHARDED_SMOKE:
        cfg = sharded_smoke_cfg(arch)
        opt = dataclasses.replace(optimizer_config_from_model(cfg), warmup_steps=1)
        params, state = init_train_state(cfg, dev, seed=SEED)
        step = make_train_step(cfg, opt, microbatches=SHARDED_MB)
        ref = {"loss": [], "grad_norm": []}
        for batch in sharded_batches(cfg, SHARDED_SMOKE_SEQ.get(arch, 32),
                                     SHARDED_STEPS, SEED):
            params, state, m = step(params, state, shape_for_microbatches(batch, SHARDED_MB))
            ref["loss"].append(float(m["loss"]))
            ref["grad_norm"].append(float(m["grad_norm"]))
        ref_leaves = [t.to("cpu", torch.float32).numpy()
                      for t in tree_flatten((params, state))[0]]
        bf16 = [t.dtype == torch.bfloat16 for t in tree_flatten((params, state))[0]]
        del params, state, step
        n_rglru = cfg.layer_kinds.count("rglru")
        n_rwkv = cfg.layer_kinds.count("rwkv6")
        per_rank = SHARDED_MB * SHARDED_STEPS
        want = {k: v * per_rank for k, v in (("rglru_scan_cuda", 3 * n_rglru),
                                              ("wkv6_cuda", 2 * n_rwkv),
                                              ("wkv6_bwd_cuda", n_rwkv)) if v}
        for shape in SHARDED_MESHES:
            key = f"{arch} {shape}"
            got = smoke[0][key]
            for rank, found in enumerate(smoke):
                check(found[key]["loss"] == got["loss"]
                      and found[key]["grad_norm"] == got["grad_norm"],
                      f"train_sharded {key}: rank {rank}'s metrics differ from rank 0's")
                check(found[key]["launches"] == want,
                      f"train_sharded {key} rank {rank} launches {found[key]['launches']} "
                      f"!= {want}")
                for k, v in found[key]["launches"].items():
                    sharded_train_launches[k] = sharded_train_launches.get(k, 0) + v
            rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
            err = {"loss_rel": max(rel(a, b) for a, b in zip(got["loss"], ref["loss"])),
                   "grad_norm_1_rel": rel(got["grad_norm"][0], ref["grad_norm"][0]),
                   "grad_norm_2_rel": rel(got["grad_norm"][1], ref["grad_norm"][1])}

            leaves = tree_flatten(got["whole"])[0]
            check(len(leaves) == len(ref_leaves), f"train_sharded {key}: tree differs")
            err["leaf_max_abs"] = max(float(np.abs(a - b).max())
                                      for a, b in zip(leaves, ref_leaves))
            err["leaf_excess"] = max(float((np.abs(a - b) - TRAIN_TOL
                                            - (2.0**-8 * np.abs(b) if w else 0)).max())
                                     for a, b, w in zip(leaves, ref_leaves, bf16))
            check(err["loss_rel"] <= SHARDED_LOSS_REL
                  and err["grad_norm_1_rel"] <= SHARDED_LOSS_REL
                  and err["grad_norm_2_rel"] <= SHARDED_NORM2_REL
                  and err["leaf_excess"] <= 0,
                  f"train_sharded {key} against one process: {err}")
            smoke_err[key] = err
            del got["whole"]
    del smoke

    def full_sharded(cfg, shape, steps, batch):
        world = shape[0] * shape[1]
        t0 = time.perf_counter()
        ranks = run_ranks(_train_sharded_rank_body, world, work_dir,
                          {"part": "full", "device": None, "cfg": cfg, "mesh": shape,
                           "steps": steps, "batch": batch}, timeout=SHARDED_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        wire = shard_wire_reckoning(cfg, shape, batch, TRAIN_SEQ)
        for rank, found in enumerate(ranks):
            check(found["finite"] and found["loss"] == ranks[0]["loss"],
                  f"train_sharded {cfg.name} rank {rank}: losses {found['loss']}")
            check(not found["launches"], f"train_sharded {cfg.name} launched "
                  f"{found['launches']}")
            check(all(b == wire["gather"] for b in found["gather_bytes"])
                  and all(b == wire["grad_sum"] for b in found["grad_sum_bytes"]),
                  f"train_sharded {cfg.name} rank {rank} wire {found['gather_bytes']} "
                  f"{found['grad_sum_bytes']} != reckoning {wire}")
        check(abs(ranks[0]["loss"][0] - np.log(cfg.vocab_size)) <= 2.0,
              f"train_sharded {cfg.name}: first loss {ranks[0]['loss'][0]}")
        host_ms = [[r["host_s"][i] * 1e3 for r in ranks] for i in range(steps)]
        split = [r["split"] for r in ranks]
        check(all(sp["device_kernel_ms"] > 0 and sp["collective_calls"] > 0 for sp in split),
              f"train_sharded {cfg.name}: the profiled step saw no kernel or collective {split}")
        return {"layers": cfg.n_layers, "mesh": list(shape), "tokens": batch * TRAIN_SEQ,
                "steps": steps, "loss": ranks[0]["loss"], "grad_norm": ranks[0]["grad_norm"],
                "aux_loss": ranks[0]["aux_loss"],
                "host_ms_median": [statistics.median(s) for s in host_ms],
                "host_ms_slowest": [max(s) for s in host_ms],
                "init_s": [r["init_s"] for r in ranks],
                "peak_gb": [r["peak_gb"] for r in ranks],
                "peak_gb_sum": sum(r["peak_gb"] for r in ranks),
                "pieces_gb": [r["piece_gb"] for r in ranks],
                "gather_bytes_per_step": ranks[0]["gather_bytes"],
                "grad_sum_bytes_per_step": ranks[0]["grad_sum_bytes"],
                "wire_reckoning": {k: wire[k] for k in ("gather", "grad_sum")},
                "spawn_s": spawn_s,
                "profiled_step_split": split,
                "profiled_step_device_kernel_ms_sum": sum(sp["device_kernel_ms"] for sp in split)}

    # (b) qwen1.5-0.5b at published widths, 4 of 24 layers, on (4, 1),
    # against one device's steps at that depth (bf16 compute).
    gc.collect()
    torch.cuda.empty_cache()
    dense_full = get_config(DENSE_TRAIN_ARCH)
    dense_cfg = dataclasses.replace(dense_full, n_layers=SHARDED_DENSE_LAYERS)
    params, state = init_train_state(dense_cfg, dev, seed=SEED)
    step = make_train_step(dense_cfg, optimizer_config_from_model(dense_cfg))
    data = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  vocab_size=dense_cfg.vocab_size, seed=SEED))
    one_device_loss = []
    for i in range(SHARDED_DENSE_STEPS):
        params, state, m = step(params, state, data.batch_at(i))
        one_device_loss.append(float(m["loss"]))
    del params, state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    dense = full_sharded(dense_cfg, SHARDED_DENSE_MESH, SHARDED_DENSE_STEPS, TRAIN_BATCH)
    dense["reduced"] = {"n_layers": [dense_full.n_layers, SHARDED_DENSE_LAYERS]}
    dense["one_device_loss"] = one_device_loss
    dense["loss_abs_err"] = max(abs(a - b) for a, b in zip(dense["loss"],
                                                           dense["one_device_loss"]))
    check(dense["loss_abs_err"] <= SHARDED_FULL_LOSS,
          f"train_sharded {DENSE_TRAIN_ARCH} against one device: {dense}")
    # (c) qwen3-moe at published widths, 1 of 94 layers, on (1, 2).
    moe_full = get_config(MOE_TRAIN_ARCH)
    moe_cfg = dataclasses.replace(moe_full, n_layers=MOE_TRAIN_LAYERS)
    moe_run = full_sharded(moe_cfg, SHARDED_MOE_MESH, SHARDED_MOE_STEPS, SHARDED_MOE_BATCH)
    moe_run["reduced"] = {"n_layers": [moe_full.n_layers, MOE_TRAIN_LAYERS]}
    if SHARDED_MOE_BATCH != TRAIN_BATCH:
        moe_run["reduced"]["batch"] = [TRAIN_BATCH, SHARDED_MOE_BATCH]
    check(all(a > 0 for a in moe_run["aux_loss"]), f"train_sharded MoE aux: {moe_run}")
    if SHARDED_MOE_BATCH == TRAIN_BATCH:
        moe_run["one_device_loss"] = trainers[MOE_TRAIN_ARCH]["losses"][:SHARDED_MOE_STEPS]
        moe_run["loss_abs_err"] = max(abs(a - b) for a, b in zip(moe_run["loss"],
                                                                 moe_run["one_device_loss"]))
        check(moe_run["loss_abs_err"] <= SHARDED_FULL_LOSS,
              f"train_sharded {MOE_TRAIN_ARCH} against one device: {moe_run}")
    # (d) Tensor-parallel training at published widths, f32 (TF32 off), 4
    # gloo ranks: each case against one process on the card (rank 0, before
    # the ranks start), K6 / K7 / K7' held against their plain versions at
    # each launch of the first step, the second step's peak against the dry
    # run and its collectives against the reckoning.
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_ranks = run_ranks(_train_sharded_rank_body, SHARDED_RANKS, work_dir,
                         {"part": "tp", "device": None, "cases": TP_CASES,
                          "batch": TRAIN_BATCH}, timeout=SHARDED_TIMEOUT)
    tp_s = time.perf_counter() - t0
    tp_predicted = [f.result(timeout=DRYRUN_TIMEOUT) for f in tp_predicted]
    tp_pool.shutdown()
    tp_cases, tp_worst = {}, {}
    for (arch, shape, layers), pred in zip(TP_CASES, tp_predicted):
        cfg = tp_train_cfg(arch, layers)
        key = f"{arch} {tuple(shape)}"
        found = [r[key] for r in tp_ranks]
        first = found[0]
        ref = first["ref"]
        rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
        case = {"layers": cfg.n_layers, "mesh": list(shape), "tokens": TRAIN_BATCH * TRAIN_SEQ,
                "steps": TP_STEPS, "loss": first["loss"], "grad_norm": first["grad_norm"],
                "one_process": ref,
                "loss_rel_err": [rel(a, b) for a, b in zip(first["loss"], ref["loss"])],
                "grad_norm_rel_err": [rel(a, b) for a, b in zip(first["grad_norm"],
                                                                ref["grad_norm"])],
                "param_max_abs_err": first["param_max_abs_err"],
                "param_off_share": first["param_off_share"],
                "half_update": first["half_update"],
                "host_s_per_step": [r["host_s"] for r in found],
                "launches_per_rank": first["launches"],
                "kernel_errs": [r["kernel_errs"] for r in found]}
        if layers:
            case["reduced"] = {"n_layers": [get_config(arch).n_layers, layers]}
        n_rglru, n_rwkv = cfg.layer_kinds.count("rglru"), cfg.layer_kinds.count("rwkv6")
        want = {k: v * TP_STEPS for k, v in (("rglru_scan_cuda", 3 * n_rglru),
                                             ("wkv6_cuda", 2 * n_rwkv),
                                             ("wkv6_bwd_cuda", n_rwkv)) if v}
        reckoning = shard_wire_reckoning(cfg, shape, TRAIN_BATCH, TRAIN_SEQ)["collectives"]
        case["collectives"] = {"equal_to_reckoning": True}
        for kind, nbytes, _ in reckoning:
            row = case["collectives"].setdefault(kind, {"calls": 0, "payload_bytes": 0})
            row["calls"] += 1
            row["payload_bytes"] += nbytes
        case["peak"] = {"predicted_gb": pred["peak_bytes"] / 1e9,
                        "measured_gb": [r["peak_gb"] for r in found],
                        "held_before_gb": [r["held_gb"] for r in found]}
        case["peak"]["ratios"] = [case["peak"]["predicted_gb"] / m
                                  for m in case["peak"]["measured_gb"]]
        case["peak"]["summed_gb"] = sum(case["peak"]["measured_gb"])
        for rank, r in enumerate(found):
            check(r["finite"] and r["loss"] == first["loss"]
                  and r["grad_norm"] == first["grad_norm"],
                  f"train_sharded (d) {key} rank {rank}: metrics {r['loss']} {r['grad_norm']}")
            check(r["launches"] == want, f"train_sharded (d) {key} rank {rank} launches "
                  f"{r['launches']} != {want}")
            check(sorted(map(tuple, r["tally"])) == sorted(reckoning),
                  f"train_sharded (d) {key} rank {rank}: collectives differ from "
                  f"shard_wire_reckoning")
            for name, (err, share) in r["kernel_errs"].items():
                check(err == 0 if name == "rglru_scan_cuda" else share <= 1,
                      f"train_sharded (d) {key} rank {rank} {name}: {err} ({share} of its bound)")
                tp_worst[name] = max(tp_worst.get(name, 0.0), err)
            for k, v in r["launches"].items():
                sharded_train_launches[k] = sharded_train_launches.get(k, 0) + v
        check(set(first["kernel_errs"]) == set(want),
              f"train_sharded (d) {key}: checked kernels {set(first['kernel_errs'])}")
        check(all(DRYRUN_BAND[0] <= x <= DRYRUN_BAND[1] for x in case["peak"]["ratios"]),
              f"train_sharded (d) {key}: peaks {case['peak']} (band {DRYRUN_BAND})")
        # An element moves at most one learning rate a step: twice the
        # steps' rates bound any run's difference (f32 rounding beside).
        bounds = TP_BOUNDS.get(arch, TP_DEFAULT_BOUNDS)
        case["bounds"] = bounds
        got = case["loss_rel_err"] + case["grad_norm_rel_err"] + [case["param_off_share"]]
        check(all(b is None or g <= b for g, b in zip(got, bounds))
              and case["param_max_abs_err"] <= 4 * case["half_update"] * 1.01 + 1e-6,
              f"train_sharded (d) {key} against one process: {case}")
        tp_cases[key] = case
    emit({"phase": "train_sharded", "device": smi,
          "note": "gloo ranks time-sharing one card, collectives staged through host memory: "
                  "not a multi-GPU figure",
          "smoke": {"archs": list(SHARDED_SMOKE), "meshes": [list(m) for m in SHARDED_MESHES],
                    "microbatches": SHARDED_MB, "steps": SHARDED_STEPS,
                    "errors_vs_one_process": smoke_err,
                    "launches_summed_over_ranks": sharded_train_launches,
                    "spawn_s": smoke_s},
          "dense": dense, "moe": moe_run,
          "tensor_parallel": {"cases": tp_cases, "spawn_s": tp_s,
                              "bounds": "(loss 1, loss 2, grad norm 1, grad norm 2, share "
                                        "off by half an update) relative; None: reported; "
                                        "param_max_abs_err: twice the steps' learning rates"},
          "seconds": time.perf_counter() - t_phase})

    # -- dryrun: each full-width step's peak, predicted on meta tensors ------------
    # The port's dry run of every full-width step measured above (the
    # trainers at TRAIN_BATCH x TRAIN_SEQ, llama-vision's media prefill at
    # its served depth) in spawned children, against the card's peak less
    # the bytes held before the step was built.
    t_phase = time.perf_counter()
    jobs = {arch: (arch, layers, "train", TRAIN_SEQ, TRAIN_BATCH) for arch, layers in (
        (TRAIN_ARCH, None), (RWKV_TRAIN_ARCH, None), (DENSE_TRAIN_ARCH, None),
        (MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS), (ARCTIC_TRAIN_ARCH, ARCTIC_TRAIN_LAYERS),
        (AUDIO_TRAIN_ARCH, None))}
    jobs[VISION_ARCH] = (VISION_ARCH, SERVE_LAYERS[VISION_ARCH], "prefill", MEDIA_PROMPT, 1)
    for arch in jobs:
        if arch != VISION_ARCH:
            run = trainers[arch]
            dryrun_measured[arch] = {"peak_bytes": run["peak_bytes"],
                                     "held_bytes": run["held_before"]["allocated_bytes"]}
    with concurrent.futures.ProcessPoolExecutor(
            DRYRUN_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        predicted = list(pool.map(_dryrun_job, jobs.values(), timeout=DRYRUN_TIMEOUT))
    steps = []
    for (arch, job), pred in zip(jobs.items(), predicted):
        got = dryrun_measured[arch]
        measured = got["peak_bytes"] - got["held_bytes"]
        ratio = pred["peak_bytes"] / measured
        steps.append({"arch": arch, "kind": job[2], "layers": job[1], "seq": job[3],
                      "batch": job[4], "predicted_gb": pred["peak_bytes"] / 1e9,
                      "measured_gb": measured / 1e9, "ratio": ratio,
                      "held_before_gb": got["held_bytes"] / 1e9,
                      "predicted_argument_gb": pred["argument_bytes"] / 1e9,
                      "predicted_by_category_gb": {k: v / 1e9 for k, v in
                                                   pred["peak_bytes_by_category"].items()},
                      "microbatches": pred["microbatches"], "trace_s": pred["trace_s"]})
    emit({"phase": "dryrun", "device": smi, "band": list(DRYRUN_BAND), "steps": steps,
          "held_before_trainers": trainers[TRAIN_ARCH]["held_before"],
          "seconds": time.perf_counter() - t_phase})
    for step in steps:
        check(DRYRUN_BAND[0] <= step["ratio"] <= DRYRUN_BAND[1],
              f"dryrun {step['arch']}: predicted {step['predicted_gb']} GB against "
              f"{step['measured_gb']} GB measured (ratio {step['ratio']}, band {DRYRUN_BAND})")

    # -- result lines ----------------------------------------------------------
    # Launches: K1-K3 from the hdiff path (K2 runs on the hdiff, elementary
    # and grad paths; its one-output count here is the hdiff path's),
    # K4/K5/K5' from the elementary path, K6/K7 from the serve path, then the
    # trainers' K6, K7 and K7's backward.
    paper, paper_rows = "x".join(map(str, PAPER_GRID)), "x".join(map(str, PAPER_ROWS))
    # K6 and K7 serve two paths: BatchedServer's and serve_tp's ranks (summed).
    served = {name: serve_launches[name] + serve_tp["launches"].get(name, 0)
              for name in ("rglru_scan_cuda", "wkv6_cuda")}
    for name, err in serve_tp["errors"].items():
        worst[name] = max(worst[name], err)
    rows = [
        ("hdiff_cuda", "hdiff f32", paper, "src/repro_torch/csrc/hdiff.cu",
         "src/repro/kernels/hdiff/kernel.py:131", launches),
        ("hdiff_fixed_cuda", "hdiff i32", paper, "src/repro_torch/csrc/hdiff.cu",
         "src/repro/kernels/hdiff/kernel.py:204", launches),
        ("stencil_program_cuda", "hdiff x2", paper, "src/repro_torch/ir/codegen_cuda.py",
         "src/repro/ir/lower_pallas.py:263", launches),
        ("stencil2d_cuda", "stencil2d jacobi2d_9pt", paper, "src/repro_torch/csrc/stencil2d.cu",
         "src/repro/kernels/stencil2d/kernel.py:59", elem_launches),
        ("jacobi1d_cuda", "jacobi1d", paper_rows, "src/repro_torch/csrc/stencil2d.cu",
         "src/repro/kernels/stencil2d/kernel.py:85", elem_launches),
        ("stencil_program_1d_cuda", "jacobi1d x1", paper_rows,
         "src/repro_torch/ir/codegen_cuda.py", "src/repro/ir/lower_pallas.py:336",
         elem_launches),
        ("rglru_scan_cuda", "rglru f32", "x".join(map(str, K6_SERVE)),
         "src/repro_torch/csrc/rglru.cu", "src/repro/kernels/rglru/kernel.py:49", served),
        ("wkv6_cuda", "wkv6", "x".join(map(str, K7_SERVE)), "src/repro_torch/csrc/wkv6.cu",
         "src/repro/kernels/wkv6/kernel.py:82", served),
    ]
    kernels = []
    for name, label, grid, source, replaces, counts in rows:
        t = timing[(name, label, grid)]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    # K2's N-output site: the gradient path's N-output launches (per step the
    # augmented forward and the adjoint, counted at the launch under their own
    # key), timed on the adjoint.
    t = timing[(GRAD_K2, "hdiff_coupled.adj", "x".join(map(str, padded(PAPER_GRID, coupled))))]
    kernels.append({
        "name": "stencil_program_cuda", "route": "cuda",
        "source": "src/repro_torch/ir/codegen_cuda.py",
        "replaces": "src/repro/ir/lower_pallas.py:273",
        "launches": grad_launches[KERNEL_N_OUT], "max_abs_err": worst[GRAD_K2],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    })
    # K2 on the sharded path, both sites: the 8-rank run's launches summed
    # over the ranks, the one-output ones timed on one shard of hdiff at
    # k = 1 on the 2x4 split, the N-output ones on shallow_water's; the
    # errors are the offset mode's against the plain version and the
    # unsharded launch (N outputs: and the zero-boundary gradient launches).
    mesh_tag = "x".join(map(str, SHARD_MESH))
    for label, site, replaces, count in (
            ("hdiff k=1", "stencil_program_cuda", "src/repro/ir/lower_pallas.py:263",
             sharded_launches["stencil_program_cuda"] - sharded_launches[KERNEL_N_OUT]
             - batched_sharded),
            ("shallow_water", GRAD_K2, "src/repro/ir/lower_pallas.py:273",
             sharded_launches[KERNEL_N_OUT] + driver_ranks_n_out),
            (batched_label, "stencil_program_cuda", "src/repro/ir/lower_pallas.py:263",
             batched_sharded)):
        t = shard_timing[(label, mesh_tag, paper)]
        kernels.append({
            "name": "stencil_program_cuda", "route": "cuda",
            "source": "src/repro_torch/ir/codegen_cuda.py", "replaces": replaces,
            "launches": count, "max_abs_err": offset_err[site],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    # K2 on the forecast path, both sites: the counted serving run's launches
    # (one a batch: N members folded into depth), each timed on 8 members of
    # the paper grid; the errors are the batched parity cells' and served
    # results' against the plain version and unbatched launches.
    for name, site, replaces, count in (
            ("hdiff k=2", "stencil_program_cuda", "src/repro/ir/lower_pallas.py:263",
             forecast_launches["stencil_program_cuda"] - forecast_launches[KERNEL_N_OUT]),
            ("shallow_water", GRAD_K2, "src/repro/ir/lower_pallas.py:273",
             forecast_launches[KERNEL_N_OUT])):
        t = fc_timing[name]
        kernels.append({
            "name": "stencil_program_cuda", "route": "cuda",
            "source": "src/repro_torch/ir/codegen_cuda.py", "replaces": replaces,
            "launches": count, "max_abs_err": fc_err[site],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    # The driver's path (--devices 1: the whole grid, one N-output launch a
    # step; its --devices 8 launches are offset-mode and join the sharded
    # N-output row above) and the trainer's K6 launches (forward, remat
    # recompute and backward), each timed at its own shape.
    for site, replaces, count, err, t in (
            ("stencil_program_cuda", "src/repro/ir/lower_pallas.py:273",
             driver_launches[KERNEL_N_OUT], driver_err, sw_timing),
            ("rglru_scan_cuda", "src/repro/kernels/rglru/kernel.py:49",
             trainers[TRAIN_ARCH]["launches"]["rglru_scan_cuda"]
             + sharded_train_launches.get("rglru_scan_cuda", 0),
             max(k6_err, tp_worst.get("rglru_scan_cuda", 0.0)), k6_train_timing)):
        kernels.append({
            "name": site, "route": "cuda",
            "source": ("src/repro_torch/csrc/rglru.cu" if site == "rglru_scan_cuda"
                       else "src/repro_torch/ir/codegen_cuda.py"),
            "replaces": replaces, "launches": count, "max_abs_err": err, **t})
    # RWKV-6's trainer: K7 forward (forward and remat recompute) and K7's
    # backward, which replaces no Pallas kernel: the JAX package takes
    # jax.grad of its jnp chunked form (the function named in "replaces").
    rwkv_launches = trainers[RWKV_TRAIN_ARCH]["launches"]
    for site, source, replaces in (
            ("wkv6_cuda", "src/repro_torch/csrc/wkv6.cu", "src/repro/kernels/wkv6/kernel.py:82"),
            ("wkv6_bwd_cuda", "src/repro_torch/csrc/wkv6_bwd.cu",
             "src/repro/kernels/wkv6/ref.py:36")):
        t = {k: v for k, v in k7_train_timing[site].items() if k not in ("bytes", "flops")}
        kernels.append({"name": site, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": rwkv_launches[site] + sharded_train_launches.get(site, 0),
                        "max_abs_err": max(worst[site], tp_worst.get(site, 0.0)), **t})
    # The health probe's kernel, which replaces no Pallas kernel: the JAX
    # package leaves field_stats to XLA's fused reductions. Its launches are
    # the NaN drill's probes; timed at a served COSMO-E member.
    kernels.append({"name": "field_stats", "route": "cuda",
                    "source": "src/repro_torch/csrc/field_stats.cu",
                    "replaces": "src/repro/obs/health.py:60", "launches": drill_launches[
                        "field_stats"], "max_abs_err": fs_err,
                    **{k: v for k, v in fs_timing.items() if k != "grid"},
                    "library_ms": None})
    for k in kernels:  # a time under its bound would make the bound no bound
        check(k["ms"] >= k["bound_ms"],
              f"{k['name']} ({k['replaces']}): {k['ms']} ms under its bound {k['bound_ms']} ms")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
