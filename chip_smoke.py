#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases a,b,...]

``--phases`` runs only the named phases (``PHASES``) and those whose
results they read, a partial run while developing: it prints its phases'
lines and ``{"phases_run": [...]}``, never the kernels line or the ok
line. Without it every phase runs.

Phases, each printing one JSON line:

1. card   — the GPU's name and power limit (nvidia-smi), versions;
2. build  — compile the port's CUDA kernels from ``paddle_tpu_torch/
   kernels/csrc`` with nvcc for sm_90a (set-up time), and count each
   kernel's tensor-core instructions in its SASS (``cuobjdump``): the
   flash forward, dQ and dK/dV at bf16, at fp16 and at fp32 (3xTF32) must
   have them in every instantiation;
3. kernels — each of the six fp32 kernels against its plain PyTorch
   version on the card at the shapes BERT-large serving and training give
   it and at awkward ones, without and with dropout, with its time, the
   plain version's, one PyTorch library call's as a yardstick, and the
   bound (the attention rows' at the TF32 peak); the fp32 forward at most
   SDPA's fp32 forward at the serving and the train shape, the fp32 dQ and
   dK/dV each at most SDPA's whole fp32 backward; a causal case whose
   first keys all carry BERT's bf16 key bias (-9984), at fp32 and bf16;
   the Philox dropout mask bit for bit against ``kernels/philox.py``;
   add+LayerNorm on both of its routes (``ADD_LN_CASES``); the mask
   gradient bit for bit against its plain version on its vector path, a
   ragged tail and its scalar path (``dmask_bit_exact``), at most the
   multiply by a stored mask;
4. kernels bf16 — the same six kernels at bf16 on the bf16 train step's
   inputs (attention at (8, 16, 512, 64) as transpose(1, 2) views, p = 0.1;
   the norms at (4096, 1024) and (608, 1024); add+LayerNorm with 4
   outputs; the mask gradient), each against its plain version at bf16,
   timed beside the plain version, a bf16 library call and the bound at the
   bf16 tensor-core peak; L = 300 with D = 40 and a -inf batch row, and
   D = 128 causal; each wrapper called under an op log that sees no copy
   and no cast; the bf16 kernel's mask bit for bit as the fp32 kernel's;
   the speed limits of the three tensor-core kernels against SDPA, of
   add+LayerNorm against x + res then ``native_layer_norm``, of LayerNorm
   against ``native_layer_norm`` and of the mask gradient against a stored
   mask; the LayerNorm's ``fixed_cost`` (4096 and 16384 rows, beside a
   copy of as many bytes); then the same at fp16 (``kernel_fp16``: the
   f16 instantiations against their plain versions within ``FP16_TOL``,
   timed beside SDPA and ``native_layer_norm`` at fp16, the ratios
   printed, not held); then ``attention_mask_probe``: the attention
   dropout mask read back bit for bit through the forward, dQ and dK/dV
   at fp32, bf16 and fp16;
5. rms    — ``nn.RMSNorm`` forward and backward (autograd) at fp32, bf16
   and fp16, with and without a weight, at (4096, 1024), (4096, 4096) and
   (300, 1000), against the plain version, with exactly one RMSNorm launch
   per forward; the kernel's time beside ``F.rms_norm``'s and the bound,
   at bf16 at most ``F.rms_norm``'s; its ``fixed_cost`` at bf16;
6. parity — a full-width, 2-layer BERT served through ``ServingEngine`` on
   the GPU against the same weights run on the CPU (plain path);
7. serve  — BERT-large (24 layers, hidden 1024, seq 512) served through
   ``ServingEngine`` in batches landing in buckets 1, 4 and 16, plus one
   request through the worker thread; the kernel launch counts of this
   run must be exactly 1 LayerNorm, 48 add+LayerNorm and 24 flash
   attention launches per batch; the waves' host syncs (sync debug mode
   'warn') are counted;
7b. serve tenants (run right after serve, on its model) — multi-tenant
   serving with the telemetry spine (``phase_serve_tenants``): a
   ``TenantArbiter`` (gold weight 3, silver 1, storm 1 with a 4/s, burst
   8 quota), ``register(slo_ms=250, slo_objective=0.99)``, telemetry on;
   pumped with the arbiter's clock frozen (exact quota sheds, two
   cancels, each batch's tenants as the CPU's ``WeightedFairQueue`` pops
   them, outputs within ``TOL`` of each request served alone on the
   plain versions, SLO and tenant tallies as the responses give them),
   then threaded behind ``start_endpoint(port=0)`` with three client
   threads, ``/metrics`` against ``stats()``, ``/healthz``, ``/events``,
   ``/timeseries``, ``/diagnosis`` (the doctor's findings), ``kill()`` and
   ``EngineDeadError``; phase 7's waves with telemetry off, on, on and
   off (each with phase 7's launches and outputs bit for bit; off with its
   host syncs, on with at most the sampled syncs more; req/s of each);
   the paged engine with a draft under page pressure, its telemetry
   against the runner's counts; a profiled batch with the
   ``serving.batch`` host range;
7c. serve fleet (run right after serve tenants, on serve's model) — the
   fleet layer (``phase_serve_fleet``): a ``FleetRouter`` over three
   started BERT-large engines on one card, telemetry on; phase 7's
   requests in its waves with r1 killed at its 5th request and r2
   slowed (``faultinject``): none lost, r1 one death and an open
   circuit, a failover retry, each output within ``TOL`` of the request
   served alone on the plain versions; ``FleetSupervisor`` relaunching r1
   half-open and closing it (``fleet.recovery_ms``); hedged against
   unhedged requests one at a time with r2 the straggler (p50, p99,
   hedges fired and won, the losers' extra batches); ``drain`` and
   ``readmit`` with nothing aborted; ``FleetAutoscaler`` growing a warmed
   replica on real SLO burn and shrinking through ``drain``
   (``fleet.autoscale.scale_up_ms``); exact launches over every
   replica's batches and the in-phase warmups; prefix affinity on two
   paged ``TinyCausalLM`` replicas; the doctor's fleet detectors; no
   thread left;
8. profile — device time by kernel over one more bucket-16 batch; every
   LayerNorm and add+LayerNorm call on the register path
   (``SERVE_ROUTES``); here and in every profile, the profiled call
   follows a pre-roll of sleep kernels (``PREROLL_SPINS``), and a
   session that caught fewer of the port's kernels than the launch
   counters counted lost device events and is taken again with a longer
   pre-roll (``PROFILE_TAKES``);
9. train parity — a full-width, 2-layer ``BertForPretraining``, batch 2 x
   512: loss and every gradient, GPU against CPU at p = 0, and kernel
   path against plain path on the GPU at p = 0.1 with the same seeds; the
   same step twice from one (seed, offset) gives one loss;
10. train — BERT-large pretraining, batch 8 x 512, dropout 0.1, through
   ``engine.build_train_step`` with AdamW: 2 warm-up and 18 timed steps on
   one batch; per step exactly 24 flash forward, 24 dQ, 24 dK/dV, 48
   add+LayerNorm, 48 mask-gradient and 2 LayerNorm launches; every loss
   finite and the 20th below the 1st; then one profiled step, every
   LayerNorm, add+LayerNorm and mask-gradient call on its fast route
   (``TRAIN_ROUTES``);
11. train parity bf16 — phase 9's model and batch under the reference's
   bf16 recipe (``bf16_recipe``, ``bench.py::bench_bert``): at p = 0
   against the fp32 step on the same weights, at p = 0.1 against the
   plain versions on the card; gates on the loss and on each gradient's
   error over its max; the repeated step gives one loss;
12. train bf16 — phase 10 under the bf16 recipe on the same weights and
   batch, with the same launch counts; one profiled step, and one step
   under the op log, whose copies and casts are listed by the line that
   asked for them (none from a kernel wrapper);
13. train parity bf16 flat, train bf16 flat — ``bench_bert``'s flat mode
   (``FlatFusedUpdate(compute_dtype=bf16)``, ``flat_recipe``): three
   2-layer steps against the per-parameter recipe's (1e-6), then phase
   12 on it, with the AdamW update profiled alone;
14. train parity fp16, train fp16 amp — ``amp.auto_cast(level='O1',
   dtype='float16')`` on fp32 parameters: the 2-layer step against the
   fp32 step (p = 0) and the plain versions (p = 0.1) under the bf16
   gates, and a ``microbatch=2`` call bitwise equal to two single ones;
   then 20 BERT-large steps with ``GradScaler`` and ``nan_guard=True``
   under ``torch.cuda.set_sync_debug_mode('error')``, with phase 10's
   launch counts, ``sync``, and ``amp_overflow``: the scale set to 2^40,
   two steps that leave the state bitwise unchanged and halve it;
15. train parity fit — a full-width 2-layer ``engine.fit`` (fp32, p = 0,
   Lamb with the global-norm clip, a ``ParamAttr`` learning rate, an
   ``L1Decay`` parameter, ``StepDecay`` stepped between two calls) with
   the kernels against the plain versions and the CPU; ``remat='full'``
   and ``'dots'`` at p = 0.1 under O1 fp16 against no remat after 3
   steps (1e-6), with their launches; the pre-norm encoder layer at
   BERT-large width against its plain versions;
16. train fit — BERT-large pretraining through ``engine.fit``: O1 fp16,
   ``GradScaler``, ``nan_guard=True``, ``microbatch=2``, ``log_every=5``,
   Lamb (no decay on LayerNorm and biases) with
   ``ClipGradByGlobalNorm(1.0)`` under ``fit_schedule``; two calls of 10
   dispatches on the repeated batch, the scheduler stepped between them;
   exact launch counts, no more host syncs (sync debug mode 'warn') than
   the loss fetches and the guard and scaler reconciles, finite losses,
   the last logged below the first; step ms and samples/s, peak memory;
   one profiled step, Lamb's update and the clip profiled alone, and
   ``amp_overflow`` on the Lamb + clip step;
17. remat memory — 3 BERT-large O1 fp16 steps with ``remat='full'`` and
   without: each one's peak memory, the remat one lower;
18. kernel gpt (run before the parity phases, with the kernel phases'
   flush buffer) — the two kernels GPT's generate launches at its shapes:
   the fp32 causal flash forward at (8, 12, 512, 64) beside SDPA causal
   fp32, the fp32 LayerNorm at width 768 on 4096 and 8 rows beside
   ``F.layer_norm`` and a copy;
19. generate — GPT ``generate`` at gpt_small's full size (vocab 50304,
   hidden 768, 12 layers and heads), fp32: 8 prompts of 512 ids, 256 new
   tokens, greedy; a warm-up and 5 timed calls with exactly 12 flash
   forward and 6400 LayerNorm launches each; time to first token, decode
   ms a token, tokens/s, peak memory, host syncs; a 2-layer parity
   (kernels against plain versions against the CPU), every emitted token
   against the plain no-cache forward (``TEACHER_TOL``), a sampled call
   repeating under its seed inside the filtered support, an eos call
   padding as the reference does; profiles of the prefill (attention on
   ``flash_fwd_tf32_kernel``) and of one decode step;
20. serve generative — the engine's generative path on ``TinyCausalLM``
   at gpt_small's widths: 48 requests (16-512 tokens, 16 sharing a
   256-token prefix, 64 new tokens) paged, slot, with a draft and under
   page pressure; every request OK and within ``TEACHER_TOL`` of the
   no-cache forward, a prefix hit, a preemption, no kernel launched;
21. routes — the kernel each LayerNorm and RMSNorm shape takes at fp32
   and bf16 (``LN_ROUTES``, ``RMS_ROUTES``: the register path or the
   block path), and the O1 fp16 step's attention launches (each an f16
   instantiation, ``AMP_ATTENTION``), read from one profiler session;
22. hapi parity (run before routes) — the high-level API
   (``hapi.Model``, the ``io``
   DataLoader with two loader threads, ``metric.Accuracy``, the
   callbacks) at 2 layers (BERT-large widths), p = 0, 24 + 8 samples:
   the eager and the jit ``fit`` and an ``evaluate`` with the kernels
   against the plain versions (each loss within ``HAPI_PARITY_TOL``
   relative, accuracies absolute); then, under ``deterministic()``,
   ``CheckpointSaver``'s SIGTERM stop and resume, sync and async, each
   equal to the uninterrupted run bit for bit;
23. hapi fit — BERT-large pretraining (fp32 AdamW under a warm-up,
   dropout 0.1) through ``Model.fit`` on 48 + 16 samples of
   ``bench_bert``'s feeds, 2 epochs, eager and ``jit=True`` on
   ``phase_train``'s weights, then ``evaluate`` and ``predict``; exact
   launches of the six kernels over the whole path (24 steps, 12
   forwards), finite and falling losses, accuracies in [0, 1], the two
   paths' first losses within 1e-3; step ms and samples/s beside
   ``phase_train``'s step, host syncs, the loader's wait, evaluate and
   predict ms a batch, peak memory, a profiled ``train_batch`` a path,
   ``Accuracy``'s device ms on the MLM logits;
24. train resume — ``engine.fit``'s checkpoint, resume and preemption
   in train fit's configuration (p = 0.1, O1 fp16, scaler, guard,
   microbatch 2, Lamb with the clip under the schedule, restored by the
   caller): at 2 layers (BERT-large widths) a sync save, an async save
   and a SIGTERM caught while an async save is in flight, each resumed
   run bitwise the uninterrupted one, the async checkpoint bitwise the
   sync one; at full width the restored state bitwise the saved one, the
   resumed fit's launches exact (3 dispatches of 2 steps), its losses
   within twice the spread of two uninterrupted runs; the checkpoint's
   bytes, a sync save's ms, an async save's stall (at most a tenth of the
   sync save's), commit ms, the device memory its snapshot adds, step ms
   with and without a commit in flight, restore ms. After it a profiler
   session loses its first device events (PERF.md, 7): no profile runs
   after it;
25. train telemetry — the training side's telemetry at train fit's
   configuration (24 layers, 10 dispatches of 2 steps a fit, under
   ``deterministic()``): fits with telemetry off, on, on and off with the
   same launches, bitwise the same losses and at most the ``engine.step``
   span's sampled host syncs more; the first telemetry-on fit's cost
   ledger entry (FLOPs within ``LEDGER_FLOPS_TOL`` of ``fit_flops``, its
   bytes, peak against the fit's own, roofline at the card's peaks; the
   doctor's ``memory_pressure`` quiet at the card's budget, warning and
   critical at 1.1x and 0.9x the peak); a fit with one sync save and one
   with one async save through a ``RankFlusher`` into a run dir, merged by
   ``aggregate`` and diagnosed: ``checkpoint_stall`` after the sync save
   only; ``Model.fit`` (jit, one epoch) with the ``TelemetryCallback``
   attached by itself, ``/diagnosis`` and ``/costs`` from a live endpoint
   equal to the in-process values, a flight dump carrying the ledger;
26. collectives — ``distributed.init_parallel_env()`` on NCCL at world 1
   (a ``file://`` store): every collective of the port's API on CUDA
   tensors at fp32 and bf16 against its closed form, the
   ``collective.<op>.calls`` / ``.bytes`` counters exact, a deadline met
   and one expired by ``faultinject.slow_collective``, naming the op;
27. train sharded — ``train_fit``'s recipe with
   ``sharding=ShardingConfig(fsdp=True)`` in the NCCL group at world 1,
   bit for bit the same fit without a process group (both under
   ``deterministic()``): losses, parameters, Lamb's slots, the scale and
   the guard; exact launches, the collectives a dispatch as planned
   (``_fsdp_plan``), the fit's host-sync budget; a 2-layer full-width
   sharded checkpoint restored into an unsharded fit and back, bit for
   bit; the step ms beside the unsharded one (timed in both orders) and
   ``train_fit``'s, the peak, the ``sharding.*`` gauges; the group
   destroyed at the end;
28. dp two ranks — ``distributed.spawn(nprocs=2, backend='gloo')`` on the
   one card: a 2-layer BERT at BERT-large widths, a ``DataParallel`` net,
   3 steps each with AdamW and with SGD against one process on the whole
   batch (losses 1e-3; SGD's parameters 1e-3; AdamW's printed, not held),
   the ranks bit for bit, exact launches from each child, and
   rank-distinct dropout masks with rank 0's the one process's;
29. vision parity — ``resnet50`` at 2 x 3 x 64 x 64 on the card against
   the same model on the CPU, cuDNN TF32 off: the train pass (logits,
   loss, running statistics, every gradient) in fp64 within ``TOL``, its
   fp32 logits, loss and statistics within ``GRAD_TOL`` (the fp32
   gradients printed: ill-conditioned at this size), eval within
   ``TOL``; NHWC and the space-to-depth stem against NCHW; eval forwards
   of ``mobilenet_v2``, ``vgg11`` and ``LeNet``;
30. serve resnet — ``ServingEngine.register(layer=resnet50())`` at 3 x
   224 x 224, fp32, in waves over buckets 1-16: the CPU's logits within
   ``MODEL_TOL`` of the max, none of the seven kernels; req/s, p50/p99
   per bucket, peak; a profiled bucket-16 batch;
31. train resnet — ``bench.py::bench_resnet50``'s recipe: NHWC, batch
   256 x 224, bf16 on fp32 masters through ``FlatFusedUpdate``,
   Momentum(0.1, 0.9, 1e-4), BatchNorm's statistics in
   ``state['buffers']``, 2 + 10 steps: a falling, finite loss, moving
   statistics, a NaN batch skipped bitwise (master, momentum, buffers);
   step ms, images/s, peak, host syncs, copies; a profiled step;
32. hapi fit resnet — ``hapi.Model(resnet50())`` ``fit`` fp32 on one
   Flowers batch of 32 through ``vision.transforms``, 6 epochs: a falling
   loss, ``flops`` equal to the reference's formula's 8178368512;
33. detection parity — every function of ``vision/ops.py`` and
   ``vision/detection_train.py`` on the card against the CPU on the same
   inputs (``_detection_cases``): fp64 within ``TOL`` (the gradients of
   ``ssd_loss``, ``yolov3_loss``, ``roi_align``, ``deformable_conv`` and
   the focal loss too), fp32 within ``MODEL_TOL``, at small sizes and at
   the YOLOv3 head at 608 x 608 (batch 8, COCO's nine anchors, 80
   classes, 50 padded boxes), the RPN on a 50 x 68 stride-16 map with 15
   anchors a cell, ``roi_align`` 7 x 7 on 1024 channels of that map; the
   NMS forms exactly, the CPU fed the card's own pre-NMS tensors, with
   the candidate pairs whose IoU lies within ``NEAR_THRESHOLD`` of the
   threshold counted; priors, anchors, samplers and ``multi_box_head`` on
   the card;
34. serve ssd — ``register(layer=SSDDetector(SSDMobileNet()))``,
   PaddleDetection's ``ssd_mobilenet_v1_voc`` at full width (3 x 300 x
   300, 21 classes, 1917 priors), fp32, in waves over buckets 1-16, a
   request's (out (200, 6), count): the pre-NMS boxes and scores within
   ``MODEL_TOL`` of the CPU's, the served detections equal to the CPU's
   NMS on the card's pre-NMS tensors, ``detection_output``'s host syncs
   within ``DETECT_SYNC_BUDGET`` at ``nms_top_k`` 400 and 100, none of
   the seven kernels; req/s, p50/p99 per bucket, ``detection_output``'s
   ms, peak; a profiled bucket-16 batch;
35. train ssd — the SSD through ``build_train_step(loss_fn=, params=,
   buffers=)``, batch 32 x 300 x 300, fp32, RMSProp(0.001) with
   L2Decay(5e-5), ``nan_guard``, 2 + 10 steps: a falling, finite loss,
   moving statistics, a NaN batch skipped bitwise, none of the seven
   kernels; step ms, images/s, peak, host syncs; a profiled step; then
   one fp64 train pass at 2 x 3 x 300 x 300, GPU against CPU: the loss,
   the location and confidence gradients, every parameter gradient and
   the BatchNorm statistics within ``TOL``;
36. ernie parity — ``ErnieForPretraining`` at ERNIE-large's widths, 2
   layers, fp32, p = 0, on one ``ernie_mask_batch`` batch (2 x 333,
   ragged padding masks, phrase spans): the loss within ``TOL`` and every
   gradient within ``GRAD_TOL``, GPU against CPU; the flash forward, dQ
   and dK/dV against their plain versions at L = 77, 200 and 333 (a tail
   tile), fp32 and bf16, with a key bias, p = 0 and 0.1;
37. finetune ernie — ERNIE-large (``bert_large(type_vocab_size=4)``) with
   a sentence-pair classifier (``ErnieClassifier``) through
   ``hapi.Model.fit``, eager, fp32, AdamW 2e-5 under a linear warm-up,
   the global-norm clip, batch 16 at padded lengths cycling 128, 333, 512
   and 77 with per-row padding masks, 2 + 8 steps: every step's launches
   exactly (kernels 1, 2, 3, 4, 6 and 7 at every length), a held-out
   batch's loss lower after the fit,
   one host sync a step at most; step ms by length, samples/s, peak, the
   idle share of a profiled step;
38. seq2seq parity — ``Seq2SeqTransformer`` at Transformer-base's
   widths, 2 + 2 layers, fp32, p = 0, on 8 sources and targets of 64
   tokens: the loss within ``TOL`` and every gradient within
   ``GRAD_TOL``, the card against the CPU in fp64, with the train step's
   launches (the CPU's fp32 pass printed beside it); the
   LayerNorm, add+LayerNorm and mask-gradient kernels against their plain
   versions at width 512 and the seq2seq's rows (the train step's with
   the saved statistics, at p = 0 and 0.1; ``translate``'s);
39. seq2seq — ``Seq2SeqTransformer`` at Transformer-base (vocabularies
   10000 and 10000) trained through ``build_train_step`` (AdamW on
   ``NoamDecay``, batch 32 at 64 x 64 and 80 x 64, 2 + 6 steps, exact
   launches), then ``translate`` of 16 sources of 64 ids, beam 4,
   ``max_len`` 64 (kernels 1, 4 and 6): first-token ms, decode step ms,
   tokens/s, host reads a step, peak; its beams against the CPU's step by
   step up to each row's first near-tie, the final log-probabilities
   within ``TOL``;
40. rnn parity — the recurrent slice on the card, fp32 with TF32 off,
   against the port on the CPU in fp64 on the same weights (the CPU's
   fp32 distance printed): ``nn.SimpleRNN`` (tanh, relu), ``nn.LSTM`` and
   ``nn.GRU`` of 2 layers, forward and bidirectional, batch- and
   time-major, with and without initial states and lengths, the text
   zoo's ``LSTM``, ``BidirectionalGRU`` (both ways of merging) and
   ``RNN`` over a ``StackedLSTMCell`` with ``forget_bias``, at I = H =
   256, batch 8, 40 steps: outputs and states within ``TOL``, gradients
   within ``GRAD_TOL``, cuDNN's RNN against the CPU and the card's
   per-step route against cuDNN's; ``F.linear_chain_crf`` at (300, 64,
   57) and ``F.crf_decoding`` on the card's own emissions (paths equal up
   to counted near-ties); ``SkipGram``; the text zoo's Transformer at
   Transformer-base widths, 2 + 2 layers, 8 x 64: one pass within
   ``TOL`` / ``GRAD_TOL`` with exactly one LayerNorm launch an ``n``
   command, and a ``TransformerBeamSearchDecoder`` through
   ``DynamicDecode`` (beam 4, 16 steps) equal to the CPU's up to each
   row's first near-tie;
41. train ptb lm — ``LSTMLanguageModel`` at PTB large (vocab 10000,
   hidden 1500, 2 layers, dropout 0.65), ptb_lm's eager loop: 20 x 35
   truncated BPTT with the state carried, SGD(1.0) with the global-norm
   clip at 10, 2 + 20 steps; a falling loss, two cuDNN calls a step, none
   of the seven kernels; step ms, words/s, peak, host syncs, perplexity,
   a profiled step, cuDNN against the per-step route and against flat
   weights;
42. train lac — LAC's ``SequenceTagging`` (vocab 20940, 57 tags) through
   ``hapi.Model.fit``: batch 300 x 64, Adam(1e-3), the CRF cost, the
   chunk F1, 2 + 10 steps; a falling loss, none of the seven kernels;
   step ms, sentences/s, tokens/s, peak, host syncs, a profiled step;
43. serve lac — the trained tagger behind ``ServingEngine`` with batch
   buckets 1-64 and the one length bucket it was trained at (64),
   query-length sentences in waves: paths equal to the CPU's Viterbi on
   each batch's own emissions, and each request's tags equal to those it
   gets served alone, up to counted near-ties, at most
   ``LAC_SYNC_BUDGET`` host syncs a batch, none of the seven kernels;
   req/s, p50/p99 per bucket, a profiled batch.

Every kernel row carries ``share_of_bound`` (bound ms over kernel ms) and
the achieved TFLOP/s and TB/s beside the library call's time. Then a
``{"kernels": [...]}`` line (all seven kernels, bf16 numbers at the top
level and under ``bf16``, fp32 under ``fp32``, fp16 under ``fp16``, the
GPT cases under ``gpt``, the attention kernels' ragged cases under
``ragged``, the norm kernels' seq2seq cases under ``width_512`` (with
their library calls' times),
launches by path: ``serve``,
``serve_tenants``, ``serve_fleet``, the training paths,
``train_resume``, ``nn.RMSNorm``, ``generate``, ``serve_generative``,
``hapi_fit``, ``train_telemetry``, ``train_sharded``,
``dp_two_ranks``, the model-parallel phases, the three ResNet-50 paths
and the two SSD paths, ``serve_ssd`` and ``train_ssd``, which launch
none, ``finetune_ernie``, ``seq2seq_train``, ``seq2seq_translate``,
``text_transformer``, and ``train_ptb_lm``, ``train_lac`` and
``serve_lac``, which launch none)
and, last, ``{"ok": true,
"device": ...}``. Any failure raises and exits non-zero; without a CUDA
device (or without the package beside this file) it exits non-zero and
prints no result. fp32 matrix products run in full
fp32 (TF32 off).
"""
import argparse
import contextlib
import copy
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# published H100 SXM peaks (dense): fp32 outside the tensor cores, TF32 and
# bf16 on the tensor cores, HBM3. The fp32 attention rows take their bound
# at the TF32 peak: it is the fastest the card does that work, whatever
# unit a kernel runs it on (the forward runs 3xTF32 on the tensor cores)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# kernel vs plain version, max abs, fp32: the two sum in different orders,
# which moves values of order 1-10 by ~1e-6; 1e-4 leaves a wide margin
TOL = 1e-4
# GPU engine vs CPU plain path, whole model, fp32: cuBLAS and the CPU BLAS
# sum 1024- and 4096-term products in different orders, layer after layer
MODEL_TOL = 1e-3
# gradients, kernel vs plain version and GPU vs CPU: max abs error over the
# gradient's max abs value
GRAD_TOL = 1e-3
SEQ = 512
TRAIN_BATCH = 8
TIMED_RUNS = 25
# device cycles the stream is held before each timed launch: ~2.5 ms at the
# H100's 1.6-1.98 GHz, far longer than any wrapper's Python
HOLD_CYCLES = 4_000_000


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    """The least time the card could take for ``flops`` operations on
    ``nbytes`` moved to or from device memory -> a row's work fields."""
    t_ops, t_mem = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return {'bound_ms': 1e3 * max(t_ops, t_mem),
            'bound_by': 'operations' if t_ops > t_mem else 'bytes',
            'flops': flops, 'bytes': nbytes}


def closeness(row):
    """A row's time against its work: ``share_of_bound`` (bound ms over
    kernel ms) and the achieved rates; ``_p0`` and ``_p0.1`` beside them
    for a row's (or a nested case's) p = 0 and p = 0.1 times."""
    out = {}
    for suffix in ('', '_p0', '_p0.1'):
        ms = row.get(f'ms{suffix}')
        if ms:
            out[f'share_of_bound{suffix}'] = row['bound_ms'] / ms
            out[f'achieved_tflops{suffix}'] = row['flops'] / ms / 1e9
            out[f'achieved_tb_per_s{suffix}'] = row['bytes'] / ms / 1e9
            if row.get('copy_ms'):
                out[f'copy_share{suffix}'] = row['copy_ms'] / ms
    return out


def copy_ms(nbytes, flush):
    """Median ms of a device-to-device copy that moves ``nbytes`` in all,
    half read and half written, timed as ``time_ms`` times a kernel: what
    moving as many bytes takes with no arithmetic at all, a yardstick for
    the norm and mask kernels. At 16-100 MB it sits well above the byte
    bound (a few microseconds of each interval do not shrink with the
    bytes). ``copy_share`` is it over kernel ms."""
    src = torch.empty(int(nbytes) // 8, dtype=torch.float32, device='cuda')
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src), flush)


def fixed_cost(run_at, nbytes_at, flush, rows=TRAIN_BATCH * SEQ):
    """How much of a short interval is a fixed cost and how much moves with
    the bytes: ``run_at(n)`` (a function that launches the kernel on n
    rows) and a device copy of as many bytes (``copy_ms``), each timed at
    ``rows`` and at 4 * ``rows`` (``nbytes_at(n)`` bytes) with the same
    timer and flush -> for each, its two times, ``marginal_tbps`` (the
    extra bytes over the extra time), ``fixed_ms`` (the time at ``rows``
    less its bytes at that rate) and ``marginal_share`` (the marginal rate
    over the HBM peak). A kernel whose marginal share is near the copy's
    loses its share of the byte bound to the interval, not to its own
    work. No gate reads them."""
    n = [rows, 4 * rows]
    nbytes = [nbytes_at(r) for r in n]
    out = {}
    for what, ms in (('kernel', [time_ms(run_at(r), flush) for r in n]),
                     ('copy', [copy_ms(b, flush) for b in nbytes])):
        rate = (nbytes[1] - nbytes[0]) / (ms[1] - ms[0]) / 1e9 \
            if ms[1] > ms[0] else None
        out[what] = {'rows': n, 'bytes': nbytes, 'ms': ms,
                     'marginal_tbps': rate,
                     'fixed_ms': (ms[0] - nbytes[0] / rate / 1e9
                                  if rate else None),
                     'marginal_share': (rate * 1e12 / PEAK_HBM_BYTES
                                        if rate else None)}
    return out


def time_ms(fn, flush):
    """Median device time of ``fn`` over TIMED_RUNS launches, CUDA events
    around each; the L2 cache is overwritten before each launch, so every
    input comes from device memory. Then the stream is held busy for a few
    ms (``torch.cuda._sleep``) before the first event, so that the host has
    queued all of ``fn``'s work by the time it fires: the time is the
    device's, without the wrapper's Python (which a 0.05 ms kernel would
    otherwise wait on)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b):
    """Max abs error of ``a`` against ``b`` over ``b``'s max abs value."""
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def check(name, err, tol):
    if not err <= tol:      # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} > {tol}")


def phase_card():
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({'phase': 'card', 'nvidia_smi': smi,
          'torch_device': torch.cuda.get_device_name(0),
          'device_count': torch.cuda.device_count(),
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'tf32_matmul': torch.backends.cuda.matmul.allow_tf32,
          'tf32_cudnn': torch.backends.cudnn.allow_tf32})
    return smi


# the kernels that must run on the tensor cores -> their instantiations
# (two head dims, with and without dropout; the forwards also with and
# without a key bias; the 16-bit ones at bf16 and at fp16): each needs
# mma.sync (HMMA) or wgmma (HGMMA) instructions in its SASS
TENSOR_CORE_KERNELS = {'flash_fwd_mma_kernel': 16, 'flash_dkv_mma_kernel': 8,
                       'flash_dq_mma_kernel': 8, 'flash_fwd_tf32_kernel': 8,
                       'flash_dq_tf32_kernel': 4, 'flash_dkv_tf32_kernel': 4}
# of which the f16 instantiations (the first template argument __half)
F16_TENSOR_CORE_KERNELS = {'flash_fwd_mma_kernel': 8,
                           'flash_dkv_mma_kernel': 4,
                           'flash_dq_mma_kernel': 4}


def phase_build():
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.load()
    seconds = time.perf_counter() - t0
    path = _build.build()
    log = path.with_suffix('.so.log')
    mma = _tensor_core_counts(path, _build)
    need = {n: c for n, c in mma.items()
            if n.split('<')[0] in TENSOR_CORE_KERNELS}
    found = {k: sum(n.split('<')[0] == k for n in need)
             for k in TENSOR_CORE_KERNELS}
    f16 = {k: sum(n.startswith(k + '<__half') for n in need)
           for k in F16_TENSOR_CORE_KERNELS}
    if (found != TENSOR_CORE_KERNELS or f16 != F16_TENSOR_CORE_KERNELS
            or not all(need.values())):
        raise AssertionError(f"tensor-core kernels without HMMA/HGMMA "
                             f"instructions, or missing: {need}")
    emit({'phase': 'build', 'seconds': seconds, 'library': lib._name,
          'flags': list(_build.NVCC_FLAGS),
          'tensor_core_instructions': need,
          'other_kernels_with_mma': {n: c for n, c in mma.items()
                                     if c and n not in need},
          'ptxas': _ptxas_table(log.read_text() if log.exists() else '')})


def _tensor_core_counts(lib, _build):
    """``cuobjdump --dump-sass`` of the built library -> {kernel: number of
    tensor-core instructions (HMMA for mma.sync, HGMMA for wgmma)}."""
    tool = Path(_build._nvcc()).parent / 'cuobjdump'
    sass = subprocess.run([str(tool), '--dump-sass', str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            current = line.split('Function :', 1)[1].strip()
            counts[current] = 0
        elif current is not None and ('HMMA' in line or 'HGMMA' in line):
            counts[current] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))


def _demangle(names):
    """Kernel symbols -> their names with template arguments (c++filt),
    or the mangled names where c++filt is missing."""
    try:
        out = subprocess.run(['c++filt'], input='\n'.join(names),
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    if len(out) != len(names):
        return names
    return [n.replace('(anonymous namespace)::', '').split('(')[0]
            .replace('void ', '') for n in out]


def _ptxas_table(text):
    """ptxas's -v report -> one entry per kernel: its name (demangled
    when c++filt is there), registers, spill stores and loads."""
    entries, current = [], None
    for line in text.splitlines():
        if 'Compiling entry function' in line:
            current = {'kernel': line.split("'")[1]}
            entries.append(current)
        elif current is not None and 'spill stores' in line:
            words = line.replace(',', '').split()
            current['spill_stores'] = int(words[words.index('spill') - 2])
            current['spill_loads'] = int(words[-4])
        elif current is not None and 'Used' in line and 'registers' in line:
            words = line.replace(',', ' ').split()
            current['registers'] = int(words[words.index('registers') - 1])
    for e, name in zip(entries, _demangle([e['kernel'] for e in entries])):
        e['kernel'] = name
    return entries


def emit_kernel(name, rows, tolerance=TOL, **extra):
    """One kernel's phase line; ``phase_launches`` counts this phase's
    own launches (checks and timing), not the main path's."""
    from paddle_tpu_torch import kernels
    rows[name].update(closeness(rows[name]))
    row = dict(rows[name])
    emit({'phase': 'kernel', 'name': name, 'tolerance': tolerance,
          'kernel_ms': row.pop('ms'),
          'phase_launches': kernels.launch_counts()[name], **row, **extra})


def phase_kernels(seed, flush):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import (flash_attention, fused_dropout_norm,
                                          fused_norm)
    kernels.reset_launch_counts()
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = {}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # -- flash attention at BERT-large serving's bucket-16 shape ----------
    B, H, L, D = 16, 16, SEQ, 64
    q, k, v = randn(B, H, L, D), randn(B, H, L, D), randn(B, H, L, D)
    lengths = torch.randint(L // 8, L + 1, (B,), device=dev, generator=gen)
    bias = torch.where(torch.arange(L, device=dev)[None, :] < lengths[:, None],
                       0.0, -1e4).to(torch.float32)   # BERT's (1 - m) * -1e4
    scale = 1.0 / D ** 0.5
    o, lse = flash_attention.flash_attention_forward(q, k, v, kpad_bias=bias)
    ro, rlse = flash_attention._attn_reference(q, k, v, False, scale, bias)
    torch.cuda.synchronize()
    err = max(max_err(o, ro), max_err(lse, rlse))
    check('flash attention (kpad)', err, TOL)
    cases = []
    # extra shapes: causal at full size; ragged L with a head dim padded
    # to 64 and one batch row whose every key is -inf; head dim 128
    for causal, shape, neg_row in ((True, (B, H, L, D), False),
                                   (False, (2, 3, 300, 40), True),
                                   (True, (1, 2, 77, 128), False)):
        b_, h_, l_, d_ = shape
        qq, kk, vv = randn(*shape), randn(*shape), randn(*shape)
        kb = None
        if not causal or d_ == 128:
            kb = torch.where(torch.rand(b_, l_, device=dev, generator=gen)
                             < 0.2, -1e4, 0.0).to(torch.float32)
            if neg_row:
                kb[1] = float('-inf')
        oo, ll = flash_attention.flash_attention_forward(
            qq, kk, vv, causal=causal, kpad_bias=kb)
        ro2, rl2 = flash_attention._attn_reference(
            qq, kk, vv, causal, 1.0 / d_ ** 0.5, kb)
        torch.cuda.synchronize()
        e = max(max_err(oo, ro2), max_err(ll, rl2))
        check(f'flash attention {shape} causal={causal}', e, TOL)
        cases.append({'shape': list(shape), 'causal': causal,
                      'bias': kb is not None, 'empty_row': neg_row,
                      'max_abs_err': e})
    # the work this input needs: every query row against the unmasked keys
    # of its batch row (a -1e4 bias contributes exp(-1e4) == 0 in fp32);
    # q, bias and o whole, k and v at the unmasked rows
    keys = float(lengths.sum())
    flops = 4.0 * H * L * D * keys
    nbytes = 4.0 * (2 * B * H * L * D + 2 * H * D * keys + B * L)
    work = bound(flops, nbytes, PEAK_TF32_FLOPS)
    mask4 = bias[:, None, None, :]
    rows['flash_attention_fwd'] = {
        'max_abs_err': err,
        'ms': time_ms(lambda: flash_attention.flash_attention_bhld(
            q, k, v, kpad_bias=bias), flush),
        'plain_ms': time_ms(lambda: flash_attention._attn_reference(
            q, k, v, False, scale, bias), flush),
        'library_ms': time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask4), flush),
        **work,
        'shape': [B, H, L, D], 'unmasked_keys': keys,
        'flops_all_keys': 4.0 * B * H * L * L * D,
        'extra_cases': cases}
    serve = rows['flash_attention_fwd']
    check_speed('attention_speed_fp32_serve', {
        'fwd_fp32_over_sdpa_fwd': serve['ms'] / serve['library_ms']})

    # -- LayerNorm (embedding norm) and add+LayerNorm (48 epilogues) -----
    N, E = 16 * SEQ, 1024
    x, res = randn(N, E), randn(N, E)
    w, b = 1.0 + 0.1 * randn(E), 0.1 * randn(E)
    y = fused_norm.fused_layer_norm(x, w, b, 1e-12)
    err = max_err(y, fused_norm.fused_layer_norm_plain(x, w, b, 1e-12))
    check('layer norm', err, TOL)
    work = bound(8.0 * N * E, 4.0 * (2 * N * E + 2 * E))
    rows['layer_norm_fwd'] = {
        'max_abs_err': err,
        'ms': time_ms(lambda: fused_norm.fused_layer_norm(x, w, b, 1e-12),
                      flush),
        'plain_ms': time_ms(lambda: fused_norm.fused_layer_norm_plain(
            x, w, b, 1e-12), flush),
        'library_ms': time_ms(lambda: torch.nn.functional.layer_norm(
            x, (E,), w, b, 1e-12), flush),
        'copy_ms': copy_ms(work['bytes'], flush), **work, 'shape': [N, E]}

    y = fused_dropout_norm.fused_dropout_add_layer_norm(x, res, w, b)
    err = max_err(y, fused_dropout_norm.fused_dropout_add_layer_norm_plain(
        x, res, w, b))
    check('add + layer norm', err, TOL)
    work = bound(9.0 * N * E, 4.0 * (3 * N * E + 2 * E))
    rows['add_layer_norm_fwd'] = {
        'max_abs_err': err,
        'ms': time_ms(lambda: fused_dropout_norm.fused_dropout_add_layer_norm(
            x, res, w, b), flush),
        'plain_ms': time_ms(
            lambda: fused_dropout_norm.fused_dropout_add_layer_norm_plain(
                x, res, w, b), flush),
        'library_ms': time_ms(lambda: torch.nn.functional.layer_norm(
            x + res, (E,), w, b, 1e-5), flush),
        'library': 'x + res, then F.layer_norm (two calls, one interval)',
        'copy_ms': copy_ms(work['bytes'], flush), **work, 'shape': [N, E]}
    # the rows are printed once the train step's shapes are in them
    phase_train_kernels(randn, gen, flush, rows)
    return rows


def _key_bias(batch, length, dev, gen):
    """BERT's (1 - mask) * -1e4 for real lengths in [L/8, L]."""
    lengths = torch.randint(length // 8, length + 1, (batch,), device=dev,
                            generator=gen)
    bias = torch.where(
        torch.arange(length, device=dev)[None, :] < lengths[:, None], 0.0,
        -1e4).to(torch.float32)
    return bias, float(lengths.sum())


# A causal case whose batch row 0 has its first BIASED_KEYS keys at BERT's
# key bias as the kernels see it (-1e4 rounded to bf16: -9984), so that the
# first BIASED_KEYS query rows have no key without it. There a score's ulp
# is 2^-10, ten times the gate on lse: scores and lse have to be rounded as
# the reference rounds them (csrc/flash_common.cuh, fragment_scores). At
# bf16 the products are exact and the kernels' o and lse are held to their
# plain versions as everywhere. At fp32 the 3xTF32 products, within ~2^-21
# of each fp32 product, now and then round a score of that size to the
# fp32 value next to the plain version's, 2^-10 away, which moves o and
# lse by up to 2^-10 times that key's weight; the plain version's own lse
# is 2^-10 from the float64 one there. So on this case the fp32
# forward's o and lse are held to the float64 attention, each no farther
# from it than the plain version's plus TOL (``_attention_case(exact=
# True)``); its gradients to the plain versions' as everywhere.
BIASED_ROWS_SHAPE = (2, 4, 256, 64)
BIASED_KEYS = 96


def biased_first_keys(batch, length, dev):
    bias = torch.zeros(batch, length, device=dev)
    bias[0, :BIASED_KEYS] = -9984.0
    return bias


def _attention_case(fa, q, k, v, do, causal, kb, p, seed, offset,
                    exact=False):
    """Forward, dQ and dK/dV kernels against their plain versions on one
    input -> the errors (o and lse absolute, and o over its max abs value;
    gradients relative). delta is fp32 whatever the dtype, as the
    backward computes it. With ``exact``, also the forward's and its plain
    version's errors against the plain version in float64: ``o_f64``,
    ``lse_f64`` and ``o_f64_plain``, ``lse_f64_plain``, absolute."""
    from paddle_tpu_torch import kernels
    scale = 1.0 / q.shape[-1] ** 0.5
    kw = dict(causal=causal, kpad_bias=kb, dropout_p=p, seed=seed,
              offset=offset)
    o, lse = fa.flash_attention_forward(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    rest = (lse, delta, causal, scale, kb, p, seed, offset)
    dq = fa.flash_attention_dq(q, k, v, do, *rest)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, *rest)
    torch.cuda.synchronize()
    with kernels.plain_versions():
        ro, rlse = fa.flash_attention_forward(q, k, v, **kw)
        # the plain backward starts from the kernel's own (lse, delta), as
        # the kernels do
        rdq = fa.flash_attention_dq(q, k, v, do, *rest)
        rdk, rdv = fa.flash_attention_dkv(q, k, v, do, *rest)
    errs = {'o': max(max_err(o, ro), max_err(lse, rlse)),
            'o_rel': rel_err(o, ro), 'lse': max_err(lse, rlse),
            'dq': rel_err(dq, rdq), 'dk': rel_err(dk, rdk),
            'dv': rel_err(dv, rdv)}
    if exact:
        with kernels.plain_versions():
            xo, xlse = fa.flash_attention_forward(
                *(t.double() for t in (q, k, v)),
                **dict(kw, kpad_bias=None if kb is None else kb.double()))
        errs.update(o_f64=max_err(o, xo), lse_f64=max_err(lse, xlse),
                    o_f64_plain=max_err(ro, xo),
                    lse_f64_plain=max_err(rlse, xlse))
    for t in (o, dq, dk, dv):
        if not torch.isfinite(t).all():
            raise AssertionError("attention kernels: non-finite output")
    return errs


def attention_mask_probe(dtype, device, length, p, seed, offset, heads=2,
                         head_map=None):
    """Read the attention dropout mask back, bit for bit, through the
    forward, dQ and dK/dV, on one 64-key (forward, dQ) or 64-query (dK/dV)
    window per batch row: batch row b probes window 64 b .. 64 b + 63, so
    the windows cover every key tile, the last one ragged unless 64
    divides ``length``. D = 64.

    - forward: q = k = 0 and a key bias 0 on the window, -inf elsewhere,
      so P = 1 there; v = the one-hot of key position mod 64, so
      o[b, h, i, j] != 0 iff element (b H + h, i, 64 b + j) is kept;
    - dQ: q = 0, k = the one-hot of key position mod 64, v and dO a
      column of ones each, lse = delta = 0, the forward's bias; so P = 1
      on the window, dP = 1 and dS = keep / (1 - p) there, and
      dq[b, h, i, j] != 0 iff (b H + h, i, 64 b + j) is kept;
    - dK/dV: q = k = v = 0, lse = delta = 0, no bias, so P = 1 and dS = 0;
      dO = the one-hot of query position mod 64 on the window rows, zero
      elsewhere, so dv[b, h, key, j] != 0 iff (b H + h, 64 b + j, key) is
      kept.

    CUDA tensors run the kernels, CPU tensors the plain versions. With
    ``head_map=(heads of the model, first head)`` (a tensor-parallel
    rank's local heads) the kernels and ``want`` key the mask on the
    model's (batch, head) rows. -> {'forward': (read, want), 'dq': (read,
    want), 'dkv': (read, want)}: boolean masks of the probed elements,
    ``want`` from ``philox.keep_mask``."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import philox
    D = 64
    B = -(-length // D)
    shape = (B, heads, length, D)
    pos = torch.arange(length, device=device)
    window = pos[None, :] // D == torch.arange(B, device=device)[:, None]
    onehot = (pos[:, None] % D == torch.arange(D, device=device)[None, :])
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    stats = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    keep = philox.keep_mask((B, heads, length, length), p, seed, offset,
                            device, philox.head_block(
                                (B, heads, length, length), head_map))
    windows = [slice(D * b, min(D * (b + 1), length)) for b in range(B)]

    def key_windows(out):
        """out[b, :, :, :n] against the keys of batch row b's window"""
        return (torch.cat([(out[b, :, :, :w.stop - w.start] != 0).flatten()
                           for b, w in enumerate(windows)]),
                torch.cat([keep[b, :, :, w].flatten()
                           for b, w in enumerate(windows)]))
    bias = torch.where(window, 0.0, float('-inf')).to(torch.float32)
    v = onehot.to(dtype).expand(shape).contiguous()
    o, _ = fa.flash_attention_forward(zeros, zeros, v, False, None, bias, p,
                                      seed, offset, head_map)
    out = {'forward': key_windows(o)}

    ones = torch.zeros(shape, dtype=dtype, device=device)
    ones[..., 0] = 1
    dq = fa.flash_attention_dq(zeros, v, ones, ones, stats, stats, False,
                               1.0 / D ** 0.5, bias, p, seed, offset,
                               head_map)
    out['dq'] = key_windows(dq)

    do = (window[:, :, None] & onehot[None]).to(dtype)[:, None].expand(
        shape).contiguous()
    _, dv = fa.flash_attention_dkv(zeros, zeros, zeros, do, stats, stats,
                                   False, 1.0 / D ** 0.5, None, p, seed,
                                   offset, head_map)
    out['dkv'] = (
        torch.cat([(dv[b, :, :, :w.stop - w.start] != 0).flatten()
                   for b, w in enumerate(windows)]),
        torch.cat([keep[b, :, w, :].transpose(-1, -2).flatten()
                   for b, w in enumerate(windows)]))
    return out


def phase_mask_probe(seed):
    """``attention_mask_probe`` on the card at fp32, bf16 and fp16, at a
    length that 4 divides (the 16-bit kernels' lanes share each Philox
    call's four words) and one it does not (a call per probability): every
    bit must be philox.py's."""
    dev = torch.device('cuda', 0)
    P, SEED = 0.1, 0x1234567890ABCDEF + seed
    probes = []
    for dtype in (torch.float32, BF16, FP16):
        for length in (300, 333):
            res = attention_mask_probe(dtype, dev, length, P, SEED, 17)
            torch.cuda.synchronize()
            row = {'dtype': str(dtype)[6:], 'length': length}
            for path, (read, want) in res.items():
                wrong = int((read != want).sum())
                if wrong:
                    raise AssertionError(
                        f"attention mask probe ({path}, {row}): {wrong} of "
                        f"{want.numel()} bits differ from kernels/philox.py")
                row[path] = {'bits': want.numel(), 'kept': int(want.sum())}
            probes.append(row)
    emit({'phase': 'attention_mask_probe', 'p': P, 'bit_exact': True,
          'probes': probes})


def _attention_ms(fa, q, k, v, do, bias, p, seed, flush):
    """Median ms of the forward (o and lse out, as training runs it), dQ
    and dK/dV on one non-causal input."""
    drop = (p, seed, 3) if p else ()
    o, lse = fa.flash_attention_forward(q, k, v, False, None, bias, *drop)
    rest = (lse, (do.float() * o.float()).sum(-1), False,
            1.0 / q.shape[-1] ** 0.5, bias, *drop)
    return {'fwd': time_ms(lambda: fa.flash_attention_forward(
                q, k, v, False, None, bias, *drop), flush),
            'dq': time_ms(lambda: fa.flash_attention_dq(q, k, v, do, *rest),
                          flush),
            'dkv': time_ms(lambda: fa.flash_attention_dkv(q, k, v, do, *rest),
                           flush)}


# add+LayerNorm against its plain version, (rows, width, p), at fp32 and
# bf16, y, yin, mean and rstd out. The kernel takes a route by the width
# (csrc/fused_dropout_norm.cu, dispatch_add_ln): the register path for
# widths of whole 16-byte chunks up to 1024 -- the train shape at p = 0.1
# and 0, BERT-base's 768 (3 chunks a lane at bf16, 6 at fp32) on a row
# count that is not a multiple of a block's 4 rows, and 1000 (lanes past
# the width masked) -- and the block path for the others: 1023 columns (not
# a whole chunk) and 8192 (too wide; at bf16 the dropout sum parked in
# shared memory)
ADD_LN_CASES = ((TRAIN_BATCH * SEQ, 1024, 0.1), (TRAIN_BATCH * SEQ, 1024, 0.0),
                (4099, 768, 0.1), (300, 1000, 0.1), (37, 1023, 0.25),
                (16, 8192, 0.1))
ADD_LN_LIBRARY = ('x + res, then torch.native_layer_norm (y, mean, rstd): '
                  'two calls, one interval, p = 0')
# The LayerNorm and RMSNorm shapes (rows, width) this script times and
# checks, at fp32 and bf16, and the kernel each takes (csrc/fused_norm.cu,
# dispatch_ln and dispatch_rms: the register path for widths of whole
# 16-byte chunks up to 1024 columns, 16-byte aligned, else the block path).
# LayerNorm: serving's embeddings (bucket 16), training's embeddings and
# MLM head rows, the 4x rows of fixed_cost, and GPT generate's prefill and
# decode-step rows at width 768; RMSNorm (nn.RMSNorm): the
# train step's rows at the hidden and the intermediate width, and 1000
# columns (at bf16 125 chunks: the last round of chunks masked past lane
# 28). phase_routes reads each one's kernel on the card;
# tests/test_torch_norm_fwd_rows.py reads the rule from the source and
# checks these tables against it
LN_ROUTES = {(16 * SEQ, 1024): 'ln_rows_warp_kernel',
             (TRAIN_BATCH * SEQ, 1024): 'ln_rows_warp_kernel',
             (TRAIN_BATCH * (SEQ * 15 // 100), 1024): 'ln_rows_warp_kernel',
             (4 * TRAIN_BATCH * SEQ, 1024): 'ln_rows_warp_kernel',
             (8 * SEQ, 768): 'ln_rows_warp_kernel',       # GPT's prefill
             (8, 768): 'ln_rows_warp_kernel',             # a decode step
             # the seq2seq's decoder at Transformer-base's width: the
             # train step's rows and a beam-search step's
             (32 * 64, 512): 'ln_rows_warp_kernel',
             (16 * 4, 512): 'ln_rows_warp_kernel'}
RMS_ROUTES = {(TRAIN_BATCH * SEQ, 1024): 'rms_rows_warp_kernel',
              (TRAIN_BATCH * SEQ, 4096): 'rms_norm_fwd_kernel',
              (300, 1000): 'rms_rows_warp_kernel'}


def dmask_bit_exact(fdn, g, randn, p, seed):
    """The mask gradient bit for bit against its plain version on ``g``
    flat (the vector path), on n = 37 * 1023 (the vector path and the
    elements past its last 16-byte pack) and on a view that starts one
    element into its storage (the scalar path) -> {case: elements}."""
    from paddle_tpu_torch import kernels
    flat = g.reshape(-1)
    cases = {'flat': flat, 'ragged 37 * 1023': randn(37 * 1023),
             'one element into its storage': randn(flat.numel() + 1)[1:]}
    out = {}
    for name, gc in cases.items():
        got = fdn.dropout_grad(gc, p, seed, 9)
        with kernels.plain_versions():
            want = fdn.dropout_grad(gc, p, seed, 9)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"mask gradient {gc.dtype} ({name}): "
                f"{int((got != want).sum())} elements differ from the plain "
                f"version")
        out[name] = gc.numel()
    return out


def phase_train_kernels(randn, gen, flush, rows):
    """The kernels the train step adds (dQ, dK/dV, the dropout-mask
    gradient) and the dropout branches of the two forward kernels, at the
    train step's shapes and at the awkward ones."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_dropout_norm as fdn
    from paddle_tpu_torch.kernels import fused_norm, philox
    dev = torch.device('cuda', 0)
    F = torch.nn.functional
    P, SEED = 0.1, 0x1234567890ABCDEF

    # -- the Philox mask itself, bit for bit, and its keep rate ----------
    n = 4 * 2 ** 20 + 3           # not a multiple of 4: the tail path too
    mask = fdn.dropout_grad(torch.ones(n, device=dev), P, SEED, 7)
    want = philox.keep_scale((n,), P, SEED, 7, dev)
    torch.cuda.synchronize()
    keep_rate = float((mask > 0).double().mean())
    if not torch.equal(mask, want):
        raise AssertionError("dropout mask: the kernel's bits differ from "
                             "kernels/philox.py")
    if abs(keep_rate - (1 - P)) > 0.002:
        raise AssertionError(f"dropout mask: keep rate {keep_rate}")
    emit({'phase': 'philox', 'elements': n, 'p': P, 'bit_exact': True,
          'keep_rate': keep_rate, 'allowed': [1 - P - 0.002, 1 - P + 0.002]})

    # -- attention as the train step feeds it: no mask (every key counts),
    # q, k, v and dO seen through transpose(1, 2) of (B, L, H, D) tensors,
    # as the projections and the output's reshape leave them; the same
    # shape with a key bias, contiguous, is an extra case ----------------
    B, H, L, D = TRAIN_BATCH, 16, SEQ, 64
    shape = (B, H, L, D)
    q, k, v, do = (randn(B, L, H, D).transpose(1, 2) for _ in range(4))
    qb, kb_, vb, dob = (randn(*shape) for _ in range(4))
    bias, keys = _key_bias(B, L, dev, gen)
    errs = {p: _attention_case(fa, q, k, v, do, False, None, p, SEED, 3)
            for p in (0.0, P)}
    cases = [{'shape': list(shape), 'causal': False, 'bias': True,
              'empty_row': False, 'p': p,
              **_attention_case(fa, qb, kb_, vb, dob, False, bias, p, SEED, 3)}
             for p in (0.0, P)]
    # causal at full size; ragged L with the head dim padded to 64 and one
    # batch row whose every key is -inf; head dim 128; causal with the
    # first keys of batch row 0 at BERT's bf16 key bias
    for causal, shp, neg_row in ((True, shape, False),
                                 (False, (2, 3, 300, 40), True),
                                 (True, (1, 2, 77, 128), False),
                                 (True, BIASED_ROWS_SHAPE, False)):
        b_, _, l_, d_ = shp
        qq, kk, vv, dd = (randn(*shp) for _ in range(4))
        kb = None
        if shp == BIASED_ROWS_SHAPE:
            kb = biased_first_keys(b_, l_, dev)
        elif not causal or d_ == 128:
            kb = torch.where(torch.rand(b_, l_, device=dev, generator=gen)
                             < 0.2, -1e4, 0.0).to(torch.float32)
            if neg_row:
                kb[1] = float('-inf')
        for p in (0.0, P):
            e = _attention_case(fa, qq, kk, vv, dd, causal, kb, p, SEED, 11,
                                exact=shp == BIASED_ROWS_SHAPE)
            cases.append({'shape': list(shp), 'causal': causal,
                          'bias': kb is not None, 'empty_row': neg_row,
                          'p': p, **e})
    for case in [dict(errs[0.0], p=0.0, shape=list(shape)),
                 dict(errs[P], p=P, shape=list(shape))] + cases:
        what = f"flash forward {case['shape']} p={case['p']}"
        if 'o_f64' in case:     # BIASED_ROWS_SHAPE says why
            for out in ('o', 'lse'):
                check(f'{what}: {out} against float64', case[f'{out}_f64'],
                      case[f'{out}_f64_plain'] + TOL)
        else:
            check(what, case['o'], TOL)
        for g in ('dq', 'dk', 'dv'):
            check(f"flash {g} {case['shape']} p={case['p']}", case[g],
                  GRAD_TOL)

    ms = {p: _attention_ms(fa, q, k, v, do, None, p, SEED, flush)
          for p in (0.0, P)}
    ms_bias = _attention_ms(fa, qb, kb_, vb, dob, bias, P, SEED, flush)
    with kernels.plain_versions():
        plain = _attention_ms(fa, q, k, v, do, None, P, SEED, flush)
    # one library call for dQ, dK and dV together: the backward of SDPA
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), do, retain_graph=True), flush)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                       flush)
    del ol, ql, kl, vl
    # the work: without a mask every key of every row; each of q, k, v, dO
    # read once, each output written once, lse and delta (B, H, L) each.
    # With the bias only the unmasked keys count, as for the serving row:
    # k and v at the unmasked rows
    n_qd = 4.0 * B * H * L * D
    side = 4.0 * B * H * L
    all_keys = float(B * L)
    kv_bytes = 4.0 * 2 * H * D * keys

    def bounds(flops_per_key, whole, extra):
        """(bound of the unmasked input, bound of the biased one), at the
        TF32 peak."""
        return (bound(flops_per_key * H * L * D * all_keys,
                      (whole + 2) * n_qd + extra, PEAK_TF32_FLOPS),
                bound(flops_per_key * H * L * D * keys,
                      whole * n_qd + kv_bytes + extra + 4.0 * B * L,
                      PEAK_TF32_FLOPS))
    work, biased = bounds(4.0, 2, side)         # q, o; lse
    rows['flash_attention_fwd'].update({
        'train': {'shape': list(shape), 'layout': '(B, L, H, D) seen '
                  'through transpose(1, 2)', 'bias': False,
                  'ms_p0': ms[0.0]['fwd'], 'ms_p0.1': ms[P]['fwd'],
                  'dropout_ratio': ms[P]['fwd'] / ms[0.0]['fwd'],
                  'plain_ms_p0.1': plain['fwd'], 'library_ms_p0': sdpa_fwd,
                  **work,
                  'max_abs_err_p0.1': errs[P]['o'],
                  'with_key_bias': {'unmasked_keys': keys,
                                    'ms_p0.1': ms_bias['fwd'],
                                    'bound_ms': biased['bound_ms'],
                                    'bound_by': biased['bound_by']},
                  'cases': cases}})
    check_speed('attention_speed_fp32_train', {
        'fwd_fp32_over_sdpa_fwd': ms[0.0]['fwd'] / sdpa_fwd,
        'dq_fp32_over_sdpa_bwd': ms[0.0]['dq'] / sdpa_bwd,
        'dkv_fp32_over_sdpa_bwd': ms[0.0]['dkv'] / sdpa_bwd})
    library = ('SDPA backward (dQ, dK, dV together) through '
               'torch.autograd.grad, p = 0')
    for name, kind, grads, flops_per_key, whole in (
            ('flash_attention_dq', 'dq', ('dq',), 6.0, 3),     # q, dO, dq
            ('flash_attention_dkv', 'dkv', ('dk', 'dv'), 8.0, 4)):
        work, biased = bounds(flops_per_key, whole, 2 * side)
        rows[name] = {
            'max_abs_err': max(errs[p][g] for p in (0.0, P) for g in grads),
            'ms': ms[P][kind], 'ms_p0': ms[0.0][kind],
            'plain_ms': plain[kind], 'library_ms': sdpa_bwd,
            'library': library, **work,
            'shape': list(shape), 'layout': '(B, L, H, D) seen through '
            'transpose(1, 2)', 'bias': False,
            'with_key_bias': {'unmasked_keys': keys, 'ms': ms_bias[kind],
                              'bound_ms': biased['bound_ms'],
                              'bound_by': biased['bound_by']}}
    emit_kernel('flash_attention_fwd', rows)
    emit_kernel('flash_attention_dq', rows, tolerance=GRAD_TOL,
                error_is='relative to the max abs gradient')
    emit_kernel('flash_attention_dkv', rows, tolerance=GRAD_TOL,
                error_is='relative to the max abs gradient')
    del q, k, v, do, qb, kb_, vb, dob

    # -- dropout + add + LayerNorm in training, and the mask gradient ----
    N, E = TRAIN_BATCH * SEQ, 1024
    x, res, g = randn(N, E), randn(N, E), randn(N, E)
    w, b = 1.0 + 0.1 * randn(E), 0.1 * randn(E)
    # LayerNorm as the train step launches it, twice a step: y, mean and
    # rstd out, eps 1e-12, on the embeddings and on the MLM head's rows
    ln_train = {}
    for lead in ((TRAIN_BATCH, SEQ), (TRAIN_BATCH, SEQ * 15 // 100)):
        xs = randn(*lead, E)
        out = fused_norm._forward(xs, w, b, 1e-12, True)
        with kernels.plain_versions():
            ref = fused_norm._forward(xs, w, b, 1e-12, True)
            ln_plain = time_ms(lambda: fused_norm._forward(
                xs, w, b, 1e-12, True), flush)
        torch.cuda.synchronize()
        err = max(max_err(a, c) for a, c in zip(out, ref))
        check(f'layer norm {(*lead, E)}: y, mean, rstd', err, TOL)
        n_ = lead[0] * lead[1]
        work = bound(8.0 * n_ * E, 4.0 * (2 * n_ * E + 2 * E + 2 * n_))
        ln_train[str((*lead, E))] = {
            'max_abs_err': err, 'ms': time_ms(lambda: fused_norm._forward(
                xs, w, b, 1e-12, True), flush), 'plain_ms': ln_plain,
            'library_ms': time_ms(lambda: torch.native_layer_norm(
                xs, (E,), w, b, 1e-12), flush),
            'copy_ms': copy_ms(work['bytes'], flush), **work}
    rows['layer_norm_fwd']['train'] = {'outputs': 'y, mean, rstd',
                                       **ln_train}
    rows['layer_norm_fwd']['max_abs_err'] = max(
        [rows['layer_norm_fwd']['max_abs_err']]
        + [r['max_abs_err'] for r in ln_train.values()])
    emit_kernel('layer_norm_fwd', rows)
    ln_errs = {}
    for n_, e_, p in ADD_LN_CASES:
        xs, rs_ = randn(n_, e_), randn(n_, e_)
        ws, bs = randn(e_), randn(e_)
        out = fdn._forward(xs, rs_, ws, bs, p, 1e-5, SEED, 5, True)
        with kernels.plain_versions():
            ref = fdn._forward(xs, rs_, ws, bs, p, 1e-5, SEED, 5, True)
        torch.cuda.synchronize()
        err = max(max_err(a, c) for a, c in zip(out, ref))
        check(f'dropout + add + layer norm ({n_}, {e_}) p={p}: y, yin, '
              f'mean, rstd', err, TOL)
        ln_errs[f'({n_}, {e_}) p={p}'] = err
    train_ms = {p: time_ms(lambda p=p: fdn._forward(
        x, res, w, b, p, 1e-5, SEED, 5, True), flush) for p in (0.0, P)}
    with kernels.plain_versions():
        train_plain = time_ms(lambda: fdn._forward(
            x, res, w, b, P, 1e-5, SEED, 5, True), flush)
    # training writes yin, mean and rstd too
    work = bound(9.0 * N * E, 4.0 * (4 * N * E + 2 * E + 2 * N))
    train = {'shape': [N, E], 'outputs': 'y, yin, mean, rstd',
             'ms_p0': train_ms[0.0], 'ms_p0.1': train_ms[P],
             'plain_ms_p0.1': train_plain,
             'library_ms_p0': time_ms(lambda: torch.native_layer_norm(
                 x + res, (E,), w, b, 1e-5), flush),
             'library': ADD_LN_LIBRARY,
             'copy_ms': copy_ms(work['bytes'], flush),
             **work, 'max_abs_err': ln_errs}
    train.update(closeness(train))
    train['p0_over_library'] = train['ms_p0'] / train['library_ms_p0']
    rows['add_layer_norm_fwd']['train'] = train
    emit_kernel('add_layer_norm_fwd', rows)

    dx = fdn.dropout_grad(g, P, SEED, 5)
    with kernels.plain_versions():
        rdx = fdn.dropout_grad(g, P, SEED, 5)
    err = max_err(dx, rdx)
    check('dropout mask gradient', err, TOL)
    cases = dmask_bit_exact(fdn, g, randn, P, SEED)
    stored = philox.keep_scale(g.shape, P, SEED, 5, dev)
    with kernels.plain_versions():
        grad_plain = time_ms(lambda: fdn.dropout_grad(g, P, SEED, 5), flush)
    work = bound(1.0 * N * E, 4.0 * 2 * N * E)
    rows['dropout_grad'] = {
        'max_abs_err': err,
        'ms': time_ms(lambda: fdn.dropout_grad(g, P, SEED, 5), flush),
        'plain_ms': grad_plain,
        'library_ms': time_ms(lambda: g * stored, flush),
        'library': 'multiply by a stored (N, D) fp32 mask',
        'copy_ms': copy_ms(work['bytes'], flush), **work, 'shape': [N, E],
        'bit_exact_cases': cases}
    emit_kernel('dropout_grad', rows, mask_bit_exact=True,
                keep_rate=keep_rate)
    grad = rows['dropout_grad']
    check_speed('mask_gradient_speed_fp32', {
        'dmask_fp32_over_stored_mask': grad['ms'] / grad['library_ms']})


def _requests(rs, n, vocab):
    """``n`` requests with real lengths in [32, SEQ], zero-padded to SEQ."""
    out = []
    for length in rs.randint(32, SEQ + 1, size=n):
        ids = np.zeros(SEQ, np.int32)
        ids[:length] = rs.randint(1, vocab, size=length)
        mask = np.zeros(SEQ, np.int32)
        mask[:length] = 1
        out.append({'input_ids': ids, 'attention_mask': mask})
    return out


def _example():
    return {'input_ids': np.zeros(SEQ, np.int32),
            'attention_mask': np.zeros(SEQ, np.int32)}


def phase_parity(seed):
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.bert import BertModel, bert_large
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg = bert_large()
    cfg.num_hidden_layers = 2
    model = BertModel(cfg, device=dev, generator=gen)
    cpu_model = copy.deepcopy(model).to('cpu').eval()
    eng = ServingEngine(device=dev)
    ep = eng.register('bert2', layer=model, example=_example())
    reqs = _requests(np.random.RandomState(seed), 4, cfg.vocab_size)
    futs = [ep.submit(r) for r in reqs]
    eng.run_until_idle()
    resps = [f.result(timeout=600) for f in futs]
    with torch.inference_mode():
        seq, pooled = cpu_model(
            torch.from_numpy(np.stack([r['input_ids'] for r in reqs])),
            attention_mask=torch.from_numpy(
                np.stack([r['attention_mask'] for r in reqs])))
    errs = []
    for i, resp in enumerate(resps):
        if not resp.ok:
            raise AssertionError(f"parity request {i}: {resp.status}")
        errs.append(max(float(np.abs(resp.outputs[0] - seq[i].numpy()).max()),
                        float(np.abs(resp.outputs[1] - pooled[i].numpy()
                                     ).max())))
    check('2-layer BERT-large, GPU engine vs CPU', max(errs), MODEL_TOL)
    emit({'phase': 'parity', 'layers': 2, 'hidden': cfg.hidden_size,
          'requests': len(reqs), 'tolerance': MODEL_TOL,
          'max_abs_err': max(errs), 'per_request_err': errs})


# phase_serve's traffic: waves of 1, 3 (bucket 4, one padding row), 13 and
# 16 (bucket 16) requests, 87 in all
SERVE_WAVES = [1] * 10 + [3] * 6 + [13] * 2 + [16] * 2


def _serve_waves(eng, ep, reqs):
    """``SERVE_WAVES`` through ``ep``, each wave submitted and pumped until
    idle -> (responses, {bucket: [batch ms]}, seconds)."""
    from paddle_tpu_torch.serving import DEFAULT_BATCH_BUCKETS, select_bucket
    batch_ms, served = {}, []
    t0 = time.perf_counter()
    at = 0
    for n in SERVE_WAVES:
        futs = [ep.submit(r) for r in reqs[at:at + n]]
        at += n
        eng.run_until_idle()
        resps = [f.result(timeout=600) for f in futs]
        batch_ms.setdefault(select_bucket(n, DEFAULT_BATCH_BUCKETS),
                            []).append(resps[0].breakdown['run'])
        served += resps
    return served, batch_ms, time.perf_counter() - t0


def phase_serve(seed, card):
    """-> (the launch counts, what ``phase_serve_tenants`` compares with:
    the model, the requests, the waves' outputs, launches and host
    syncs)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.bert import BertModel, bert_large
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    cfg = bert_large()
    t0 = time.perf_counter()
    model = BertModel(cfg, device=dev, generator=gen)
    eng = ServingEngine(queue_capacity=64, device=dev)
    ep = eng.register('bert', layer=model, example=_example())
    warm = eng.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    waves = SERVE_WAVES
    reqs = _requests(np.random.RandomState(seed), sum(waves), cfg.vocab_size)
    kernels.reset_launch_counts()              # the main path starts here
    (served, batch_ms, serve_s), syncs, sync_sites = _count_syncs(
        lambda: _serve_waves(eng, ep, reqs))
    syncs -= _SYNC_NOTICE in ' '.join(sync_sites)
    wave_counts = kernels.launch_counts()
    eng.start()
    try:
        threaded = ep.predict(reqs[-1], timeout=600)
    finally:
        eng.stop()
    counts = kernels.launch_counts()           # ... and ends here
    batches = eng.stats()['models']['bert']['batches']

    for i, resp in enumerate(served + [threaded]):
        if not resp.ok:
            raise AssertionError(f"request {i}: status {resp.status}")
        _bert_outputs_ok(f"request {i}", resp, cfg.hidden_size)
    # serving is forward only, without dropout: the backward kernels and
    # the mask gradient must not run
    want = {**dict.fromkeys(counts, 0), 'layer_norm_fwd': batches,
            'add_layer_norm_fwd': 48 * batches,
            'flash_attention_fwd': 24 * batches}
    if batches != len(waves) + 1 or counts != want:
        raise AssertionError(f"launches {counts} over {batches} batches, "
                             f"expected {want}")
    # the last request of a full bucket-16 batch, served again alone on
    # the worker thread: batch composition does not leak into a result
    drift = float(np.abs(threaded.outputs[0] - served[-1].outputs[0]).max())
    check('bucket-16 vs bucket-1 repeat', drift, MODEL_TOL)
    lat = {str(bk): {'batches': len(v), 'p50_ms': float(np.percentile(v, 50)),
                     'p99_ms': float(np.percentile(v, 99))}
           for bk, v in sorted(batch_ms.items())}
    emit({'phase': 'serve', 'model': 'bert_large', 'layers':
          cfg.num_hidden_layers, 'hidden': cfg.hidden_size, 'seq': SEQ,
          'dtype': 'float32', 'card': card, 'setup_s': setup_s,
          'warmup_buckets': warm['bert'], 'requests': len(served) + 1,
          'batches': batches, 'requests_per_s': sum(waves) / serve_s,
          'batch_latency_ms': lat, 'launches': counts,
          'host_syncs_waves': syncs, 'host_sync_sites': sync_sites,
          'repeat_drift': drift})
    def one_batch():
        futs = [ep.submit(r) for r in reqs[:16]]
        eng.run_until_idle()
        for f in futs:
            f.result(timeout=600)
    phase_profile('serve', one_batch, SERVE_ROUTES, bucket=16)
    return counts, {'model': model, 'requests': reqs,
                    'outputs': [r.outputs for r in served],
                    'launches': wave_counts, 'syncs': syncs,
                    'requests_per_s': sum(waves) / serve_s,
                    'batch_p50_ms': {bk: row['p50_ms']
                                     for bk, row in lat.items()}}


# Calls a profiled batch or step must show, by a word of the kernels' CUDA
# names (csrc/fused_dropout_norm.cu, csrc/fused_norm.cu): each of the 48
# add+LayerNorm launches on the register path (add_layer_norm_warp_kernel),
# none on the block path (add_layer_norm_fwd_kernel,
# dropout_add_layer_norm_fwd_kernel); each LayerNorm launch (1 a batch, 2 a
# step) on the register path (ln_rows_warp_kernel), none on a block kernel
# (the word layer_norm_fwd_kernel also names the two add+LayerNorm block
# kernels); in training also each of the 48 mask gradients on the vector
# kernel and none on the scalar one
SERVE_ROUTES = {'add_layer_norm_warp_kernel': 48,
                'add_layer_norm_fwd_kernel': 0, 'ln_rows_warp_kernel': 1,
                'layer_norm_fwd_kernel': 0}
TRAIN_ROUTES = {**SERVE_ROUTES, 'ln_rows_warp_kernel': 2,
                'dropout_grad_vec_kernel': 48, 'dropout_grad_kernel': 0}


# sessions phase_profile takes when one comes up short: a session can
# lose a stretch of device events (the first 10-120 of a BERT-large train
# step, in ~4 % of sessions on an H100; PERF.md, section 7)
PROFILE_TAKES = 3

# short sleep kernels a session launches, and waits for, before the call
# it profiles; each retake launches PREROLL_GROWTH times as many. In some
# process states a session drops its first device records as outside
# the profiler's window (kineto's out-of-range count): 7-10 records, once
# 120, as many whether they are one 20 ms sleep or short kernels, so a
# longer sleep does not help and more sleeps absorb them (PERF.md,
# section 7)
PREROLL_SPINS = 1024
PREROLL_GROWTH = 4


def _profile_session(run, spins, cycles=1000, ranges=()):
    """One call of ``run`` under torch.profiler, after ``spins`` sleep
    kernels of ``cycles`` each -> ({kernel name: (ms, calls)}, device
    intervals, wall ms, the port's launches in it, the sleep kernels
    caught, {host range in ``ranges``: times seen}). The device lists
    leave out the ranges' projections onto the device timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import kernels
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(spins):
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    launched = sum(n - before[k] for k, n in kernels.launch_counts().items())
    spans, by_name, slept = [], {}, 0
    seen = dict.fromkeys(ranges, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            if e.name in seen:
                seen[e.name] += 1
            continue
        if e.is_user_annotation:
            # a record_function range (the port's telemetry spans bridge
            # into it) projected onto the device's timeline: no device
            # work, and its interval would fill the gaps between kernels
            continue
        if 'spin_kernel' in e.name:
            slept += 1
            continue
        t0_us, t1_us = e.time_range.start, e.time_range.end
        spans.append((t0_us, t1_us))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t1_us - t0_us) / 1e3, n + 1)
    return by_name, spans, wall_ms, launched, slept, seen


def phase_profile(what, run, routes, top_n=12, ranges=(), **extra):
    """Device time by kernel over one call of ``run`` — one bucket-16
    batch, one train step — (torch.profiler's device-side events: kernels
    and copies), and the device's idle share of that call's wall time.
    Raises unless, over every kernel name, the calls whose names hold a
    word of ``routes`` number what it says. A session that caught fewer
    of the port's kernels than its launch counters counted lost events,
    and is taken again (up to ``PROFILE_TAKES``; ``run`` runs again,
    after ``PREROLL_GROWTH`` times the sleep kernels): lost events only
    lower a count, and a kernel on a wrong route shows in a complete
    session too. Each host range named in ``ranges`` (a
    ``torch.profiler.record_function`` range, such as the port's
    telemetry spans) must show at least once. -> the printed row."""
    for take in range(1, PROFILE_TAKES + 1):
        spins = PREROLL_SPINS * PREROLL_GROWTH ** (take - 1)
        by_name, spans, wall_ms, launched, slept, seen = _profile_session(
            run, spins, ranges=ranges)
        calls = {word: sum(n for name, (_, n) in by_name.items()
                           if word in name) for word in routes}
        caught = sum(n for name, (_, n) in by_name.items()
                     if _kernel_group(name) in PORT_GROUPS)
        if calls == routes or caught >= launched:
            break
    busy_us, reach = 0.0, None      # union of the device intervals
    for a, b in sorted(spans):
        if reach is None or a > reach:
            busy_us += b - a
            reach = b
        elif b > reach:
            busy_us += b - reach
            reach = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    groups = {}
    for name, (ms, n) in by_name.items():
        group = _kernel_group(name)
        g_ms, g_n = groups.get(group, (0.0, 0))
        groups[group] = (g_ms + ms, g_n + n)
    row = {'phase': 'profile', 'of': what, **extra, 'wall_ms': wall_ms,
           'route_calls': calls,
           'device_busy_ms': busy_us / 1e3,
           'device_idle_share': (1.0 - busy_us / 1e3 / wall_ms
                                 if spans else None),
           'device_events': len(spans), 'takes': take,
           'preroll': {'spins': spins, 'caught': slept},
           'port_kernels': {'caught': caught, 'launched': launched},
           'groups': {g: {'ms': ms, 'calls': n} for g, (ms, n) in
                      sorted(groups.items(), key=lambda kv: -kv[1][0])},
           'top': [{'ms': ms, 'calls': n, 'name': name[:90]}
                   for name, (ms, n) in top]}
    if ranges:
        row['host_ranges'] = seen
    emit(row)
    if calls != routes:
        raise AssertionError(f"profile of {what}: kernel calls {calls}, "
                             f"expected {routes} ({caught} of the port's "
                             f"{launched} launches caught, {take} takes)")
    if not all(seen.values()):
        raise AssertionError(f"profile of {what}: host ranges {seen}")
    return row


# the port's kernels by their CUDA function names; the rest by the words
# PyTorch's, cuBLAS's and CUTLASS's kernel names carry
_GROUPS = (('attention kernels', ('flash_fwd_tf32_kernel',
                                  'flash_dq_tf32_kernel',
                                  'flash_dkv_tf32_kernel',
                                  'flash_fwd_mma_kernel',
                                  'flash_dq_mma_kernel',
                                  'flash_dkv_mma_kernel')),
           ('norm and mask kernels', ('layer_norm_fwd_kernel',
                                      'add_layer_norm_warp_kernel',
                                      'ln_rows_warp_kernel',
                                      'rms_norm_fwd_kernel',
                                      'rms_rows_warp_kernel',
                                      'dropout_grad_kernel',
                                      'dropout_grad_vec_kernel')),
           ('matrix products', ('gemm', 'xmma', 'cutlass', 'nvjet',
                                'sgemm', 'splitk')),
           ('AdamW (multi_tensor_apply)', ('multi_tensor_apply',)),
           ('copies and casts', ('copy', 'Memcpy', 'Memset')),
           ('reductions', ('reduce',)))


# the groups of the port's own kernels
PORT_GROUPS = ('attention kernels', 'norm and mask kernels')


def _kernel_group(name):
    for group, words in _GROUPS:
        if any(w in name for w in words):
            return group
    return 'other elementwise'


def _pretraining_batch(rs, batch, vocab):
    """The feeds ``bench.py::bench_bert`` makes: ids, token types, 15 % of
    the positions masked, their labels, NSP labels."""
    n_masked = max(SEQ * 15 // 100, 1)
    x = {'input_ids': rs.randint(0, vocab, (batch, SEQ)).astype(np.int64),
         'token_type_ids': np.zeros((batch, SEQ), np.int64),
         'masked_positions': np.stack(
             [rs.choice(SEQ, n_masked, replace=False)
              for _ in range(batch)]).astype(np.int64)}
    y = (rs.randint(0, vocab, (batch, n_masked)).astype(np.int64),
         rs.randint(0, 2, (batch, 1)).astype(np.int64))
    return x, y


# the loss scale of the fp16 parity's backward: GradScaler's initial one
FP16_LOSS_SCALE = 2.0 ** 15


def _loss_and_grads(model, x, y, device, bf16=False, fp16=False):
    """One forward and backward of ``pretraining_loss`` -> (loss, {name:
    fp32 gradient on the host}), with the model's dropout state rewound to
    offset 0; with ``bf16``, under the reference's recipe
    (``bf16_recipe``); with ``fp16``, under ``amp.auto_cast(level='O1',
    dtype='float16')`` on the fp32 parameters, the backward taken from the
    loss times ``FP16_LOSS_SCALE`` and divided by it, as the loss scaler
    does (unscaled, fp16 activation gradients of ~1e-6 would lose their
    bits below fp16's smallest normal, 6.1e-5)."""
    from paddle_tpu_torch import amp
    model.dropout_state.offset = 0
    params = dict(model.named_parameters())
    feeds = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    labels = tuple(torch.from_numpy(v).to(device) for v in y)
    scale = FP16_LOSS_SCALE if fp16 else 1.0
    if bf16:
        loss, _ = bf16_recipe(model)(params, (feeds, labels))
    else:
        with amp.auto_cast(enable=fp16, level='O1', dtype='float16'):
            loss = model.pretraining_loss(*model(**feeds), *labels)
    grads = torch.autograd.grad(loss * scale, list(params.values()))
    return (float(loss.detach()),
            {n: (g.detach().float() / scale).cpu()
             for n, g in zip(params, grads)})


def _grad_errs(got, want):
    """``{name: max abs error over the tensor's max abs value}``, the scale
    floored at 1e-3 of the largest entry of ``want`` (see
    ``_compare_grads``)."""
    top = max(float(g.abs().max()) for g in want.values())
    return {n: max_err(got[n], r) / max(float(r.abs().max()), 1e-3 * top)
            for n, r in want.items()}


def _compare_grads(what, got, want, tol=GRAD_TOL, mean_tol=None):
    """Each gradient's max abs error over its tensor's max abs value ->
    (worst, its name, mean over the tensors); raises past ``tol`` (and
    ``mean_tol`` for the mean, when given). A tensor whose true gradient is
    zero (the key bias: softmax ignores a shift of a row's scores) holds
    rounding noise on both sides, so the scale has a floor of 1e-3 of the
    model's largest gradient entry."""
    errs = _grad_errs(got, want)
    worst_name = max(errs, key=lambda n: (errs[n] != errs[n], errs[n]))
    mean = float(np.mean(list(errs.values())))
    check(f'{what}: gradient of {worst_name}', errs[worst_name], tol)
    if mean_tol is not None:
        check(f'{what}: mean gradient error', mean, mean_tol)
    return errs[worst_name], worst_name, mean


def phase_train_parity(seed):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    x, y = _pretraining_batch(np.random.RandomState(seed), 2, 30522)
    out = {'phase': 'train_parity', 'layers': 2, 'batch': [2, SEQ],
           'tolerance': GRAD_TOL}
    for p in (0.0, 0.1):
        cfg = bert_large(hidden_dropout_prob=p,
                         attention_probs_dropout_prob=p)
        cfg.num_hidden_layers = 2
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 2)
        model = BertForPretraining(cfg, device=dev, generator=gen).train()
        kernels.reset_launch_counts()
        loss, grads = _loss_and_grads(model, x, y, dev)
        counts = kernels.launch_counts()
        if p == 0.0:
            # the card's kernel path against the CPU's plain path
            ref_model = copy.deepcopy(model).to('cpu')
            ref_loss, ref_grads = _loss_and_grads(ref_model, x, y, 'cpu')
            other = 'cpu'
        else:
            # same weights, same (seed, offset): kernels against their
            # plain versions, both on the card
            with kernels.plain_versions():
                ref_loss, ref_grads = _loss_and_grads(model, x, y, dev)
            other = 'plain versions on the GPU'
            again, _ = _loss_and_grads(model, x, y, dev)
            if again != loss:
                raise AssertionError(
                    f"train parity: the same step from the same seed and "
                    f"offset gave losses {loss} and {again}")
            out['repeat_loss_identical'] = True
        if kernels.launch_counts() != (counts if p == 0.0 else
                                       {k: 2 * v for k, v in counts.items()}):
            raise AssertionError("train parity: the plain path launched a "
                                 "kernel")
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        check(f'train parity p={p}: loss', loss_err, GRAD_TOL)
        worst, name, _ = _compare_grads(f'train parity p={p}', grads,
                                        ref_grads)
        out[f'p={p}'] = {'against': other, 'loss': loss,
                         'reference_loss': ref_loss, 'loss_rel_err': loss_err,
                         'worst_grad_rel_err': worst, 'worst_grad': name,
                         'gradients': len(grads), 'launches': counts}
        del model
        torch.cuda.empty_cache()
    emit(out)


TRAIN_LAUNCHES = {'flash_attention_fwd': 24, 'flash_attention_dq': 24,
                  'flash_attention_dkv': 24, 'add_layer_norm_fwd': 48,
                  'dropout_grad': 48, 'layer_norm_fwd': 2,
                  'rms_norm_fwd': 0}


TRAIN_MODES = {
    'fp32': 'float32',
    'bf16': 'bfloat16 compute, fp32 master weights (bench_bert recipe)',
    'bf16_flat': ('bfloat16 compute on views of one flat bf16 buffer, one '
                  'flat fp32 master (bench_bert flat mode, FlatFusedUpdate)'),
    'fp16_amp': ('amp.auto_cast O1 float16 on fp32 parameters, '
                 'GradScaler, nan_guard'),
}


def _amp_step(step, debug=True):
    """One call of ``step`` under ``auto_cast(level='O1', dtype=
    'float16')``; with ``debug``, with CUDA's sync debug mode at 'error':
    a step that made the host wait for the device would raise."""
    from paddle_tpu_torch import amp

    def run(state, batch):
        with amp.auto_cast(level='O1', dtype='float16'):
            torch.cuda.set_sync_debug_mode('error' if debug else 'default')
            try:
                return step(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode('default')
    return run


def phase_train(seed, card, mode='fp32'):
    """BERT-large pretraining steps through ``build_train_step`` on the
    same weights (the same seed) and batch: ``mode`` of ``TRAIN_MODES``.
    -> (this path's launch counts, a callable that runs one more step, the
    step ms row)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.engine import build_train_step
    from paddle_tpu_torch.optimizer import AdamW, FlatFusedUpdate
    from paddle_tpu_torch.resilience import NanGuard
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    cfg = bert_large()
    t0 = time.perf_counter()
    model = BertForPretraining(cfg, device=dev, generator=gen).train()
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
    params = dict(model.named_parameters())
    scaler = guard = None
    if mode == 'bf16':
        step = build_train_step(bf16_recipe(model), opt, params=params)
    elif mode == 'bf16_flat':
        step = build_train_step(
            flat_recipe(model), FlatFusedUpdate(opt, params,
                                                compute_dtype=BF16),
            params=params)
    elif mode == 'fp16_amp':
        scaler, guard = GradScaler(), NanGuard()
        step = build_train_step(net=model, loss=model.pretraining_loss,
                                optimizer=opt, scaler=scaler,
                                nan_guard=True)
    else:
        step = build_train_step(net=model, loss=model.pretraining_loss,
                                optimizer=opt)
    run = _amp_step(step) if mode == 'fp16_amp' else step
    # the profile and the op log run outside the sync debug mode
    quiet = _amp_step(step, debug=False) if mode == 'fp16_amp' else step
    state = step.init_state()
    x, y = _pretraining_batch(np.random.RandomState(seed), TRAIN_BATCH,
                              cfg.vocab_size)
    batch = ({k: torch.from_numpy(v).to(dev) for k, v in x.items()},
             tuple(torch.from_numpy(v).to(dev) for v in y))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # 20 steps, because Adam at lr 1e-4 without a warm-up overshoots on
    # random weights: over seeds 0 to 4 (H100, fp32) the loss rose from 11
    # to 15-20 for 8 to 12 steps, then fell steadily, and was 1.4 to 2.0
    # below the first by step 20; at step 10 it was below it for two seeds
    warmup, timed = 2, 18
    losses, step_ms = [], []
    totals = dict.fromkeys(TRAIN_LAUNCHES, 0)
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + timed):
        kernels.reset_launch_counts()          # the main path: one step
        t1 = time.perf_counter()
        state, result = run(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        counts = kernels.launch_counts()       # ... read right after it
        if counts != TRAIN_LAUNCHES:
            raise AssertionError(f"train step {i} ({mode}): launches "
                                 f"{counts}, expected {TRAIN_LAUNCHES}")
        for name, n in counts.items():
            totals[name] += n
        losses.append(float(result.loss))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {mode}: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train {mode}: loss did not fall: {losses}")
    ms = step_ms[warmup:]
    if mode.startswith('bf16') and result.outputs[0].dtype != BF16:
        raise AssertionError(f"{mode} train: the logits are not bf16")
    out = {'phase': 'train' if mode == 'fp32' else f'train_{mode}',
           'model': 'bert_large pretraining', 'layers':
           cfg.num_hidden_layers, 'hidden': cfg.hidden_size,
           'batch': [TRAIN_BATCH, SEQ], 'dtype': TRAIN_MODES[mode],
           'dropout': cfg.hidden_dropout_prob, 'optimizer':
           'AdamW(lr=1e-4, weight_decay=0.01)', 'card': card,
           'setup_s': setup_s, 'warmup_steps': warmup, 'timed_steps': timed,
           'step_ms': {'median': float(np.median(ms)), 'min': min(ms),
                       'max': max(ms), 'warmup': step_ms[:warmup]},
           'samples_per_s': TRAIN_BATCH / (float(np.median(ms)) / 1e3),
           'max_memory_allocated_bytes': peak, 'losses': losses,
           'launches_per_step': TRAIN_LAUNCHES, 'launches': totals}
    if mode == 'fp16_amp':
        # the counters the steps kept on the device, into the host objects
        out['sync'] = step.sync(state, nan_guard=guard, scaler=scaler)
        if guard.total_steps != warmup + timed:
            raise AssertionError(f"fp16 amp: the guard counted "
                                 f"{guard.total_steps} steps")
        out['steps_run_under_sync_debug_mode'] = 'error'
    emit(out)
    phase_profile(f'train step {mode}' if mode != 'fp32' else 'train step',
                  lambda: quiet(state, batch), TRAIN_ROUTES,
                  top_n=16 if mode == 'fp32' else 20,
                  batch=[TRAIN_BATCH, SEQ])
    if mode != 'fp32':
        copy_accounting(mode, lambda: quiet(state, batch))
    if mode in ('bf16', 'bf16_flat'):
        optimizer_profile(mode, step, state)
    if mode == 'fp16_amp':
        amp_overflow(step, state, lambda: run(state, batch), scaler, guard)
    return totals, lambda: quiet(state, batch), out['step_ms']


def flat_recipe(net):
    """``bench.py::bench_bert``'s flat mode as a ``loss_fn`` for
    ``build_train_step`` with a ``FlatFusedUpdate(compute_dtype=bf16)``:
    the step hands it bf16 views of the flat buffer, which go to the model
    through ``torch.func.functional_call``; the loss on fp32 logits."""
    def loss_fn(params, batch):
        x, y = batch
        logits, nsp = torch.func.functional_call(net, params, (), x)
        loss = net.pretraining_loss(logits.float(), nsp.float(), *y)
        return loss, (logits, nsp)
    return loss_fn


def optimizer_profile(mode, step, state):
    """Device time and events of one AdamW update alone (zero gradients,
    the same arithmetic) on the step's state: the flat update of the
    whole buffer, or the per-parameter one over ~400 tensors."""
    flat = step._flat
    if flat is not None:
        g = torch.zeros_like(state['params'])
        run = lambda: flat.update(state['params'], g, state['opt'])  # noqa
    else:
        grads = {n: torch.zeros_like(p) for n, p in state['params'].items()}
        run = lambda: step.optimizer.functional_update(  # noqa: E731
            state['params'], grads, state['opt'])
    run()
    torch.cuda.synchronize()
    phase_profile(f'AdamW update alone ({mode})', run, {})


def amp_overflow(step, state, run, scaler, guard, of='AdamW'):
    """Force fp16 gradients past 65504: the device scale set to 2^40, then
    ``decr_every_n_nan_or_inf`` steps. Each must leave parameters, moments
    and beta*_pow bitwise as they were (``of``: the optimizer, and the
    clip, the step runs: an inf gradient gives an inf global norm and NaN
    clipped gradients, which the select must discard); after them the
    scale has halved; ``sync`` brings the host GradScaler and NanGuard to
    the device's counts."""
    from paddle_tpu_torch import kernels
    step.sync(state, nan_guard=guard, scaler=scaler)   # the steps so far
    state['scaler']['scale'].fill_(2.0 ** 40)
    steps0 = guard.total_steps
    for i in range(scaler._decr_every):
        before = [t.clone() for t in _state_tensors(state)]
        kernels.reset_launch_counts()
        state, result = run()
        torch.cuda.synchronize()
        if kernels.launch_counts() != TRAIN_LAUNCHES:
            raise AssertionError("fp16 amp overflow step: launches "
                                 f"{kernels.launch_counts()}")
        changed = [j for j, (a, b) in enumerate(zip(
            before, _state_tensors(state))) if not torch.equal(a, b)]
        if changed:
            raise AssertionError(f"fp16 amp: the overflowed step {i} moved "
                                 f"{len(changed)} state tensors")
        del before
    synced = step.sync(state, nan_guard=guard, scaler=scaler)
    want = {'scale': 2.0 ** 39, 'good': 0, 'bad': 0}
    if scaler.state_dict() != want or synced['scaler'] != want:
        raise AssertionError(f"fp16 amp: after the overflow the scaler is "
                             f"{scaler.state_dict()}, expected {want}")
    if guard.total_steps != steps0 + scaler._decr_every:
        raise AssertionError("fp16 amp: the guard's step count")
    emit({'phase': 'amp_overflow', 'of': of, 'scale_set': 2.0 ** 40,
          'bad_steps': scaler._decr_every, 'state_bitwise_unchanged': True,
          'scale_after': scaler.get_loss_scaling(), 'sync': synced,
          'last_loss': float(result.loss)})


def _state_tensors(state):
    """Every parameter and optimizer-state tensor of a step's state (the
    moments, beta*_pow, ... of whatever optimizer), each once."""
    out = {id(t): t for t in state['params'].values()}
    for st in state['opt'].values():
        for t in st.values():
            if isinstance(t, torch.Tensor):
                out.setdefault(id(t), t)
    return list(out.values())


# ---------------------------------------------------------------------------
# bf16: the reference's training precision (bench.py::bench_bert: bf16
# compute, fp32 master weights)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
FP16 = torch.float16
# kernel vs plain version at bf16, max abs error over the output's (or
# gradient's) max abs value: both compute in fp32 and round at the same
# points, so they differ by one bf16 step (2^-8 = 3.9e-3 relative) where
# sums taken in another order straddle a rounding boundary, and again where
# a rounded P or dS feeds a product
BF16_TOL = 1e-2
# kernel vs plain version at fp16, as BF16_TOL: fp16 keeps 3 more mantissa
# bits (2^-11 = 4.9e-4 relative a step), so the one-step differences are
# an eighth of bf16's; the same arithmetic and rounding points otherwise
# (the f16 instantiations of the same kernels)
FP16_TOL = 2e-3
# fp32 statistics (lse, mean, rstd) of 16-bit inputs: summation order only
STAT_TOL = 1e-4
# a bf16 model step against another path (fp32 weights and path, or the
# plain versions), per gradient tensor over its max abs value: rounding
# compounds over the layers (2 layers at full width); the same gates hold
# a narrow 2-layer model against the JAX package's bf16 recipe on the CPU
# (tests/test_torch_bf16.py)
BF16_LOSS_TOL = 2e-3
BF16_GRAD_MAX = 0.1
BF16_GRAD_MEAN = 0.03
# the tensor-core attention kernels' time over the library call's in the
# same run, p = 0: at bf16 at the train step's shape, the forward at most
# twice SDPA's forward, dK/dV and dQ each at most SDPA's whole backward (dQ,
# dK, dV); the fp32 forward at most SDPA's fp32 forward, at the fp32 train
# shape and at the serving shape with its key bias; the fp32 dQ and dK/dV
# each at most SDPA's whole fp32 backward at the fp32 train shape. The mask
# gradient at the train shape, bf16 and fp32, at most the multiply by a
# stored mask of its dtype; the bf16 add+LayerNorm at the train shape, p =
# 0, four outputs, at most x + res then torch.native_layer_norm; at bf16
# and (4096, 1024), the LayerNorm with its statistics at most
# torch.native_layer_norm, and the RMSNorm with rstd at most F.rms_norm
SPEED_LIMITS = {'fwd_over_sdpa_fwd': 2.0, 'dkv_over_sdpa_bwd': 1.0,
                'dq_over_sdpa_bwd': 1.0, 'fwd_fp32_over_sdpa_fwd': 1.0,
                'dq_fp32_over_sdpa_bwd': 1.0, 'dkv_fp32_over_sdpa_bwd': 1.0,
                'dmask_over_stored_mask': 1.0,
                'dmask_fp32_over_stored_mask': 1.0,
                'add_ln_over_add_native_ln': 1.0,
                'ln_over_native_ln': 1.0, 'rms_over_rms_norm': 1.0}
COPY_OPS = ('aten._to_copy.default', 'aten.copy_.default',
            'aten.clone.default')
# the functions that check tensors and launch a kernel: none may copy or
# cast a tensor (the C entry points read and write each dtype in HBM)
WRAPPERS = ('_forward', '_rms_forward', '_launch_forward', '_kernel_inputs',
            '_backward_inputs', '_backward_call', 'flash_attention_dq',
            'flash_attention_dkv', 'dropout_grad', '_require_rows')


def _site():
    """The innermost line of this repository on the Python stack."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        path = fr.filename.replace('\\', '/')
        at = path.rfind('paddle_tpu_torch/')
        if at >= 0:
            return f'{path[at:]}:{fr.lineno} {fr.name}'
        if path.endswith('chip_smoke.py'):
            return f'chip_smoke.py:{fr.lineno} {fr.name}'
    return 'torch'


class OpLog(TorchDispatchMode):
    """Every aten op dispatched while active; for each copy or cast, its
    dtypes, shape and the line of this repository that asked for it."""

    def __init__(self):
        super().__init__()
        self.ops, self.copies = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        self.ops.append(name)
        if name in COPY_OPS:
            src = args[1] if name == 'aten.copy_.default' else args[0]
            self.copies.append((str(src.dtype).replace('torch.', ''),
                                str(out.dtype).replace('torch.', ''),
                                tuple(src.shape), _site()))
        return out


def check_speed(phase, speed):
    """Print ``speed`` ({limit: kernel ms over library ms, one run}) as
    ``phase``'s line and hold each ratio to its SPEED_LIMITS entry."""
    emit({'phase': phase, **speed,
          'limits': {k: SPEED_LIMITS[k] for k in speed}})
    for key, ratio in speed.items():
        if not ratio <= SPEED_LIMITS[key]:
            raise AssertionError(f"{phase}: {key} = {ratio} > "
                                 f"{SPEED_LIMITS[key]}")


def no_copies(what, fn):
    """``fn()`` under the op log; raises if it copied or cast a tensor."""
    with OpLog() as log:
        out = fn()
    if log.copies:
        raise AssertionError(f"{what}: copied or cast {log.copies}")
    return out, sorted(set(log.ops))


def phase_kernels_16(seed, flush, dtype=None):
    """The six kernels at a 16-bit dtype (bf16, or fp16: the same designs'
    f16 instantiations) on the bf16 train step's own inputs, each against
    its plain version on the card (``BF16_TOL`` / ``FP16_TOL``), with its
    time, the plain version's, a PyTorch library call's at that dtype and
    the bound at the 16-bit tensor-core peak; the wrappers called under
    the op log (no copy, no cast); the awkward attention cases; the Philox
    mask of the 16-bit kernel bit for bit as at fp32. The speed limits are
    bf16's; at fp16 the same ratios are printed, not held."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_dropout_norm as fdn
    from paddle_tpu_torch.kernels import fused_norm, philox
    dtype = dtype or BF16
    tag = 'bf16' if dtype == BF16 else 'fp16'
    tol = BF16_TOL if dtype == BF16 else FP16_TOL
    name16 = str(dtype)[6:]

    def speed(phase, ratios):
        if dtype == BF16:
            check_speed(f'{phase}_{tag}', ratios)
        else:
            emit({'phase': f'{phase}_{tag}', **ratios, 'limits': None})
    dev = torch.device('cuda', 0)
    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    P, SEED = 0.1, 0x1234567890ABCDEF
    kernels.reset_launch_counts()
    rows, wrapper_ops = {}, {}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def bf16_bound(flops, nbytes):
        # the dense bf16 and fp16 tensor-core peaks are one number
        return bound(flops, nbytes, PEAK_BF16_FLOPS)

    # -- the mask: the 16-bit kernel's bits are the fp32 kernel's and
    # philox.py's; a kept element is 1/(1-p) rounded once to the dtype ----
    n = 4 * 2 ** 20 + 3
    m16 = fdn.dropout_grad(torch.ones(n, device=dev, dtype=dtype), P, SEED,
                           7)
    m32 = fdn.dropout_grad(torch.ones(n, device=dev), P, SEED, 7)
    keep = philox.keep_mask((n,), P, SEED, 7, dev)
    torch.cuda.synchronize()
    if not (torch.equal(m16 != 0, keep) and torch.equal(m32 != 0, keep)
            and torch.equal(m16, m32.to(dtype))):
        raise AssertionError(f"dropout mask: the {tag} kernel's bits differ "
                             f"from the fp32 kernel's and kernels/philox.py")
    emit({'phase': f'philox_{tag}', 'elements': n, 'p': P,
          'bit_exact_with_fp32_kernel_and_philox_py': True,
          'keep_rate': float(keep.double().mean())})
    del m16, m32, keep

    # -- attention at the train step's inputs: (8, 16, 512, 64), no
    # mask, q/k/v/dO seen through transpose(1, 2) -------------------------
    B, H, L, D = TRAIN_BATCH, 16, SEQ, 64
    shape = (B, H, L, D)
    q, k, v, do = (randn(B, L, H, D).transpose(1, 2) for _ in range(4))
    errs = {p: _attention_case(fa, q, k, v, do, False, None, p, SEED, 3)
            for p in (0.0, P)}
    cases = []
    for causal, shp, neg_row in ((False, (2, 3, 300, 40), True),
                                 (True, (2, 4, SEQ, 128), False),
                                 (True, BIASED_ROWS_SHAPE, False)):
        b_, _, l_, _ = shp
        qq, kk, vv, dd = (randn(*shp) for _ in range(4))
        kb = None
        if shp == BIASED_ROWS_SHAPE:
            kb = biased_first_keys(b_, l_, dev)
        elif neg_row:
            kb = torch.where(torch.rand(b_, l_, device=dev, generator=gen)
                             < 0.2, -1e4, 0.0).to(torch.float32)
            kb[1] = float('-inf')
        for p in (0.0, P):
            e = _attention_case(fa, qq, kk, vv, dd, causal, kb, p, SEED, 11)
            cases.append({'shape': list(shp), 'causal': causal,
                          'bias': kb is not None, 'empty_row': neg_row,
                          'p': p, **e})
    for case in [dict(errs[0.0], p=0.0, shape=list(shape)),
                 dict(errs[P], p=P, shape=list(shape))] + cases:
        what = f"{tag} flash {case['shape']} p={case['p']}"
        check(f'{what}: o over its max', case['o_rel'], tol)
        check(f'{what}: lse', case['lse'], STAT_TOL)
        for g in ('dq', 'dk', 'dv'):
            check(f'{what}: {g}', case[g], tol)
    # the wrappers as the step calls them: 16-bit in and out, no cast
    drop = (P, SEED, 3)
    (o, lse), wrapper_ops['flash_attention_fwd'] = no_copies(
        'flash forward', lambda: fa.flash_attention_forward(
            q, k, v, False, None, None, *drop))
    delta = (do.float() * o.float()).sum(-1)
    rest = (lse, delta, False, 1.0 / D ** 0.5, None, *drop)
    dq, wrapper_ops['flash_attention_dq'] = no_copies(
        'flash dQ', lambda: fa.flash_attention_dq(q, k, v, do, *rest))
    (dk, dv), wrapper_ops['flash_attention_dkv'] = no_copies(
        'flash dK/dV', lambda: fa.flash_attention_dkv(q, k, v, do, *rest))
    if not (o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
            and lse.dtype == torch.float32):
        raise AssertionError(f"flash attention: {tag} in, not {tag} out")
    ms = {p: _attention_ms(fa, q, k, v, do, None, p, SEED, flush)
          for p in (0.0, P)}
    with kernels.plain_versions():
        plain = _attention_ms(fa, q, k, v, do, None, P, SEED, flush)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), do, retain_graph=True), flush)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                       flush)
    del ol, ql, kl, vl
    # the work: every key of every row (no mask); q, k, v, dO read once and
    # each output written once in 16 bits, lse and delta in fp32
    n_qd = 2.0 * B * H * L * D
    side = 4.0 * B * H * L
    products = float(B * H) * L * L * D
    library = f'{tag} SDPA backward (dQ, dK, dV together), p = 0'
    for name, kind, outs, per, tensors, extra in (
            ('flash_attention_fwd', 'fwd', ('o_rel',), 4.0, 4, side),
            ('flash_attention_dq', 'dq', ('dq',), 6.0, 5, 2 * side),
            ('flash_attention_dkv', 'dkv', ('dk', 'dv'), 8.0, 6, 2 * side)):
        work = bf16_bound(per * products, tensors * n_qd + extra)
        rows[name] = {
            'max_abs_err': max(errs[p][g] for p in (0.0, P) for g in outs),
            'error_is': 'relative to the max abs value',
            'ms': ms[P][kind], 'ms_p0': ms[0.0][kind], 'plain_ms': plain[kind],
            'library_ms': sdpa_fwd if kind == 'fwd' else sdpa_bwd,
            'library': (f'{tag} SDPA forward, p = 0' if kind == 'fwd'
                        else library),
            **work, 'shape': list(shape),
            'layout': '(B, L, H, D) seen through transpose(1, 2)',
            'dtype': name16, 'tolerance': tol}
    rows['flash_attention_fwd'].update(
        lse_abs_err=max(errs[p]['lse'] for p in (0.0, P)), cases=cases)
    for name in ('flash_attention_fwd', 'flash_attention_dq',
                 'flash_attention_dkv'):
        emit_kernel(name, rows, tolerance=tol, phase=f'kernel_{tag}')
    # the tensor-core kernels against one library call each, p = 0
    speed('attention_speed', {
        'fwd_over_sdpa_fwd': ms[0.0]['fwd'] / sdpa_fwd,
        'dkv_over_sdpa_bwd': ms[0.0]['dkv'] / sdpa_bwd,
        'dq_over_sdpa_bwd': ms[0.0]['dq'] / sdpa_bwd})
    del q, k, v, do, o, dq, dk, dv

    # -- LayerNorm as the 16-bit step launches it, y/mean/rstd out, eps
    # 1e-12, on the embeddings (4096 rows) and the MLM head (608 rows) ----
    E = 1024
    w, b = (1.0 + 0.1 * randn(E).float()).to(dtype), 0.1 * randn(E)
    ln = {}
    for lead in ((TRAIN_BATCH, SEQ), (TRAIN_BATCH, SEQ * 15 // 100)):
        xs = randn(*lead, E)
        out, ops = no_copies('layer norm', lambda: fused_norm._forward(
            xs, w, b, 1e-12, True))
        wrapper_ops['layer_norm_fwd'] = ops
        with kernels.plain_versions():
            ref = fused_norm._forward(xs, w, b, 1e-12, True)
        torch.cuda.synchronize()
        err_y, err_st = rel_err(out[0], ref[0]), max(
            max_err(out[1], ref[1]), max_err(out[2], ref[2]))
        check(f'{tag} layer norm {(*lead, E)}: y over its max', err_y, tol)
        check(f'{tag} layer norm {(*lead, E)}: mean, rstd', err_st,
              STAT_TOL)
        n_ = lead[0] * lead[1]
        work = bf16_bound(8.0 * n_ * E, 2.0 * (2 * n_ * E + 2 * E)
                                + 8.0 * n_)
        with kernels.plain_versions():
            ln_plain = time_ms(lambda: fused_norm._forward(
                xs, w, b, 1e-12, True), flush)
        ln[str((*lead, E))] = {
            'max_abs_err': max_err(out[0], ref[0]), 'y_rel_err': err_y,
            'stats_abs_err': err_st,
            'ms': time_ms(lambda: fused_norm._forward(xs, w, b, 1e-12, True),
                          flush),
            'plain_ms': ln_plain,
            'library_ms': time_ms(lambda: torch.native_layer_norm(
                xs, (E,), w, b, 1e-12), flush),
            'copy_ms': copy_ms(work['bytes'], flush), **work}
    first = ln[str((TRAIN_BATCH, SEQ, E))]

    def ln_at(n_):
        xs = randn(n_, E)
        return lambda: fused_norm._forward(xs, w, b, 1e-12, True)
    rows['layer_norm_fwd'] = {
        **first, 'library': f'torch.native_layer_norm ({tag}, fp32 stats)',
        'shape': [TRAIN_BATCH * SEQ, E], 'dtype': name16,
        'outputs': 'y, mean, rstd', 'shapes': ln}
    if dtype == BF16:
        rows['layer_norm_fwd']['fixed_cost'] = fixed_cost(
            ln_at, lambda n_: 2.0 * (2 * n_ * E + 2 * E) + 8.0 * n_, flush)
    emit_kernel('layer_norm_fwd', rows, tolerance=tol, phase=f'kernel_{tag}')
    speed('layer_norm_speed', {
        'ln_over_native_ln': first['ms'] / first['library_ms']})

    # -- dropout + add + LayerNorm in the 16-bit step (4 outputs), and the
    # mask gradient ------------------------------------------------------
    N = TRAIN_BATCH * SEQ
    x, res, g = randn(N, E), randn(N, E), randn(N, E)
    add_errs = {}
    for n_, e_, p in ADD_LN_CASES:
        xs, rs_ = (randn(n_, e_) for _ in range(2))
        ws, bs = randn(e_), randn(e_)
        out, ops = no_copies('add + layer norm', lambda: fdn._forward(
            xs, rs_, ws, bs, p, 1e-5, SEED, 5, True))
        wrapper_ops['add_layer_norm_fwd'] = ops
        with kernels.plain_versions():
            ref = fdn._forward(xs, rs_, ws, bs, p, 1e-5, SEED, 5, True)
        torch.cuda.synchronize()
        e_rel = max(rel_err(out[0], ref[0]), rel_err(out[1], ref[1]))
        e_st = max(max_err(out[2], ref[2]), max_err(out[3], ref[3]))
        what = f'{tag} dropout + add + layer norm ({n_}, {e_}) p={p}'
        check(f'{what}: y, yin over their max', e_rel, tol)
        check(f'{what}: mean, rstd', e_st, STAT_TOL)
        add_errs[f'({n_}, {e_}) p={p}'] = {
            'max_abs_err': max(max_err(out[0], ref[0]),
                               max_err(out[1], ref[1])),
            'y_yin_rel_err': e_rel, 'stats_abs_err': e_st}
    add_ms = {p: time_ms(lambda p=p: fdn._forward(
        x, res, w, b, p, 1e-5, SEED, 5, True), flush) for p in (0.0, P)}
    with kernels.plain_versions():
        add_plain = time_ms(lambda: fdn._forward(
            x, res, w, b, P, 1e-5, SEED, 5, True), flush)
    work = bf16_bound(9.0 * N * E,
                            2.0 * (4 * N * E + 2 * E) + 8.0 * N)
    rows['add_layer_norm_fwd'] = {
        'max_abs_err': max(r['max_abs_err'] for r in add_errs.values()),
        'ms': add_ms[P], 'ms_p0': add_ms[0.0], 'plain_ms': add_plain,
        'library_ms': time_ms(lambda: torch.native_layer_norm(
            x + res, (E,), w, b, 1e-5), flush),
        'library': ADD_LN_LIBRARY, 'copy_ms': copy_ms(work['bytes'], flush),
        **work, 'shape': [N, E],
        'dtype': name16, 'outputs': 'y, yin, mean, rstd',
        'errors': add_errs}
    emit_kernel('add_layer_norm_fwd', rows, tolerance=tol,
                phase=f'kernel_{tag}')
    add_ln = rows['add_layer_norm_fwd']
    speed('add_layer_norm_speed', {
        'add_ln_over_add_native_ln': add_ln['ms_p0'] / add_ln['library_ms']})

    dx, wrapper_ops['dropout_grad'] = no_copies(
        'dropout mask gradient', lambda: fdn.dropout_grad(g, P, SEED, 5))
    with kernels.plain_versions():
        rdx = fdn.dropout_grad(g, P, SEED, 5)
    torch.cuda.synchronize()
    if not torch.equal(dx, rdx):      # one product, rounded once, both
        raise AssertionError(f"{tag} dropout mask gradient differs from "
                             f"its plain version")
    cases = dmask_bit_exact(fdn, g, randn, P, SEED)
    stored = philox.keep_scale(g.shape, P, SEED, 5, dev).to(dtype)
    with kernels.plain_versions():
        grad_plain = time_ms(lambda: fdn.dropout_grad(g, P, SEED, 5), flush)
    work = bf16_bound(1.0 * N * E, 2.0 * 2 * N * E)
    rows['dropout_grad'] = {
        'max_abs_err': max_err(dx, rdx), 'bit_exact': True,
        'ms': time_ms(lambda: fdn.dropout_grad(g, P, SEED, 5), flush),
        'plain_ms': grad_plain,
        'library_ms': time_ms(lambda: g * stored, flush),
        'library': f'multiply by a stored (N, D) {tag} mask',
        'copy_ms': copy_ms(work['bytes'], flush), **work, 'shape': [N, E],
        'dtype': name16, 'bit_exact_cases': cases}
    emit_kernel('dropout_grad', rows, tolerance=0.0, phase=f'kernel_{tag}')
    grad = rows['dropout_grad']
    speed('mask_gradient_speed', {
        'dmask_over_stored_mask': grad['ms'] / grad['library_ms']})
    emit({'phase': f'wrappers_{tag}', 'copies_or_casts': 0,
          'aten_ops': wrapper_ops})
    return rows


def phase_rms(seed, flush):
    """``nn.RMSNorm`` forward and backward (autograd) at fp32, bf16 and fp16,
    with and without a weight, at the BERT-large train step's rows by its
    hidden and intermediate widths and at an odd shape, against the plain
    version on the card; exactly one RMSNorm launch per forward; times at
    the two large shapes. -> (rows by dtype, this path's launch counts)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.kernels import fused_norm
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)
    totals = dict.fromkeys(kernels.KERNELS, 0)
    one = {**dict.fromkeys(kernels.KERNELS, 0), 'rms_norm_fwd': 1}
    checks, timings = [], {}
    rows = {}
    for dtype in (torch.float32, BF16, FP16):
        for n_, d_ in RMS_ROUTES:
            x0 = torch.randn(n_, d_, device=dev, generator=gen).to(dtype)
            gy = torch.randn(n_, d_, device=dev, generator=gen).to(dtype)
            for weighted in (True, False):
                mod = tnn.RMSNorm(d_, weight_attr=None if weighted else False,
                                  device=dev).to(dtype)
                if weighted:
                    with torch.no_grad():
                        mod.weight.copy_(1.0 + 0.1 * torch.randn(
                            d_, device=dev, generator=gen))
                x = x0.clone().requires_grad_()
                kernels.reset_launch_counts()      # the path: one forward
                y = mod(x)
                counts = kernels.launch_counts()   # ... read right after
                if counts != one:
                    raise AssertionError(f"nn.RMSNorm forward launched "
                                         f"{counts}, expected {one}")
                params = [x] + ([mod.weight] if weighted else [])
                grads = torch.autograd.grad(y, params, gy)
                if kernels.launch_counts() != one:
                    raise AssertionError("the RMSNorm backward launched a "
                                         "kernel (it is torch ops)")
                for k_, c in counts.items():
                    totals[k_] += c
                xr = x0.clone().requires_grad_()
                with kernels.plain_versions():
                    yr = mod(xr)
                    rgrads = torch.autograd.grad(
                        yr, [xr] + ([mod.weight] if weighted else []), gy)
                torch.cuda.synchronize()
                tol16 = BF16_TOL if dtype == BF16 else FP16_TOL
                if dtype == torch.float32:
                    e_y, tol_y = max_err(y, yr), TOL
                else:
                    e_y, tol_y = rel_err(y, yr), tol16
                e_g = max(rel_err(a, c) for a, c in zip(grads, rgrads))
                tol_g = GRAD_TOL if dtype == torch.float32 else tol16
                what = f'nn.RMSNorm {str(dtype)[6:]} ({n_}, {d_}) ' \
                       f'weight={weighted}'
                check(f'{what}: y', e_y, tol_y)
                check(f'{what}: gradients', e_g, tol_g)
                if not all(torch.isfinite(t).all() for t in (y, *grads)):
                    raise AssertionError(f'{what}: non-finite')
                checks.append({'dtype': str(dtype)[6:], 'shape': [n_, d_],
                               'weight': weighted, 'y_err': e_y,
                               'y_err_is': ('abs' if dtype == torch.float32
                                            else 'relative to max'),
                               'grad_rel_err': e_g,
                               'max_abs_err': max_err(y, yr),
                               'y_dtype': str(y.dtype)[6:],
                               'grad_dtype': str(grads[0].dtype)[6:]})
                if weighted and n_ == TRAIN_BATCH * SEQ:
                    xd, wd = x0, mod.weight.detach()
                    size = 4 if dtype == torch.float32 else 2
                    peak = (PEAK_FP32_FLOPS if dtype == torch.float32
                            else PEAK_BF16_FLOPS)
                    # x read and y written once, the weight, fp32 rstd
                    work = bound(4.0 * n_ * d_, size * (2 * n_ * d_ + d_)
                                       + 4.0 * n_, peak)
                    with kernels.plain_versions():
                        plain_ms = time_ms(lambda: fused_norm._rms_forward(
                            xd, wd, 1e-6, True), flush)
                    timings[f'{str(dtype)[6:]} ({n_}, {d_})'] = {
                        'max_abs_err': max_err(y, yr),
                        'ms': time_ms(lambda: fused_norm._rms_forward(
                            xd, wd, 1e-6, True), flush),
                        'plain_ms': plain_ms,
                        'library_ms': time_ms(
                            lambda: torch.nn.functional.rms_norm(
                                xd, (d_,), wd, 1e-6), flush),
                        'copy_ms': copy_ms(work['bytes'], flush), **work}
        key = f'{str(dtype)[6:]} ({TRAIN_BATCH * SEQ}, 1024)'
        rows[{torch.float32: 'fp32', BF16: 'bf16', FP16: 'fp16'}[dtype]] = {
            **timings[key],
            'max_abs_err': max(c['max_abs_err'] for c in checks
                               if c['dtype'] == str(dtype)[6:]),
            'library': 'torch.nn.functional.rms_norm', 'shape':
            [TRAIN_BATCH * SEQ, 1024], 'dtype': str(dtype)[6:],
            'outputs': 'y, rstd (the autograd path)'}
    bf16 = timings[f'bfloat16 ({TRAIN_BATCH * SEQ}, 1024)']
    wd = torch.randn(1024, device=dev, generator=gen).to(BF16)

    def rms_at(n_):
        xs = torch.randn(n_, 1024, device=dev, generator=gen).to(BF16)
        return lambda: fused_norm._rms_forward(xs, wd, 1e-6, True)
    # x read and y written once at bf16, the weight, fp32 rstd
    bf16['fixed_cost'] = fixed_cost(
        rms_at, lambda n_: 2.0 * (2 * n_ * 1024 + 1024) + 4.0 * n_, flush)
    emit({'phase': 'rms', 'module': 'paddle_tpu_torch.nn.RMSNorm',
          'tolerance': {'fp32': [TOL, GRAD_TOL], 'bf16': BF16_TOL,
                        'fp16': FP16_TOL},
          'checks': checks, 'timings': timings,
          'launches_per_forward': 1, 'launches': totals})
    check_speed('rms_norm_speed_bf16', {
        'rms_over_rms_norm': bf16['ms'] / bf16['library_ms']})
    return rows, totals


# the attention kernels one O1 fp16 BERT-large step launches, each an f16
# instantiation (phase_routes reads them)
AMP_ATTENTION = {'flash_fwd_mma_kernel<__half': 24,
                 'flash_dq_mma_kernel<__half': 24,
                 'flash_dkv_mma_kernel<__half': 24}


def phase_routes(seed, amp_step=None):
    """The kernel each LayerNorm and RMSNorm shape of ``LN_ROUTES`` and
    ``RMS_ROUTES`` takes on the card, at fp32 and bf16: one call a shape
    and dtype, on fresh (16-byte aligned) tensors, read by name from one
    torch.profiler session at the end of the run. A session may miss the
    kernels launched first in it, and short sessions opened earlier in a
    run made later ones (the serving profile's) miss kernels, so this is
    the run's last session: it holds the stream first, then makes every
    call twice, and the second round must show each call's kernel, in
    order. Raises on another kernel. With ``amp_step`` (one more O1 fp16
    train step), that step runs first in the same session, and its
    attention launches must be the f16 instantiations ``AMP_ATTENTION``
    names, and no other attention kernel. -> {call: kernel word}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.kernels import fused_norm
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 30)
    calls = []
    for dtype in (torch.float32, BF16):
        for kind, routes in (('layer norm', LN_ROUTES),
                             ('rms norm', RMS_ROUTES)):
            for (n_, d_), want in routes.items():
                x, w, b = (torch.randn(*shape, device=dev, generator=gen)
                           .to(dtype) for shape in ((n_, d_), (d_,), (d_,)))
                fn = ((lambda x=x, w=w, b=b: fused_norm._forward(
                          x, w, b, 1e-12, True)) if kind == 'layer norm'
                      else (lambda x=x, w=w: fused_norm._rms_forward(
                          x, w, 1e-6, True)))
                calls.append((f'{kind} {str(dtype)[6:]} ({n_}, {d_})', want,
                              fn))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(HOLD_CYCLES)
        torch.cuda.synchronize()
        if amp_step is not None:
            amp_step()
            torch.cuda.synchronize()
        for _ in range(2):
            for _, _, fn in calls:
                fn()
            torch.cuda.synchronize()
    names = [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start)
        if 'norm' in e.name or 'rows_warp' in e.name][-len(calls):]
    got = {}
    for (what, want, _), name in zip(calls, names):
        if want not in name:
            raise AssertionError(f"{what}: launched {name[:120]}, expected "
                                 f"{want}")
        got[what] = want
    if len(got) != len(calls):
        raise AssertionError(f"routes: the profiler saw {len(names)} of "
                             f"{len(calls)} norm calls")
    amp = None
    if amp_step is not None:
        attention = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and 'flash_' in e.name]
        amp = {w: sum(w in n for n in attention) for w in AMP_ATTENTION}
        if amp != AMP_ATTENTION or len(attention) != sum(amp.values()):
            raise AssertionError(f"routes: the O1 fp16 step launched "
                                 f"{amp} of {len(attention)} attention "
                                 f"kernels, expected {AMP_ATTENTION}")
    emit({'phase': 'routes', 'kernels': got, 'amp_fp16_attention': amp})
    return got


def bf16_recipe(net):
    """``bench.py::bench_bert``'s ``loss_of`` as a ``loss_fn`` for
    ``build_train_step``: every fp32 leaf cast to bf16 (``.to`` is
    differentiable, so gradients arrive in fp32 on the fp32 masters), the
    model through ``torch.func.functional_call``, the loss on fp32
    logits."""
    def loss_fn(params, batch):
        x, y = batch
        pc = {k: v.to(BF16) if v.dtype == torch.float32 else v
              for k, v in params.items()}
        logits, nsp = torch.func.functional_call(net, pc, (), x)
        loss = net.pretraining_loss(logits.float(), nsp.float(), *y)
        return loss, (logits, nsp)
    return loss_fn


def phase_train_parity_bf16(seed):
    """A full-width 2-layer BertForPretraining, batch 2 x 512, under the
    bf16 recipe: at p = 0 against the fp32 step on the same weights and
    batch, at p = 0.1 against the plain versions on the card with the same
    seeds; the same step twice from one (seed, offset) gives one loss."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    x, y = _pretraining_batch(np.random.RandomState(seed), 2, 30522)
    out = {'phase': 'train_parity_bf16', 'layers': 2, 'batch': [2, SEQ],
           'recipe': 'bf16 compute, fp32 master weights',
           'gates': {'loss_rel': BF16_LOSS_TOL, 'grad_max': BF16_GRAD_MAX,
                     'grad_mean': BF16_GRAD_MEAN}}
    for p in (0.0, 0.1):
        cfg = bert_large(hidden_dropout_prob=p,
                         attention_probs_dropout_prob=p)
        cfg.num_hidden_layers = 2
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 2)
        model = BertForPretraining(cfg, device=dev, generator=gen).train()
        kernels.reset_launch_counts()
        loss, grads = _loss_and_grads(model, x, y, dev, True)
        counts = kernels.launch_counts()
        if p == 0.0:
            ref_loss, ref_grads = _loss_and_grads(model, x, y, dev)
            other = 'the fp32 step (kernels) on the same weights'
        else:
            with kernels.plain_versions():
                ref_loss, ref_grads = _loss_and_grads(model, x, y, dev,
                                                      True)
            other = 'plain versions on the GPU, bf16 recipe'
            again, _ = _loss_and_grads(model, x, y, dev, True)
            if again != loss:
                raise AssertionError(
                    f"bf16 train parity: the same step from the same seed "
                    f"and offset gave losses {loss} and {again}")
            out['repeat_loss_identical'] = True
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        check(f'bf16 train parity p={p}: loss', loss_err, BF16_LOSS_TOL)
        worst, name, mean = _compare_grads(
            f'bf16 train parity p={p}', grads, ref_grads, BF16_GRAD_MAX,
            BF16_GRAD_MEAN)
        out[f'p={p}'] = {'against': other, 'loss': loss,
                         'reference_loss': ref_loss, 'loss_rel_err': loss_err,
                         'worst_grad_rel_err': worst, 'worst_grad': name,
                         'mean_grad_rel_err': mean, 'gradients': len(grads),
                         'launches': counts}
        del model
        torch.cuda.empty_cache()
    emit(out)


def phase_train_parity_fp16(seed):
    """A full-width 2-layer BertForPretraining, batch 2 x 512, under
    ``amp.auto_cast(level='O1', dtype='float16')`` on fp32 parameters (the
    backward of the loss times ``FP16_LOSS_SCALE``, unscaled): at p = 0
    against the fp32 step on the same weights and batch, at p = 0.1
    against the plain versions on the card, under the bf16 recipe's gates;
    then a ``microbatch=2`` call of ``build_train_step(scaler=,
    nan_guard=True)`` under O1 fp16 against two ``microbatch=1`` calls on
    a model of the same seed: every parameter, moment and counter bitwise
    equal."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.engine import build_train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    x, y = _pretraining_batch(np.random.RandomState(seed), 2, 30522)
    out = {'phase': 'train_parity_fp16', 'layers': 2, 'batch': [2, SEQ],
           'recipe': 'amp.auto_cast O1 float16, fp32 parameters',
           'loss_scale': FP16_LOSS_SCALE,
           'gates': {'loss_rel': BF16_LOSS_TOL, 'grad_max': BF16_GRAD_MAX,
                     'grad_mean': BF16_GRAD_MEAN}}

    def model_of(p):
        cfg = bert_large(hidden_dropout_prob=p,
                         attention_probs_dropout_prob=p)
        cfg.num_hidden_layers = 2
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 2)
        return BertForPretraining(cfg, device=dev, generator=gen).train()
    for p in (0.0, 0.1):
        model = model_of(p)
        kernels.reset_launch_counts()
        loss, grads = _loss_and_grads(model, x, y, dev, fp16=True)
        counts = kernels.launch_counts()
        if p == 0.0:
            ref_loss, ref_grads = _loss_and_grads(model, x, y, dev)
            other = 'the fp32 step (kernels) on the same weights'
        else:
            with kernels.plain_versions():
                ref_loss, ref_grads = _loss_and_grads(model, x, y, dev,
                                                      fp16=True)
            other = 'plain versions on the GPU, O1 fp16'
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        check(f'fp16 train parity p={p}: loss', loss_err, BF16_LOSS_TOL)
        worst, name, mean = _compare_grads(
            f'fp16 train parity p={p}', grads, ref_grads, BF16_GRAD_MAX,
            BF16_GRAD_MEAN)
        out[f'p={p}'] = {'against': other, 'loss': loss,
                         'reference_loss': ref_loss, 'loss_rel_err': loss_err,
                         'worst_grad_rel_err': worst, 'worst_grad': name,
                         'mean_grad_rel_err': mean, 'gradients': len(grads),
                         'launches': counts}
        del model
        torch.cuda.empty_cache()
    feeds = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    labels = tuple(torch.from_numpy(v).to(dev) for v in y)
    final = {}
    for k in (2, 1):
        model = model_of(0.1)
        train = build_train_step(
            net=model, loss=model.pretraining_loss,
            optimizer=AdamW(learning_rate=1e-4, weight_decay=0.01),
            scaler=GradScaler(), nan_guard=True, microbatch=k)
        run = _amp_step(train)
        state = train.init_state()
        if k == 2:
            state, res = run(state, (
                {n: torch.stack([v, v]) for n, v in feeds.items()},
                tuple(torch.stack([v, v]) for v in labels)))
            losses = res.losses
        else:
            losses = []
            for _ in range(2):
                state, res = run(state, (feeds, labels))
                losses.append(res.losses)
            losses = torch.stack(losses)
        torch.cuda.synchronize()
        final[k] = ([t.clone() for t in _state_tensors(state)], losses,
                    train.sync(state))
        del model, train, state
    (t2, l2, s2), (t1, l1, s1) = final[2], final[1]
    if not (len(t2) == len(t1) and s2 == s1 and torch.equal(l2, l1)
            and all(torch.equal(a_, b_) for a_, b_ in zip(t2, t1))):
        raise AssertionError("fp16 amp: a microbatch=2 call differs from "
                             "two microbatch=1 calls")
    out['microbatch_2_equals_two_steps'] = {
        'bitwise': True, 'state_tensors': len(t2),
        'losses': [float(v) for v in l2], 'sync': s2}
    emit(out)
    torch.cuda.empty_cache()


def phase_train_parity_flat(seed):
    """A full-width 2-layer BertForPretraining, batch 2 x 512, p = 0.1:
    three steps of the flat bf16 path (``FlatFusedUpdate`` with
    ``compute_dtype=bf16``, ``flat_recipe``) and of the per-parameter bf16
    recipe on the same weights and batch; every parameter and moment
    within 1e-6 of its largest value (bitwise, where it is, is printed)."""
    from paddle_tpu_torch.engine import build_train_step
    from paddle_tpu_torch.optimizer import AdamW, FlatFusedUpdate
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    x, y = _pretraining_batch(np.random.RandomState(seed), 2, 30522)
    batch = ({k: torch.from_numpy(v).to(dev) for k, v in x.items()},
             tuple(torch.from_numpy(v).to(dev) for v in y))
    got = {}
    for flat in (False, True):
        cfg = bert_large()
        cfg.num_hidden_layers = 2
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 2)
        model = BertForPretraining(cfg, device=dev, generator=gen).train()
        params = dict(model.named_parameters())
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
        if flat:
            fl = FlatFusedUpdate(opt, params, compute_dtype=BF16)
            step = build_train_step(flat_recipe(model), fl, params=params)
        else:
            step = build_train_step(bf16_recipe(model), opt, params=params)
        state = step.init_state()
        losses = []
        for _ in range(3):
            state, res = step(state, batch)
            losses.append(float(res.loss))
        if flat:
            m1, m2 = (fl.unflatten(state['opt'][s_])
                      for s_ in ('moment1', 'moment2'))
            slots = {n: (m1[n], m2[n]) for n in params}
        else:
            slots = {n: (st['moment1'], st['moment2'])
                     for n, st in state['opt'].items()}
        got[flat] = ({n: p.detach().clone() for n, p in params.items()},
                     {n: tuple(t.clone() for t in v)
                      for n, v in slots.items()}, losses)
        del model, step, state
    (p0, m0, l0), (p1, m1_, l1) = got[False], got[True]
    worst, bitwise = 0.0, True
    for n in p0:
        for a_, b_ in ((p1[n], p0[n]), *zip(m1_[n], m0[n])):
            bitwise &= bool(torch.equal(a_, b_))
            worst = max(worst, rel_err(a_, b_))
    check('flat bf16 parity: parameters and moments', worst, 1e-6)
    emit({'phase': 'train_parity_bf16_flat', 'layers': 2, 'batch': [2, SEQ],
          'steps': 3, 'p': 0.1, 'tolerance': 1e-6, 'worst_rel_err': worst,
          'bitwise': bitwise, 'losses_flat': l1, 'losses_per_parameter': l0,
          'tensors': len(p0)})
    torch.cuda.empty_cache()


def copy_accounting(mode, run):
    """One more step (``run``) under the op log: every copy or cast,
    grouped by (from, to, the line that asked for it). None may come from
    a kernel wrapper."""
    with OpLog() as log:
        run()
        torch.cuda.synchronize()
    groups = {}
    for src, dst, _, site in log.copies:
        key = f'{src}->{dst} {site}'
        groups[key] = groups.get(key, 0) + 1
    bad = [k for k in groups if '/kernels/' in k
           and k.rsplit(' ', 1)[-1] in WRAPPERS]
    if bad:
        raise AssertionError(f"{mode} step: a kernel wrapper copied or "
                             f"cast: {bad}")
    emit({'phase': f'copies_{mode}_step', 'ops': len(log.ops),
          'copies_or_casts': len(log.copies), 'from_kernel_wrappers': 0,
          'by_site': dict(sorted(groups.items(), key=lambda kv: -kv[1]))})


# ---------------------------------------------------------------------------
# the training loop users run: engine.fit with Lamb, a schedule, the
# global-norm clip, O1 fp16, the scaler, the guard and microbatches
# ---------------------------------------------------------------------------

# Lamb's peak learning rate on the repeated batch (LinearWarmup from half
# of it over the first call's 10 dispatches, then PolynomialDecay): chosen
# so that the loss falls within the 20 steps (PERF.md, section 4)
FIT_PEAK_LR = 2e-3
FIT_DISPATCHES = 10          # a fit call: 10 dispatches of 2 microbatches
FIT_LOG_EVERY = 5


def _no_decay(name):
    """Lamb's exclusion: the LayerNorm parameters and the biases."""
    return 'norm' in name or name.endswith('bias')


def fit_schedule(peak):
    from paddle_tpu_torch.optimizer import lr
    return lr.LinearWarmup(lr.PolynomialDecay(peak, 2 * FIT_DISPATCHES,
                                              end_lr=peak / 10),
                           FIT_DISPATCHES, peak / 2, peak)


def fit_optimizer(peak=FIT_PEAK_LR, epsilon=1e-6):
    """BERT pretraining's optimizer setup: Lamb(weight decay 0.01, none on
    LayerNorm and biases) under a warm-up and decay schedule, the gradient
    clipped to a global norm of 1.0."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Lamb
    sched = fit_schedule(peak)
    return Lamb(learning_rate=sched, lamb_weight_decay=0.01, epsilon=epsilon,
                exclude_from_weight_decay_fn=_no_decay,
                grad_clip=ClipGradByGlobalNorm(1.0)), sched


def _count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode('warn')`` -> (its
    result, the number of host syncs it made)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = [w for w in caught if 'synchroniz' in str(w.message)]
    return out, len(syncs), sorted({str(w.message)[:120] for w in syncs})


def phase_train_fit(seed, card):
    """BERT-large pretraining through ``engine.fit``: fp32 parameters under
    ``auto_cast(level='O1', dtype='float16')``, ``GradScaler``,
    ``nan_guard=True``, ``microbatch=2``, ``log_every=5``, Lamb with the
    global-norm clip under ``fit_schedule``; two calls of 10 dispatches
    on the repeated batch, the scheduler stepped 10 times between them.
    Exact launch counts (20 steps a call, ``TRAIN_LAUNCHES`` each), no
    more host syncs than the loss fetches and reconciles, finite losses,
    the last logged below the first. Then one profiled step (the same
    optimizer and clip, microbatch 1), Lamb's update and the clip
    profiled alone, and ``amp_overflow`` on the Lamb + clip step.
    -> (the fit calls' launch counts, a row of numbers)."""
    from paddle_tpu_torch import amp, engine, kernels
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.resilience import NanGuard
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    cfg = bert_large()
    # what earlier phases still hold (the O1 cell's step, for phase_routes)
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = BertForPretraining(cfg, device=dev, generator=gen).train()
    opt, sched = fit_optimizer()
    scaler, guard = GradScaler(), NanGuard()
    x, y = _pretraining_batch(np.random.RandomState(seed), TRAIN_BATCH,
                              cfg.vocab_size)
    k = 2
    data = [(x, y)] * (k * FIT_DISPATCHES)   # host numpy, as a loader gives
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reports, totals, syncs, budgets, lrs, wall = [], dict.fromkeys(
        TRAIN_LAUNCHES, 0), [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for call in range(2):
        lrs.append(opt.get_lr())

        def run():
            with amp.auto_cast(level='O1', dtype='float16'):
                return engine.fit(model, model.pretraining_loss, opt,
                                  data, microbatch=k,
                                  log_every=FIT_LOG_EVERY,
                                  nan_guard=guard, scaler=scaler,
                                  prefetch=2)
        kernels.reset_launch_counts()       # the main path: one call
        t1 = time.perf_counter()
        report, n_sync, where = _count_syncs(run)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t1)
        counts = kernels.launch_counts()    # ... read right after it
        want = {n: k * FIT_DISPATCHES * c
                for n, c in TRAIN_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"train_fit call {call}: launches "
                                 f"{counts}, expected {want}")
        for n, c in counts.items():
            totals[n] += c
        # the loss fetches, the reconciles at the cadence, the last one
        sync_every = min(FIT_LOG_EVERY,
                         -(-guard.max_consecutive_skips // k))
        budget = len(report['loss']) + \
            report['dispatches'] // sync_every + 1
        if n_sync > budget:
            raise AssertionError(
                f"train_fit call {call}: {n_sync} host syncs, the fit "
                f"cadence allows {budget}: {where}")
        syncs.append(n_sync)
        budgets.append(budget)
        reports.append(report)
        for _ in range(FIT_DISPATCHES):     # fit never steps a schedule
            sched.step()
    peak = torch.cuda.max_memory_allocated()
    losses = [v for r in reports for v in r['loss']]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_fit: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_fit: the loss did not fall: {losses}")
    if guard.total_steps != 2 * k * FIT_DISPATCHES:
        raise AssertionError(f"train_fit: the guard counted "
                             f"{guard.total_steps} steps")
    # the loop's rate: each call's steps over its wall time, prefetch, loss
    # fetches and reconciles included (the first call warms up)
    ms = [1e3 * w / r['steps'] for w, r in zip(wall, reports)]
    row = {'phase': 'train_fit', 'model': 'bert_large pretraining',
           'entry': 'engine.fit', 'layers': cfg.num_hidden_layers,
           'hidden': cfg.hidden_size, 'batch': [TRAIN_BATCH, SEQ],
           'dtype': 'amp.auto_cast O1 float16 on fp32 parameters',
           'dropout': cfg.hidden_dropout_prob,
           'optimizer': ('Lamb(lamb_weight_decay=0.01, no decay on '
                         'LayerNorm and biases), ClipGradByGlobalNorm(1.0)'),
           'schedule': (f'LinearWarmup(PolynomialDecay({FIT_PEAK_LR}, '
                        f'{2 * FIT_DISPATCHES}, end_lr={FIT_PEAK_LR / 10}), '
                        f'{FIT_DISPATCHES}, {FIT_PEAK_LR / 2}, '
                        f'{FIT_PEAK_LR}), stepped {FIT_DISPATCHES} times '
                        f'between the calls'),
           'lr_per_call': lrs, 'microbatch': k, 'log_every': FIT_LOG_EVERY,
           'card': card, 'setup_s': setup_s,
           'reports': [{key: v for key, v in r.items() if key != 'state'}
                       for r in reports],
           'losses_logged': losses,
           'step_ms': {'median': float(np.median(ms)), 'min': min(ms),
                       'max': max(ms), 'per_call': ms},
           'samples_per_s': [TRAIN_BATCH * r['steps'] / w
                             for w, r in zip(wall, reports)],
           'fit_call_wall_s': wall,
           'max_memory_allocated_bytes': peak,
           'held_before_bytes': held,
           'host_syncs_per_call': syncs, 'host_sync_budget': budgets,
           'launches_per_step': TRAIN_LAUNCHES, 'launches': totals,
           'guard': {'steps': guard.total_steps,
                     'skipped': guard.skipped_steps},
           'scale': scaler.get_loss_scaling()}
    emit(row)
    state = reports[-1]['state']
    del reports
    # one step of the same setup, microbatch 1, profiled; then Lamb's
    # update and the clip alone on its state
    step = engine.build_train_step(net=model, loss=model.pretraining_loss,
                                   optimizer=opt, scaler=scaler,
                                   nan_guard=True)
    state = step.init_state(opt_state=state['opt'], nan_guard=guard,
                            scaler=scaler)
    batch = ({n: torch.from_numpy(v).to(dev) for n, v in x.items()},
             tuple(torch.from_numpy(v).to(dev) for v in y))
    quiet = _amp_step(step, debug=False)
    quiet(state, batch)
    torch.cuda.synchronize()
    phase_profile('train step fit (Lamb, clip, O1 fp16)',
                  lambda: quiet(state, batch), TRAIN_ROUTES, top_n=20,
                  batch=[TRAIN_BATCH, SEQ])
    update, clip = update_profiles(step, state)
    for key, prof in (('lamb_update', update), ('clip', clip)):
        row[key] = {'device_busy_ms': prof['device_busy_ms'],
                    'device_events': prof['device_events']}
    emit({'phase': 'train_fit_update', 'lamb_update_alone': row[
        'lamb_update'], 'global_norm_clip_alone': row['clip'],
        'parameters': len(state['params'])})
    amp_overflow(step, state, lambda: _amp_step(step)(state, batch), scaler,
                 guard, of='Lamb + ClipGradByGlobalNorm(1.0)')
    del step, state, model, opt
    torch.cuda.empty_cache()
    return totals, row


def update_profiles(step, state):
    """Device time and events of Lamb's update alone (zero gradients, the
    skip select of a scaler step) and of the global-norm clip alone, on a
    step's state -> the two profile rows' numbers."""
    opt = step.optimizer
    params = state['params']
    grads = {n: torch.zeros_like(p) for n, p in params.items()
             if p.requires_grad}
    ok = torch.ones((), dtype=torch.bool, device=next(iter(
        params.values())).device)
    clip, opt._grad_clip = opt._grad_clip, None
    metas = step._params_meta
    try:
        def lamb():
            opt.functional_update(params, grads, state['opt'], ok=ok,
                                  params_meta=metas)
        lamb()
        torch.cuda.synchronize()
        a = phase_profile(f'{type(opt).__name__} update alone (fit)', lamb,
                          {})
    finally:
        opt._grad_clip = clip
    pairs = [(metas[n], g) for n, g in grads.items()]

    def clipped():
        clip(pairs)
    clipped()
    torch.cuda.synchronize()
    b = phase_profile(f'{type(clip).__name__} alone (fit)', clipped, {})
    return a, b


def _fit_parity_model(seed, dev, p=0.0):
    """A full-width, 2-layer BertForPretraining of the parity phases, with
    one parameter at half the learning rate and one under L1Decay
    (``ParamAttr``)."""
    from paddle_tpu_torch.nn.initializer import ParamAttr, apply_param_attr
    from paddle_tpu_torch.nn.regularizer import L1Decay
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    cfg = bert_large(hidden_dropout_prob=p, attention_probs_dropout_prob=p)
    cfg.num_hidden_layers = 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    model = BertForPretraining(cfg, device=dev, generator=gen).train()
    named = dict(model.named_parameters())
    apply_param_attr(named['bert.encoder.layers.0.linear1.weight'],
                     ParamAttr(learning_rate=0.5))
    apply_param_attr(named['bert.encoder.layers.1.linear2.weight'],
                     ParamAttr(regularizer=L1Decay(1e-4)))
    return model


# per layer and per step of a 2-layer model: without remat, with 'full'
# (each layer's forward kernels again in the backward) and 'dots' (the
# attention outputs kept)
PARITY_LAUNCHES = {'flash_attention_fwd': 2, 'flash_attention_dq': 2,
                   'flash_attention_dkv': 2, 'add_layer_norm_fwd': 4,
                   'dropout_grad': 4, 'layer_norm_fwd': 2, 'rms_norm_fwd': 0}
REMAT_EXTRA = {'full': {'flash_attention_fwd': 2, 'add_layer_norm_fwd': 4},
               'dots': {'add_layer_norm_fwd': 4}}


def phase_train_parity_fit(seed):
    """Three checks at full width, 2 layers, batch 2 x 512:
    1. ``engine.fit`` (fp32, p = 0; Lamb with the global-norm clip,
       ``epsilon=1e-4``; one ``ParamAttr(learning_rate=0.5)`` parameter,
       one ``L1Decay``; ``StepDecay`` stepped between two calls of two
       dispatches) with the kernels, against the same under
       ``kernels.plain_versions()`` and on the CPU: every parameter within
       ``GRAD_TOL`` of its tensor's largest value (the key biases, whose
       true gradient is zero, of the model's largest entry);
    2. ``remat='full'`` and ``'dots'`` at p = 0.1 under O1 fp16 with the
       scaler: the parameters after 3 steps against those without remat,
       within 1e-6 of each tensor's largest value (bitwise is printed),
       and the launches of a remat step;
    3. the pre-norm encoder layer (``normalize_before=True``) at BERT-large
       width, p = 0.1, forward and backward against its plain versions."""
    from paddle_tpu_torch import amp, engine, kernels
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nn.initializer import copy_param_attrs
    from paddle_tpu_torch.optimizer import AdamW, Lamb, lr
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    dev = torch.device('cuda', 0)
    x, y = _pretraining_batch(np.random.RandomState(seed), 2, 30522)
    out = {'phase': 'train_parity_fit', 'layers': 2, 'batch': [2, SEQ]}

    # 1. fit, kernels / plain versions / CPU
    got = {}
    base = _fit_parity_model(seed, dev)
    for where in ('kernels', 'plain', 'cpu'):
        model = copy_param_attrs(base, copy.deepcopy(base))
        device = dev
        if where == 'cpu':
            model, device = model.to('cpu'), torch.device('cpu')
        sched = lr.StepDecay(1e-3, step_size=1, gamma=0.5)
        opt = Lamb(learning_rate=sched, lamb_weight_decay=0.01,
                   epsilon=1e-4, grad_clip=ClipGradByGlobalNorm(1.0))
        kernels.reset_launch_counts()
        with (kernels.plain_versions() if where == 'plain'
              else contextlib.nullcontext()):
            losses = []
            for _ in range(2):
                rep = engine.fit(model, model.pretraining_loss, opt,
                                 [(x, y)] * 2, log_every=1, device=device)
                losses += rep['loss']
                sched.step()
        counts = kernels.launch_counts()
        # 4 steps at p = 0: no mask gradient
        want = {n: 4 * c if n != 'dropout_grad' else 0
                for n, c in PARITY_LAUNCHES.items()} \
            if where == 'kernels' else dict.fromkeys(PARITY_LAUNCHES, 0)
        if counts != want:
            raise AssertionError(f"train_parity_fit {where}: launches "
                                 f"{counts}, expected {want}")
        got[where] = ({n: p.detach().float().cpu()
                       for n, p in model.named_parameters()}, losses)
        del model, opt
    del base
    ref = got['kernels'][0]
    # the attention key biases have no true gradient (softmax ignores a
    # shift of a row's scores): Lamb steps them on rounding noise, so they
    # are held to the model's largest entry, the rest to their own
    top = max(float(t.abs().max()) for t in ref.values())
    for other in ('plain', 'cpu'):
        worst, name = max((max_err(got[other][0][n], ref[n]) / (
            top if n.endswith('self_attn.k_proj.bias')
            else float(ref[n].abs().max())), n) for n in ref)
        check(f'train_parity_fit: fit, kernels against {other} ({name})',
              worst, GRAD_TOL)
        out[f'fit_vs_{other}'] = {'worst_rel_err': worst, 'worst': name,
                                  'losses': got[other][1]}
    out['fit_kernels_losses'] = got['kernels'][1]
    del got, ref
    torch.cuda.empty_cache()

    # 2. remat at p = 0.1 under O1 fp16
    feeds = ({n: torch.from_numpy(v).to(dev) for n, v in x.items()},
             tuple(torch.from_numpy(v).to(dev) for v in y))
    runs = {}
    for remat in (None, 'full', 'dots'):
        model = _fit_parity_model(seed, dev, p=0.1)
        step = engine.build_train_step(
            net=model, loss=model.pretraining_loss,
            optimizer=AdamW(learning_rate=1e-4, weight_decay=0.01),
            scaler=GradScaler(), remat=remat)
        state = step.init_state()
        run = _amp_step(step)
        per_step = []
        for _ in range(3):
            kernels.reset_launch_counts()
            state, res = run(state, feeds)
            torch.cuda.synchronize()
            per_step.append(kernels.launch_counts())
        want = dict(PARITY_LAUNCHES)
        for n, c in REMAT_EXTRA.get(remat, {}).items():
            want[n] += c
        if any(c != want for c in per_step):
            raise AssertionError(f"train_parity_fit remat={remat}: launches "
                                 f"{per_step}, expected {want}")
        runs[remat] = ([t.detach().clone() for t in _state_tensors(state)],
                       float(res.loss), want)
        del model, step, state
    for remat in ('full', 'dots'):
        worst = max(rel_err(a_, b_) for a_, b_ in
                    zip(runs[remat][0], runs[None][0]))
        check(f'train_parity_fit: remat={remat} against no remat', worst,
              1e-6)
        out[f'remat_{remat}'] = {
            'worst_rel_err': worst,
            'bitwise': all(torch.equal(a_, b_) for a_, b_ in
                           zip(runs[remat][0], runs[None][0])),
            'loss': runs[remat][1], 'launches_per_step': runs[remat][2]}
    out['remat_none'] = {'loss': runs[None][1],
                         'launches_per_step': runs[None][2]}
    del runs
    torch.cuda.empty_cache()

    # 3. the pre-norm layer at full width against its plain versions
    from paddle_tpu_torch.kernels.philox import DropoutState
    from paddle_tpu_torch.nn import TransformerEncoderLayer
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    state = DropoutState(seed + 11)
    layer = TransformerEncoderLayer(1024, 16, 4096, dropout=0.1,
                                    activation='gelu', act_dropout=0.0,
                                    normalize_before=True, device=dev,
                                    generator=gen, dropout_state=state)
    src = torch.randn(2, SEQ, 1024, device=dev, generator=gen)
    dout = torch.randn(2, SEQ, 1024, device=dev, generator=gen)
    res = {}
    for where in ('kernels', 'plain'):
        state.offset = 0
        xs = src.clone().requires_grad_()
        kernels.reset_launch_counts()
        with (kernels.plain_versions() if where == 'plain'
              else contextlib.nullcontext()):
            o = layer(xs)
            grads = torch.autograd.grad(o, [xs, *layer.parameters()], dout)
        res[where] = (o.detach(), grads, kernels.launch_counts())
    want = {'flash_attention_fwd': 1, 'flash_attention_dq': 1,
            'flash_attention_dkv': 1, 'layer_norm_fwd': 2}
    got_counts = {n: c for n, c in res['kernels'][2].items() if c}
    if got_counts != want or any(res['plain'][2].values()):
        raise AssertionError(f"pre-norm layer: launches {res['kernels'][2]}"
                             f", plain {res['plain'][2]}, expected {want}")
    out_err = rel_err(res['kernels'][0], res['plain'][0])
    check('pre-norm layer: output', out_err, TOL)
    names = ['input'] + [n for n, _ in layer.named_parameters()]
    grad_err, grad_name, _ = _compare_grads(
        'pre-norm layer', dict(zip(names, res['kernels'][1])),
        dict(zip(names, res['plain'][1])))
    out['pre_norm_layer'] = {'shape': [2, SEQ, 1024], 'p': 0.1,
                             'output_rel_err': out_err,
                             'worst_grad_rel_err': grad_err,
                             'worst_grad': grad_name,
                             'launches': got_counts}
    emit(out)
    torch.cuda.empty_cache()


def phase_remat_memory(seed, card):
    """Peak device memory of 3 full-width O1 fp16 steps (BERT-large, batch
    8 x 512, p = 0.1) with ``remat='full'`` against the same steps without
    remat, both printed, the remat one lower. The optimizer is SGD, which
    keeps no state and updates in place, so that each step's peak is its
    forward and backward's, the part remat changes; a remat step launches
    each encoder layer's forward kernels once more."""
    from paddle_tpu_torch import engine, kernels
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    x, y = _pretraining_batch(np.random.RandomState(seed), TRAIN_BATCH,
                              30522)
    batch = ({n: torch.from_numpy(v).to(dev) for n, v in x.items()},
             tuple(torch.from_numpy(v).to(dev) for v in y))
    row = {'phase': 'remat_memory', 'model': 'bert_large pretraining',
           'batch': [TRAIN_BATCH, SEQ], 'steps': 3,
           'dtype': 'amp.auto_cast O1 float16 on fp32 parameters',
           'optimizer': 'SGD(1e-4)', 'card': card}
    for remat in (None, 'full'):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 3)
        model = BertForPretraining(bert_large(), device=dev,
                                   generator=gen).train()
        step = engine.build_train_step(net=model,
                                       loss=model.pretraining_loss,
                                       optimizer=SGD(learning_rate=1e-4),
                                       remat=remat)
        run = _amp_step(step)
        state = step.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = dict(TRAIN_LAUNCHES)
        if remat:
            want['flash_attention_fwd'] += 24
            want['add_layer_norm_fwd'] += 48
        losses, ms = [], []
        for _ in range(3):
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            state, res = run(state, batch)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
            if kernels.launch_counts() != want:
                raise AssertionError(f"remat_memory remat={remat}: launches "
                                     f"{kernels.launch_counts()}, expected "
                                     f"{want}")
            losses.append(float(res.loss))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"remat_memory: losses {losses}")
        row[f'remat={remat}'] = {
            'max_memory_allocated_bytes': torch.cuda.max_memory_allocated(),
            'allocated_before_bytes': base, 'losses': losses, 'step_ms': ms,
            'launches_per_step': want}
        del model, step, state, run
        torch.cuda.empty_cache()
    peak_none = row['remat=None']['max_memory_allocated_bytes']
    peak_full = row['remat=full']['max_memory_allocated_bytes']
    row['peak_ratio'] = peak_full / peak_none
    emit(row)
    if not peak_full < peak_none:
        raise AssertionError(f"remat_memory: peak {peak_full} with remat, "
                             f"{peak_none} without")



# ---------------------------------------------------------------------------
# checkpoint, resume and preemption in engine.fit (BERT-large, O1 fp16,
# the scaler, the guard, microbatches, Lamb with the clip under a schedule)
# ---------------------------------------------------------------------------

RESUME_N = 3          # dispatches before the stop, and as many after it
RESUME_K = 2          # microbatches a dispatch
# a full-width resumed loss against the uninterrupted run's: within twice
# the spread of two uninterrupted runs (the full-width step is not bitwise
# repeatable, PERF.md section 7), and never tighter than this relative
RESUME_LOSS_REL = 1e-4
# the training thread's stall for an async save, over a sync save's time
ASYNC_STALL_MAX = 0.10


class _SignalAt:
    """``batches`` every epoch; ``hook()`` runs when batch ``index`` of
    epoch ``epoch`` is read (by the prefetcher, on the main thread)."""

    def __init__(self, batches, epoch, index, hook):
        self.batches, self.at, self.hook = batches, (epoch, index), hook
        self.epoch = -1

    def __iter__(self):
        self.epoch += 1
        for i, b in enumerate(self.batches):
            if (self.epoch, i) == self.at:
                self.hook()
            yield b


def _resume_run(seed, layers, data, epochs, sched_state=None, **kw):
    """One O1 fp16 ``engine.fit`` of a fresh BERT-large (``layers`` deep)
    from ``seed``, with a fresh ``fit_optimizer`` (its scheduler set to
    ``sched_state`` when given), ``GradScaler`` and ``NanGuard`` ->
    (model, scheduler, report)."""
    from paddle_tpu_torch import amp, engine
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.resilience import NanGuard
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    cfg = bert_large()
    cfg.num_hidden_layers = layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = BertForPretraining(cfg, device=dev, generator=gen).train()
    opt, sched = fit_optimizer()
    if sched_state is not None:      # the caller's, as in the reference
        sched.set_state_dict(sched_state)
    with amp.auto_cast(level='O1', dtype='float16'):
        rep = engine.fit(model, model.pretraining_loss, opt, data,
                         epochs=epochs, microbatch=RESUME_K, log_every=1,
                         nan_guard=NanGuard(), scaler=GradScaler(),
                         prefetch=2, **kw)
    return model, sched, rep


def _state_mismatches(a, b, where=''):
    """Paths where two states (nested dicts of numpy arrays or tensors: a
    checkpoint's host state, a live one) differ in dtype, shape or any
    bit."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or \
                set(a) != set(b):
            return [where or '.']
        return [m for k in a for m in _state_mismatches(a[k], b[k],
                                                        f'{where}.{k}')]
    a, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in (a, b))
    same = a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()
    return [] if same else [where]


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
    block (the index backward of BERT's masked positions and embeddings
    sums with atomics otherwise, so that two runs of the same step differ
    in their last bits) -> a list that gets the warnings of the ops that
    have no deterministic version; the previous setting comes back."""
    import warnings
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield seen
        finally:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
            seen.extend(sorted({str(w.message)[:200] for w in caught
                                if 'determinis' in str(w.message)}))


def _resume_two_layers(seed, data, root):
    """The 2-layer (BERT-large widths) checks: an uninterrupted run of 2N
    dispatches, and three runs stopped at N and resumed from another
    seed's model: a sync save, an async save, and a SIGTERM caught while
    an async save is in flight. Each resumed run
    equals the uninterrupted one bitwise (every logged loss, every
    parameter); the async checkpoint at N equals the sync one bitwise."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.resilience import CheckpointManager
    model, _, rep = _resume_run(seed, 2, data, 2)
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    want_loss = rep['loss']
    del model, rep
    out = {}
    for how in ('sync', 'async', 'preempted'):
        mgr = CheckpointManager(os.path.join(root, f'two_{how}'),
                                max_keep=2)
        seen = {}
        src, kw = data, {}
        if how == 'preempted':
            def hook():
                if signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                        None):
                    raise AssertionError("train_resume: fit installed no "
                                         "SIGTERM handler")
                seen['save_in_flight'] = mgr.in_flight()
                signal.raise_signal(signal.SIGTERM)
            # read when the second epoch starts: its first groups are
            # prefetched while the save of dispatch N is committing
            src, kw = _SignalAt(data, 1, RESUME_K, hook), \
                dict(checkpoint_every=1)
        model, sched, rep = _resume_run(
            seed, 2, src, 1 if how != 'preempted' else 2, checkpoint=mgr,
            async_save=how != 'sync', **kw)
        stop = rep['dispatches']
        if how == 'preempted' and not (rep['preempted'] and
                                       seen.get('save_in_flight')):
            raise AssertionError(f"train_resume 2 layers: preempted "
                                 f"{rep['preempted']}, a save in flight "
                                 f"{seen}")
        sched_state = sched.state_dict()
        del model, rep
        kernels.reset_launch_counts()
        model, _, rep = _resume_run(seed + 1, 2, data, 2,
                                    sched_state=sched_state,
                                    resume_from=mgr)
        counts = kernels.launch_counts()
        n_after = 2 * RESUME_N - stop
        launches = {n: n_after * RESUME_K * c
                    for n, c in PARITY_LAUNCHES.items()}
        bad = [n for n, p in model.named_parameters()
               if not torch.equal(p, want[n])]
        if rep['resumed_from'] != stop or counts != launches or bad or \
                rep['loss'] != want_loss[stop:]:
            raise AssertionError(
                f"train_resume 2 layers {how}: resumed from "
                f"{rep['resumed_from']} (stopped at {stop}); launches "
                f"{counts}, expected {launches}; parameters not bitwise "
                f"{bad[:4]}; losses {rep['loss']} against {want_loss}")
        out[how] = {'stopped_at': stop, 'resumed_losses': rep['loss'],
                    'bitwise': True, **seen}
        del model, rep
    got = {how: CheckpointManager(os.path.join(root, f'two_{how}')).restore(
        step=RESUME_N, return_extra=True) for how in ('sync', 'async')}
    bad = _state_mismatches(got['sync'][0], got['async'][0])
    if bad or got['sync'][2]['rng']['dropout'] != \
            got['async'][2]['rng']['dropout']:
        raise AssertionError(f"train_resume: the async checkpoint at "
                             f"{RESUME_N} differs from the sync one: "
                             f"{bad[:4]}")
    out['async_checkpoint_equals_sync'] = True
    torch.cuda.empty_cache()
    return out


def phase_train_resume(seed, card):
    """``engine.fit``'s checkpoint, resume and preemption on BERT-large in
    ``phase_train_fit``'s configuration (p = 0.1, O1 fp16, ``GradScaler``,
    ``nan_guard``, ``microbatch=2``, Lamb with the global-norm clip under
    ``fit_schedule``, restored by the caller through its ``state_dict``),
    on ``RESUME_N`` x 2 distinct batches a epoch, checkpoints in a
    temporary directory (at most 2 kept), removed at the end:

    Parts 1 and 2 run under ``deterministic()``: without it two runs of
    the same 2-layer fit differ in their last bits (two such runs are
    printed), so no resume could equal one bitwise.

    1. at 2 layers (BERT-large widths): ``_resume_two_layers`` (sync,
       async, preempted; bitwise);
    2. at full width: two uninterrupted runs of 2N dispatches (their loss
       spread), a run of N with an async checkpoint, then a model from
       another seed resumed from it for the last N. Every leaf of the
       checkpoint equals the stopped run's live state, and the state
       ``TrainStep.adopt_state`` restores equals the checkpoint, bit for
       bit (parameters, Lamb's slots, the scaler's scale and counters, the
       guard's counters), and so do the ``DropoutState`` offsets after
       ``restore_rng``; the resumed fit launches exactly N x 2 x
       ``TRAIN_LAUNCHES``; each of its losses within max(2 x the spread,
       ``RESUME_LOSS_REL`` relative) of the first uninterrupted run's;
    3. ``CheckpointManager.save`` on the stopped run's fit state: the
       checkpoint's bytes, a sync save's ms, an async save's stall on the
       training thread (at most ``ASYNC_STALL_MAX`` of the sync save's)
       and its commit ms, the device memory its snapshot adds, step ms
       with the commit in flight against without, restore ms.
    -> the resumed full-width fit's launch counts."""
    rs = np.random.RandomState(seed + 5)
    data = [_pretraining_batch(rs, TRAIN_BATCH, 30522)
            for _ in range(RESUME_N * RESUME_K)]
    root = tempfile.mkdtemp(prefix='train_resume_')
    t_phase = time.perf_counter()
    row = {'phase': 'train_resume', 'model': 'bert_large pretraining',
           'entry': 'engine.fit(checkpoint=, resume_from=, preempt_save=)',
           'card': card, 'batch': [TRAIN_BATCH, SEQ],
           'dtype': 'amp.auto_cast O1 float16 on fp32 parameters',
           'dropout': 0.1, 'microbatch': RESUME_K,
           'dispatches': {'before_stop': RESUME_N, 'after': RESUME_N}}
    try:
        # without the deterministic mode: two runs of the same 2-layer fit
        # (printed, not held)
        twice = [_resume_run(seed, 2, data, 2) for _ in range(2)]
        row['two_layers_default_mode'] = {
            'losses': [r[2]['loss'] for r in twice],
            'bitwise_repeatable': all(
                torch.equal(p, q) for p, q in zip(
                    twice[0][0].parameters(), twice[1][0].parameters())),
            'loss_spread': max(abs(a - b) for a, b in zip(
                twice[0][2]['loss'], twice[1][2]['loss']))}
        del twice
        torch.cuda.empty_cache()
        with deterministic() as nondeterministic:
            row['two_layers'] = _resume_two_layers(seed, data, root)
            row['two_layers_s'] = time.perf_counter() - t_phase
            t_full = time.perf_counter()
            model, fit_state, counts, row['full_width'] = \
                _resume_full_width(seed, data, root)
            row['full_width_s'] = time.perf_counter() - t_full
        row['ops_without_a_deterministic_version'] = nondeterministic
        # 3. the saves, on the stopped run's fit state, outside the
        # deterministic mode (as a user's run would be)
        t_save = time.perf_counter()
        row['checkpoint'] = _save_costs(model, fit_state, data[0], root)
        row['checkpoint'].update(row['full_width'].pop('costs'))
        row['saves_s'] = time.perf_counter() - t_save
        del model, fit_state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row['phase_s'] = time.perf_counter() - t_phase
    emit(row)
    return counts


def _kept_restore_manager(path, max_keep):
    """A ``CheckpointManager`` for ``fit(resume_from=)`` that keeps what
    its last ``restore`` returned (the host state, meta and extras) and
    the ms it took."""
    from paddle_tpu_torch.resilience import CheckpointManager

    class KeptRestore(CheckpointManager):
        def restore(self, *args, **kwargs):
            t0 = time.perf_counter()
            got = super().restore(*args, **kwargs)
            self.restore_ms = 1e3 * (time.perf_counter() - t0)
            self.restored = got
            return got
    return KeptRestore(path, max_keep=max_keep)


def _resume_full_width(seed, data, root):
    """Part 2 of ``phase_train_resume``: two uninterrupted full-width runs
    of 2N dispatches (their spread), a run stopped at N with an async
    checkpoint, the resumed run from another seed's model; then the state
    that resume read against the stopped run's live state, and against
    the state another model's ``TrainStep.adopt_state`` makes of it ->
    (the stopped run's model and fit state, the resumed fit's launch
    counts, a row)."""
    from paddle_tpu_torch import engine, kernels
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.resilience import restore_rng
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    runs = []
    for _ in range(2):
        model, _, rep = _resume_run(seed, 24, data, 2)
        runs.append(rep['loss'])
        final_offset = model.dropout_state.offset
        del model, rep
        torch.cuda.empty_cache()
    spread = max(abs(a - b) for a, b in zip(*runs))
    mgr = _kept_restore_manager(os.path.join(root, 'full'), max_keep=2)
    model, sched, rep = _resume_run(seed, 24, data, 1, checkpoint=mgr,
                                    async_save=True)
    fit_state = rep['state']
    nbytes = sum(s['size'] for s in mgr.load_manifest(RESUME_N)[
        'shards'].values())
    kernels.reset_launch_counts()          # the main path: the resume
    resumed, _, rep = _resume_run(seed + 1, 24, data, 2,
                                  sched_state=sched.state_dict(),
                                  resume_from=mgr)
    counts = kernels.launch_counts()       # ... read right after it
    want = {n: RESUME_N * RESUME_K * c for n, c in TRAIN_LAUNCHES.items()}
    tol = [max(2 * spread, RESUME_LOSS_REL * abs(u))
           for u in runs[0][RESUME_N:]]
    off = [abs(a - b) for a, b in zip(rep['loss'], runs[0][RESUME_N:])]
    if counts != want or rep['resumed_from'] != RESUME_N or \
            len(off) != RESUME_N or any(o > t for o, t in zip(off, tol)) \
            or resumed.dropout_state.offset != final_offset:
        raise AssertionError(
            f"train_resume full width: launches {counts}, expected "
            f"{want}; resumed from {rep['resumed_from']}; losses "
            f"{rep['loss']} against {runs[0]} (off {off}, tolerance "
            f"{tol}); dropout offset {resumed.dropout_state.offset}, "
            f"{final_offset} uninterrupted")
    resumed_losses = rep['loss']
    del resumed, rep
    torch.cuda.empty_cache()
    # what the resume read: the stopped run's live state, bit for bit
    saved, _, extra = mgr.restored
    bad = _state_mismatches(saved, fit_state)
    offsets = extra['rng']['dropout']
    if bad or offsets != {'bert.dropout_state': {
            'seed': model.dropout_state.seed,
            'offset': model.dropout_state.offset}}:
        raise AssertionError(f"train_resume: the checkpoint differs from "
                             f"the live state at {bad[:4]}, or its "
                             f"dropout offsets {offsets}")
    # ... and what adopt_state and restore_rng make of it on another model
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    other = BertForPretraining(bert_large(), device=dev,
                               generator=gen).train()
    opt, _ = fit_optimizer()
    step = engine.build_train_step(net=other, loss=other.pretraining_loss,
                                   optimizer=opt, scaler=GradScaler(),
                                   nan_guard=True, microbatch=RESUME_K)
    t0 = time.perf_counter()
    adopted = step.adopt_state(saved)
    torch.cuda.synchronize()
    adopt_ms = 1e3 * (time.perf_counter() - t0)
    restore_rng(extra['rng'], other, adopted['opt'])
    bad = _state_mismatches(saved, adopted)
    if bad or other.dropout_state.offset != \
            offsets['bert.dropout_state']['offset']:
        raise AssertionError(f"train_resume: the adopted state differs "
                             f"from the checkpoint at {bad[:4]}")
    out = {'uninterrupted_losses': runs, 'spread': spread,
           'resumed_losses': resumed_losses, 'loss_off': off,
           'loss_tolerance': tol,
           'restored_state_bitwise': True, 'launches': counts,
           'costs': {'bytes': nbytes, 'restore_ms': mgr.restore_ms,
                     'adopt_ms': adopt_ms}}
    del other, opt, step, adopted, saved
    torch.cuda.empty_cache()
    return model, fit_state, counts, out


def _save_costs(model, fit_state, batch, root):
    """``CheckpointManager.save`` on a fit state: a sync save's ms; an
    async save's stall on the training thread (at most ``ASYNC_STALL_MAX``
    of the sync save's), the device memory its snapshot adds and its
    commit ms (read after each step, so to within a step); O1 fp16 step ms
    of the same model, Lamb, clip, scaler and guard (one microbatch of
    ``batch``) without a commit in flight and while one is -> a dict."""
    from paddle_tpu_torch import engine
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.resilience import CheckpointManager, NanGuard
    dev = torch.device('cuda', 0)
    mgr = CheckpointManager(os.path.join(root, 'measure'), max_keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(fit_state, step=0, world=1)
    sync_ms = 1e3 * (time.perf_counter() - t0)
    opt, _ = fit_optimizer()
    scaler, guard = GradScaler(), NanGuard()
    step = engine.build_train_step(net=model, loss=model.pretraining_loss,
                                   optimizer=opt, scaler=scaler,
                                   nan_guard=True)
    state = step.init_state(opt_state=fit_state['opt'], nan_guard=guard,
                            scaler=scaler)
    x, y = batch
    feed = ({n: torch.from_numpy(v).to(dev) for n, v in x.items()},
            tuple(torch.from_numpy(v).to(dev) for v in y))
    run = _amp_step(step, debug=False)

    def timed():
        # the training stream's own work: the writer's copies run on a
        # side stream, which a device-wide synchronize would wait for
        t = time.perf_counter()
        run(state, feed)
        torch.cuda.current_stream().synchronize()
        return 1e3 * (time.perf_counter() - t)
    timed()
    quiet_ms = [timed() for _ in range(8)]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mgr.save(state, step=1, world=1, async_=True)
    stall_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    snapshot_bytes = torch.cuda.max_memory_allocated() - base
    busy_ms = []
    while mgr.in_flight() and len(busy_ms) < 300:
        busy_ms.append(timed())
    mgr.fence(timeout=600)
    commit_ms = 1e3 * (time.perf_counter() - t0)
    out = {'sync_save_ms': sync_ms, 'async_stall_ms': stall_ms,
           'stall_over_sync': stall_ms / sync_ms,
           'async_commit_ms': commit_ms,
           'snapshot_added_device_bytes': snapshot_bytes,
           'step_ms_no_commit': quiet_ms,
           'step_ms_commit_in_flight': busy_ms,
           'step_ms_median': {'no_commit': float(np.median(quiet_ms)),
                              'commit_in_flight': float(np.median(busy_ms))
                              if busy_ms else None}}
    del step, state
    if stall_ms > ASYNC_STALL_MAX * sync_ms:
        raise AssertionError(f"train_resume: an async save stalled the "
                             f"training thread {stall_ms:.1f} ms, over "
                             f"{ASYNC_STALL_MAX} of a sync save's "
                             f"{sync_ms:.1f} ms")
    return out


# -- generative serving (GPT generate, the serving engine's generative path)
# GPT's prefill attention (gpt_small, batch 8 x 512) and its LayerNorms:
# the prefill's 8 x 512 rows and one decode step's 8, width 768, fp32
GPT_PREFILL = (8, 12, SEQ, 64)
GPT_LN_ROWS = (8 * SEQ, 8)
GPT_BATCH, GPT_NEW = 8, 256
GPT_TIMED_CALLS = 5
# one generate call at (8, 512) + 256 new tokens: the prefill (12 flash
# forwards, 25 LayerNorms) and 255 decode steps (25 LayerNorms each, no
# kernel attention: the cached attention is plain torch, as the
# reference's is composed XLA)
GPT_LAUNCHES = {'flash_attention_fwd': 12, 'layer_norm_fwd': 25 * GPT_NEW}
# a profiled prefill: 12 attention launches, each the fp32 3xTF32
# kernel; 25 LayerNorms on the register path. A decode step: 25
# LayerNorms, no attention kernel
GPT_PREFILL_ROUTES = {'flash_fwd_tf32_kernel': 12, 'flash_fwd_mma_kernel': 0,
                      'ln_rows_warp_kernel': 25, 'layer_norm_fwd_kernel': 0}
GPT_DECODE_ROUTES = {'flash_': 0, 'ln_rows_warp_kernel': 25,
                     'layer_norm_fwd_kernel': 0}
# teacher-forced check: an emitted token's logit in the no-cache forward
# (plain versions) lies within this share of the position's max |logit|
# of the position's maximum
TEACHER_TOL = 1e-4


# _count_syncs also counts this one-time notice of the debug mode, which
# is no sync
_SYNC_NOTICE = 'Synchronization debug mode is a prototype feature'


def phase_kernels_gpt(seed, flush):
    """The two kernels GPT's generate launches, at its shapes: the fp32
    causal flash forward at the prefill's (8, 12, 512, 64), p = 0, no key
    bias (bound: bytes, and the work's TF32 time beside its 3xTF32 time),
    against its plain version and timed beside SDPA causal fp32 (a
    yardstick, on no path); the fp32 LayerNorm at width 768 on the
    prefill's 4096 rows and a decode step's 8, beside ``F.layer_norm``
    and a device copy of as many bytes. -> {kernel: {case: row}}."""
    from paddle_tpu_torch.kernels import flash_attention, fused_norm
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 42)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    out = {'flash_attention_fwd': {}, 'layer_norm_fwd': {}}
    B, H, L, D = GPT_PREFILL
    q, k, v = randn(B, H, L, D), randn(B, H, L, D), randn(B, H, L, D)
    scale = 1.0 / D ** 0.5
    o, lse = flash_attention.flash_attention_forward(q, k, v, causal=True)
    ro, rlse = flash_attention._attn_reference(q, k, v, True, scale)
    torch.cuda.synchronize()
    err = max(max_err(o, ro), max_err(lse, rlse))
    check('flash attention, GPT prefill causal fp32', err, TOL)
    # the causal work: query row i against keys 0..i
    pairs = B * H * L * (L + 1) / 2
    flops = 4.0 * D * pairs
    row = {'max_abs_err': err, 'shape': [B, H, L, D], 'causal': True,
           'ms': time_ms(lambda: flash_attention.flash_attention_bhld(
               q, k, v, causal=True), flush),
           'plain_ms': time_ms(lambda: flash_attention._attn_reference(
               q, k, v, True, scale), flush),
           'library_ms': time_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=True), flush),
           'library': 'F.scaled_dot_product_attention(is_causal=True) fp32',
           **bound(flops, 4.0 * 4 * B * H * L * D, PEAK_TF32_FLOPS),
           'bound_3xtf32_ms': 1e3 * 3 * flops / PEAK_TF32_FLOPS}
    row.update(closeness(row))
    row['over_library'] = row['ms'] / row['library_ms']
    out['flash_attention_fwd']['gpt_prefill_fp32'] = row
    E = 768
    w, b = 1.0 + 0.1 * randn(E), 0.1 * randn(E)
    for n in GPT_LN_ROWS:
        x = randn(n, E)
        y = fused_norm.fused_layer_norm(x, w, b, 1e-5)
        err = max_err(y, fused_norm.fused_layer_norm_plain(x, w, b, 1e-5))
        check(f'layer norm ({n}, {E})', err, TOL)
        work = bound(8.0 * n * E, 4.0 * (2 * n * E + 2 * E))
        row = {'max_abs_err': err, 'shape': [n, E],
               'ms': time_ms(lambda: fused_norm.fused_layer_norm(
                   x, w, b, 1e-5), flush),
               'plain_ms': time_ms(lambda: fused_norm.fused_layer_norm_plain(
                   x, w, b, 1e-5), flush),
               'library_ms': time_ms(lambda: torch.nn.functional.layer_norm(
                   x, (E,), w, b, 1e-5), flush),
               'copy_ms': copy_ms(work['bytes'], flush), **work}
        row.update(closeness(row))
        out['layer_norm_fwd'][f'gpt_{"prefill" if n > 8 else "decode"}'
                              f'_fp32_{n}x{E}'] = row
    for name, cases in out.items():
        for case, row in cases.items():
            emit({'phase': 'kernel_gpt', 'name': name, 'case': case,
                  'tolerance': TOL, **row})
    return out


class _StepEvents:
    """CUDA events at the start of every model call (a forward pre-hook)
    and at its end (a forward hook): the prefill is call 0, decode step i
    call i + 1. Measurement only; removed by ``close``."""

    def __init__(self, model):
        self.starts, self.ends = [], []
        self._hooks = [model.register_forward_pre_hook(self._pre),
                       model.register_forward_hook(self._post)]

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _pre(self, module, args):
        self.starts.append(self._event())

    def _post(self, module, args, out):
        self.ends.append(self._event())

    def close(self):
        for h in self._hooks:
            h.remove()


def _teacher_forced(model, out, prompt_len, upto=None):
    """The no-cache forward (plain versions) of each generated sequence:
    -> (positions whose emitted token's logit is farther than TEACHER_TOL
    x max |logit| below the maximum, emitted tokens that are not the plain
    argmax, tokens checked). ``upto`` (B,) limits each row's checked
    tokens (those before its first eos)."""
    from paddle_tpu_torch import kernels
    dev = torch.device('cuda', 0)
    seq = out.to(dev, torch.int64)
    with torch.no_grad(), kernels.plain_versions():
        logits = model(seq[:, :-1])[:, prompt_len - 1:]       # (B, N, V)
    toks = seq[:, prompt_len:]
    picked = logits.gather(-1, toks[..., None])[..., 0]
    top = logits.amax(-1)
    tol = TEACHER_TOL * logits.abs().amax(-1)
    bad = picked < top - tol
    not_argmax = logits.argmax(-1) != toks
    keep = torch.ones_like(bad)
    if upto is not None:
        keep = torch.arange(toks.shape[1], device=dev)[None, :] < \
            upto.to(dev)[:, None]
    return (int((bad & keep).sum()), int((not_argmax & keep).sum()),
            int(keep.sum()))


def _support_violations(model, out, prompt_len, top_k, top_p, temperature):
    """Sampled tokens outside the filtered support, judged on the no-cache
    forward (plain versions), with TEACHER_TOL of slack at each filter's
    edge: the token must rank below ``top_k`` among logits larger than its
    own by more than the slack, and those larger logits' mass under the
    softmax of the top-k-filtered logits at ``temperature`` (what the
    top-p filter reads) must be under ``top_p`` (+ 1e-3)."""
    from paddle_tpu_torch import kernels
    dev = torch.device('cuda', 0)
    seq = out.to(dev, torch.int64)
    with torch.no_grad(), kernels.plain_versions():
        logits = model(seq[:, :-1])[:, prompt_len - 1:]
    toks = seq[:, prompt_len:]
    picked = logits.gather(-1, toks[..., None])
    tol = TEACHER_TOL * logits.abs().amax(-1, keepdim=True)
    above = logits > picked + tol
    rank = above.sum(-1)
    scaled = logits / temperature
    kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
    probs = torch.softmax(scaled.masked_fill(scaled < kth, float('-inf')),
                          dim=-1)
    mass = (probs * above).sum(-1)
    return int(((rank >= top_k) | (mass >= top_p + 1e-3)).sum())


def _gpt_parity(seed):
    """2 layers at gpt_small's widths: the prefill logits (8 x 512) and the
    logits of 8 decode steps (fixed random tokens), kernels against plain
    versions on the card and against the CPU (plain path)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTModel
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 41)
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12)
    model = GPTModel(cfg, device=dev, generator=gen).eval()
    cpu_model = copy.deepcopy(model).to('cpu')
    rs = np.random.RandomState(seed + 41)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(
        GPT_BATCH, SEQ)).astype(np.int64))
    steps = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(
        GPT_BATCH, 8)).astype(np.int64))

    def run(m, device):
        caches = m.init_caches(GPT_BATCH, SEQ + steps.shape[1])
        with torch.no_grad():
            pre, caches = m(ids.to(device), caches, 0)
            dec = []
            for i in range(steps.shape[1]):
                lg, caches = m(steps[:, i:i + 1].to(device), caches, SEQ + i)
                dec.append(lg[:, 0])
        return pre, torch.stack(dec, 1)

    kernels.reset_launch_counts()
    pre_k, dec_k = run(model, dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    with kernels.plain_versions():
        pre_p, dec_p = run(model, dev)
    pre_c, dec_c = run(cpu_model, 'cpu')
    errs = {'prefill_kernels_vs_plain': rel_err(pre_k, pre_p),
            'decode_kernels_vs_plain': rel_err(dec_k, dec_p),
            'prefill_kernels_vs_cpu': rel_err(pre_k.cpu(), pre_c),
            'decode_kernels_vs_cpu': rel_err(dec_k.cpu(), dec_c),
            'prefill_plain_vs_cpu': rel_err(pre_p.cpu(), pre_c)}
    for what, e in errs.items():
        check(f'GPT 2-layer parity, {what} (relative)', e, MODEL_TOL)
    want = {**dict.fromkeys(launches, 0), 'flash_attention_fwd': 2,
            'layer_norm_fwd': 5 * (1 + steps.shape[1])}
    if launches != want:
        raise AssertionError(f"GPT 2-layer parity launches {launches}, "
                             f"expected {want}")
    return {'layers': 2, 'hidden': 768, 'batch': GPT_BATCH, 'prompt': SEQ,
            'decode_steps': int(steps.shape[1]), 'tolerance': MODEL_TOL,
            'relative_errors': errs, 'launches': launches}


def phase_generate(seed, card):
    """GPT ``generate`` at gpt_small's full width (vocab 50304, hidden
    768, 12 layers, 12 heads, max_seq 1024), random weights from
    ``seed``, eval, fp32, TF32 off: batch 8 prompts of 512 random ids,
    256 new tokens, greedy, no eos; one warm-up call and 5 timed calls.
    Prints time to first token (CUDA events from the call's start to the
    prefill's end), decode ms per token (events at each decode step's
    start, p50 and p99), tokens/s (8 x 256 over each call's wall time),
    peak device memory, host syncs a call (sync debug mode 'warn', an
    extra call), and profiles of the prefill and one decode step. Gates:
    exactly 12 flash forward and 25 x 256 LayerNorm launches a call and
    no other kernel; the prefill's attention on ``flash_fwd_tf32_kernel``
    (the build phase holds every instantiation to HMMA) and every
    LayerNorm on the register path; the 2-layer parity (``_gpt_parity``);
    every emitted token within TEACHER_TOL of its position's maximum in
    the plain no-cache forward; a sampled call (top_k 50, top_p 0.95,
    temperature 0.8) repeating itself under one seed, inside the filtered
    support; an eos call padding after each row's first eos as the
    reference does. -> the main path's launch counts (the 5 timed
    calls)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.text.generation import greedy_token
    from paddle_tpu_torch.text.gpt import gpt_small
    parity = _gpt_parity(seed)
    torch.cuda.empty_cache()
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 40)
    t0 = time.perf_counter()
    model = gpt_small(device=dev, generator=gen).eval()
    setup_s = time.perf_counter() - t0
    cfg = model.config
    rs = np.random.RandomState(seed + 40)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(
        GPT_BATCH, SEQ)).astype(np.int64)).to(dev)

    def call(**kw):
        return model.generate(ids, max_new_tokens=GPT_NEW, **kw)

    first = call()                                      # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev = _StepEvents(model)
    outs, walls, ttft, step_ms = [], [], [], []
    kernels.reset_launch_counts()           # the main path starts here
    for _ in range(GPT_TIMED_CALLS):
        ev.starts.clear()
        ev.ends.clear()
        begin = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        begin.record()
        outs.append(call())
        walls.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        if len(ev.starts) != GPT_NEW:
            raise AssertionError(f"generate: {len(ev.starts)} model steps, "
                                 f"expected {GPT_NEW}")
        ttft.append(begin.elapsed_time(ev.ends[0]))
        step_ms += [a.elapsed_time(b) for a, b in
                    zip(ev.starts[1:], ev.starts[2:])]
    counts = kernels.launch_counts()        # ... and ends here
    ev.close()
    peak = torch.cuda.max_memory_allocated()
    want = {**dict.fromkeys(counts, 0),
            **{k: n * GPT_TIMED_CALLS for k, n in GPT_LAUNCHES.items()}}
    if counts != want:
        raise AssertionError(f"generate launches {counts} over "
                             f"{GPT_TIMED_CALLS} calls, expected {want}")
    (_, syncs, sync_sites) = _count_syncs(call)
    syncs -= _SYNC_NOTICE in ' '.join(sync_sites)
    for o in outs + [first]:
        if o.shape != (GPT_BATCH, SEQ + GPT_NEW) or \
                not torch.equal(o[:, :SEQ], ids.cpu().to(torch.int32)):
            raise AssertionError(f"generate: output {tuple(o.shape)} or "
                                 "its prompt is wrong")
    bad, not_argmax, checked = _teacher_forced(model, outs[0], SEQ)
    repeats = [int((o != outs[0]).sum()) for o in outs[1:] + [first]]
    for o, r in zip(outs[1:] + [first], repeats):
        if r:
            b2, n2, c2 = _teacher_forced(model, o, SEQ)
            bad, not_argmax, checked = bad + b2, not_argmax + n2, checked + c2
    if bad:
        raise AssertionError(f"generate: {bad} of {checked} emitted tokens "
                             "are not within the teacher-forced tolerance")
    # sampling: repeatable under a seed, inside the filtered support
    skw = dict(do_sample=True, top_k=50, top_p=0.95, temperature=0.8,
               seed=seed + 43)
    s1, s2 = call(**skw), call(**skw)
    if not torch.equal(s1, s2):
        raise AssertionError("generate: a sampled call does not repeat "
                             "under its seed")
    outside = _support_violations(model, s1, SEQ, 50, 0.95, 0.8)
    if outside:
        raise AssertionError(f"generate: {outside} sampled tokens outside "
                             "the filtered support")
    # eos: row 0's token 8 steps in; every later token of a row that
    # emitted it must be eos
    eos = int(outs[0][0, SEQ + 8])
    (e_out, eos_syncs, e_sites) = _count_syncs(
        lambda: call(eos_token_id=eos))
    eos_syncs -= _SYNC_NOTICE in ' '.join(e_sites)
    gen_part = e_out[:, SEQ:]
    is_eos = gen_part == eos
    first_eos = torch.where(is_eos.any(1), is_eos.int().argmax(1),
                            torch.full((GPT_BATCH,), GPT_NEW))
    after = torch.arange(GPT_NEW)[None, :] > first_eos[:, None]
    if not (gen_part[after] == eos).all() or int(first_eos[0]) > 8:
        raise AssertionError("generate: tokens after eos are not eos")
    e_bad, _, e_checked = _teacher_forced(model, e_out, SEQ,
                                          upto=first_eos + 1)
    if e_bad:
        raise AssertionError(f"generate eos: {e_bad} of {e_checked} tokens "
                             "off the teacher-forced tolerance")
    row = {'phase': 'generate', 'model': 'gpt_small', 'card': card,
           'vocab': cfg.vocab_size, 'hidden': cfg.hidden_size,
           'layers': cfg.num_layers, 'heads': cfg.num_heads,
           'dtype': 'float32', 'batch': GPT_BATCH, 'prompt': SEQ,
           'new_tokens': GPT_NEW, 'setup_s': setup_s,
           'calls': GPT_TIMED_CALLS,
           'ttft_ms': ttft, 'ttft_ms_median': float(np.median(ttft)),
           'decode_ms_per_token_p50': float(np.percentile(step_ms, 50)),
           'decode_ms_per_token_p99': float(np.percentile(step_ms, 99)),
           'decode_steps_timed': len(step_ms),
           'call_s': walls,
           'tokens_per_s': [GPT_BATCH * GPT_NEW / w for w in walls],
           'tokens_per_s_min': GPT_BATCH * GPT_NEW / max(walls),
           'tokens_per_s_max': GPT_BATCH * GPT_NEW / min(walls),
           'peak_memory_bytes': peak, 'allocated_before_bytes': base,
           'host_syncs_per_call': syncs, 'sync_sites': sync_sites,
           'host_syncs_eos_call': eos_syncs,
           'launches_per_call': GPT_LAUNCHES,
           'teacher_forced': {'tolerance': TEACHER_TOL, 'checked': checked,
                              'outside': bad, 'not_plain_argmax':
                              not_argmax},
           'tokens_differing_between_calls': repeats,
           'sampled': {'repeats': True, 'outside_support': outside},
           'eos': {'token': eos, 'rows_with_eos': int(is_eos.any(1).sum()),
                   'checked': e_checked},
           'parity_2_layer': parity}
    emit(row)
    # profiles: the prefill (its 12 attention launches on the 3xTF32
    # kernel) and one decode step
    caches = model.init_caches(GPT_BATCH, SEQ + 2)
    state = {}

    def prefill():
        with torch.no_grad():
            lg, state['c'] = model(ids, caches, 0)
            state['tok'] = greedy_token(lg[:, -1])[:, None].to(torch.int64)

    def decode():
        with torch.no_grad():
            model(state['tok'], state['c'], SEQ)

    phase_profile('generate prefill', prefill, GPT_PREFILL_ROUTES,
                  batch=GPT_BATCH, prompt=SEQ)
    phase_profile('generate decode step', decode, GPT_DECODE_ROUTES,
                  batch=GPT_BATCH, position=SEQ)
    del model, caches, state
    torch.cuda.empty_cache()
    return counts


# the engine's generative traffic: TinyCausalLM at gpt_small's widths
SG_WAVES, SG_WAVE_SIZE, SG_NEW = 3, 16, 64
SG_BUCKETS = (64, 128, 256)


def _gen_requests(rs, vocab):
    """48 prompts, lengths uniform in [16, 512]; every third one (16 in
    all) is one shared 256-token prefix plus a tail of 1-256 tokens."""
    prefix = rs.randint(1, vocab, size=256)
    out = []
    for i in range(SG_WAVES * SG_WAVE_SIZE):
        if i % 3 == 0:
            tail = rs.randint(1, vocab, size=int(rs.randint(1, 257)))
            out.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            out.append(rs.randint(1, vocab, size=int(rs.randint(16, 513)))
                       .astype(np.int32))
    return out


def _serve_generative_run(lm, reqs, **register):
    """Serve ``reqs`` in 3 waves of 16 (each wave pumped until the runner
    is idle) -> (responses, row). Time to first token: from submit to the
    end of the scheduler iteration that made the request's first token."""
    from paddle_tpu_torch.serving import ServingEngine
    dev = torch.device('cuda', 0)
    eng = ServingEngine(queue_capacity=64, device=dev)
    ep = eng.register('lm', generative=lm, **register)
    warm = eng.warmup()['lm']
    torch.cuda.synchronize()
    runner = eng._models['lm']
    futs, ttft = [], {}
    t0 = time.perf_counter()
    for w in range(SG_WAVES):
        wave = reqs[w * SG_WAVE_SIZE:(w + 1) * SG_WAVE_SIZE]
        futs += [ep.submit({'tokens': r}, max_new_tokens=SG_NEW)
                 for r in wave]
        while runner.has_work():
            eng.pump()
            for s in runner.slots:
                if s is not None and s['tokens'] and \
                        s['req'].id not in ttft:
                    ttft[s['req'].id] = s['req'].sw.elapsed_ms()
            for f in futs:
                if f.done() and f.request_id not in ttft:
                    ttft[f.request_id] = f._req.response.latency_ms
    wall = time.perf_counter() - t0
    resps = [f.result(timeout=60) for f in futs]
    st = eng.stats()
    first = [ttft[f.request_id] for f in futs]
    gen_tokens = sum(len(r.outputs['tokens']) for r in resps)
    row = {'requests': len(reqs), 'wall_s': wall,
           'requests_per_s': len(reqs) / wall,
           'tokens_per_s': gen_tokens / wall,
           'ttft_ms_p50': float(np.percentile(first, 50)),
           'ttft_ms_p99': float(np.percentile(first, 99)),
           'programs_warmed': warm, 'stats': st['models']['lm'],
           'kv': st['kv'].get('lm')}
    return resps, row


# the paged cache's default size for TinyCausalLM at max_batch 8, max_seq
# 1024, page_size 16 (every row at max_seq, plus the null page); the
# pressure case takes a quarter of it plus 1
SG_DEFAULT_PAGES = 8 * (1024 // 16) + 1
SG_PRESSURE_PAGES = SG_DEFAULT_PAGES // 4 + 1


def _sg_models(seed):
    """``TinyCausalLM`` at gpt_small's widths and its draft, on the card."""
    from paddle_tpu_torch.serving import TinyCausalLM
    dev = torch.device('cuda', 0)
    lm = TinyCausalLM.random(vocab=50304, embed=768, num_heads=12,
                             max_seq=1024, max_batch=8,
                             prompt_buckets=SG_BUCKETS, seed=seed,
                             device=dev)
    draft = TinyCausalLM.random(vocab=50304, embed=256, num_heads=4,
                                max_seq=1024, seed=seed + 1, device=dev)
    return lm, draft


def _teacher_forced_serving(what, lm, prompts, resps, ref_tokens, name):
    """Raise unless every response is OK with ``SG_NEW`` tokens, each
    within ``TEACHER_TOL`` of the maximum of ``lm.reference_logits`` (the
    no-cache forward) at its position; the tokens go into
    ``ref_tokens[prompt][name]`` -> the row's counts."""
    dev = torch.device('cuda', 0)
    bad = not_argmax = checked = 0
    for prompt, resp in zip(prompts, resps):
        toks = np.asarray(resp.outputs['tokens'], np.int64)
        if not resp.ok or len(toks) != SG_NEW:
            raise AssertionError(f"{what}: status {resp.status}, "
                                 f"{len(toks)} tokens")
        n = len(prompt)
        with torch.no_grad():
            lg = lm.reference_logits(np.concatenate(
                [prompt, toks[:-1]]))[n - 1:]
        tt = torch.from_numpy(toks).to(dev)
        picked = lg.gather(-1, tt[:, None])[:, 0]
        tol = TEACHER_TOL * lg.abs().amax(-1)
        bad += int((picked < lg.amax(-1) - tol).sum())
        not_argmax += int((lg.argmax(-1) != tt).sum())
        checked += len(toks)
        ref_tokens.setdefault(tuple(prompt.tolist()), {})[name] = toks
    if bad:
        raise AssertionError(f"{what}: {bad} of {checked} tokens off the "
                             "teacher-forced tolerance")
    return {'tolerance': TEACHER_TOL, 'checked': checked, 'outside': bad,
            'not_plain_argmax': not_argmax}


def phase_serve_generative(seed, card):
    """The engine's generative path on ``TinyCausalLM`` at gpt_small's
    widths (vocab 50304, embed 768, 12 heads, max_seq 1024, max_batch 8,
    prompt buckets 64/128/256), fp32: 48 requests in 3 waves of 16,
    prompts of 16-512 tokens (those over 256 take chunked prefill), 16 of
    them sharing a 256-token prefix, 64 new tokens each. Four runs: (a)
    paged, page_size 16, num_pages at its default; (b) the slot cache on
    the requests of at most 256 tokens; (c) paged with a draft
    (embed 256, 4 heads, seed + 1) and draft_k 4; (d) paged with
    num_pages cut to a quarter of the default plus 1. Gates: every request
    OK with 64 tokens, each run's tokens within TEACHER_TOL of the maximum
    of ``TinyCausalLM.reference_logits`` (the no-cache forward of
    ``reference_decode``) at every position, a prefix hit in (a), a
    preemption in (d), and no launch of the port's kernels (TinyCausalLM
    is composed, as the reference's is). -> the launch counts."""
    from paddle_tpu_torch import kernels
    t0 = time.perf_counter()
    lm, draft = _sg_models(seed)
    setup_s = time.perf_counter() - t0
    reqs = _gen_requests(np.random.RandomState(seed + 50), lm.vocab)
    short = [r for r in reqs if len(r) <= SG_BUCKETS[-1]]
    runs = {'a_paged': (reqs, dict(page_size=16)),
            'b_slot': (short, dict(kv_cache='slot')),
            'c_paged_draft': (reqs, dict(page_size=16, draft=draft,
                                         draft_k=4)),
            'd_paged_pressure': (reqs, dict(page_size=16,
                                            num_pages=SG_PRESSURE_PAGES))}
    kernels.reset_launch_counts()           # the main path starts here
    results, rows = {}, {}
    for name, (rq, reg) in runs.items():
        results[name], rows[name] = _serve_generative_run(lm, rq, **reg)
    counts = kernels.launch_counts()        # ... and ends here
    if any(counts.values()):
        raise AssertionError(f"serve_generative launched kernels {counts}; "
                             "TinyCausalLM runs no kernel of the port")
    ref_tokens = {}
    for name, (rq, _) in runs.items():
        rows[name]['teacher_forced'] = _teacher_forced_serving(
            f"serve_generative {name}", lm, rq, results[name], ref_tokens,
            name)
    hits = rows['a_paged']['kv']['prefix_hits']
    preempt = rows['d_paged_pressure']['stats']['preemptions']
    if hits < 1 or preempt < 1:
        raise AssertionError(f"serve_generative: prefix hits {hits} in (a), "
                             f"preemptions {preempt} in (d)")
    differ = {}
    for name in ('b_slot', 'c_paged_draft', 'd_paged_pressure'):
        pairs = [(v['a_paged'], v[name]) for v in ref_tokens.values()
                 if name in v]
        differ[name] = sum(int((x != y).sum()) for x, y in pairs)
    emit({'phase': 'serve_generative', 'model': 'TinyCausalLM',
          'card': card, 'vocab': lm.vocab, 'embed': 768, 'heads': 12,
          'max_seq': lm.max_seq, 'max_batch': lm.max_batch,
          'prompt_buckets': list(SG_BUCKETS), 'new_tokens': SG_NEW,
          'setup_s': setup_s, 'runs': rows,
          'tokens_differing_from_a': differ, 'launches': counts})
    return counts


# ---------------------------------------------------------------------------
# multi-tenant serving with the telemetry spine: tenants, SLOs, cancel and
# kill, and the live endpoint, on BERT-large
# ---------------------------------------------------------------------------

# (name, weight, rate, burst): storm's token bucket admits 8 at once and 4
# a second after that; the arbiter's clock is frozen, so no refill happens
# unless the phase moves it
TENANT_POLICIES = (('gold', 3.0, None, None), ('silver', 1.0, None, None),
                   ('storm', 1.0, 4.0, 8))
TENANT_MIX = {'storm': 24, 'gold': 24, 'silver': 8}
TENANT_SLO_MS, TENANT_SLO_OBJECTIVE = 250.0, 0.99
TENANT_CANCELS = 2            # queued silver requests withdrawn
HTTP_TIMEOUT_S = 10.0
SERVE_BATCH_LAUNCHES = {'flash_attention_fwd': 24, 'add_layer_norm_fwd': 48,
                        'layer_norm_fwd': 1}
# phase_serve's waves with telemetry off and on, in turns, in one process
TELEMETRY_TURNS = (False, True, True, False)


def _arbiter(now):
    from paddle_tpu_torch.serving import TenantArbiter, TenantPolicy
    return TenantArbiter([TenantPolicy(n, weight=w, rate=r, burst=b)
                          for n, w, r, b in TENANT_POLICIES],
                         clock=lambda: now[0])


def _tenant_order(rs):
    """The submit order: storm's flood first, then gold and silver
    interleaved at random."""
    rest = ['gold'] * TENANT_MIX['gold'] + ['silver'] * TENANT_MIX['silver']
    return ['storm'] * TENANT_MIX['storm'] + [str(t)
                                              for t in rs.permutation(rest)]


def _expected_pops(arbiter, tenants, cancelled, max_batch):
    """The batches' tenants, in order, that the port's WeightedFairQueue
    pops on the CPU for the same admitted submits and cancels."""
    from paddle_tpu_torch.serving import Request, WeightedFairQueue
    q = WeightedFairQueue('cpu', capacity=len(tenants), arbiter=arbiter)
    reqs = [Request('cpu', {}, tenant=t) for t in tenants]
    for r in reqs:
        q.push(r)
    for i in cancelled:
        q.remove(reqs[i])
    pops = []
    while len(q):
        ready, _ = q.pop_ready_while(None, max_batch)
        pops.append([r.tenant for r in ready])
    return pops


def _spy_pops(eng, model):
    """Record (tenant, request id) of every batch ``model``'s queue
    pops."""
    queue, pops = eng._queues[model], []
    pop = queue.pop_ready_while

    def spy(admit, n):
        ready, expired = pop(admit, n)
        if ready:
            pops.append([(r.tenant, r.id) for r in ready])
        return ready, expired
    queue.pop_ready_while = spy
    return pops


def _http_get(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _prometheus(text):
    """Prometheus text -> {sample (name and labels): value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith('#'):
            key, value = line.rsplit(' ', 1)
            out[key] = float(value)
    return out


def _bert_outputs_ok(what, resp, hidden):
    seq, pooled = resp.outputs
    if seq.shape != (SEQ, hidden) or pooled.shape != (hidden,) or \
            not (np.isfinite(seq).all() and np.isfinite(pooled).all()):
        raise AssertionError(f"{what}: outputs {seq.shape} {pooled.shape}, "
                             "or not finite")


def _waves_with_telemetry(model, reqs, on):
    """phase_serve's waves on a fresh engine (warmed up first), telemetry
    on or off -> (outputs, launches, host syncs, their sites, requests/s,
    {the waves' ms: ``wall``, ``batches`` (each wave is one batch: the sum
    of its ``run`` ms, feeds to host outputs) and ``rest`` (submits,
    pumps, completions)}, the engine)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import ServingEngine
    (obs.enable if on else obs.disable)()
    eng = ServingEngine(queue_capacity=64, device=torch.device('cuda', 0))
    ep = eng.register('bert', layer=model, example=_example())
    eng.warmup()
    torch.cuda.synchronize()
    obs.reset()
    kernels.reset_launch_counts()
    (served, batch_ms, secs), syncs, sites = _count_syncs(
        lambda: _serve_waves(eng, ep, reqs))
    syncs -= _SYNC_NOTICE in ' '.join(sites)
    batches = sum(sum(v) for v in batch_ms.values())
    ms = {'wall': 1e3 * secs, 'batches': batches,
          'rest': 1e3 * secs - batches}
    return ([r.outputs for r in served], kernels.launch_counts(), syncs,
            sites, len(served) / secs, ms, (eng, ep))


def phase_serve_tenants(seed, card, serve):
    """``ServingEngine(tenants=TenantArbiter(...))`` serving BERT-large
    (phase_serve's model) with ``register(slo_ms=250, slo_objective=0.99)``,
    telemetry on, the crash hooks, the sampler and the live endpoint up.
    The main path, counted: (a) pumped with the arbiter's clock frozen:
    storm submits 24 (8 admitted, 16 shed as ``QuotaExceededError``),
    gold 24 and silver 8, two queued silver requests cancelled; (b) the
    clock moved 2 s (storm's bucket back to 8), ``start()`` and
    ``start_endpoint(port=0)``, three client threads sending the same mix
    through ``Endpoint.predict(tenant=)``; ``/metrics``, ``/healthz``,
    ``/events``, ``/timeseries`` and ``/diagnosis`` read over localhost;
    ``kill()``, ``submit`` then raising ``EngineDeadError``, ``stop()``.
    Gates: the exact sheds; each batch's tenants as the CPU's
    ``WeightedFairQueue`` pops them; the cancelled requests completed
    ``'cancelled'`` and in no batch; every other request OK, those of (a)
    within ``TOL`` of the request served alone on the plain versions; the
    SLO and tenant tallies as the responses' statuses and latencies give
    them; ``/metrics`` equal to ``stats()``; no thread left; the launches
    exact for the batches run. Then, off the main path: phase_serve's
    waves served with telemetry off, on, on and off (``TELEMETRY_TURNS``):
    each run launches what phase_serve launched and gives its outputs bit
    for bit; off makes phase_serve's host syncs, on at most the sampled
    ones more (ceil(timed spans / sync_every) a span name); req/s of
    each. The
    paged engine on ``TinyCausalLM`` at gpt_small's widths with a draft
    and 129 pages, telemetry on: its ``serving.kv.pages_free``,
    ``serving.preemptions`` and ``serving.spec.*`` against the runner's
    own counts. One bucket-16 batch profiled with telemetry on: the
    ``serving.batch`` host range and the kernel calls of ``SERVE_ROUTES``.
    Telemetry is disabled and every buffer, hook, sampler and server reset
    before it returns. -> the main path's launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import (BucketSpec, EngineDeadError,
                                          QuotaExceededError, ServingEngine,
                                          admission)
    dev = torch.device('cuda', 0)
    model = serve['model']
    hidden = model.config.hidden_size
    obs.reset()
    admission.reset_tenant_stats()
    obs.enable()
    now = [0.0]
    arb = _arbiter(now)
    eng = ServingEngine(queue_capacity=64, tenants=arb, device=dev)
    ep = eng.register('bert', layer=model, example=_example(),
                      slo_ms=TENANT_SLO_MS,
                      slo_objective=TENANT_SLO_OBJECTIVE)
    eng.warmup()
    torch.cuda.synchronize()
    pops = _spy_pops(eng, 'bert')
    rs = np.random.RandomState(seed + 14)
    order = _tenant_order(rs)
    reqs = _requests(rs, len(order), model.config.vocab_size)
    threads_before = set(threading.enumerate())
    kernels.reset_launch_counts()              # the main path starts here
    # (a) pumped, the clock frozen
    futs, sheds = [], []
    for tenant, r in zip(order, reqs):
        try:
            futs.append((tenant, r, ep.submit(r, tenant=tenant)))
        except QuotaExceededError as e:
            sheds.append((tenant, e.reason))
    silver = [i for i, (t, _, _) in enumerate(futs)
              if t == 'silver'][:TENANT_CANCELS]
    cancelled = [eng.cancel(futs[i][2]) for i in silver]
    t0 = time.perf_counter()
    eng.run_until_idle()
    pumped_s = time.perf_counter() - t0
    resps = [f.result(timeout=600) for _, _, f in futs]
    pops_a = list(pops)
    # (b) threaded, the endpoint up
    now[0] += 2.0                 # storm's bucket refills to its burst
    eng.start()
    srv = eng.start_endpoint(port=0)
    by_tenant = {t: [r for r, o in zip(reqs, order) if o == t]
                 for t in TENANT_MIX}
    threaded = {t: [] for t in TENANT_MIX}

    def client(tenant):
        for r in by_tenant[tenant]:
            try:
                threaded[tenant].append(ep.predict(r, tenant=tenant,
                                                   timeout=600))
            except QuotaExceededError as e:
                threaded[tenant].append(e.reason)
    clients = [threading.Thread(target=client, args=(t,),
                                name=f'serve_tenants-{t}')
               for t in TENANT_MIX]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(600)
    threaded_s = time.perf_counter() - t0
    st = eng.stats()
    scraped = {route: _http_get(srv.url + route) for route in (
        '/metrics', '/healthz', '/events?n=5', '/timeseries',
        '/diagnosis')}
    eng.kill()
    try:
        ep.submit(reqs[0], tenant='gold')
        dead = None
    except EngineDeadError as e:
        dead = str(e)
    eng.stop()
    counts = kernels.launch_counts()           # ... and ends here
    for c in clients:
        c.join(5)
    leftover = [t for t in threading.enumerate()
                if t not in threads_before]
    for t in leftover:
        t.join(5)
    leftover = [t.name for t in leftover if t.is_alive()]
    tallies = obs.slo.tallies()
    ledger = admission.tenant_stats()
    snap = obs.snapshot()

    # the gates of (a) and (b)
    admitted = [t for t, _, _ in futs]
    want_pops = _expected_pops(arb, admitted, silver, 16)
    if sheds != [('storm', 'quota')] * 16:
        raise AssertionError(f"serve_tenants: sheds {sheds}")
    if [[t for t, _ in b] for b in pops_a] != want_pops:
        raise AssertionError(f"serve_tenants: batches {pops_a}, the CPU's "
                             f"WeightedFairQueue pops {want_pops}")
    gone = {futs[i][2].request_id for i in silver}
    batched = {rid for b in pops for _, rid in b}
    statuses = [r.status for r in resps]
    if cancelled != [True] * TENANT_CANCELS or gone & batched or \
            [statuses[i] for i in silver] != ['cancelled'] * TENANT_CANCELS:
        raise AssertionError(f"serve_tenants: cancels {cancelled}, "
                             f"statuses {[statuses[i] for i in silver]}, "
                             f"batched {sorted(gone & batched)}")
    for i, r in enumerate(resps):
        if i not in silver:
            if not r.ok:
                raise AssertionError(f"serve_tenants: request {i}: "
                                     f"{r.status}")
            _bert_outputs_ok(f"serve_tenants request {i}", r, hidden)
    want_b = {t: ['ok'] * n for t, n in TENANT_MIX.items()}
    want_b['storm'] = ['ok'] * 8 + ['quota'] * 16
    got_b = {t: [x if isinstance(x, str) else x.status for x in v]
             for t, v in threaded.items()}
    if got_b != want_b:
        raise AssertionError(f"serve_tenants threaded: {got_b}")
    for t, v in threaded.items():
        for x in v:
            if not isinstance(x, str):
                _bert_outputs_ok(f"serve_tenants {t}", x, hidden)
    done = [r for r in resps if r.status != 'cancelled'] + \
        [x for v in threaded.values() for x in v if not isinstance(x, str)]
    tenant_of = {f.request_id: t for t, _, f in futs}
    for t, v in threaded.items():
        for x in v:
            if not isinstance(x, str):
                tenant_of[x.request_id] = t
    viol = [r.status != 'ok' or r.latency_ms > TENANT_SLO_MS for r in done]
    want_tallies = {'bert': {'requests': len(done),
                             'violations': sum(viol)}}
    want_ledger = {}
    for r, v in zip(done, viol):
        row = want_ledger.setdefault(tenant_of[r.request_id],
                                     {'requests': 0, 'violations': 0})
        row['requests'] += 1
        row['violations'] += v
    got_ledger = {t: {'requests': v['requests'],
                      'violations': v['violations']}
                  for t, v in ledger.items()}
    if tallies != want_tallies or got_ledger != want_ledger or \
            ledger['storm']['shed'] != {'quota': 32}:
        raise AssertionError(f"serve_tenants: SLO tallies {tallies}, ledger "
                             f"{ledger}; the responses give "
                             f"{want_tallies}, {want_ledger}")
    code, text = scraped['/metrics']
    metrics = _prometheus(text)
    scrape = {
        'serving_batches': st['models']['bert']['batches'],
        'serving_completed': st['models']['bert']['completed'],
        'serving_requests': st['submitted'],
        'serving_shed': st['shed'], 'serving_shed_quota': st['shed_quota'],
        'serving_cancelled': TENANT_CANCELS}
    got_scrape = {k: metrics.get(f'paddle_tpu_{k}') for k in scrape}
    health_code, health = scraped['/healthz']
    health = json.loads(health)
    if code != 200 or got_scrape != scrape or st['shed_quota'] != 32:
        raise AssertionError(f"serve_tenants: /metrics {code} "
                             f"{got_scrape}, stats() {scrape}")
    if health_code != 200 or health['serving']['queue_depth'] != \
            {'bert': 0} or not health['serving']['worker_alive']:
        raise AssertionError(f"serve_tenants: /healthz {health_code} "
                             f"{health}")
    routes = {r: c for r, (c, _) in scraped.items()}
    diagnosed = json.loads(scraped['/diagnosis'][1])
    if routes != {'/metrics': 200, '/healthz': 200, '/events?n=5': 200,
                  '/timeseries': 200, '/diagnosis': 200} or not all(
                      set(d) == {'cause', 'severity', 'detail', 'fix',
                                 'evidence'}
                      and d['cause'] != 'doctor_error' for d in diagnosed):
        raise AssertionError(f"serve_tenants: routes {routes}, "
                             f"/diagnosis {diagnosed}")
    if dead is None or leftover or srv._httpd is not None:
        raise AssertionError(f"serve_tenants: submit after kill "
                             f"{dead!r}, threads left {leftover}")
    batches = st['models']['bert']['batches']
    want = {**dict.fromkeys(counts, 0),
            **{k: n * batches for k, n in SERVE_BATCH_LAUNCHES.items()}}
    if counts != want:
        raise AssertionError(f"serve_tenants launches {counts} over "
                             f"{batches} batches, expected {want}")

    # (a)'s outputs against each request served alone on the plain versions
    obs.disable()
    plain = ServingEngine(device=dev)
    pep = plain.register('alone', layer=model, example=_example(),
                         bucket_spec=BucketSpec((1,)))
    errs = []
    with kernels.plain_versions():
        for i, ((_, r, _), resp) in enumerate(zip(futs, resps)):
            if i in silver:
                continue
            f = pep.submit(r)
            plain.run_until_idle()
            alone = f.result(timeout=600).outputs
            errs.append(max(max_err(torch.from_numpy(a),
                                    torch.from_numpy(b))
                            for a, b in zip(resp.outputs, alone)))
    check('serve_tenants batched kernels vs alone plain', max(errs), TOL)

    # off against on, in turns: phase_serve's waves off, on, on, off
    turns, every = [], obs.sync_every()
    for on in TELEMETRY_TURNS:
        outs, launches, syncs, sites, rps, ms, served_by = \
            _waves_with_telemetry(model, serve['requests'], on)
        trace = obs.trace_events()
        timed = {}
        for e in trace:
            if e['ph'] == 'X':
                timed[e['name']] = timed.get(e['name'], 0) + 1
        allowance = sum(-(-n // every) for n in timed.values())
        sampled = sum(1 for e in trace if e['ph'] == 'X' and
                      e.get('args', {}).get('synced'))
        same = sum(all(np.array_equal(x, y) for x, y in zip(a, b))
                   for a, b in zip(outs, serve['outputs']))
        if launches != serve['launches'] or same != len(outs) or \
                not serve['syncs'] <= syncs <= serve['syncs'] + allowance:
            raise AssertionError(
                f"serve_tenants telemetry {'on' if on else 'off'}: "
                f"launches {launches}, outputs bitwise {same} of "
                f"{len(outs)}, host syncs {syncs} ({sites}); phase_serve: "
                f"{serve['launches']}, {serve['syncs']} syncs, allowance "
                f"{allowance} sampled")
        turns.append({'telemetry': on, 'requests_per_s': rps, 'ms': ms,
                      'host_syncs': syncs, 'sampled_syncs': sampled,
                      'sync_allowance': allowance, 'timed_spans': timed})
        if on:
            peng, pep16 = served_by
    off_rps = [t['requests_per_s'] for t in turns if not t['telemetry']]
    on_rps = [t['requests_per_s'] for t in turns if t['telemetry']]

    # the one bucket-16 batch, profiled with telemetry on
    obs.enable()

    def one_batch():
        futs16 = [pep16.submit(r) for r in serve['requests'][:16]]
        peng.run_until_idle()
        for f in futs16:
            f.result(timeout=600)
    prof = phase_profile('serve_tenants', one_batch, SERVE_ROUTES,
                         ranges=('serving.batch',), bucket=16,
                         telemetry=True)
    launched_16 = sum(SERVE_BATCH_LAUNCHES.values())
    if prof['port_kernels']['launched'] != launched_16:
        raise AssertionError(f"serve_tenants profile: "
                             f"{prof['port_kernels']} launches, expected "
                             f"{launched_16}")
    obs.disable()
    del peng, pep16

    # the paged engine, telemetry on
    obs.reset()
    obs.enable()
    lm, draft = _sg_models(seed)
    greqs = _gen_requests(np.random.RandomState(seed + 50), lm.vocab)
    gresps, grow = _serve_generative_run(
        lm, greqs, page_size=16, draft=draft, draft_k=4,
        num_pages=SG_PRESSURE_PAGES)
    gsnap = obs.snapshot()
    obs.disable()
    teacher = _teacher_forced_serving('serve_tenants paged', lm, greqs,
                                      gresps, {}, 'paged')
    gstats = grow['stats']
    kv_tel = {
        'pages_free': gsnap['gauges'].get('serving.kv.pages_free'),
        'preemptions': gsnap['counters'].get('serving.preemptions', 0),
        'spec_proposed': gsnap['counters'].get('serving.spec.proposed', 0),
        'spec_accepted': gsnap['counters'].get('serving.spec.accepted', 0)}
    kv_own = {'pages_free': grow['kv']['pages_free'],
              'preemptions': gstats['preemptions'],
              'spec_proposed': gstats['spec_proposed'],
              'spec_accepted': gstats['spec_accepted']}
    if kv_tel != kv_own or not gstats['preemptions'] or \
            not gstats['spec_proposed']:
        raise AssertionError(f"serve_tenants paged: telemetry {kv_tel}, "
                             f"the runner's {kv_own}")

    emit({'phase': 'serve_tenants', 'model': 'bert_large', 'card': card,
          'layers': model.config.num_hidden_layers, 'hidden': hidden,
          'seq': SEQ, 'dtype': 'float32',
          'tenants': {n: {'weight': w, 'rate': r, 'burst': b}
                      for n, w, r, b in TENANT_POLICIES},
          'mix': TENANT_MIX, 'slo_ms': TENANT_SLO_MS,
          'slo_objective': TENANT_SLO_OBJECTIVE,
          'pumped': {'requests': len(order), 'shed': len(sheds),
                     'cancelled': TENANT_CANCELS, 'batches': len(pops_a),
                     'batch_tenants': [[t for t, _ in b] for b in pops_a],
                     'seconds': pumped_s,
                     'max_abs_err_vs_alone_plain': max(errs),
                     'tolerance': TOL},
          'threaded': {'clients': len(clients), 'seconds': threaded_s,
                       'diagnosis': [(d['cause'], d['severity'])
                                     for d in diagnosed],
                       'statuses': {t: {s: v.count(s) for s in set(v)}
                                    for t, v in got_b.items()}},
          'batches': batches, 'launches': counts,
          'slo_tallies': tallies, 'slo_burn': st['slo_burn'],
          'tenant_ledger': ledger, 'scrape': got_scrape,
          'healthz': health['serving'],
          'counters': {k: v for k, v in snap['counters'].items()
                       if k.startswith(('serving.', 'slo.',
                                        'host_transfer.', 'kernels.'))},
          'telemetry_off_on': {
              'requests': len(serve['requests']), 'sync_every': every,
              'turns': turns,
              'overhead': 1.0 - sum(on_rps) / sum(off_rps),
              'launches_equal': True, 'outputs_bitwise_equal': True},
          'profile_host_ranges': prof['host_ranges'],
          'paged': {'model': 'TinyCausalLM', 'num_pages': SG_PRESSURE_PAGES,
                    'draft_k': 4, 'telemetry': kv_tel,
                    'teacher_forced': teacher,
                    'requests_per_s': grow['requests_per_s']}})
    obs.disable()
    obs.reset()
    obs.endpoint.stop_active_server()
    obs.timeseries.clear()
    obs.flight.uninstall_crash_hooks()
    admission.reset_tenant_stats()
    return counts


# ---------------------------------------------------------------------------
# the fleet layer: FleetRouter, FleetSupervisor and FleetAutoscaler over
# BERT-large replicas, with the faultinject chaos harness
# ---------------------------------------------------------------------------

FLEET_REPLICAS = ('r0', 'r1', 'r2')
FLEET_KILL_AT = 5            # r1 dies right after admitting its 5th request
FLEET_SLOW_S = 0.05          # r2 sleeps this long before every pump
FLEET_HEDGE_REQUESTS = 30    # served one at a time, unhedged then hedged
FLEET_DRAIN_WAVE = 16
FLEET_SLO_OBJECTIVE = 0.5    # burn = 2 x the violating share: at most 2.0,
# below the shed ladder's reject rung (4.0), so a burning fleet still
# admits; the autoscaler grows at burn 1.0 (half the requests late)
FLEET_MAX_TICKS = 8
FLEET_AFFINITY_PROMPTS = 16
FLEET_AFFINITY_NEW = 8
FLEET_TIMEOUT_S = 120.0


def _fleet_engine(model, dev):
    """One started BERT-large replica on ``model`` (shared weights, no new
    initialisation): a rejoin or a scale-up times an engine and its
    warmup, not 1.34 GB of random init."""
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(queue_capacity=64, device=dev)
    eng.register('bert', layer=model, example=_example())
    return eng.start()


def _percentiles(ms):
    return {'p50_ms': float(np.percentile(ms, 50)),
            'p99_ms': float(np.percentile(ms, 99)), 'n': len(ms)}


def _fleet_predict(router, reqs, outs=None):
    """Each request through ``router.predict``, one at a time ->
    [host ms]; the responses go to ``outs``."""
    ms = []
    for r in reqs:
        t0 = time.perf_counter()
        resp = router.predict('bert', r, timeout=FLEET_TIMEOUT_S)
        ms.append(1e3 * (time.perf_counter() - t0))
        if not resp.ok:
            raise AssertionError(f"serve_fleet: {resp.status}")
        if outs is not None:
            outs.append(resp)
    return ms


def _close_half_open(router, name, reqs):
    """Serve ``reqs`` one at a time until ``name``'s circuit is closed ->
    the requests it took."""
    for i, r in enumerate(reqs, 1):
        _fleet_predict(router, [r])
        if router.replica(name).breaker.state == 'closed':
            return i
    raise AssertionError(f"serve_fleet: {name}'s circuit still "
                         f"{router.replica(name).breaker.state} after "
                         f"{len(reqs)} requests")


def _bert_batches(engines):
    return sum(e.stats()['models']['bert']['batches'] for e in engines)


def _fleet_affinity(seed, dev):
    """(f): two paged generative replicas on ``TinyCausalLM`` at
    gpt_small's widths behind a router; 16 prompts of one 256-token
    prefix (16 full pages) and a tail of 1-15 tokens (a partial page, no
    digest), so their rendezvous key is the prefix's. The first prompt
    alone, then the other 15."""
    from paddle_tpu_torch.serving import (FleetRouter, ServingEngine,
                                          TinyCausalLM)
    lm = TinyCausalLM.random(vocab=50304, embed=768, num_heads=12,
                             max_seq=1024, max_batch=8,
                             prompt_buckets=SG_BUCKETS, seed=seed,
                             device=dev)
    rs = np.random.RandomState(seed + 16)
    prefix = rs.randint(1, lm.vocab, size=256)
    prompts = [np.concatenate([prefix, rs.randint(
        1, lm.vocab, size=int(rs.randint(1, 16)))]).astype(np.int32)
        for _ in range(FLEET_AFFINITY_PROMPTS)]
    router = FleetRouter()
    engines = {}
    for name in ('g0', 'g1'):
        eng = ServingEngine(queue_capacity=64, device=dev)
        eng.register('lm', generative=lm, page_size=16)
        engines[name] = eng.start()
        router.add_replica(name, eng)
    try:
        first = router.submit('lm', {'tokens': prompts[0]},
                              max_new_tokens=FLEET_AFFINITY_NEW)
        resps = [first.result(timeout=FLEET_TIMEOUT_S)]
        rest = [router.submit('lm', {'tokens': p},
                              max_new_tokens=FLEET_AFFINITY_NEW)
                for p in prompts[1:]]
        resps += [p.result(timeout=FLEET_TIMEOUT_S) for p in rest]
    finally:
        for eng in engines.values():
            eng.stop()
    placed = [p.replicas_tried for p in [first] + rest]
    kv = {n: e.stats()['kv']['lm'] for n, e in engines.items()}
    home = placed[0][0]
    other = 'g1' if home == 'g0' else 'g0'
    if any(p != (home,) for p in placed) or \
            not all(r.ok and len(r.outputs['tokens']) == FLEET_AFFINITY_NEW
                    for r in resps) or not kv[home]['prefix_hits'] or \
            kv[other].get('prefix_hits', 0) or \
            router.replica(other).dispatched:
        raise AssertionError(f"serve_fleet affinity: placed {placed}, kv "
                             f"{kv}, statuses {[r.status for r in resps]}")
    return {'model': 'TinyCausalLM', 'prompts': len(prompts),
            'shared_prefix_tokens': 256, 'replica': home,
            'prefix_hits': {n: kv[n]['prefix_hits'] for n in kv},
            'prefix_hit_rate': kv[home]['prefix_hit_rate'],
            'dispatched': {n: router.replica(n).dispatched for n in kv}}


def phase_serve_fleet(seed, card, serve):
    """The fleet layer on BERT-large: a ``FleetRouter`` over three
    ``ServingEngine``s (r0-r2) on phase_serve's model (fp32, seq 512),
    worker threads started, telemetry on. One card holds the whole fleet:
    the phase measures failover and rejoin, not a fleet across cards.
    The main path, counted: (a) chaos: ``kill_replica_at_request(r1, 5)``
    and ``slow_replica(r2, 0.05)``, phase_serve's 87 requests through
    ``router.submit`` in its waves: every request OK, none lost, r1 one
    death and an open circuit, a failover retry, the completions summing
    to the requests; (b) rejoin: ``FleetSupervisor(max_restarts=3,
    warmup=True).check_once() == ['r1']``, r1 half-open and dispatchable,
    closed again by the requests through its gate, ``fleet.recovery_ms``;
    (c) hedging: r2 the straggler, ``FLEET_HEDGE_REQUESTS`` requests one
    at a time unhedged, then hedged after twice phase_serve's bucket-1
    p50: p50 and p99 of each, hedges fired and won, the losers' extra
    batches; one settled answer a request, equal to the unhedged one
    within ``TOL``; (d) drain: a wave of 16, ``drain('r0')`` with work
    queued: every request OK, nothing aborted, no admit to r0 while it
    drains; ``readmit``; (e) autoscaling on real burn: SLO between
    phase_serve's bucket-4 and bucket-16 p50s (objective 0.5),
    ``FleetAutoscaler(min_replicas=2, max_replicas=4)`` ticked between
    full waves (16 requests a replica) until it grows a warmed BERT-large
    replica, then between single requests after ``slo.reset()`` until it
    shrinks through ``drain`` with zero aborted;
    ``fleet.autoscale.scale_up_ms``. Launches zeroed before (a) and read
    after (e): per batch 24 flash forward, 48 add+LayerNorm, 1 LayerNorm,
    over every engine's batches and the warmups of the engines built in
    between. Then (f) prefix affinity on two paged ``TinyCausalLM``
    replicas (no kernel); the doctor over the phase's events
    (``replica_flapping`` and ``autoscale_flap`` quiet, ``retry_storm``
    reported); no thread left; (a)'s outputs against each request served
    alone on the plain versions. -> the main path's launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.resilience import faultinject as fi
    from paddle_tpu_torch.serving import (DEFAULT_BATCH_BUCKETS, BucketSpec,
                                          FleetAutoscaler, FleetRouter,
                                          FleetSupervisor, RouterPolicy,
                                          ServingEngine, admission)
    model = serve['model']
    dev = next(model.parameters()).device
    hidden = model.config.hidden_size
    reqs = serve['requests']
    p50 = serve['batch_p50_ms']
    obs.reset()
    admission.reset_tenant_stats()
    obs.enable()
    threads_before = set(threading.enumerate())
    policy = RouterPolicy(max_retries=2, attempt_timeout_ms=60_000,
                          trip_after=3, circuit_cooldown_s=600.0)
    router = FleetRouter(policy=policy)
    engines = []                 # every BERT engine of the phase
    for name in FLEET_REPLICAS:
        eng = _fleet_engine(model, dev)
        eng.warmup()
        router.add_replica(name, eng)
        engines.append(eng)
    built = []

    def factory(name):
        eng = _fleet_engine(model, dev)
        engines.append(eng)
        built.append(name)
        return eng
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    kernels.reset_launch_counts()              # the main path starts here
    # (a) chaos
    r1, r2 = engines[1], engines[2]
    fi.kill_replica_at_request(r1, at_request=FLEET_KILL_AT)
    fi.slow_replica(r2, delay_s=FLEET_SLOW_S)
    served, t0, at = [], time.perf_counter(), 0
    for n in SERVE_WAVES:
        pend = [router.submit('bert', r, deadline_ms=60_000)
                for r in reqs[at:at + n]]
        at += n
        served += [p.result(timeout=FLEET_TIMEOUT_S) for p in pend]
    chaos_s = time.perf_counter() - t0
    rows = router.stats()['replicas']
    lost = sum(SERVE_WAVES) - sum(r.ok for r in served)
    if lost or rows['r1']['deaths'] != 1 or rows['r1']['circuit'] != \
            'open' or sum(r['retried'] for r in rows.values()) < 1 or \
            sum(r['completed'] for r in rows.values()) != len(served):
        raise AssertionError(f"serve_fleet chaos: {lost} lost, rows "
                             f"{rows}")
    for i, r in enumerate(served):
        _bert_outputs_ok(f"serve_fleet request {i}", r, hidden)
    chaos_rows = rows

    # (b) rejoin through the supervisor
    sup = FleetSupervisor(router, factory, max_restarts=3, warmup=True)
    relaunched = sup.check_once()
    h1 = router.replica('r1')
    rejoined = (h1.breaker.state, h1.engine.dispatchable(), h1.restarts)
    if relaunched != ['r1'] or rejoined != ('half_open', True, 1):
        raise AssertionError(f"serve_fleet rejoin: {relaunched}, "
                             f"{rejoined}")
    probes = _close_half_open(router, 'r1', reqs[:12])
    rejoin = [e for e in obs.event_log()
              if e['ev'] == 'fleet.replica_rejoin'][0]

    # (c) hedging: unhedged, then hedged, r2 the straggler
    hedge_reqs = reqs[:FLEET_HEDGE_REQUESTS]
    hedge_after = 2.0 * p50['1']
    before = _bert_batches(engines)
    plain_out, hedged_out = [], []
    unhedged_ms = _fleet_predict(router, hedge_reqs, plain_out)
    unhedged_batches = _bert_batches(engines) - before
    policy.hedge_after_ms = hedge_after
    hedged_rows0 = router.stats()['replicas']
    before = _bert_batches(engines)
    hedged_ms = _fleet_predict(router, hedge_reqs, hedged_out)
    hedged_batches = _bert_batches(engines) - before
    policy.hedge_after_ms = None
    hedged_rows = router.stats()['replicas']
    fired = sum(hedged_rows[n]['hedged'] - hedged_rows0[n]['hedged']
                for n in hedged_rows)
    won = sum(hedged_rows[n]['hedge_wins'] - hedged_rows0[n]['hedge_wins']
              for n in hedged_rows)
    hedge_err = max(max_err(torch.from_numpy(a), torch.from_numpy(b))
                    for x, y in zip(plain_out, hedged_out)
                    for a, b in zip(x.outputs, y.outputs))
    check('serve_fleet hedged vs unhedged answers', hedge_err, TOL)
    if len(hedged_out) != len(hedge_reqs) or not fired:
        raise AssertionError(f"serve_fleet hedging: {len(hedged_out)} "
                             f"answers, {fired} hedges fired")
    del r2.pump                  # r2 is a healthy replica again

    # (d) drain r0 with work queued, then readmit
    pend = [router.submit('bert', r, deadline_ms=60_000)
            for r in reqs[:FLEET_DRAIN_WAVE]]
    on_r0 = sum(p.replicas_tried[0] == 'r0' for p in pend)
    t0 = time.perf_counter()
    router.drain('r0', timeout=FLEET_TIMEOUT_S)
    drain_ms = 1e3 * (time.perf_counter() - t0)
    drained = [p.result(timeout=FLEET_TIMEOUT_S) for p in pend]
    during = [router.submit('bert', r) for r in reqs[:6]]
    admitted_r0 = [p.replicas_tried for p in during
                   if 'r0' in p.replicas_tried]
    during = [p.result(timeout=FLEET_TIMEOUT_S) for p in during]
    drain_ev = [e for e in obs.event_log()
                if e['ev'] == 'serving.router.drain' and
                e['state'] == 'drained'][-1]
    if not all(r.ok for r in drained + during) or admitted_r0 or \
            drain_ev['aborted'] or not router.replica('r0').drained:
        raise AssertionError(f"serve_fleet drain: {drain_ev}, admitted "
                             f"to r0 {admitted_r0}")
    router.readmit('r0')
    readmit_probes = _close_half_open(router, 'r0', reqs[:12])

    # (e) autoscaling on real SLO burn
    slo_ms = 0.5 * (p50['4'] + p50['16'])
    obs.slo.reset()
    obs.slo.set_objective('bert', slo_ms, FLEET_SLO_OBJECTIVE)
    auto = FleetAutoscaler(router, replica_factory=factory, min_replicas=2,
                           max_replicas=4, sustain_ticks=2,
                           cooldown_ticks=1, warmup=True)
    ticks, full_waves = [], 0
    while 'grow' not in ticks:
        if len(ticks) >= FLEET_MAX_TICKS:
            raise AssertionError(f"serve_fleet: no grow in {ticks}, burn "
                                 f"{obs.slo.burn_rates()}")
        wave = [reqs[(full_waves * 16 * 4 + i) % len(reqs)]
                for i in range(16 * len(router.replicas()))]
        pend = [router.submit('bert', r, deadline_ms=60_000) for r in wave]
        if not all(p.result(timeout=FLEET_TIMEOUT_S).ok for p in pend):
            raise AssertionError("serve_fleet: a full wave failed")
        full_waves += 1
        ticks.append(auto.tick())
    burn_at_grow = obs.slo.burn_rates()
    obs.slo.reset()                            # dilute the burn
    obs.slo.set_objective('bert', slo_ms, FLEET_SLO_OBJECTIVE)
    grown = len(router.replicas())
    while 'shrink' not in ticks:
        if len(ticks) >= 2 * FLEET_MAX_TICKS:
            raise AssertionError(f"serve_fleet: no shrink in {ticks}")
        _fleet_predict(router, reqs[len(ticks):len(ticks) + 2])
        ticks.append(auto.tick())
    shrink = [d for d in auto.decisions() if d['action'] == 'shrink'][0]
    grow = [d for d in auto.decisions() if d['action'] == 'grow'][0]
    if grown != 4 or len(router.replicas()) != 3 or shrink['aborted']:
        raise AssertionError(f"serve_fleet autoscale: {ticks}, "
                             f"{auto.decisions()}")
    batches = _bert_batches(engines)
    warm_forwards = len(DEFAULT_BATCH_BUCKETS) * len(built)
    counts = kernels.launch_counts()           # ... and ends here
    want = {**dict.fromkeys(counts, 0),
            **{k: n * (batches + warm_forwards)
               for k, n in SERVE_BATCH_LAUNCHES.items()}}
    if counts != want:
        raise AssertionError(f"serve_fleet launches {counts} over "
                             f"{batches} batches and {warm_forwards} "
                             f"warmup forwards, expected {want}")

    # stop the fleet: every engine the phase built, removed ones included
    for eng in engines:
        eng.stop()
    affinity = _fleet_affinity(seed, dev)
    snap = obs.snapshot()
    events = obs.event_log()
    diagnosed = obs.doctor.diagnose(events=events, snapshot=snap)
    causes = {d['cause']: d['severity'] for d in diagnosed}
    leftover = [t for t in threading.enumerate() if t not in threads_before]
    for t in leftover:
        t.join(5)
    leftover = [t.name for t in leftover if t.is_alive()]
    if 'replica_flapping' in causes or 'autoscale_flap' in causes or \
            leftover:
        raise AssertionError(f"serve_fleet: doctor {causes}, threads "
                             f"left {leftover}")
    recovery = snap['histograms'].get('fleet.recovery_ms', {})
    scale_up = snap['histograms'].get('fleet.autoscale.scale_up_ms', {})
    if recovery.get('count') != 1 or scale_up.get('count') != 1:
        raise AssertionError(f"serve_fleet histograms: {recovery}, "
                             f"{scale_up}")

    # (a)'s outputs against each request served alone on the plain versions
    obs.disable()
    plain = ServingEngine(device=dev)
    pep = plain.register('alone', layer=model, example=_example(),
                         bucket_spec=BucketSpec((1,)))
    errs = []
    with kernels.plain_versions():
        for r, resp in zip(reqs, served):
            f = pep.submit(r)
            plain.run_until_idle()
            alone = f.result(timeout=FLEET_TIMEOUT_S).outputs
            errs.append(max(max_err(torch.from_numpy(a),
                                    torch.from_numpy(b))
                            for a, b in zip(resp.outputs, alone)))
    check('serve_fleet chaos outputs vs alone plain', max(errs), TOL)

    emit({'phase': 'serve_fleet', 'model': 'bert_large', 'card': card,
          'layers': model.config.num_hidden_layers, 'hidden': hidden,
          'seq': SEQ, 'dtype': 'float32', 'replicas': list(FLEET_REPLICAS),
          'one_card': True,
          'chaos': {'requests': len(served), 'waves': SERVE_WAVES,
                    'kill_r1_at_request': FLEET_KILL_AT,
                    'slow_r2_s': FLEET_SLOW_S, 'lost': lost,
                    'seconds': chaos_s, 'rows': chaos_rows,
                    'max_abs_err_vs_alone_plain': max(errs),
                    'tolerance': TOL},
          'rejoin': {'relaunched': relaunched,
                     'recovery_ms': rejoin['recovery_ms'],
                     'requests_to_close': probes},
          'hedging': {'hedge_after_ms': hedge_after,
                      'bucket1_p50_ms': p50['1'],
                      'requests': len(hedge_reqs),
                      'unhedged': _percentiles(unhedged_ms),
                      'hedged': _percentiles(hedged_ms),
                      'hedges_fired': fired, 'hedge_wins': won,
                      'batches_unhedged': unhedged_batches,
                      'batches_hedged': hedged_batches,
                      'extra_batches': hedged_batches - len(hedge_reqs),
                      'max_abs_err_hedged_vs_unhedged': hedge_err},
          'drain': {'wave': FLEET_DRAIN_WAVE, 'placed_on_r0': on_r0,
                    'drained': drain_ev['drained'],
                    'aborted': drain_ev['aborted'], 'ms': drain_ms,
                    'requests_to_close_after_readmit': readmit_probes},
          'autoscale': {'slo_ms': slo_ms,
                        'slo_objective': FLEET_SLO_OBJECTIVE,
                        'full_waves': full_waves, 'ticks': ticks,
                        'burn_at_grow': burn_at_grow,
                        'scale_up_ms': grow['ms'],
                        'scale_down_ms': shrink['ms'],
                        'grown': grow['replica'],
                        'shrunk': shrink['replica'],
                        'aborted': shrink['aborted'],
                        'replicas': [h.name for h in router.replicas()]},
          'affinity': affinity,
          'doctor': causes,
          'retry_storm': [d for d in diagnosed
                          if d['cause'] == 'retry_storm'],
          'batches': batches, 'warm_forwards': warm_forwards,
          'launches': counts,
          'counters': {k: v for k, v in snap['counters'].items()
                       if k.startswith(('serving.router', 'fleet.'))}})
    obs.reset()
    obs.endpoint.stop_active_server()
    obs.timeseries.clear()
    obs.flight.uninstall_crash_hooks()
    admission.reset_tenant_stats()
    return counts


# ---------------------------------------------------------------------------
# the high-level API: hapi.Model fit / evaluate / predict on BERT-large,
# with its DataLoader, callbacks and Accuracy
# ---------------------------------------------------------------------------

HAPI_TRAIN = 48          # samples: 6 steps an epoch at batch 8
HAPI_EVAL = 16           # samples: 2 batches
HAPI_EPOCHS = 2
HAPI_PEAK_LR = 1e-4
HAPI_WARMUP = 6          # LinearWarmup's steps: the first epoch
# a forward in eval mode (fit's evaluation, evaluate, predict)
FORWARD_LAUNCHES = {'flash_attention_fwd': 24, 'flash_attention_dq': 0,
                    'flash_attention_dkv': 0, 'add_layer_norm_fwd': 48,
                    'dropout_grad': 0, 'layer_norm_fwd': 2,
                    'rms_norm_fwd': 0}
# the 2-layer checks: 3 steps an epoch and one eval batch; the SIGTERM
# ends global step 4 (epoch 1, step 1), after an epoch-boundary save
HAPI_SMALL_TRAIN, HAPI_SMALL_EVAL = 24, 8
HAPI_PREEMPT_AT = 4
# kernels against plain versions through hapi, relative on each loss,
# absolute on an accuracy
HAPI_PARITY_TOL = 1e-3


def _hapi_sets(seed, n_train, n_eval, vocab):
    """A train and an eval ``io.Dataset`` of ``bench_bert``'s feeds
    (``_pretraining_batch``), one sample each: ({'input_ids',
    'token_type_ids', 'masked_positions'}, (MLM labels, NSP label))."""
    from paddle_tpu_torch import io

    class Pretraining(io.Dataset):
        def __init__(self, rs, n):
            self.x, self.y = _pretraining_batch(rs, n, vocab)

        def __len__(self):
            return len(self.y[0])

        def __getitem__(self, i):
            return ({k: v[i] for k, v in self.x.items()},
                    tuple(v[i] for v in self.y))
    rs = np.random.RandomState(seed)
    return Pretraining(rs, n_train), Pretraining(rs, n_eval)


def _hapi_model(seed, layers, p, jit):
    """``BertForPretraining(bert_large())`` (``layers`` deep, dropout
    ``p``) from ``seed`` in a ``hapi.Model`` on the card, prepared with
    AdamW(weight_decay=0.01) under ``LinearWarmup(HAPI_PEAK_LR,
    HAPI_WARMUP)``, ``pretraining_loss`` and ``Accuracy(topk=(1, 5))``,
    eager or ``jit``."""
    from paddle_tpu_torch import Model, metric, optimizer
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    cfg = bert_large(hidden_dropout_prob=p, attention_probs_dropout_prob=p)
    cfg.num_hidden_layers = layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    net = BertForPretraining(cfg, device=dev, generator=gen)
    sched = optimizer.lr.LinearWarmup(HAPI_PEAK_LR, HAPI_WARMUP,
                                      HAPI_PEAK_LR / 10, HAPI_PEAK_LR)
    opt = optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                          parameters=net.named_parameters())
    return Model(net, device=dev).prepare(
        opt, net.pretraining_loss, metric.Accuracy(topk=(1, 5)), jit=jit)


def _step_clock():
    """A callback keeping each train batch's (epoch, step, host time at
    its end, logs)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def __init__(self):
            super().__init__()
            self.epoch, self.rows = 0, []

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch

        def on_train_batch_end(self, step, logs=None):
            self.rows.append((self.epoch, step, time.perf_counter(),
                              dict(logs)))
    return StepClock()


def _preempt_at(at):
    """A callback raising SIGTERM at the end of global train batch
    ``at``."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Preempt(Callback):
        def __init__(self):
            super().__init__()
            self.seen, self.fired = 0, False

        def on_train_batch_end(self, step, logs=None):
            if self.seen == at and not self.fired:
                self.fired = True
                signal.raise_signal(signal.SIGTERM)
            self.seen += 1
    return Preempt()


def _hapi_fit(model, train, evals, callbacks, seed, **kw):
    """The recipe's ``fit``: batch 8, shuffled (numpy seeded with
    ``seed``), two loader threads, an evaluation after each epoch."""
    np.random.seed(seed)
    model.fit(train, eval_data=evals, batch_size=TRAIN_BATCH,
              epochs=HAPI_EPOCHS, eval_freq=1, shuffle=True, num_workers=2,
              verbose=0, callbacks=callbacks, **kw)


def _hapi_state(model):
    """The parameters, the optimizer's state dict and the dropout offset
    of a model, on the host."""
    model._sync_jit_state()
    out = {f'net.{k}': v.detach().cpu().clone()
           for k, v in model.network.state_dict().items()}
    for k, v in model._optimizer.state_dict().items():
        out[f'opt.{k}'] = v.detach().cpu().clone() \
            if isinstance(v, torch.Tensor) else v
    out['dropout_offset'] = model.network.dropout_state.offset
    return out


def _hapi_mismatches(got, want):
    if set(got) != set(want):
        return ['keys']
    return [k for k, w in want.items()
            if not (torch.equal(got[k], w) if isinstance(w, torch.Tensor)
                    else got[k] == w)]


def phase_hapi_parity(seed):
    """The hapi recipe at 2 layers (BERT-large widths), p = 0, on 24 train
    and 8 eval samples: (1) the eager and the jit ``fit`` (2 epochs, the
    evaluations) and an ``evaluate`` with the kernels against the same
    under ``kernels.plain_versions()``: every step's loss and the evaluate
    loss within ``HAPI_PARITY_TOL`` relative, the accuracies within it
    absolute; (2) under ``deterministic()``, ``CheckpointSaver``'s stop
    and resume: a SIGTERM at global step ``HAPI_PREEMPT_AT`` after the
    first epoch's save, sync and ``async_save=True``, each resumed from
    another seed's model, equal to the uninterrupted run bit for bit
    (parameters, AdamW's slots, the dropout offset); checkpoints in a
    temporary directory, removed at the end."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.hapi.callbacks import CheckpointSaver, LRScheduler
    train, evals = _hapi_sets(seed + 7, HAPI_SMALL_TRAIN, HAPI_SMALL_EVAL,
                              30522)
    out = {'phase': 'hapi_parity', 'layers': 2, 'dropout': 0.0,
           'batch': [TRAIN_BATCH, SEQ], 'samples': [HAPI_SMALL_TRAIN,
                                                    HAPI_SMALL_EVAL],
           'tolerance': HAPI_PARITY_TOL}
    runs = {}
    for path in ('eager', 'jit'):
        for how in ('kernels', 'plain'):
            model = _hapi_model(seed + 8, 2, 0.0, path == 'jit')
            clock = _step_clock()
            with (kernels.plain_versions() if how == 'plain'
                  else contextlib.nullcontext()):
                _hapi_fit(model, train, evals, [clock, LRScheduler()], seed,
                          log_freq=1)
                logs = model.evaluate(evals, batch_size=TRAIN_BATCH,
                                      verbose=0)
            runs[path, how] = ([r[3]['loss'] for r in clock.rows], logs)
            del model
    for path in ('eager', 'jit'):
        (lk, ek), (lp, ep) = runs[path, 'kernels'], runs[path, 'plain']
        errs = {'loss': max(abs(a - b) / abs(b) for a, b in zip(lk, lp)),
                'evaluate_loss': abs(ek['loss'] - ep['loss']) /
                abs(ep['loss']),
                'accuracy': max(abs(ek[n] - ep[n])
                                for n in ('acc_top1', 'acc_top5'))}
        for what, err in errs.items():
            check(f'hapi parity {path}: {what}', err, HAPI_PARITY_TOL)
        out[path] = {'losses_kernels': lk, 'losses_plain': lp,
                     'evaluate_kernels': ek, 'evaluate_plain': ep,
                     'errors': errs}
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix='hapi_resume_')
    try:
        with deterministic() as nondeterministic:
            straight = _hapi_model(seed + 8, 2, 0.0, False)
            _hapi_fit(straight, train, evals, [], seed)
            want = _hapi_state(straight)
            del straight
            for mode in ('sync', 'async'):
                ck = os.path.join(root, mode)
                killed = _hapi_model(seed + 8, 2, 0.0, False)
                saver = CheckpointSaver(ck, async_save=mode == 'async')
                stop = _preempt_at(HAPI_PREEMPT_AT)
                _hapi_fit(killed, train, evals, [stop, saver], seed)
                if not (stop.fired and saver.preempted):
                    raise AssertionError(f"hapi resume {mode}: the SIGTERM "
                                         f"was not caught")
                del killed
                resumed = _hapi_model(seed + 9, 2, 0.0, False)
                _hapi_fit(resumed, train, evals, [], seed, resume_from=ck)
                bad = _hapi_mismatches(_hapi_state(resumed), want)
                if bad:
                    raise AssertionError(f"hapi resume {mode}: not bitwise "
                                         f"the uninterrupted run: {bad[:4]}")
                out[f'resume_{mode}'] = {'bitwise': True,
                                         'preempted_at': HAPI_PREEMPT_AT}
                del resumed
        out['ops_without_a_deterministic_version'] = nondeterministic
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(out)


def _metric_costs(flush):
    """``Accuracy(topk=(1, 5))``'s compute and update on the MLM logits of
    a step (8, 76, 30522) fp32: the device ms (``time_ms``), the
    correctness matrix equal to the CPU's, and the host ms of the
    reference's method (the logits to numpy, a full argsort) beside it."""
    from paddle_tpu_torch import metric
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1)
    n_masked = max(SEQ * 15 // 100, 1)
    logits = torch.randn(TRAIN_BATCH, n_masked, 30522, device='cuda',
                         generator=gen)
    labels = torch.randint(0, 30522, (TRAIN_BATCH, n_masked),
                           device='cuda', generator=gen)
    acc = metric.Accuracy(topk=(1, 5))
    device_ms = time_ms(lambda: acc.update(acc.compute(logits, labels)),
                        flush)
    on_cpu = metric.Accuracy(topk=(1, 5)).compute(logits.cpu(),
                                                  labels.cpu())
    if not torch.equal(acc.compute(logits, labels).cpu(), on_cpu):
        raise AssertionError("hapi_fit: Accuracy on the card differs from "
                             "the CPU's")
    t0 = time.perf_counter()
    host = logits.cpu().numpy()
    np.argsort(-host, axis=-1)[..., :5]
    return {'device_ms': device_ms,
            'correctness_bytes': TRAIN_BATCH * n_masked * 5 * 4,
            'logits_bytes': logits.numel() * 4,
            'reference_method_host_ms': 1e3 * (time.perf_counter() - t0)}


def phase_hapi_fit(seed, card, train_step_ms):
    """BERT-large pretraining (24 layers, batch 8 x 512, dropout 0.1) in a
    ``hapi.Model`` on 48 train and 16 eval samples of ``bench_bert``'s
    feeds: ``fit`` for 2 epochs (shuffled, 2 loader threads,
    ``Accuracy(topk=(1, 5))``, an evaluation after each epoch, callbacks
    ``LRScheduler`` on ``LinearWarmup``, an ``EarlyStopping`` that cannot
    fire within 2 epochs, ``VisualDL`` to a temporary directory), eager
    and then ``jit=True`` on the same weights (``phase_train``'s), then
    ``evaluate`` and ``predict`` on the eval set. Gates: the launch counts
    of the whole path exactly 24 steps x ``TRAIN_LAUNCHES`` + 12 forwards x
    ``FORWARD_LAUNCHES``; finite losses, each path's second epoch's mean
    below its first's; every accuracy in [0, 1]; the two paths' first
    losses within 1e-3 relative; VisualDL's 12 records a path. Printed:
    step ms (median over the second epoch, batch end to batch end) and
    samples/s per path beside ``phase_train``'s fp32 step, host syncs a
    step, the loader's wait for each batch, ``evaluate`` and ``predict``
    ms a batch, peak memory; then one profiled ``train_batch`` a path
    (``TRAIN_ROUTES``) and the metric's device ms (``_metric_costs``).
    -> the path's launch counts."""
    from paddle_tpu_torch import io, kernels
    from paddle_tpu_torch.hapi.callbacks import (EarlyStopping, LRScheduler,
                                                 VisualDL)
    dev = torch.device('cuda', 0)
    train, evals = _hapi_sets(seed + 6, HAPI_TRAIN, HAPI_EVAL, 30522)
    steps = HAPI_EPOCHS * HAPI_TRAIN // TRAIN_BATCH
    eval_batches = HAPI_EVAL // TRAIN_BATCH
    logdir = tempfile.mkdtemp(prefix='hapi_fit_')

    class TimedLoader(io.DataLoader):
        """The consumer's wait for each batch (``next``), in seconds."""

        def __iter__(self):
            self.waits = getattr(self, 'waits', [])
            it = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits.append(time.perf_counter() - t0)
                yield batch

    row = {'phase': 'hapi_fit', 'model': 'bert_large pretraining',
           'entry': 'hapi.Model.fit / evaluate / predict', 'card': card,
           'layers': 24, 'batch': [TRAIN_BATCH, SEQ], 'dropout': 0.1,
           'dtype': 'float32 (TF32 off)',
           'optimizer': f'AdamW(weight_decay=0.01) under LinearWarmup('
                        f'{HAPI_PEAK_LR}, {HAPI_WARMUP}, '
                        f'{HAPI_PEAK_LR / 10}, {HAPI_PEAK_LR})',
           'samples': {'train': HAPI_TRAIN, 'eval': HAPI_EVAL},
           'epochs': HAPI_EPOCHS, 'loader_threads': 2,
           'train_fp32_step_ms': train_step_ms, 'paths': {}}
    model = None
    try:
        kernels.reset_launch_counts()   # the main path: two fits, evaluate,
        for path in ('eager', 'jit'):   # predict
            # the callbacks hold the last path's model too
            model = loader = clock = early = vdl = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()   # what earlier phases hold
            t0 = time.perf_counter()
            model = _hapi_model(seed + 3, 24, 0.1, path == 'jit')
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            loader = TimedLoader(train, batch_size=TRAIN_BATCH, shuffle=True,
                                 num_workers=2, device=dev)
            clock = _step_clock()
            early = EarlyStopping(monitor='loss', patience=HAPI_EPOCHS,
                                  verbose=0)
            vdl = VisualDL(os.path.join(logdir, path))
            t0 = time.perf_counter()
            _, n_sync, where = _count_syncs(lambda: _hapi_fit(
                model, loader, evals, [clock, LRScheduler(), early, vdl],
                seed))
            wall = time.perf_counter() - t0
            n_sync -= _SYNC_NOTICE in ' '.join(where)
            losses = [float(r[3]['loss']) for r in clock.rows]
            by_epoch = [[float(r[3]['loss']) for r in clock.rows
                         if r[0] == e] for e in range(HAPI_EPOCHS)]
            accs = [r[3]['acc_top1'] for r in clock.rows]
            ends = [r[2] for r in clock.rows if r[0] == HAPI_EPOCHS - 1]
            ms = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
            waits = loader.waits[len(loader.waits) // 2:]
            with open(os.path.join(logdir, path, 'scalars.jsonl')) as f:
                records = sum(1 for _ in f)
            if len(losses) != steps or records != steps or \
                    model.stop_training:
                raise AssertionError(
                    f"hapi_fit {path}: {len(losses)} steps, {records} "
                    f"VisualDL records (expected {steps}), stopped early "
                    f"{model.stop_training}")
            if not all(np.isfinite(losses)) or \
                    not np.mean(by_epoch[1]) < np.mean(by_epoch[0]):
                raise AssertionError(f"hapi_fit {path}: the losses are not "
                                     f"finite or did not fall: {by_epoch}")
            if not all(0.0 <= a <= 1.0 for a in accs):
                raise AssertionError(f"hapi_fit {path}: accuracy outside "
                                     f"[0, 1]: {accs}")
            row['paths'][path] = {
                'setup_s': setup_s, 'fit_wall_s': wall,
                'step_ms': {'median': float(np.median(ms)), 'min': min(ms),
                            'max': max(ms), 'per_step': ms},
                'samples_per_s': TRAIN_BATCH / (float(np.median(ms)) / 1e3),
                'over_train_fp32_step': float(np.median(ms)) / train_step_ms,
                'host_syncs': n_sync, 'host_syncs_per_step': n_sync / steps,
                'sync_sites': where[:6],
                'loader_wait_ms': {'median': 1e3 * float(np.median(waits)),
                                   'max': 1e3 * max(waits)},
                'losses_by_epoch': by_epoch, 'accuracy_top1': accs,
                'epoch_mean_losses': [float(np.mean(e)) for e in by_epoch],
                'lr_last': model._optimizer.get_lr(),
                'held_before_bytes': held,
                'own_peak_bytes': torch.cuda.max_memory_allocated() - held}
        first = [row['paths'][p]['losses_by_epoch'][0][0]
                 for p in ('eager', 'jit')]
        check('hapi_fit: eager against jit first loss',
              abs(first[0] - first[1]) / abs(first[1]), 1e-3)
        t0 = time.perf_counter()
        logs = model.evaluate(evals, batch_size=TRAIN_BATCH, num_workers=2,
                              verbose=0)
        evaluate_ms = 1e3 * (time.perf_counter() - t0) / eval_batches
        t0 = time.perf_counter()
        pred = model.predict(evals, batch_size=TRAIN_BATCH, num_workers=2)
        predict_ms = 1e3 * (time.perf_counter() - t0) / eval_batches
        counts = kernels.launch_counts()    # ... read right after it
        forwards = 2 * HAPI_EPOCHS * eval_batches + 2 * eval_batches
        want = {n: 2 * steps * c + forwards * FORWARD_LAUNCHES[n]
                for n, c in TRAIN_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"hapi_fit: launches {counts}, expected "
                                 f"{want}")
        shapes = [tuple(o.shape) for o in pred[0]]
        if len(pred) != eval_batches or shapes != [
                (TRAIN_BATCH, SEQ * 15 // 100, 30522), (TRAIN_BATCH, 2)] or \
                not all(np.isfinite(o).all() for b in pred for o in b) or \
                not np.isfinite(logs['loss']) or not all(
                    0.0 <= logs[n] <= 1.0 for n in ('acc_top1', 'acc_top5')):
            raise AssertionError(f"hapi_fit: predict shapes {shapes}, "
                                 f"evaluate {logs}")
        row.update({'evaluate': logs, 'evaluate_ms_per_batch': evaluate_ms,
                    'predict_ms_per_batch': predict_ms,
                    'predict_shapes': shapes,
                    'launches_per_step': TRAIN_LAUNCHES,
                    'launches_per_forward': FORWARD_LAUNCHES,
                    'launches': counts})
        # outside the counted path: one train_batch a path, profiled (the
        # eager one on a fresh model of the same weights)
        batch = next(iter(io.DataLoader(train, batch_size=TRAIN_BATCH,
                                        device=dev)))
        for path in ('jit', 'eager'):
            if path == 'eager':
                del model
                torch.cuda.empty_cache()
                model = _hapi_model(seed + 3, 24, 0.1, False)
            model.train_batch(*batch)
            torch.cuda.synchronize()
            prof = phase_profile(f'hapi train_batch ({path})',
                                 lambda: model.train_batch(*batch),
                                 TRAIN_ROUTES, top_n=12,
                                 batch=[TRAIN_BATCH, SEQ])
            row['paths'][path]['profiled_step'] = {
                'wall_ms': prof['wall_ms'],
                'device_busy_ms': prof['device_busy_ms'],
                'device_idle_share': prof['device_idle_share'],
                'device_events': prof['device_events']}
        del model, batch
        model = None
        torch.cuda.empty_cache()
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
        row['accuracy_metric'] = _metric_costs(flush)
        del flush
    finally:
        del model
        shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(row)
    return counts


# ---------------------------------------------------------------------------
# the training side's telemetry: engine.fit and Model.fit with it on, the
# cost ledger, the rank flusher and aggregator, the doctor
# ---------------------------------------------------------------------------

# the ledger's count of train_fit's first dispatch against fit_flops()
LEDGER_FLOPS_TOL = 0.05
# the doctor's memory_pressure, fed the ledger's peak: quiet at the card's
# budget, warning at a budget of 1.1x the peak, critical at 0.9x
PRESSURE_BUDGETS = {'warning': 1.1, 'critical': 0.9}


def fit_flops(cfg, batch, seq, masked, k):
    """The operations one dispatch of ``train_fit``'s step does (``k``
    steps), counted as the cost ledger counts them: every matrix product
    at 2 m n k, forward and both backward products (the tied MLM decoder,
    the pooler and NSP head included); each kernel's own work by its
    formula (attention 4 + 6 + 8 operations a query-key pair and head
    dim, the forward, dQ and dK/dV; add+LayerNorm 9 and LayerNorm 8 an
    element; the mask gradient 1); elementwise torch ops 0 (the flop
    counter counts none) -> {part: operations}."""
    T, H, F = batch * seq, cfg.hidden_size, cfg.intermediate_size
    L, heads, V = cfg.num_hidden_layers, cfg.num_attention_heads, \
        cfg.vocab_size
    M, d = batch * masked, H // heads
    forward = (L * 2 * T * (4 * H * H + 2 * H * F)     # q, k, v, out, FFN
               + 2 * M * H * H + 2 * M * H * V          # MLM head, decoder
               + 2 * batch * H * H + 2 * batch * H * 2)  # pooler, NSP
    parts = {'products': 3 * forward,                  # forward, dX, dW
             'attention': L * 18 * batch * heads * seq * seq * d,
             'add_layer_norm': 2 * L * 9 * T * H,
             'layer_norm': 8 * (T + M) * H,
             'dropout_grad': 2 * L * T * H}
    return {n: float(k * v) for n, v in parts.items()}


def _telemetry_fit(seed, cfg, data, on, **kw):
    """``train_fit``'s recipe (O1 fp16, ``GradScaler``, ``NanGuard``,
    microbatch 2, Lamb with the clip under ``fit_schedule``) through
    ``engine.fit`` on a fresh model from ``seed``, telemetry on or off,
    under the sync debug mode's count -> (report, host syncs, where, the
    launches, wall s, the peak bytes the fit added over what was
    allocated before its model)."""
    from paddle_tpu_torch import amp, engine, kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.resilience import NanGuard
    from paddle_tpu_torch.text.bert import BertForPretraining
    dev = torch.device('cuda', 0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = BertForPretraining(cfg, device=dev, generator=gen).train()
    opt, _ = fit_optimizer()
    if on:
        obs.enable()
    else:
        obs.disable()

    def run():
        with amp.auto_cast(level='O1', dtype='float16'):
            return engine.fit(model, model.pretraining_loss, opt, data,
                              microbatch=2, log_every=FIT_LOG_EVERY,
                              nan_guard=NanGuard(), scaler=GradScaler(),
                              prefetch=2, **kw)
    try:
        kernels.reset_launch_counts()       # the path: one fit call
        t0 = time.perf_counter()
        report, syncs, where = _count_syncs(run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()    # ... read right after it
    finally:
        obs.disable()
    peak = torch.cuda.max_memory_allocated() - held
    report.pop('state')
    del model, opt
    torch.cuda.empty_cache()
    return report, syncs, where, counts, wall, peak


def _add_counts(total, counts):
    for n, c in counts.items():
        total[n] = total.get(n, 0) + c


def _checkpoint_run(seed, cfg, data, root, async_save):
    """One ``_telemetry_fit`` with a ``RankFlusher`` into a run dir and one
    save at the epoch's end, sync or async; then ``aggregate.write_merged``
    and the doctor over the merged events, the rank's snapshot and the
    cluster snapshot -> (the fit's launches, the causes and severities,
    the checkpoint.* histograms, the merged files)."""
    from paddle_tpu_torch import observability as obs
    obs.reset()
    run_dir = os.path.join(root, 'run_async' if async_save else 'run_sync')
    obs.enable()
    flusher = obs.start_rank_flusher(run_dir)
    if flusher is None:
        raise AssertionError("train_telemetry: no rank flusher started")
    try:
        report, _, _, counts, wall, _ = _telemetry_fit(
            seed, cfg, data, True,
            checkpoint=os.path.join(root, 'ckpt_async' if async_save
                                    else 'ckpt_sync'),
            checkpoint_every=0, async_save=async_save)
    finally:
        obs.enable()
        obs.stop_rank_flusher()
        obs.disable()
    merged = obs.aggregate.write_merged(run_dir)
    cluster = obs.aggregate.cluster_snapshot(run_dir)
    head = obs.aggregate.load_rank_snapshots(run_dir)[0]
    found = obs.doctor.diagnose(events=obs.aggregate.merged_events(run_dir),
                                snapshot=head['metrics'], cluster=cluster)
    hists = {k: v for k, v in head['metrics']['histograms'].items()
             if k.startswith(('checkpoint.', 'engine.step'))}
    if report['checkpoints'] != 1 or not merged or \
            head['metrics']['counters'].get('checkpoint.saves') != 1:
        raise AssertionError(f"train_telemetry: checkpoint run "
                             f"{report}, merged {merged}, "
                             f"{head['metrics']['counters']}")
    shutil.rmtree(os.path.join(root, 'ckpt_async' if async_save
                               else 'ckpt_sync'), ignore_errors=True)
    return counts, [(d['cause'], d['severity']) for d in found], hists, {
        'merged': {k: os.path.basename(v) if isinstance(v, str) else v
                   for k, v in merged.items()},
        'flushes': flusher.flushes, 'fit_s': wall,
        'ranks': cluster['n_ranks']}


def phase_train_telemetry(seed, card):
    """The training side's telemetry at BERT-large width (24 layers, batch
    8 x 512, ``train_fit``'s recipe through ``engine.fit``, 10 dispatches
    of 2 steps a fit, under ``deterministic()``):

    1. four fits from one seed with telemetry off, on, on, off: the same
       launches, bitwise the same losses, host syncs with it on at most
       ceil(10 / ``sync_every``) = 1 more (the ``engine.step`` span's
       sampled wait); step ms (each fit's wall over its steps) printed,
       not held;
    2. a fit with one sync save and a ``RankFlusher`` into a run dir,
       ``aggregate.write_merged``, the doctor over the merged events, the
       rank's snapshot and the cluster snapshot: ``checkpoint_stall``
       named; then with one async save: quiet; the ``checkpoint.*``
       histograms printed;
    3. the first telemetry-on fit's cost-ledger entry: FLOPs within
       ``LEDGER_FLOPS_TOL`` of ``fit_flops``, bytes, peak against the fit's
       own ``max_memory_allocated``, the roofline at the card's peaks;
       the doctor's ``memory_pressure`` quiet at the card's budget,
       warning and critical at ``PRESSURE_BUDGETS`` x the peak;
    4. ``Model.fit`` on ``phase_hapi_fit``'s model, jit, one epoch, with
       telemetry on: a ``TelemetryCallback`` attached by itself, one
       ``step`` event a step, ``input_bound`` quiet; ``/diagnosis`` and
       ``/costs`` from a live endpoint equal to the in-process values; a
       flight dump carrying the ledger's summary.
    -> the launches of every telemetry-on run, each zeroed before it and
    read after it."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.text.bert import bert_large
    cfg = bert_large()
    k = 2
    x, y = _pretraining_batch(np.random.RandomState(seed), TRAIN_BATCH,
                              cfg.vocab_size)
    data = [(x, y)] * (k * FIT_DISPATCHES)
    root = tempfile.mkdtemp(prefix='train_telemetry_')
    t_phase = time.perf_counter()
    path = {}
    row = {'phase': 'train_telemetry', 'model': 'bert_large pretraining',
           'entry': 'engine.fit, hapi.Model.fit', 'card': card,
           'batch': [TRAIN_BATCH, SEQ], 'microbatch': k,
           'dispatches_per_fit': FIT_DISPATCHES,
           'dtype': 'amp.auto_cast O1 float16 on fp32 parameters',
           'sync_every': obs.sync_every()}
    try:
        obs.disable()
        obs.reset()
        # 1. off, on, on, off
        turns, ledger = [], None
        with deterministic() as nondeterministic:
            for on in TELEMETRY_TURNS:
                obs.reset()
                report, syncs, where, counts, wall, peak = _telemetry_fit(
                    seed, cfg, data, on)
                turns.append({'telemetry': on, 'losses': report['loss'],
                              'host_syncs': syncs, 'sync_sites': where,
                              'launches': counts, 'fit_s': wall,
                              'step_ms': 1e3 * wall / report['steps'],
                              'peak_bytes': peak,
                              'spans': obs.snapshot()['counters'].get(
                                  'engine.step.calls', 0),
                              # the first dispatch's is the capture's
                              'engine_step_ms': obs.snapshot()[
                                  'histograms'].get('engine.step_ms')})
                if on:
                    _add_counts(path, counts)
                    if ledger is None:
                        (ledger,) = obs.costs.ledger()
                        first_on = turns[-1]
        off = [t for t in turns if not t['telemetry']]
        budget = -(-FIT_DISPATCHES // max(obs.sync_every(), 1))
        for t in turns:
            if t['launches'] != turns[0]['launches'] or \
                    t['losses'] != turns[0]['losses']:
                raise AssertionError(
                    f"train_telemetry: telemetry {t['telemetry']} changed "
                    f"the fit: launches {t['launches']} against "
                    f"{turns[0]['launches']}, losses {t['losses']} against "
                    f"{turns[0]['losses']}")
            if t['telemetry'] and (t['host_syncs'] > min(
                    o['host_syncs'] for o in off) + budget or
                    t['spans'] != FIT_DISPATCHES):
                raise AssertionError(
                    f"train_telemetry: {t['host_syncs']} host syncs with "
                    f"telemetry on ({t['spans']} engine.step spans), off "
                    f"{[o['host_syncs'] for o in off]}, at most {budget} "
                    f"more: {t['sync_sites']}")
        row['turns'] = turns
        row['ops_without_a_deterministic_version'] = nondeterministic
        row['host_sync_budget_on'] = budget
        on_ms = [t['step_ms'] for t in turns if t['telemetry']]
        off_ms = [t['step_ms'] for t in off]
        row['step_ms_on_over_off'] = sum(on_ms) / sum(off_ms)

        # 3. the ledger entry of the first telemetry-on fit's step
        want = fit_flops(cfg, TRAIN_BATCH, SEQ, max(SEQ * 15 // 100, 1), k)
        analytic = sum(want.values())
        peaks = obs.costs.device_peaks('gpu')
        own_peak = first_on['peak_bytes']
        entry = {key: ledger[key] for key in (
            'program', 'kind', 'flops', 'bytes_accessed', 'peak_bytes',
            'argument_bytes', 'output_bytes', 'temp_bytes', 'alias_bytes')}
        entry.update(
            meta=ledger['meta'], roofline=obs.costs.roofline(
                ledger['flops'], ledger['bytes_accessed'], 'gpu'),
            analytic_flops=analytic, analytic_parts=want,
            flops_over_analytic=ledger['flops'] / analytic,
            fit_own_peak_bytes=own_peak,
            peak_over_fit_own_peak=ledger['peak_bytes'] / own_peak,
            card_peaks=peaks,
            measured_dispatch_ms=2 * first_on['step_ms'],
            off_dispatch_ms=2 * min(off_ms))
        entry['roofline_share_of_off_dispatch'] = \
            entry['roofline']['est_ms'] / entry['off_dispatch_ms']
        gauge = {'gauges': {f"cost.peak_bytes{{program={ledger['program']}}}":
                            ledger['peak_bytes']}}
        pressure = {'card': [(d['severity'], d['evidence']['budget_bytes'])
                             for d in obs.doctor.detect_memory_pressure(
                                 snapshot=gauge)],
                    'card_budget': obs.costs.hbm_budget()}
        for severity, times in PRESSURE_BUDGETS.items():
            found = list(obs.doctor.detect_memory_pressure(
                snapshot=gauge, hbm_budget=int(times * ledger['peak_bytes'])))
            pressure[f'{times}x'] = [(d['severity'], d['evidence']['ratio'])
                                     for d in found]
            if [d['severity'] for d in found] != [severity]:
                raise AssertionError(f"train_telemetry: memory_pressure at "
                                     f"{times}x the peak: {found}")
        entry['memory_pressure'] = pressure
        row['ledger'] = entry
        if abs(entry['flops_over_analytic'] - 1.0) > LEDGER_FLOPS_TOL or \
                pressure['card'] or not ledger['meta']['peak_measured']:
            raise AssertionError(f"train_telemetry: the ledger's entry "
                                 f"{entry}")

        # 2. checkpoints through the rank flusher and the aggregator
        ckpt = {}
        for async_save in (False, True):
            counts, causes, hists, files = _checkpoint_run(
                seed, cfg, data, root, async_save)
            _add_counts(path, counts)
            ckpt['async' if async_save else 'sync'] = {
                'diagnosis': causes, 'histograms': hists, **files}
        named = [c for c, _ in ckpt['sync']['diagnosis']]
        quiet = [c for c, _ in ckpt['async']['diagnosis']]
        # train_resume's measurements of the same state (PERF.md, 5)
        ckpt['train_resume_measured'] = {'sync_save_ms': 11180.0,
                                         'async_stall_ms': 32.3,
                                         'async_commit_ms': 12100.0}
        row['checkpoints'] = ckpt
        # a detector that raised is a 'doctor_error' finding: a failure
        if 'checkpoint_stall' not in named or 'checkpoint_stall' in quiet \
                or 'doctor_error' in named + quiet:
            raise AssertionError(f"train_telemetry: checkpoint_stall after "
                                 f"a sync save {named}, async only {quiet}")

        # 4. Model.fit with telemetry on
        row['hapi'], counts = _telemetry_hapi(seed, root)
        _add_counts(path, counts)
    finally:
        obs.disable()
        obs.reset()
        shutil.rmtree(root, ignore_errors=True)
    row['phase_s'] = time.perf_counter() - t_phase
    row['launches'] = path
    emit(row)
    return {n: path.get(n, 0) for n in SOURCES}


def _telemetry_hapi(seed, root):
    """Part 4 of ``phase_train_telemetry`` -> (a row, the fit's
    launches)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    obs.reset()
    obs.enable(log_dir=os.path.join(root, 'hapi_log'))
    srv = None
    try:
        model = _hapi_model(seed, 24, 0.1, True)
        train, _ = _hapi_sets(seed + 6, HAPI_TRAIN, HAPI_EVAL, 30522)
        kernels.reset_launch_counts()       # the path: Model.fit
        np.random.seed(seed)
        model.fit(train, batch_size=TRAIN_BATCH, epochs=1, shuffle=True,
                  num_workers=2, verbose=0, log_freq=1)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()    # ... read right after it
        log = obs.event_log()
        kinds = [e['ev'] for e in log]
        steps = HAPI_TRAIN // TRAIN_BATCH
        diagnosis = [(e['cause'], e['severity']) for e in log
                     if e['ev'] == 'diagnosis']
        wait = obs.snapshot()['histograms'].get('dataloader.next_wait_ms')
        srv = obs.MetricsServer(port=0).start()
        scraped = {r: _http_get(srv.url + r) for r in ('/diagnosis',
                                                       '/costs')}
        inproc = {'/diagnosis': srv.diagnosis(), '/costs': srv.costs()}
        same = {r: scraped[r][0] == 200 and json.loads(scraped[r][1]) ==
                json.loads(json.dumps(inproc[r], sort_keys=True,
                                      default=repr)) for r in scraped}
        dumped = obs.flight.dump('train_telemetry_probe',
                                 run_dir=os.path.join(root, 'flight'))
        dump = obs.flight.load_dump(dumped) if dumped else None
        out = {'steps': steps, 'step_events': kinds.count('step'),
               'events': sorted(set(kinds)), 'diagnosis': diagnosis,
               'loader_wait_ms': wait, 'endpoint_equal': same,
               'ledger_programs': len(obs.costs.ledger()),
               'flight_dump_costs': dump.get('costs') if dump else None,
               'exports': sorted(os.listdir(os.path.join(root,
                                                         'hapi_log')))}
    finally:
        if srv is not None:
            srv.stop()
        obs.disable()
    if kinds[:1] != ['train_begin'] or out['step_events'] != steps or \
            {'input_bound', 'doctor_error'} & {c for c, _ in diagnosis} or \
            not all(same.values()) or not out['flight_dump_costs'] or \
            not out['flight_dump_costs']['programs'] or \
            not {'events.jsonl', 'trace.json'} <= set(out['exports']):
        raise AssertionError(f"train_telemetry: Model.fit {out}")
    del model
    torch.cuda.empty_cache()
    return out, counts


# -- data parallelism (distributed/) -----------------------------------------

# the collective phase's deadline, and the slow collective that outlasts it
COLLECTIVE_DEADLINE_S = 0.5
COLLECTIVE_DELAY_S = 1.0
# dp_two_ranks: two ranks of 4 rows each on the one card (gloo), 3 steps
DP_RANKS = 2
DP_STEPS = 3
DP_JOIN_S = 300
# a step of dp_two_ranks' 2-layer model at p = 0: PARITY_LAUNCHES without
# the mask gradient, which runs only where a dropout drew a mask
DP_LAUNCHES = {**PARITY_LAUNCHES, 'dropout_grad': 0}
DP_LR = {'adamw': 1e-4, 'sgd': 1e-3}


def phase_collectives(card):
    """``distributed.init_parallel_env()`` on the one card: NCCL for CUDA
    tensors (gloo for CPU ones) at world 1, through a ``file://`` store;
    each collective of the port's API on CUDA tensors in fp32 and bf16
    (``all_reduce`` SUM, MAX, MIN and PROD, ``all_gather``, ``broadcast``,
    ``reduce``, ``scatter``, ``reduce_scatter``, ``alltoall``,
    ``barrier``) against its closed form at world 1 (each rank's value is
    the answer), with telemetry on, the ``collective.<op>.calls`` /
    ``.bytes`` counters exact; an all-gather under a deadline that it
    meets; ``faultinject.slow_collective`` past ``set_timeout`` raising
    ``DistributedTimeoutError`` naming the op. The group is left for
    ``phase_train_sharded``, which destroys it."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.resilience import faultinject as fi
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    dist.init_parallel_env()
    dist.barrier()                        # the NCCL communicator is up
    init_ms = 1e3 * (time.perf_counter() - t0)
    backend = str(torch.distributed.get_backend())
    if 'cuda:nccl' not in backend or dist.get_world_size() != 1 or \
            dist.get_rank() != 0:
        raise AssertionError(f"collectives: backend {backend!r}, world "
                             f"{dist.get_world_size()}")
    c = dist.collective
    rows = {}
    obs.enable()
    try:
        for dtype in (torch.float32, BF16):
            obs.reset()
            c.reset_collective_counts()
            # halves up to 4: exact in bf16, their products too
            x = torch.arange(1, 9, device=dev).to(dtype) * 0.5
            n = x.numel() * x.element_size()
            got = {}
            for op in ('sum', 'max', 'min', 'prod'):
                got[f'all_reduce_{op}'] = c.all_reduce(x.clone(), op=op)
            parts = []
            got['all_gather'] = c.all_gather(parts, x)[0]
            got['broadcast'] = c.broadcast(x.clone(), src=0)
            got['reduce'] = c.reduce(x.clone(), dst=0)
            got['scatter'] = c.scatter(torch.zeros_like(x), [x], src=0)
            got['reduce_scatter'] = c.reduce_scatter(None, x)
            got['alltoall'] = c.alltoall([x])[0]
            c.barrier()
            wrong = [k for k, v in got.items()
                     if v.dtype != dtype or not torch.equal(v, x)]
            if wrong or len(parts) != 1:
                raise AssertionError(f"collectives {dtype}: {wrong} differ "
                                     f"from the closed form")
            want = {'all_reduce': (3, 3 * n), 'all_gather': (2, 2 * n),
                    'broadcast': (1, n), 'reduce': (1, n),
                    'scatter': (1, n), 'reduce_scatter': (1, n),
                    'alltoall': (1, n), 'barrier': (1, 4)}
            counters = {k: v for k, v in obs.snapshot()['counters'].items()
                        if k.startswith('collective.')}
            expect = {}
            for op, (calls, nbytes) in want.items():
                expect[f'collective.{op}.calls'] = calls
                expect[f'collective.{op}.bytes'] = nbytes
            own = {f'collective.{op}.{k}': v
                   for op, cnt in c.collective_counts().items()
                   for k, v in cnt.items()}
            if counters != expect or own != expect:
                raise AssertionError(f"collectives {dtype}: counters "
                                     f"{counters} / {own}, expected "
                                     f"{expect}")
            rows[str(dtype)[6:]] = {'ops': sorted(got), 'counters': counters}
    finally:
        obs.disable()
        obs.reset()
    x = torch.ones(1024, device=dev)
    prev = dist.set_timeout(COLLECTIVE_DEADLINE_S)
    try:
        met = c.all_gather(None, x)               # issued, waited, in time
        torch.cuda.synchronize()
        raised = None
        try:
            with fi.slow_collective(COLLECTIVE_DELAY_S, ops=['all_reduce']):
                c.all_reduce(x)
        except dist.DistributedTimeoutError as e:
            raised = {'op': e.op, 'timeout_s': e.timeout,
                      'missing_ranks': e.missing_ranks}
    finally:
        dist.set_timeout(prev)
    if not torch.equal(met[0], x) or raised is None or \
            raised['op'] != 'all_reduce':
        raise AssertionError(f"collectives: the deadline's cases: {raised}")
    row = {'phase': 'collectives', 'card': card, 'backend': backend,
           'world': 1, 'nccl': list(torch.cuda.nccl.version()),
           'init_and_first_barrier_ms': init_ms, 'dtypes': rows,
           'deadline': {'met': 'all_gather', 'expired': raised,
                        'deadline_s': COLLECTIVE_DEADLINE_S,
                        'delay_s': COLLECTIVE_DELAY_S}}
    emit(row)
    return row


def _fsdp_plan(model, k):
    """The collectives a dispatch of ``phase_train_sharded``'s FSDP step
    issues at world 1 (``k`` microbatches, Lamb + the global-norm clip,
    scaler and guard): per step one all-gather of the parameters' pieces,
    one reduce-scatter of their gradients, one all-reduce of the whole
    leaves' gradients (when there are any) and one of the loss and ``ok``;
    the clip's norms (one all-gather) and Lamb's (two: the weights' and
    the updates')."""
    from paddle_tpu_torch.distributed.sharding import shard_dim
    whole = [n for n, p in model.named_parameters()
             if shard_dim(tuple(p.shape), 1, 1024) is None]
    per_step = {'all_gather': 1 + 1 + 2, 'reduce_scatter': 1,
                'all_reduce': 1 + (1 if whole else 0)}
    return {op: k * n for op, n in per_step.items()}, whole


def _fit_state_on_device(model, opt):
    """Device copies of ``model``'s parameters and ``opt``'s slots."""
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            {n: {s: v.detach().clone() for s, v in slots.items()
                 if isinstance(v, torch.Tensor)}
             for n, slots in opt._accumulators.items()})


def _bitwise(a, b):
    """The names where two ``_fit_state_on_device`` copies differ."""
    bad = [n for n in a[0] if not torch.equal(a[0][n], b[0][n])]
    for n, slots in a[1].items():
        for s, v in slots.items():
            w = b[1].get(n, {}).get(s)
            if w is None or v.dtype != w.dtype or not torch.equal(v, w):
                bad.append(f'{n}.{s}')
    return bad


def _sharded_fit(seed, cfg, data, sharding, layers=None, **kw):
    """``phase_train_fit``'s recipe on a model from ``seed``: BERT-large
    (or ``layers`` of it), O1 fp16, ``GradScaler``, ``nan_guard``, Lamb
    with the global-norm clip under ``fit_schedule``, microbatch 2, one
    ``engine.fit`` over ``data``, with ``sharding`` -> (model, optimizer,
    scaler, guard, report, host syncs, their places, wall s)."""
    from paddle_tpu_torch import amp, engine
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.resilience import NanGuard
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    bcfg = bert_large()
    if layers is not None:
        bcfg.num_hidden_layers = layers
    model = BertForPretraining(bcfg, device=dev, generator=gen).train()
    opt, _ = fit_optimizer()
    scaler, guard = GradScaler(), NanGuard()

    def run():
        with amp.auto_cast(level='O1', dtype='float16'):
            return engine.fit(model, model.pretraining_loss, opt, data,
                              microbatch=2, log_every=FIT_LOG_EVERY,
                              nan_guard=guard, scaler=scaler, prefetch=2,
                              sharding=sharding, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report, n_sync, where = _count_syncs(run)
    torch.cuda.synchronize()
    return model, opt, scaler, guard, report, n_sync, where, \
        time.perf_counter() - t0


def phase_train_sharded(seed, card, fit_row):
    """BERT-large pretraining through ``engine.fit`` in ``train_fit``'s
    recipe (O1 fp16, ``GradScaler``, ``nan_guard``, Lamb with the
    global-norm clip under ``fit_schedule``, microbatch 2,
    ``FIT_DISPATCHES`` dispatches) with ``sharding=ShardingConfig(
    fsdp=True)`` in the NCCL group at world 1, against the same fit
    without a process group, both under ``deterministic()`` (the step
    repeats to the bit only there; PERF.md §7):

    - the logged losses, the final parameters, Lamb's slots, the loss
      scale and the guard's counters bit for bit (at world 1 every
      collective is a copy and every cross-rank sum adds one term);
    - the sharded fit's launches exactly ``TRAIN_LAUNCHES`` a step, its
      collectives exactly ``_fsdp_plan`` a dispatch plus the write-back's
      gathers at the end (the parameters and Lamb's two moments), its
      host syncs within ``train_fit``'s budget;
    - printed, not held: both fits' step ms (under the deterministic
      mode) beside ``train_fit``'s, then both again in the other order
      (sharded first) and the ratio of the sums, the sharded fit's peak
      memory, the ``sharding.*`` gauges (a rank's resident pieces: the
      step releases the gathered parameters after its update);
    - a sharded checkpoint of a 2-layer BERT at full width restored into
      an unsharded fit, saved from it and restored into a sharded fit
      again, each state bit for bit the saved one;

    then the process group is destroyed. -> (the sharded fit's launch
    counts, a row)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import engine, kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.text.bert import bert_large
    cfg = bert_large()
    x, y = _pretraining_batch(np.random.RandomState(seed), TRAIN_BATCH,
                              cfg.vocab_size)
    k = 2
    data = [(x, y)] * (k * FIT_DISPATCHES)
    row = {'phase': 'train_sharded', 'model': 'bert_large pretraining',
           'entry': 'engine.fit(sharding=ShardingConfig(fsdp=True))',
           'card': card, 'world': 1, 'batch': [TRAIN_BATCH, SEQ],
           'dtype': 'amp.auto_cast O1 float16 on fp32 parameters',
           'microbatch': k, 'dispatches': FIT_DISPATCHES}
    root = tempfile.mkdtemp(prefix='train_sharded_')
    try:
        # the baseline: no process group (phase_collectives destroyed it)
        dist.env.shutdown()
        with deterministic() as nondet:
            m, opt, scaler, guard, rep, _, _, wall = _sharded_fit(
                seed, cfg, data, None)
            plain = _fit_state_on_device(m, opt)
            plain_losses, plain_scale = rep['loss'], scaler.get_loss_scaling()
            plain_guard = (guard.total_steps, guard.skipped_steps)
            row['unsharded_step_ms'] = 1e3 * wall / rep['steps']
            del m, opt, rep
            torch.cuda.empty_cache()
            dist.init_parallel_env()
            dist.barrier()                # the communicator is up
            kernels.reset_launch_counts()     # the main path: the fit
            dist.collective.reset_collective_counts()
            torch.cuda.reset_peak_memory_stats()
            m, opt, scaler, guard, rep, n_sync, where, wall = _sharded_fit(
                seed, cfg, data, dist.ShardingConfig(fsdp=True))
            counts = kernels.launch_counts()  # ... read right after it
            collectives = dist.collective.collective_counts()
            peak = torch.cuda.max_memory_allocated()
            sharded = _fit_state_on_device(m, opt)
        row['ops_without_a_deterministic_version'] = nondet
        bad = _bitwise(plain, sharded)
        if rep['loss'] != plain_losses or bad or \
                scaler.get_loss_scaling() != plain_scale or \
                (guard.total_steps, guard.skipped_steps) != plain_guard:
            raise AssertionError(
                f"train_sharded: not bitwise the unsharded fit: losses "
                f"{rep['loss']} against {plain_losses}, {len(bad)} tensors "
                f"differ ({bad[:6]}), scale {scaler.get_loss_scaling()} "
                f"against {plain_scale}")
        del plain
        want = {n: k * FIT_DISPATCHES * c for n, c in TRAIN_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"train_sharded: launches {counts}, "
                                 f"expected {want}")
        per_dispatch, whole = _fsdp_plan(m, k)
        plan = {op: FIT_DISPATCHES * n for op, n in per_dispatch.items()}
        plan['all_gather'] += 3            # write-back: params, 2 moments
        calls = {op: c['calls'] for op, c in collectives.items()}
        if calls != plan:
            raise AssertionError(f"train_sharded: collectives {calls}, the "
                                 f"plan {plan}")
        sync_every = min(FIT_LOG_EVERY, -(-guard.max_consecutive_skips // k))
        budget = len(rep['loss']) + rep['dispatches'] // sync_every + 1
        if n_sync > budget:
            raise AssertionError(f"train_sharded: {n_sync} host syncs, the "
                                 f"fit cadence allows {budget}: {where}")
        # the gauges, on the trained model (telemetry on for the init)
        obs.enable()
        try:
            step = engine.build_train_step(
                net=m, loss=m.pretraining_loss, optimizer=opt,
                sharding=dist.ShardingConfig(fsdp=True))
            state = step.init_state()
            gauges = {g: v for g, v in obs.snapshot()['gauges'].items()
                      if g.startswith('sharding.')}
        finally:
            obs.disable()
            obs.reset()
        # at rest (after a dispatch) the module holds no gathered
        # parameter: its bytes are the whole leaves' alone
        step(state, (x, y))
        torch.cuda.synchronize()
        at_rest = {'module_param_bytes': sum(
            q.numel() * q.element_size() for q in m.parameters()),
            'whole_leaf_bytes': sum(
                q.numel() * q.element_size() for n, q in
                m.named_parameters() if n in whole),
            'memory_allocated_bytes': torch.cuda.memory_allocated()}
        if at_rest['module_param_bytes'] != at_rest['whole_leaf_bytes']:
            raise AssertionError(f"train_sharded: the module holds "
                                 f"gathered parameters at rest: {at_rest}")
        del state
        del step, m, opt, sharded
        torch.cuda.empty_cache()
        row.update({
            'losses_logged': rep['loss'], 'bitwise_unsharded': True,
            'sharded_step_ms': 1e3 * wall / rep['steps'],
            'train_fit_step_ms': fit_row['step_ms']['median'],
            'launches_per_step': TRAIN_LAUNCHES, 'launches': counts,
            'collectives': collectives,
            'collective_plan_per_dispatch': per_dispatch,
            'whole_leaves': whole, 'host_syncs': n_sync,
            'host_sync_budget': budget,
            'max_memory_allocated_bytes': peak, 'gauges': gauges,
            'at_rest': at_rest,
            'checkpoint_round_trip': _sharded_checkpoint_round_trip(
                seed, cfg, x, y, root)})
        # the same two fits again in the other order (sharded first), so
        # that what the first of two fits pays falls on each side once
        with deterministic():
            again = {}
            for shard in (dist.ShardingConfig(fsdp=True), None):
                if shard is None:
                    dist.env.shutdown()
                m, opt, _, _, rep, _, _, wall = _sharded_fit(
                    seed, cfg, data, shard)
                again['sharded' if shard else 'unsharded'] = \
                    1e3 * wall / rep['steps']
                del m, opt, rep
                torch.cuda.empty_cache()
        first = row['sharded_step_ms'] / row['unsharded_step_ms']
        second = again['sharded'] / again['unsharded']
        row.update({
            'unsharded_first': {'unsharded_step_ms':
                                row['unsharded_step_ms'],
                                'sharded_step_ms': row['sharded_step_ms'],
                                'ratio': first},
            'sharded_first': {'sharded_step_ms': again['sharded'],
                              'unsharded_step_ms': again['unsharded'],
                              'ratio': second},
            'sharded_over_unsharded': (
                (row['sharded_step_ms'] + again['sharded'])
                / (row['unsharded_step_ms'] + again['unsharded']))})
    finally:
        shutil.rmtree(root, ignore_errors=True)
        dist.env.shutdown()
    emit(row)
    return counts, row


def _sharded_checkpoint_round_trip(seed, cfg, x, y, root):
    """A 2-layer BERT at full width: a sharded fit (2 dispatches, its
    checkpoint at the end); an unsharded fit resumed from it (the process
    group left, nothing left to train): its state bit for bit the
    checkpoint's; that state saved and a sharded fit resumed from it: its
    state bit for bit again. -> a row."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.resilience import CheckpointManager
    data = [(x, y)] * 4
    first, second = os.path.join(root, 'sharded'), os.path.join(root,
                                                               'plain')
    t0 = time.perf_counter()
    rep = _sharded_fit(seed, cfg, data, dist.ShardingConfig(fsdp=True),
                       layers=2, checkpoint=first, async_save=False)[4]
    saved, meta = CheckpointManager(first).restore()
    dist.env.shutdown()
    back = _sharded_fit(seed + 1, cfg, data, None, layers=2,
                        resume_from=first)[4]
    bad = _state_mismatches(saved, back['state'])
    if back['resumed_from'] != 2 or bad:
        raise AssertionError(f"train_sharded checkpoint: the unsharded fit "
                             f"resumed from {back['resumed_from']}, its state "
                             f"differs at {bad[:6]}")
    CheckpointManager(second).save(back['state'], step=2, meta=meta)
    dist.init_parallel_env()
    again = _sharded_fit(seed + 2, cfg, data,
                         dist.ShardingConfig(fsdp=True), layers=2,
                         resume_from=second)[4]
    bad = _state_mismatches(saved, again['state'])
    if again['resumed_from'] != 2 or bad:
        raise AssertionError(f"train_sharded checkpoint: the sharded fit's "
                             f"state differs at {bad[:6]}")
    return {'layers': 2, 'manifest_world': CheckpointManager(
                first).load_manifest(2)['world'],
            'bytes': sum(s['size'] for s in CheckpointManager(
                first).load_manifest(2)['shards'].values()),
            'bitwise': True, 'seconds': time.perf_counter() - t0,
            'first_fit_losses': rep['loss']}


VOCAB = 30522      # bert_large()'s


def _dp_model(seed, dev, p):
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    cfg = bert_large(hidden_dropout_prob=p, attention_probs_dropout_prob=p)
    cfg.num_hidden_layers = 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    return BertForPretraining(cfg, device=dev, generator=gen).train()


def _dp_steps(seed, rank, world, data_parallel, opt='adamw'):
    """``DP_STEPS`` steps of ``build_train_step`` (``opt``: AdamW or SGD)
    on a 2-layer BERT at BERT-large widths (fp32, p = 0): rank ``rank`` of
    ``world`` on its ``TRAIN_BATCH // world`` rows (a ``DataParallel`` net
    when ``data_parallel``) -> (losses, the model, launch counts)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import engine, kernels
    from paddle_tpu_torch.optimizer import SGD, AdamW
    dev = torch.device('cuda', 0)
    model = _dp_model(seed, dev, 0.0)
    x, y = _pretraining_batch(np.random.RandomState(seed + 11), TRAIN_BATCH,
                              VOCAB)
    n = TRAIN_BATCH // world
    rows = slice(rank * n, (rank + 1) * n)
    batch = ({k: torch.from_numpy(v[rows]).to(dev) for k, v in x.items()},
             tuple(torch.from_numpy(v[rows]).to(dev) for v in y))
    net = dist.DataParallel(model) if data_parallel else model
    step = engine.build_train_step(
        net=net, loss=model.pretraining_loss,
        optimizer=(AdamW if opt == 'adamw' else SGD)(
            learning_rate=DP_LR[opt]))
    state = step.init_state()
    kernels.reset_launch_counts()
    losses = [float(step(state, batch)[1].loss) for _ in range(DP_STEPS)]
    return losses, model, kernels.launch_counts()


def _digest(model):
    import hashlib
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _param_err(model, ref):
    """The parameters' largest error, each tensor's over its largest
    entry, with a floor of 1e-3 of the model's largest entry (a bias that
    barely moved holds rounding noise on both sides, as in
    ``_compare_grads``)."""
    top = max(float(r.abs().max()) for r in ref.values())
    return max(max_err(p.detach(), ref[n]) /
               max(float(ref[n].abs().max()), 1e-3 * top)
               for n, p in model.named_parameters())


@torch.no_grad()
def _update_rel_err(model, ref, init):
    """The norm of the difference of the whole model's update from the
    reference's update (``ref`` - ``init``), over that update's norm."""
    diff = sum(float((p.detach() - ref[n]).double().square().sum())
               for n, p in model.named_parameters())
    step = sum(float((ref[n] - init[n]).double().square().sum())
               for n in ref)
    return (diff / step) ** 0.5


def _dp_rank(seed, ref_paths, probe_seed):
    """One rank of ``phase_dp_two_ranks`` (a spawned process on the card):
    the ``DataParallel`` steps with AdamW and with SGD, the parameters
    against the one-process runs' (``ref_paths``), their digests, the
    AdamW run's launches, and the attention mask probe at p = 0.1 from the
    AdamW run's model's ``DropoutState`` reseeded with ``probe_seed`` (the
    step averaged its gradients, so it keyed the state on this rank: the
    rank in its offsets' high word)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.kernels import philox
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    import torch.distributed as tdist
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    init = dict(_dp_model(int(seed), torch.device('cuda', 0),
                          0.0).named_parameters())
    for opt in ('adamw', 'sgd'):
        losses, model, counts = _dp_steps(int(seed), rank, world, True, opt)
        ref = torch.load(ref_paths[opt], map_location='cuda:0')
        out[opt] = {'losses': losses, 'launches': counts,
                    'param_err': _param_err(model, ref),
                    'param_abs_err': max(max_err(p.detach(), ref[n]) for n, p
                                         in model.named_parameters()),
                    'update_rel_err': _update_rel_err(model, ref, init),
                    'digest': _digest(model)}
        if opt == 'adamw':
            state = model.dropout_state
        del model, ref
    del init
    state.seed = philox.DropoutState(probe_seed).seed
    state.offset = 0
    seed_, offset = state.next()
    probe = attention_mask_probe(torch.float32, torch.device('cuda', 0), 128,
                                 0.1, seed_, offset)
    torch.cuda.synchronize()
    return {'rank': rank, 'world': world, 'backend':
            str(tdist.get_backend()), 'runs': out, 'offset': offset,
            'probe': {k: r.cpu().numpy().tobytes() for k, (r, _) in
                      probe.items()}}


def phase_dp_two_ranks(seed, card):
    """Two ranks on the one card through ``distributed.spawn(nprocs=2,
    backend='gloo')`` (NCCL refuses two ranks of one device; gloo
    all-reduces CUDA tensors), joined within ``DP_JOIN_S``: a 2-layer
    BERT at BERT-large widths, fp32, p = 0, ``DP_STEPS`` steps of
    ``build_train_step`` on a ``DataParallel`` net, each rank on 4 of the
    8 x 512 batch, against one process on the whole batch on the card:

    - AdamW: the global losses within ``MODEL_TOL`` (relative), the two
      ranks' parameters bit for bit equal, each rank's kernel launches
      exactly ``DP_LAUNCHES`` a step (its spawn result); its parameters'
      difference from the one process's is printed, not held (Adam moves
      an element by the sign of its gradient, and an element whose
      gradient is rounding noise moves either way in two summation
      orders): the largest over each tensor's largest entry, the largest
      absolute, and the whole update's relative norm (``_update_rel_err``);
    - SGD: the losses within ``MODEL_TOL`` and the parameters within the
      2-layer parity gate (``MODEL_TOL`` of each tensor's largest entry,
      ``_param_err``), the ranks bit for bit;
    - the attention mask probe at p = 0.1 from the ``DataParallel``
      model's ``DropoutState`` on one seed: the two ranks' masks differ,
      rank 0's is the one process's.

    -> (the ranks' summed AdamW launch counts, a row)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.kernels import philox
    root = tempfile.mkdtemp(prefix='dp_two_ranks_')
    t0 = time.perf_counter()
    alone, paths = {}, {}
    try:
        for opt in ('adamw', 'sgd'):
            losses, model, _ = _dp_steps(seed, 0, 1, False, opt)
            paths[opt] = os.path.join(root, f'{opt}.pt')
            torch.save({n: p.detach() for n, p in model.named_parameters()},
                       paths[opt])
            alone[opt] = losses
            del model
            torch.cuda.empty_cache()
        probe_seed = 0x5EED + seed
        s, off = philox.DropoutState(probe_seed).next()
        probe = {k: r.cpu().numpy().tobytes() for k, (r, _) in
                 attention_mask_probe(torch.float32, torch.device('cuda', 0),
                                      128, 0.1, s, off).items()}
        t1 = time.perf_counter()
        ctx = dist.spawn(_dp_rank, args=(seed, paths, probe_seed),
                         nprocs=DP_RANKS, backend='gloo', join=False)
        ranks = ctx.join(timeout=DP_JOIN_S)
        spawn_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if [r['rank'] for r in ranks] != [0, 1] or \
            any(r['backend'] != 'gloo' for r in ranks):
        raise AssertionError(f"dp_two_ranks: ranks {ranks}")
    want = {n: DP_STEPS * c for n, c in DP_LAUNCHES.items()}
    if any(r['runs']['adamw']['launches'] != want for r in ranks):
        raise AssertionError(
            f"dp_two_ranks: launches "
            f"{[r['runs']['adamw']['launches'] for r in ranks]}, expected "
            f"{want} a rank")
    row = {'phase': 'dp_two_ranks', 'card': card, 'entry':
           'distributed.spawn(nprocs=2, backend="gloo") + '
           'build_train_step(net=DataParallel(...))',
           'model': '2-layer BertForPretraining at bert_large widths, fp32, '
                    'p = 0', 'steps': DP_STEPS, 'lr': DP_LR,
           'rows_a_rank': TRAIN_BATCH // DP_RANKS, 'runs': {}}
    for opt in ('adamw', 'sgd'):
        runs = [r['runs'][opt] for r in ranks]
        loss_err = max(abs(a - b) / abs(b) for r in runs
                       for a, b in zip(r['losses'], alone[opt]))
        check(f'dp_two_ranks {opt}: global loss', loss_err, MODEL_TOL)
        if opt == 'sgd':
            for r, run in zip(ranks, runs):
                check(f"dp_two_ranks sgd: rank {r['rank']} parameters",
                      run['param_err'], MODEL_TOL)
        if runs[0]['digest'] != runs[1]['digest']:
            raise AssertionError(f"dp_two_ranks {opt}: the two ranks' "
                                 f"parameters differ")
        row['runs'][opt] = {
            'one_process_losses': alone[opt],
            'rank_losses': [r['losses'] for r in runs],
            'loss_rel_err': loss_err,
            'param_err': [r['param_err'] for r in runs],
            'param_abs_err': [r['param_abs_err'] for r in runs],
            'update_rel_err': [r['update_rel_err'] for r in runs],
            'parameters_held': opt == 'sgd',
            'ranks_bitwise_equal': True}
    if ranks[0]['probe'] != probe or ranks[1]['probe'] == probe or \
            ranks[1]['offset'] != 1 << 32:
        raise AssertionError("dp_two_ranks: rank 0's masks are not the one "
                             "process's, or rank 1's are the same")
    total = {n: sum(r['runs']['adamw']['launches'][n] for r in ranks)
             for n in want}
    row.update({'launches_a_rank': want,
                'mask_probe': {'rank0_is_one_process': True,
                               'rank1_differs': True,
                               'offsets': [r['offset'] for r in ranks]},
                'spawn_s': spawn_s, 'phase_s': time.perf_counter() - t0})
    emit(row)
    return total, row


# -- model parallelism (distributed/: tensor, sequence, pipeline) -----------

# the three phases: two ranks on the one card through gloo, joined within
MP_JOIN_S = 400
# tp_two_ranks: BERT-large at full width; the training steps' depth (the
# forward parity runs at the full 24 layers whatever this is)
TP_LAYERS = 24
TP_STEPS = 2
TP_LR = {'adamw': 1e-4, 'sgd': 1e-3}
# ring_two_ranks: gpt_small on 8 x 1024 tokens, two blocks of 512
RING_BATCH, RING_SEQ = 8, 1024
# pipeline_two_ranks: 4 microbatches of 2 x 512, one encoder layer a stage
PIPE_MICRO, PIPE_ROWS = 4, 2


def _tp_launches(layers, steps):
    """A BERT step's launches on a tensor-parallel rank at p = 0: each
    layer's attention kernels once on the local heads, its two
    add+LayerNorms, the embeddings' and the MLM head's LayerNorm."""
    per = {'flash_attention_fwd': layers, 'flash_attention_dq': layers,
           'flash_attention_dkv': layers, 'add_layer_norm_fwd': 2 * layers,
           'layer_norm_fwd': 2, 'dropout_grad': 0, 'rms_norm_fwd': 0}
    return {k: v * steps for k, v in per.items()}


def _tp_model(seed, layers, p=0.0):
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    cfg = bert_large(hidden_dropout_prob=p, attention_probs_dropout_prob=p)
    cfg.num_hidden_layers = layers
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    return BertForPretraining(cfg, device=dev, generator=gen)


def _tp_batch(seed, rows=TRAIN_BATCH):
    dev = torch.device('cuda', 0)
    x, y = _pretraining_batch(np.random.RandomState(seed + 11), rows, VOCAB)
    return ({k: torch.from_numpy(v).to(dev) for k, v in x.items()},
            tuple(torch.from_numpy(v).to(dev) for v in y))


def _tp_train(model, opt, batch, sharding=None):
    """``TP_STEPS`` steps -> (losses, each step's ms (synchronised), the
    step)."""
    from paddle_tpu_torch import engine
    from paddle_tpu_torch.optimizer import SGD, AdamW
    step = engine.build_train_step(
        net=model, loss=model.pretraining_loss, sharding=sharding,
        optimizer=(AdamW if opt == 'adamw' else SGD)(
            learning_rate=TP_LR[opt]))
    state = step.init_state()
    losses, ms = [], []
    for _ in range(TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state, batch)[1].loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, step


def _tp_rank(seed, paths, probe_seed):
    """One rank of ``phase_tp_two_ranks`` on the card (gloo, mesh (1,
    2)): BERT-large turned tensor-parallel by ``megatron_rules``; its
    24-layer forward against the one process's logits; ``TP_STEPS`` steps
    of ``build_train_step(sharding=ShardingConfig(tensor_parallel_degree=
    2, fsdp=False, param_rules=...))`` with SGD and AdamW (their launches
    and collectives counted, the parameters' pieces against the one
    process's); the mask probes at p = 0.1."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.sharding import (
        apply_tensor_parallel, megatron_rules, tp_pieces)
    from paddle_tpu_torch.kernels import philox
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env((1, 2), ('data', 'model'))
    rank = dist.get_rank('model')
    batch = _tp_batch(seed)
    rules = megatron_rules()
    out = {'rank': rank, 'backend': str(torch.distributed.get_backend())}
    # the forward at 24 layers, p = 0
    model = _tp_model(seed, 24).eval()
    apply_tensor_parallel(model, rules)
    with torch.no_grad():
        logits = model(**batch[0])[0]
    want = torch.load(paths['logits'], map_location='cuda:0')
    out['forward_err'] = max_err(logits, want) / float(want.abs().max())
    del model, logits, want
    torch.cuda.empty_cache()
    cfg = dist.ShardingConfig(tensor_parallel_degree=2, fsdp=False,
                              param_rules=rules)
    out['runs'] = {}
    for opt in ('sgd', 'adamw'):
        model = _tp_model(seed, TP_LAYERS).train()
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        collective.reset_collective_counts()
        losses, ms, step = _tp_train(model, opt, batch, cfg)
        counts = kernels.launch_counts()
        colls = collective.collective_counts()
        ref = tp_pieces(torch.load(paths[opt], map_location='cuda:0'), model)
        init = tp_pieces(init, model)
        out['runs'][opt] = {
            'losses': losses, 'step_ms': ms, 'launches': counts,
            'collectives': colls,
            'peak_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
            'param_err': _param_err(model, ref),
            'update_rel_err': _update_rel_err(model, ref, init),
            'heads': model.bert.encoder.layers[0].self_attn.num_heads}
        del model, step, ref, init
        torch.cuda.empty_cache()
    # p = 0.1: the TP forward draws the dense model's masks (two layers at
    # full width, against the one process's output) ...
    model = _tp_model(seed, 2, 0.1).train()
    apply_tensor_parallel(model, rules)
    dist.parallel.mask_ranks(model, True)
    with torch.no_grad():
        seq = model.bert(**{k: v for k, v in batch[0].items()
                            if k != 'masked_positions'})[0]
    want = torch.load(paths['masked'], map_location='cuda:0')
    out['masked_err'] = max_err(seq, want) / float(want.abs().max())
    out['mask_rank'] = model.dropout_state.rank
    # ... and the attention kernels read the dense model's bits of this
    # rank's heads (2 of 4), bit for bit
    s, off = philox.DropoutState(probe_seed).next()
    probe = attention_mask_probe(torch.float32, torch.device('cuda', 0),
                                 300, 0.1, s, off, heads=2,
                                 head_map=(4, 2 * rank))
    torch.cuda.synchronize()
    out['probe_wrong'] = {k: int((r != w).sum()) for k, (r, w) in
                          probe.items()}
    out['probe_bits'] = {k: int(w.numel()) for k, (_, w) in probe.items()}
    return out


def phase_tp_two_ranks(seed, card):
    """Tensor parallelism at degree 2 on the one card: two ranks through
    ``distributed.spawn(nprocs=2, backend='gloo')`` on a (data 1, model
    2) mesh, joined within ``MP_JOIN_S``, BERT-large at full width, fp32,
    p = 0, the 8 x 512 batch of ``bench.py::bench_bert``, against one
    process on the card:

    - the 24-layer forward's prediction logits within ``MODEL_TOL`` of the
      one process's (max abs over the largest);
    - ``TP_STEPS`` steps of SGD and of AdamW at ``TP_LAYERS`` layers: the
      losses within ``MODEL_TOL`` (relative); SGD's parameters (each
      rank's pieces) within the parity gate (``_param_err``); AdamW's
      update error printed, not held (``_update_rel_err``; Adam moves an
      element by the sign of its gradient);
    - each rank's launches exactly ``_tp_launches`` (the dense step's, on
      local heads), its collectives exactly the Megatron plan: two
      all-reduces a layer forward and two backward, each of B x L x
      hidden fp32, on the model axis, and nothing else;
    - the masks at p = 0.1: each rank's 2-layer forward equals the one
      process's (its attention masks are the dense model's for its heads,
      its hidden masks the other rank's), and the attention kernels read
      the dense model's bits of its heads (``attention_mask_probe`` with
      ``head_map``), bit for bit.

    -> (the ranks' summed launch counts of the AdamW run, a row)."""
    from paddle_tpu_torch import distributed as dist
    root = tempfile.mkdtemp(prefix='tp_two_ranks_')
    t0 = time.perf_counter()
    alone, paths = {}, {}
    try:
        batch = _tp_batch(seed)
        model = _tp_model(seed, 24).eval()
        with torch.no_grad():
            logits = model(**batch[0])[0]
        paths['logits'] = os.path.join(root, 'logits.pt')
        torch.save(logits, paths['logits'])
        del model, logits
        for opt in ('sgd', 'adamw'):
            model = _tp_model(seed, TP_LAYERS).train()
            torch.cuda.reset_peak_memory_stats()
            losses, ms, step = _tp_train(model, opt, batch)
            alone[opt] = {'losses': losses, 'step_ms': ms,
                          'peak_gb': torch.cuda.max_memory_allocated()
                          / 2 ** 30}
            paths[opt] = os.path.join(root, f'{opt}.pt')
            torch.save({n: p.detach() for n, p in model.named_parameters()},
                       paths[opt])
            del model, step
            torch.cuda.empty_cache()
        model = _tp_model(seed, 2, 0.1).train()
        with torch.no_grad():
            seq = model.bert(**{k: v for k, v in batch[0].items()
                                if k != 'masked_positions'})[0]
        paths['masked'] = os.path.join(root, 'masked.pt')
        torch.save(seq, paths['masked'])
        del model, seq, batch
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = dist.spawn(_tp_rank, args=(seed, paths, 0x7E5 + seed),
                           nprocs=2, backend='gloo',
                           join=False).join(timeout=MP_JOIN_S)
        spawn_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ranks = sorted(ranks, key=lambda r: r['rank'])
    if [r['rank'] for r in ranks] != [0, 1] or \
            any(r['backend'] != 'gloo' for r in ranks):
        raise AssertionError(f"tp_two_ranks: ranks {ranks}")
    want = _tp_launches(TP_LAYERS, TP_STEPS)
    act = TRAIN_BATCH * SEQ * 1024 * 4
    plan = {'model.all_reduce': {'calls': 4 * TP_LAYERS * TP_STEPS,
                                 'bytes': 4 * TP_LAYERS * TP_STEPS * act}}
    row = {'phase': 'tp_two_ranks', 'card': card, 'entry':
           'distributed.spawn(nprocs=2, backend="gloo") + init_parallel_env('
           '(1, 2)) + build_train_step(sharding=ShardingConfig('
           'tensor_parallel_degree=2, fsdp=False, param_rules='
           'megatron_rules()))',
           'model': f'BertForPretraining(bert_large()), {TP_LAYERS} layers '
                    f'trained (24 in the forward parity), fp32, p = 0',
           'steps': TP_STEPS, 'lr': TP_LR, 'rows': TRAIN_BATCH, 'runs': {}}
    for r in ranks:
        check(f"tp_two_ranks: rank {r['rank']} 24-layer forward",
              r['forward_err'], MODEL_TOL)
        check(f"tp_two_ranks: rank {r['rank']} masked forward (p = 0.1)",
              r['masked_err'], MODEL_TOL)
        if r['mask_rank'] != 0 or any(r['probe_wrong'].values()):
            raise AssertionError(f"tp_two_ranks: rank {r['rank']}'s masks "
                                 f"are not the dense model's: "
                                 f"{r['probe_wrong']}")
    for opt in ('sgd', 'adamw'):
        runs = [r['runs'][opt] for r in ranks]
        for r, run in zip(ranks, runs):
            if run['launches'] != want:
                raise AssertionError(
                    f"tp_two_ranks {opt}: rank {r['rank']} launched "
                    f"{run['launches']}, expected {want}")
            if run['collectives'] != plan:
                raise AssertionError(
                    f"tp_two_ranks {opt}: rank {r['rank']} collectives "
                    f"{run['collectives']}, expected {plan}")
            if run['heads'] != 8:
                raise AssertionError("tp_two_ranks: not 8 local heads")
        loss_err = max(abs(a - b) / abs(b) for run in runs
                       for a, b in zip(run['losses'], alone[opt]['losses']))
        check(f'tp_two_ranks {opt}: losses', loss_err, MODEL_TOL)
        if opt == 'sgd':
            for r, run in zip(ranks, runs):
                check(f"tp_two_ranks sgd: rank {r['rank']} parameters",
                      run['param_err'], MODEL_TOL)
        row['runs'][opt] = {
            'one_process': alone[opt],
            'rank_losses': [run['losses'] for run in runs],
            'loss_rel_err': loss_err,
            'rank_step_ms': [run['step_ms'] for run in runs],
            'rank_peak_gb': [run['peak_gb'] for run in runs],
            'param_err': [run['param_err'] for run in runs],
            'update_rel_err': [run['update_rel_err'] for run in runs],
            'parameters_held': opt == 'sgd',
            'collectives_a_step': {
                k: {f: v // TP_STEPS for f, v in c.items()}
                for k, c in runs[0]['collectives'].items()}}
    total = {n: sum(r['runs']['adamw']['launches'][n] for r in ranks)
             for n in want}
    row.update({'launches_a_rank': want,
                'forward_err': [r['forward_err'] for r in ranks],
                'masked_err': [r['masked_err'] for r in ranks],
                'mask_probe_bits': ranks[0]['probe_bits'],
                'spawn_s': spawn_s, 'phase_s': time.perf_counter() - t0})
    emit(row)
    return total, row


def _ring_model(seed, ring):
    from paddle_tpu_torch.text.gpt import gpt_small
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 41)
    return gpt_small(device=dev, generator=gen,
                     use_ring_attention=ring).eval()


def _ring_batch(seed):
    rs = np.random.RandomState(seed + 41)
    ids = rs.randint(0, 50304, size=(RING_BATCH, RING_SEQ + 1))
    dev = torch.device('cuda', 0)
    return (torch.from_numpy(ids[:, :-1]).to(dev),
            torch.from_numpy(ids[:, 1:]).to(dev))


def _ring_pass(model, ids, labels):
    """The logits (no grad) and every parameter's gradient of the loss."""
    with torch.no_grad():
        logits = model(ids)
    loss = model.loss(ids, labels)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return logits, loss.detach(), dict(zip(
        [n for n, _ in model.named_parameters()], grads))


def _ring_rank(seed, paths):
    """One rank of ``phase_ring_two_ranks`` on the card (gloo, a ``'seq'``
    axis of 2): gpt_small with ``use_ring_attention``, its logits and
    gradients against the one process's, the launches of the logits' and
    the loss's forward and backward."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import collective
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env((2,), ('seq',))
    model = _ring_model(seed, True)
    ids, labels = _ring_batch(seed)
    _ring_pass(model, ids, labels)       # warm-up: a process's first calls
    kernels.reset_launch_counts()
    collective.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, loss, grads = _ring_pass(model, ids, labels)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    colls = collective.collective_counts()
    want = torch.load(paths['logits'], map_location='cuda:0')
    logits_err = max_err(logits, want) / float(want.abs().max())
    del want, logits
    grad_err = max(_grad_errs(grads, torch.load(
        paths['grads'], map_location='cuda:0')).values())
    return {'rank': dist.get_rank('seq'), 'loss': float(loss),
            'logits_err': logits_err, 'grad_err': grad_err,
            'launches': counts, 'collectives': colls, 'ms': ms,
            'peak_gb': torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_ring_two_ranks(seed, card):
    """Ring attention on the one card: gpt_small (hidden 768, 12 layers, 12
    heads, vocab 50304) at full width with ``use_ring_attention=True`` on
    a ``'seq'`` axis of two gloo ranks, fp32, eval mode, 8 x 1024 tokens
    (two blocks of 512), against the one-process causal model on the same
    weights: the logits and the loss's gradient of every parameter within
    ``MODEL_TOL`` / ``GRAD_TOL`` (max abs over the largest); each rank's
    launches exactly: a layer's forward (twice: the logits, then the
    loss) on rank 0 one diagonal block, on rank 1 one full block and one
    diagonal block, the backward the same blocks' dQ and dK/dV; every
    other kernel the one process's. The gradients' error is
    ``_compare_grads``' (the key biases' true gradient is zero). -> (the
    ranks' summed launches, a row)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels
    root = tempfile.mkdtemp(prefix='ring_two_ranks_')
    t0 = time.perf_counter()
    try:
        model = _ring_model(seed, False)
        ids, labels = _ring_batch(seed)
        _ring_pass(model, ids, labels)       # warm-up
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, loss, grads = _ring_pass(model, ids, labels)
        torch.cuda.synchronize()
        alone_ms = (time.perf_counter() - t1) * 1e3
        alone_counts = kernels.launch_counts()
        paths = {'logits': os.path.join(root, 'logits.pt'),
                 'grads': os.path.join(root, 'grads.pt')}
        torch.save(logits, paths['logits'])
        torch.save(grads, paths['grads'])
        alone_loss = float(loss)
        del model, logits, grads
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = dist.spawn(_ring_rank, args=(seed, paths), nprocs=2,
                           backend='gloo', join=False).join(
                               timeout=MP_JOIN_S)
        spawn_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ranks = sorted(ranks, key=lambda r: r['rank'])
    layers = 12
    for r in ranks:
        blocks = 1 + r['rank']            # rank 1: a full and a diagonal
        want = dict(alone_counts)
        want['flash_attention_fwd'] = 2 * layers * blocks
        want['flash_attention_dq'] = layers * blocks
        want['flash_attention_dkv'] = layers * blocks
        if r['launches'] != want:
            raise AssertionError(f"ring_two_ranks: rank {r['rank']} "
                                 f"launched {r['launches']}, expected {want}")
        check(f"ring_two_ranks: rank {r['rank']} logits", r['logits_err'],
              MODEL_TOL)
        check(f"ring_two_ranks: rank {r['rank']} gradients", r['grad_err'],
              GRAD_TOL)
        check(f"ring_two_ranks: rank {r['rank']} loss",
              abs(r['loss'] - alone_loss) / abs(alone_loss), MODEL_TOL)
    row = {'phase': 'ring_two_ranks', 'card': card,
           'entry': 'distributed.spawn(nprocs=2, backend="gloo") + '
                    'init_parallel_env((2,), ("seq",)) + '
                    'gpt_small(use_ring_attention=True)',
           'tokens': [RING_BATCH, RING_SEQ], 'block': RING_SEQ // 2,
           'one_process': {'loss': alone_loss, 'ms': alone_ms,
                           'launches': alone_counts},
           'ranks': [{k: r[k] for k in ('rank', 'loss', 'logits_err',
                                        'grad_err', 'launches', 'ms',
                                        'peak_gb', 'collectives')}
                     for r in ranks],
           'spawn_s': spawn_s, 'phase_s': time.perf_counter() - t0}
    emit(row)
    return {n: sum(r['launches'][n] for r in ranks) for n in alone_counts}, \
        row


def _pipe_layers(seed):
    from paddle_tpu_torch.nn import TransformerEncoderLayer
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 53)
    return [TransformerEncoderLayer(1024, 16, 4096, dropout=0.0,
                                    activation='gelu', device=dev,
                                    generator=gen).eval()
            for _ in range(2)]


def _pipe_input(seed):
    g = torch.Generator(device='cuda')
    g.manual_seed(seed + 54)
    shape = (PIPE_MICRO * PIPE_ROWS, SEQ, 1024)
    return (torch.randn(shape, device='cuda', generator=g),
            torch.randn(shape, device='cuda', generator=g))


def _pipe_rank(seed, paths):
    """One rank (stage) of ``phase_pipeline_two_ranks`` on the card (gloo,
    a ``'pipe'`` axis of 2): ``pipeline_apply`` of the two stacked encoder
    layers on ``PIPE_MICRO`` microbatches, the output and this stage's
    gradients against the one process's, its launches."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import collective, pipeline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env((2,), ('pipe',))
    s = dist.get_rank('pipe')
    layers = _pipe_layers(seed)
    stacked = {k: v.detach().requires_grad_() for k, v in
               pipeline.stack_stage_params(
                   [dict(layer.named_parameters()) for layer in layers])
               .items()}
    x, w = _pipe_input(seed)

    def stage(params, mb):
        return torch.func.functional_call(layers[0], params, (mb,))

    def run():
        y = pipeline.pipeline_apply(stage, stacked, x, PIPE_MICRO)
        return y, torch.autograd.grad((y * w).sum(), list(stacked.values()))
    run()                                # warm-up: a process's first calls
    kernels.reset_launch_counts()
    collective.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, grads = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    ref = torch.load(paths['ref'], map_location='cuda:0')
    out_err = max_err(y, ref['y']) / float(ref['y'].abs().max())
    grad_err = max(_grad_errs({k: g[s] for k, g in zip(stacked, grads)},
                              ref['grads'][s]).values())
    return {'rank': s, 'out_err': out_err, 'grad_err': grad_err,
            'launches': counts, 'ms': ms,
            'collectives': collective.collective_counts(),
            'schedule': pipeline.schedule(2, PIPE_MICRO)}


def phase_pipeline_two_ranks(seed, card):
    """The GPipe pipeline on the one card: ``pipeline_apply`` over a
    ``'pipe'`` axis of two gloo ranks, each stage one BERT-large encoder
    layer (hidden 1024, 16 heads, FFN 4096, fp32, p = 0; the two layers'
    parameters stacked), ``PIPE_MICRO`` microbatches of ``PIPE_ROWS`` x
    512, ``checkpoint=True``, against both layers run in one process on
    the whole batch: the output and each stage's parameter gradients (of
    ``sum(y * w)``, ``w`` fixed random) within ``MODEL_TOL`` /
    ``GRAD_TOL`` (the gradients' error ``_compare_grads``'); each
    stage's launches exactly: its layer's kernels on
    each microbatch in the forward, and again (the recompute) with the
    attention's dQ and dK/dV in the backward. -> (the ranks' summed
    launches, a row)."""
    from paddle_tpu_torch import distributed as dist
    root = tempfile.mkdtemp(prefix='pipeline_two_ranks_')
    t0 = time.perf_counter()
    try:
        layers = _pipe_layers(seed)
        x, w = _pipe_input(seed)

        def run():
            y = layers[1](layers[0](x))
            return y, [torch.autograd.grad((y * w).sum(),
                                           list(layer.parameters()),
                                           retain_graph=True)
                       for layer in layers]
        run()                                # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y, grads = run()
        torch.cuda.synchronize()
        alone_ms = (time.perf_counter() - t1) * 1e3
        paths = {'ref': os.path.join(root, 'ref.pt')}
        torch.save({'y': y.detach(), 'grads': [
            dict(zip([n for n, _ in layer.named_parameters()], g))
            for layer, g in zip(layers, grads)]}, paths['ref'])
        del layers, x, w, y, grads
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = dist.spawn(_pipe_rank, args=(seed, paths), nprocs=2,
                           backend='gloo', join=False).join(
                               timeout=MP_JOIN_S)
        spawn_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ranks = sorted(ranks, key=lambda r: r['rank'])
    want = {'flash_attention_fwd': 2 * PIPE_MICRO,
            'flash_attention_dq': PIPE_MICRO,
            'flash_attention_dkv': PIPE_MICRO,
            'add_layer_norm_fwd': 4 * PIPE_MICRO, 'layer_norm_fwd': 0,
            'dropout_grad': 0, 'rms_norm_fwd': 0}
    for r in ranks:
        if r['launches'] != want:
            raise AssertionError(f"pipeline_two_ranks: stage {r['rank']} "
                                 f"launched {r['launches']}, expected "
                                 f"{want}")
        check(f"pipeline_two_ranks: stage {r['rank']} output", r['out_err'],
              MODEL_TOL)
        check(f"pipeline_two_ranks: stage {r['rank']} gradients",
              r['grad_err'], GRAD_TOL)
    row = {'phase': 'pipeline_two_ranks', 'card': card,
           'entry': 'distributed.spawn(nprocs=2, backend="gloo") + '
                    'init_parallel_env((2,), ("pipe",)) + pipeline_apply',
           'stages': 'one BERT-large encoder layer each, fp32, p = 0',
           'microbatches': [PIPE_MICRO, PIPE_ROWS, SEQ],
           'schedule': ranks[0]['schedule'], 'one_process_ms': alone_ms,
           'launches_a_stage': want,
           'ranks': [{k: r[k] for k in ('rank', 'out_err', 'grad_err', 'ms',
                                        'collectives')} for r in ranks],
           'spawn_s': spawn_s, 'phase_s': time.perf_counter() - t0}
    emit(row)
    return {n: sum(r['launches'][n] for r in ranks) for n in want}, row


# ---------------------------------------------------------------------------
# vision: ResNet-50 served and trained, the convolutional nn on the card
# ---------------------------------------------------------------------------

# the reference's formula (paddle_tpu/hapi/model_summary.py) for
# resnet50(), [1, 3, 224, 224]: 2 k (cin / groups) cout H W N a convolution
# and 2 in out the Linear, as paddle_tpu.hapi.model_summary.flops counts it
# on the CPU
RESNET50_FLOPS = 8178368512
VISION_PARITY_SHAPE = (2, 3, 64, 64)
# serve_resnet's traffic: waves of 1, 2, 4, 8 and 16 requests (one batch
# each, buckets 1-16), 64 requests in all
RESNET_WAVES = [1] * 4 + [2] * 2 + [4] * 2 + [8] * 2 + [16] * 2
RESNET_CHECKED = 3            # requests held against the port on the CPU
TRAIN_RESNET_BATCH = 256      # bench.py::_resnet50_batch
TRAIN_RESNET_WARMUP = 2
TRAIN_RESNET_STEPS = 10
HAPI_RESNET_BATCH = 32
HAPI_RESNET_EPOCHS = 6        # one batch, repeated: the loss must fall


@contextlib.contextmanager
def tf32_off():
    """cuDNN's convolutions and cuBLAS's products in full fp32 inside,
    the previous settings restored after."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def _zero_counts(counts, what):
    if any(counts.values()):
        raise AssertionError(f"{what}: the port's kernels launched "
                             f"{counts}; a vision path runs none of them")


def _vision_model(name, gen, dev, **kw):
    from paddle_tpu_torch import vision
    return getattr(vision.models, name)(device=dev, generator=gen, **kw)


def _train_pass(model, x, y):
    """One train-mode forward and backward -> (logits, loss, gradients,
    running statistics), all detached."""
    from paddle_tpu_torch.nn import functional as F
    model.train()
    model.zero_grad(set_to_none=True)
    logits = model(x)
    loss = F.cross_entropy(logits, y)
    loss.backward()
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    return logits.detach(), loss.detach(), grads, stats


def _train_errors(cpu, gpu, x, y, dev):
    """``_train_pass`` on both devices -> (errors of the logits, the loss
    and the running statistics, each over the CPU's largest entry; the
    gradients' ``_grad_errs``)."""
    want = _train_pass(cpu, x, y)
    got = _train_pass(gpu, x.to(dev), y.to(dev))
    got = [g.cpu() if isinstance(g, torch.Tensor) else
           {n: t.cpu() for n, t in g.items()} for g in got]
    return ({'logits': rel_err(got[0], want[0]),
             'loss': rel_err(got[1], want[1]),
             'running_stats': max(rel_err(got[3][n], want[3][n])
                                  for n in want[3])},
            _grad_errs(got[2], want[2]))


def phase_vision_parity(seed):
    """The port's vision models on the card against the same models (the
    same weights) on the CPU, cuDNN's TF32 off (restored after):
    ``resnet50`` at ``VISION_PARITY_SHAPE`` in train mode (logits, the
    loss, the running statistics after the forward, every gradient) and
    in eval; NHWC against NCHW and the space-to-depth stem against the
    plain stem on the card; eval forwards of ``mobilenet_v2``, ``vgg11``
    and ``LeNet``. fp32: the eval outputs within ``TOL`` of their largest
    entry; the train-mode logits, loss and running statistics within
    ``GRAD_TOL``; the fp32 gradients printed, not held: ResNet-50's
    train-mode backward at this size is ill-conditioned in fp32 (the
    port's own CPU pass in fp32 against fp64 differs by 3 % of the
    largest gradient entry, with torch's own ``batch_norm`` too), so the
    train pass is held in fp64 on both devices, every gradient within
    ``TOL`` (``_compare_grads``)."""
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    rows = {}
    with tf32_off():
        gen = torch.Generator().manual_seed(seed + 40)
        cpu = _vision_model('resnet50', gen, 'cpu', num_classes=1000)
        gpu = copy.deepcopy(cpu).to(dev)
        rs = np.random.RandomState(seed + 41)
        x = torch.from_numpy(rs.randn(*VISION_PARITY_SHAPE).astype(
            np.float32))
        y = torch.from_numpy(rs.randint(0, 1000, VISION_PARITY_SHAPE[0]))
        train, grads = _train_errors(cpu, gpu, x, y, dev)
        for key, err in train.items():
            check(f'resnet50 train {key}, GPU vs CPU', err, GRAD_TOL)
        worst = max(grads, key=grads.get)
        rows['fp32_train'] = {**train, 'gradients_worst': grads[worst],
                              'gradients_worst_of': worst,
                              'gradients_mean': float(np.mean(
                                  list(grads.values())))}
        cpu.load_state_dict(copy.deepcopy(gpu).cpu().state_dict())
        cpu64, gpu64 = copy.deepcopy(cpu).double(), copy.deepcopy(gpu).double()
        train64, grads64 = _train_errors(cpu64, gpu64, x.double(), y, dev)
        for key, err in train64.items():
            check(f'resnet50 fp64 train {key}, GPU vs CPU', err, TOL)
        worst64 = max(grads64, key=grads64.get)
        check(f'resnet50 fp64 train: gradient of {worst64}',
              grads64[worst64], TOL)
        rows['fp64_train'] = {**train64, 'gradients_worst': grads64[worst64],
                              'gradients_worst_of': worst64}
        del cpu64, gpu64
        cpu.eval()
        gpu.eval()
        with torch.no_grad():
            e_cpu = cpu(x)
            e_gpu = gpu(x.to(dev)).cpu()
            rows['eval_logits'] = rel_err(e_gpu, e_cpu)
            check('resnet50 eval, GPU vs CPU', rows['eval_logits'], TOL)
            # NHWC and the packed stem, on the card, on the same weights
            state = gpu.state_dict()
            xh = x.permute(0, 2, 3, 1).contiguous().to(dev)
            for key, kw in (('nhwc', {}),
                            ('space_to_depth_stem',
                             {'space_to_depth_stem': True})):
                m = _vision_model('resnet50', None, dev, num_classes=1000,
                                  data_format='NHWC', **kw)
                m.load_state_dict(state)
                m.eval()
                rows[key] = rel_err(m(xh).cpu(), e_gpu)
                check(f'resnet50 {key} vs NCHW', rows[key], TOL)
                del m
            for name, shape, kw in (
                    ('mobilenet_v2', (2, 3, 64, 64), {}),
                    ('vgg11', (2, 3, 64, 64), {}),
                    ('LeNet', (2, 1, 28, 28), {})):
                c = _vision_model(name, gen, 'cpu', **kw).eval()
                g = copy.deepcopy(c).to(dev).eval()
                v = torch.from_numpy(rs.randn(*shape).astype(np.float32))
                rows[name] = rel_err(g(v.to(dev)).cpu(), c(v))
                check(f'{name} eval, GPU vs CPU', rows[name], TOL)
        tf32 = torch.backends.cudnn.allow_tf32
    torch.cuda.synchronize()
    emit({'phase': 'vision_parity', 'shape': list(VISION_PARITY_SHAPE),
          'cudnn_tf32': tf32, 'tolerance_eval_and_fp64': TOL,
          'tolerance_fp32_train': GRAD_TOL, 'errors': rows,
          'seconds': time.perf_counter() - t0})


def _waves(eng, ep, reqs, waves):
    """``waves`` (request counts) through ``ep``, each wave submitted and
    pumped until idle -> (responses, {bucket: [batch ms]}, seconds)."""
    from paddle_tpu_torch.serving import DEFAULT_BATCH_BUCKETS, select_bucket
    batch_ms, served = {}, []
    at = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in waves:
        futs = [ep.submit(r) for r in reqs[at:at + n]]
        at += n
        eng.run_until_idle()
        resps = [f.result(timeout=600) for f in futs]
        batch_ms.setdefault(select_bucket(n, DEFAULT_BATCH_BUCKETS),
                            []).append(resps[0].breakdown['run'])
        served += resps
    return served, batch_ms, time.perf_counter() - t0


def phase_serve_resnet(seed, card):
    """``ServingEngine.register(layer=resnet50())`` at full width (3 x 224
    x 224, 1000 classes), fp32, eval, cuDNN TF32 as ``main`` set it (off),
    served in ``RESNET_WAVES`` (buckets 1-16). Gates: every response ok
    with 1000 finite logits; the first ``RESNET_CHECKED`` requests' logits
    within 1e-3 of the largest logit of the port's model on the CPU (the
    same weights); the seven kernels' launch counters exactly zero.
    Printed: requests/s over the waves, p50/p99 batch ms per bucket, peak
    memory, host syncs; then one profiled bucket-16 batch. -> the path's
    launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import ServingEngine
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 42)
    t0 = time.perf_counter()
    model = _vision_model('resnet50', gen, dev, num_classes=1000)
    eng = ServingEngine(queue_capacity=64, device=dev)
    ep = eng.register('resnet50', layer=model,
                      example={'x': np.zeros((3, 224, 224), np.float32)})
    warm = eng.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rs = np.random.RandomState(seed + 43)
    reqs = [{'x': rs.randn(3, 224, 224).astype(np.float32)}
            for _ in range(sum(RESNET_WAVES))]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()              # the main path starts here
    (served, batch_ms, serve_s), syncs, sync_sites = _count_syncs(
        lambda: _waves(eng, ep, reqs, RESNET_WAVES))
    counts = kernels.launch_counts()           # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    _zero_counts(counts, 'serve_resnet')
    for i, resp in enumerate(served):
        if not resp.ok:
            raise AssertionError(f"resnet request {i}: {resp.status}")
        out = np.asarray(resp.outputs)
        if out.shape != (1000,) or not np.isfinite(out).all():
            raise AssertionError(f"resnet request {i}: logits {out.shape}")
    cpu = copy.deepcopy(model).to('cpu').eval()
    with torch.inference_mode():
        want = cpu(torch.from_numpy(np.stack(
            [r['x'] for r in reqs[:RESNET_CHECKED]]))).numpy()
    err = max(float(np.abs(np.asarray(served[i].outputs) - want[i]).max())
              for i in range(RESNET_CHECKED)) / float(np.abs(want).max())
    check('resnet50 served on the GPU vs the CPU', err, MODEL_TOL)
    lat = {str(bk): {'batches': len(v), 'p50_ms': float(np.percentile(v, 50)),
                     'p99_ms': float(np.percentile(v, 99))}
           for bk, v in sorted(batch_ms.items())}
    emit({'phase': 'serve_resnet', 'model': 'resnet50', 'image': [3, 224, 224],
          'classes': 1000, 'dtype': 'float32',
          'cudnn_tf32': torch.backends.cudnn.allow_tf32, 'card': card,
          'setup_s': setup_s, 'warmup_buckets': warm['resnet50'],
          'requests': len(served), 'requests_per_s': len(served) / serve_s,
          'batch_latency_ms': lat, 'peak_gb': peak / 1e9,
          'launches': counts, 'host_syncs_waves': syncs,
          'host_sync_sites': sync_sites, 'cpu_rel_err': err})

    def one_batch():
        futs = [ep.submit(r) for r in reqs[:16]]
        eng.run_until_idle()
        for f in futs:
            f.result(timeout=600)
    phase_profile('serve_resnet', one_batch, {}, bucket=16)
    return counts


def phase_train_resnet(seed, card):
    """``bench.py::bench_resnet50``'s recipe at full width:
    ``resnet50(num_classes=1000, data_format='NHWC')`` in train mode,
    batch ``TRAIN_RESNET_BATCH`` of 224 x 224 images (bf16) and labels
    made on the card from a seeded generator, bf16 compute on fp32
    masters (``FlatFusedUpdate(compute_dtype=bf16)``, the loss on fp32
    logits), ``Momentum(0.1, 0.9, weight_decay=1e-4)`` through the flat
    update, BatchNorm's running statistics in the step's
    ``state['buffers']``, ``nan_guard=True``; ``TRAIN_RESNET_WARMUP``
    steps, then ``TRAIN_RESNET_STEPS`` timed ones (CUDA events around
    each). Gates: every loss finite and one after the first below it (the
    same batch each step; at lr 0.1 without warm-up a later step may
    overshoot again); the running statistics moved and finite; a
    batch with a NaN leaves the master, the momentum and every buffer
    bitwise as they were; the seven kernels' launch counters zero.
    Printed: step ms (median), images/s, peak GB, host syncs a step,
    the copies and casts of one more step by source line, then one
    profiled step. -> the path's launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.engine import build_train_step
    from paddle_tpu_torch.nn import functional as F
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 44)
    t0 = time.perf_counter()
    net = _vision_model('resnet50', gen, dev, num_classes=1000,
                        data_format='NHWC').train()
    b = TRAIN_RESNET_BATCH
    images = torch.randn((b, 224, 224, 3), generator=gen, device=dev,
                         dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (b,), generator=gen, device=dev)
    params = dict(net.named_parameters())
    flat = topt.FlatFusedUpdate(
        topt.Momentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4),
        params, compute_dtype=torch.bfloat16)
    step = build_train_step(
        net=net, loss=lambda logits, y: F.cross_entropy(logits.float(), y),
        optimizer=flat, nan_guard=True, device=dev)
    state = step.init_state()
    stats0 = {n: v.clone() for n, v in state['buffers'].items()}
    batch = ((images,), (labels,))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = []
    for _ in range(TRAIN_RESNET_WARMUP):
        state, out = step(state, batch)
        losses.append(out.losses)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_RESNET_STEPS)]

    def timed():
        for start, end in events:
            start.record()
            st, res = step(state, batch)
            end.record()
            losses.append(res.losses)
    kernels.reset_launch_counts()              # the main path starts here
    _, syncs, sync_sites = _count_syncs(timed)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()           # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    _zero_counts(counts, 'train_resnet')
    ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not min(losses[1:]) < losses[0]:
        raise AssertionError(f"train_resnet: losses {losses}")
    moved = sum(not torch.equal(stats0[n], v)
                for n, v in state['buffers'].items())
    if moved != len(stats0) or not all(
            torch.isfinite(v).all() for v in state['buffers'].values()):
        raise AssertionError(f"train_resnet: {moved} of {len(stats0)} "
                             f"running statistics moved (or not finite)")
    # a poisoned batch: the guard skips it, and nothing moves
    before = {'master': state['params'].clone(),
              **{f'opt.{k}': v.clone() for k, v in state['opt'].items()
                 if isinstance(v, torch.Tensor)},
              **{f'buffers.{k}': v.clone()
                 for k, v in state['buffers'].items()}}
    bad = images.clone()
    bad[0, 0, 0, 0] = float('nan')
    state, res = step(state, ((bad,), (labels,)))
    after = {'master': state['params'],
             **{f'opt.{k}': v for k, v in state['opt'].items()
                if isinstance(v, torch.Tensor)},
             **{f'buffers.{k}': v for k, v in state['buffers'].items()}}
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    if np.isfinite(float(res.loss)) or changed:
        raise AssertionError(f"train_resnet: the poisoned step changed "
                             f"{changed[:8]} (loss {float(res.loss)})")
    guard = step.sync(state)['guard']
    if guard['skipped'] != 1:
        raise AssertionError(f"train_resnet: guard {guard}")
    med = float(np.median(ms))
    emit({'phase': 'train_resnet', 'model': 'resnet50', 'format': 'NHWC',
          'batch': b, 'image': 224, 'dtype': 'bf16 compute, fp32 masters',
          'optimizer': 'Momentum(0.1, 0.9, weight_decay=1e-4), flat',
          'card': card, 'setup_s': setup_s, 'step_ms': ms,
          'step_ms_median': med, 'images_per_s': b / (med / 1e3),
          'peak_gb': peak / 1e9, 'losses': losses,
          'launches': counts, 'host_syncs_per_step': syncs /
          TRAIN_RESNET_STEPS, 'host_sync_sites': sync_sites,
          'running_stats_moved': moved, 'poisoned_step_skipped': True})
    copy_accounting('resnet50_bf16_flat',
                    lambda: step(state, batch))
    phase_profile('train_resnet', lambda: step(state, batch), {})
    return counts


def phase_hapi_fit_resnet(seed, card):
    """``hapi.Model(resnet50()).prepare(Momentum, nn.CrossEntropyLoss(),
    metric.Accuracy()).fit(...)``, fp32, eager, on the synthetic Flowers
    test set (224 x 224) through ``vision.transforms`` (``ToTensor``,
    ``Normalize``): one batch of ``HAPI_RESNET_BATCH`` for
    ``HAPI_RESNET_EPOCHS`` epochs. Gates: finite losses, one after the
    first below it; accuracy in [0, 1]; ``hapi.flops(resnet50(), [1, 3, 224,
    224])`` equal to ``RESNET50_FLOPS``; the seven kernels' launch
    counters zero. Printed: step ms (median, batch end to batch end),
    images/s, peak GB. -> the path's launch counts."""
    from paddle_tpu_torch import Model, kernels, metric, nn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch import vision
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.hapi.model_summary import flops
    from paddle_tpu_torch.io import Subset
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 45)
    net = _vision_model('resnet50', gen, dev, num_classes=1000)
    counted = flops(net, [1, 3, 224, 224])
    if counted != RESNET50_FLOPS:
        raise AssertionError(f"flops(resnet50) = {counted}, the "
                             f"reference's formula {RESNET50_FLOPS}")
    tr = vision.transforms.Compose([
        vision.transforms.ToTensor(),
        vision.transforms.Normalize([0.485, 0.456, 0.406],
                                    [0.229, 0.224, 0.225])])
    data = vision.datasets.Flowers(mode='test', transform=tr)
    data = Subset(data, list(range(HAPI_RESNET_BATCH)))

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.t, self.logs = [], []

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())
            self.logs.append(dict(logs))
    rec = Steps()
    model = Model(net, device=dev)
    model.prepare(topt.Momentum(learning_rate=0.01, momentum=0.9,
                                parameters=net.parameters()),
                  nn.CrossEntropyLoss(), metric.Accuracy())
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()              # the main path starts here
    model.fit(data, batch_size=HAPI_RESNET_BATCH, epochs=HAPI_RESNET_EPOCHS,
              shuffle=False, verbose=0, callbacks=[rec])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()           # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    _zero_counts(counts, 'hapi_fit_resnet')
    losses = [float(np.ravel(l['loss'])[0]) for l in rec.logs]
    accs = [float(l['acc']) for l in rec.logs]
    if not all(np.isfinite(losses)) or not min(losses[1:]) < losses[0]:
        raise AssertionError(f"hapi_fit_resnet: losses {losses}")
    if not all(0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"hapi_fit_resnet: accuracy {accs}")
    ms = list(np.diff(rec.t) * 1e3)
    med = float(np.median(ms))
    emit({'phase': 'hapi_fit_resnet', 'model': 'resnet50', 'format': 'NCHW',
          'batch': HAPI_RESNET_BATCH, 'image': 224, 'dtype': 'float32',
          'cudnn_tf32': torch.backends.cudnn.allow_tf32, 'card': card,
          'steps': len(losses), 'losses': losses, 'accuracy': accs,
          'step_ms': ms, 'step_ms_median': med,
          'images_per_s': HAPI_RESNET_BATCH / (med / 1e3),
          'peak_gb': peak / 1e9, 'flops': counted, 'launches': counts})
    return counts


# detection (PaddleDetection's ssd_mobilenet_v1_voc, PaddlePaddle 1.8 era):
# MobileNetV1 at 300 x 300, four extra stride-2 pairs, priors from
# prior_box, ssd_loss for training, detection_output for serving
SSD_IMAGE = 300
SSD_CLASSES = 21                  # VOC's 20 and the background, label 0
SSD_ASPECT_RATIOS = [[2.], [2., 3.], [2., 3.], [2., 3.], [2., 3.], [2., 3.]]
SSD_MIN_SIZES = [60., 105., 150., 195., 240., 285.]
SSD_MAX_SIZES = [[], 150., 195., 240., 285., 300.]
SSD_VARIANCE = (0.1, 0.1, 0.2, 0.2)
SSD_EXTRAS = ((256, 512), (128, 256), (128, 256), (64, 128))
SSD_PRIORS = 1917                 # 19^2 * 3 + (10^2 + 5^2 + 3^2 + 2^2 + 1) * 6
SSD_MAX_GT = 16                   # ground-truth rows an image, -1 padded
SSD_DETECT = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                  score_threshold=0.01)
SSD_LOSS = dict(overlap_threshold=0.5, neg_pos_ratio=3.0)
SSD_CHECKED = 4                   # requests held against the CPU
TRAIN_SSD_BATCH = 32
TRAIN_SSD_WARMUP = 2
TRAIN_SSD_STEPS = 10
SSD_PARITY_BATCH = 2              # the fp64 train pass, GPU against CPU
# the YOLOv3 head at 608 x 608 (COCO): three levels of 3 anchors each
YOLO_IMAGE = 608
YOLO_BATCH = 8
YOLO_CLASSES = 80
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_LEVELS = (([6, 7, 8], 32), ([3, 4, 5], 16), ([0, 1, 2], 8))
YOLO_MAX_GT = 50
# Faster R-CNN's RPN on an 800 x 1088 image: stride 16, 15 anchors a cell
RPN_MAP = (50, 68)
RPN_SIZES = [32., 64., 128., 256., 512.]
RPN_RATIOS = [0.5, 1., 2.]
ROI_COUNT = 256                   # rois over the batch of 2 images
ROI_CHANNELS = 1024
NEAR_THRESHOLD = 1e-6             # IoUs this close to an NMS threshold
DETECT_SYNC_BUDGET = 0            # host syncs of one detection_output call


def _ssd_size(n, halvings):
    """A side after ``halvings`` stride-2 convolutions (kernel 3, pad 1)."""
    for _ in range(halvings):
        n = (n - 1) // 2 + 1
    return n


class SSDMobileNet(torch.nn.Module):
    """PaddleDetection's ``ssd_mobilenet_v1_voc`` (PaddlePaddle 1.8 era),
    built from the port's modules: ``MobileNetV1(scale, num_classes=0,
    with_pool=False)`` (``conv1`` and ``blocks[:11]`` give the 19 x 19 map
    at 300 x 300, ``blocks[11:]`` the 10 x 10 one), four extra pairs (a
    1 x 1 conv, then a 3 x 3 stride-2 conv, each with BatchNorm and ReLU:
    5, 3, 2 and 1), and a 1 x 1 loc and conf ``Conv2D`` head a map; the
    priors from ``vision.ops.prior_box`` at ``SSD_MIN_SIZES`` /
    ``SSD_MAX_SIZES`` scaled to ``image``, flipped ``SSD_ASPECT_RATIOS``,
    offset 0.5 (``SSD_PRIORS`` of them at 300). ``forward`` returns the
    heads: loc (B, P, 4) and conf logits (B, P, C); ``SSDDetector`` serves
    it."""

    def __init__(self, num_classes=SSD_CLASSES, image=SSD_IMAGE, scale=1.0,
                 *, device=None, generator=None):
        from paddle_tpu_torch import nn
        from paddle_tpu_torch.vision import models
        from paddle_tpu_torch.vision.models.mobilenetv1 import ConvBNLayer
        from paddle_tpu_torch.vision.ops import prior_box
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.backbone = models.MobileNetV1(scale=scale, num_classes=0,
                                           with_pool=False, **kw)
        c = [int(512 * scale), int(1024 * scale)]
        extras = []
        for mid, out in SSD_EXTRAS:
            mid, out = int(mid * scale), int(out * scale)
            extras.append(nn.Sequential(
                ConvBNLayer(c[-1], mid, 1, 1, 0, **kw),
                ConvBNLayer(mid, out, 3, 2, 1, **kw)))
            c.append(out)
        self.extras = nn.LayerList(extras)
        sides = [_ssd_size(image, 4 + i) for i in range(len(c))]
        ratio = image / SSD_IMAGE
        boxes, variances, per_cell = [], [], []
        for i, side in enumerate(sides):
            mx = SSD_MAX_SIZES[i]
            box, var = prior_box(
                np.zeros((1, 1, side, side)), np.zeros((1, 3, image, image)),
                [SSD_MIN_SIZES[i] * ratio], [mx * ratio] if mx else None,
                SSD_ASPECT_RATIOS[i], SSD_VARIANCE, flip=True, offset=0.5,
                device=device)
            per_cell.append(box.shape[2])
            boxes.append(box.reshape(-1, 4))
            variances.append(var.reshape(-1, 4))
        self.register_buffer('priors', torch.cat(boxes), persistent=False)
        self.register_buffer('prior_vars', torch.cat(variances),
                             persistent=False)
        self.loc_heads = nn.LayerList([
            nn.Conv2D(ch, n * 4, 1, **kw) for ch, n in zip(c, per_cell)])
        self.conf_heads = nn.LayerList([
            nn.Conv2D(ch, n * num_classes, 1, **kw)
            for ch, n in zip(c, per_cell)])

    def feature_maps(self, x):
        feats = []
        x = self.backbone.conv1(x)
        for i, block in enumerate(self.backbone.blocks):
            x = block(x)
            if i == 10:
                feats.append(x)
        feats.append(x)
        for extra in self.extras:
            x = extra(x)
            feats.append(x)
        return feats

    def forward(self, x):
        locs, confs = [], []
        for f, lh, ch in zip(self.feature_maps(x), self.loc_heads,
                             self.conf_heads):
            b = f.shape[0]
            locs.append(lh(f).permute(0, 2, 3, 1).reshape(b, -1, 4))
            confs.append(ch(f).permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes))
        return torch.cat(locs, 1), torch.cat(confs, 1)


class SSDDetector(torch.nn.Module):
    """An ``SSDMobileNet`` with its inference output: ``forward(x)`` ->
    ``detection_output``'s (out (B, 200, 6), counts (B,)) at
    ``SSD_DETECT``."""

    def __init__(self, ssd):
        super().__init__()
        self.ssd = ssd

    def forward(self, x):
        from paddle_tpu_torch.vision import detection_output
        loc, conf = self.ssd(x)
        return detection_output(loc, conf, self.ssd.priors,
                                self.ssd.prior_vars, **SSD_DETECT)


def ssd_loss_fn(model):
    """The reference's ``loss_fn(params, buffers, batch)`` for
    ``build_train_step``: PaddleDetection's loss, ``ssd_loss`` (overlap
    0.5, 3 negatives a positive) summed over the batch; ``batch`` is
    (images, gt boxes, gt labels)."""
    from paddle_tpu_torch.vision import ssd_loss

    def loss_fn(params, buffers, batch):
        images, gt_box, gt_label = batch
        loc, conf = torch.func.functional_call(
            model, {**params, **buffers}, (images,))
        loss = ssd_loss(loc, conf, gt_box, gt_label, model.priors,
                        model.prior_vars, **SSD_LOSS).sum()
        return loss, (loc, conf), buffers
    return loss_fn


def ssd_ground_truth(rs, batch, max_gt=SSD_MAX_GT, classes=SSD_CLASSES):
    """Synthetic VOC-like targets: 1 to ``max_gt`` boxes an image
    (normalized xyxy, sides 0.05-0.6), labels 1..classes-1, the rest of
    the rows zero boxes labelled -1 -> (boxes (B, G, 4) float32, labels
    (B, G) int64)."""
    boxes = np.zeros((batch, max_gt, 4), np.float32)
    labels = np.full((batch, max_gt), -1, np.int64)
    for b in range(batch):
        n = rs.randint(1, max_gt + 1)
        wh = 0.05 + 0.55 * rs.rand(n, 2)
        xy = rs.rand(n, 2) * (1 - wh)
        boxes[b, :n] = np.concatenate([xy, xy + wh], 1)
        labels[b, :n] = rs.randint(1, classes, n)
    return boxes, labels


def _nms_near(boxes, scores, thr, top_k, score_threshold=-math.inf,
              normalized=True):
    """The pairs of NMS candidates (the ``top_k`` best above
    ``score_threshold`` a row of ``scores`` (..., M); ``boxes`` (..., M, 4)
    broadcast against it), in fp64 on the host, whose IoU lies within
    ``NEAR_THRESHOLD`` of ``thr``: where a last-bit difference could flip
    a suppression."""
    from paddle_tpu_torch.vision.ops import _pairwise_iou
    s = scores.detach().double().cpu()
    s = torch.where(s > score_threshold, s, torch.tensor(-math.inf,
                                                         dtype=s.dtype))
    order = torch.argsort(-s, dim=-1, stable=True)[..., :top_k]
    b = boxes.detach().double().cpu().expand(*s.shape, 4)
    cand = b.gather(-2, order[..., None].expand(*order.shape, 4))
    live = torch.isfinite(s.gather(-1, order))
    iou = _pairwise_iou(cand, cand, normalized)
    upper = torch.ones(iou.shape[-2:], dtype=torch.bool).triu(1)
    near = ((iou - thr).abs() < NEAR_THRESHOLD) & upper \
        & live[..., :, None] & live[..., None, :]
    return int(near.sum())


def _to(value, dev, dtype):
    if isinstance(value, np.ndarray):
        t = torch.from_numpy(value)
        return t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
    return value


def _on_both(fn, arrays, dtype, dev, grads=(), **kw):
    """``fn`` on the card and on the CPU, the float inputs at ``dtype`` ->
    (card outputs, CPU outputs, card gradients, CPU gradients), outputs
    flattened to lists of CPU tensors; gradients of the first output's sum
    against a fixed cotangent with respect to ``arrays[i]``, i in
    ``grads``."""
    outs = []
    for d in (dev, torch.device('cpu')):
        ts = [_to(a, d, dtype) for a in arrays]
        for i in grads:
            ts[i].requires_grad_(True)
        out = fn(*ts, **kw)
        flat = list(out) if isinstance(out, (list, tuple)) else [out]
        g = []
        if grads:
            cot = torch.cos(torch.arange(flat[0].numel(), dtype=dtype,
                                         device=d)).reshape(flat[0].shape)
            g = torch.autograd.grad((flat[0] * cot).sum(),
                                    [ts[i] for i in grads])
        outs.append(([_flat_cpu(o) for o in flat],
                     [x.detach().cpu() for x in g]))
    return outs[0][0], outs[1][0], outs[0][1], outs[1][1]


def _flat_cpu(o):
    if isinstance(o, (list, tuple)):
        return [_flat_cpu(x) for x in o]
    return o.detach().cpu()


def _held(name, got, want, tol, rows):
    """Each float output within ``tol`` of its largest entry, each integer
    output equal -> the worst error, recorded in ``rows``."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, list):
            for j, (a, b) in enumerate(zip(g, w)):
                worst = max(worst, _held_one(f'{name}[{i}][{j}]', a, b, tol))
            continue
        worst = max(worst, _held_one(f'{name}[{i}]', g, w, tol))
    rows[name] = worst
    return worst


def _held_one(name, g, w, tol):
    if tuple(g.shape) != tuple(w.shape):
        raise AssertionError(f"{name}: shape {tuple(g.shape)} on the card, "
                             f"{tuple(w.shape)} on the CPU")
    if not w.is_floating_point():
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: integer outputs differ")
        return 0.0
    if w.numel() == 0:
        return 0.0
    finite = torch.isfinite(w)
    if not torch.equal(torch.isfinite(g), finite) or not torch.equal(
            g[~finite], w[~finite]):
        raise AssertionError(f"{name}: the infinities differ")
    g, w = g[finite], w[finite]
    err = rel_err(g, w) if float(w.abs().max()) > 0 else max_err(g, w)
    check(f'{name}, GPU vs CPU', err, tol)
    return err


def _detection_cases(seed, dtype, full):
    """The parity cases -> [(name, fn, arrays, kwargs, grad argnums)]: the
    small ones, and with ``full`` the YOLOv3 head at 608 x 608, the RPN
    and ``roi_align`` at Faster R-CNN's stride-16 map."""
    from paddle_tpu_torch.nn.initializer import Assign, ParamAttr
    from paddle_tpu_torch.vision import detection_train as D
    from paddle_tpu_torch.vision import ops as O
    rs = np.random.RandomState(seed + 50)
    f = np.float32

    def bx(n, scale=1.0, lo=0.05):
        xy = rs.rand(n, 2) * (1 - lo)
        wh = lo + rs.rand(n, 2) * (1 - lo - xy)
        return (np.concatenate([xy, xy + wh], 1) * scale).astype(f)
    prior = bx(60, lo=0.1)
    var = np.tile(np.asarray(SSD_VARIANCE, f), (60, 1))
    dw, db = 0.2 * rs.randn(8, 6, 3, 3), rs.randn(8)
    gt, lab = ssd_ground_truth(rs, 3, 6, 5)
    cases = [
        ('iou_similarity', O.iou_similarity, [bx(40), prior], {}, ()),
        ('box_coder encode', O.box_coder, [prior, var, bx(8)], {}, ()),
        ('box_coder decode', O.box_coder,
         [prior, var, (0.5 * rs.randn(3, 60, 4)).astype(f)],
         dict(code_type='decode_center_size'), ()),
        ('box_clip', O.box_clip, [(rs.randn(2, 9, 4) * 40 + 20).astype(f),
                                  np.array([[30, 40, 1.], [60, 50, 2.]], f)],
         {}, ()),
        ('nms', O.nms, [bx(50, lo=0.2), rs.rand(50).astype(f)],
         dict(iou_threshold=0.4, top_k=30), ()),
        ('multiclass_nms', O.multiclass_nms,
         [np.stack([bx(50, lo=0.2), bx(50, lo=0.2)]),
          rs.rand(2, 4, 50).astype(f)],
         dict(score_threshold=0.1, nms_top_k=30, keep_top_k=40,
              nms_threshold=0.45, return_index=True), ()),
        ('bipartite_match', D.bipartite_match, [rs.rand(3, 6, 40).astype(f)],
         dict(match_type='per_prediction'), ()),
        ('target_assign', D.target_assign,
         [rs.randn(3, 6, 4).astype(f), rs.randint(-1, 6, (3, 40))], {}, ()),
        ('ssd_loss', D.ssd_loss,
         [(0.5 * rs.randn(3, 60, 4)).astype(f),
          rs.randn(3, 60, 5).astype(f), gt, lab, prior, var], {}, (0, 1)),
        ('sigmoid_focal_loss', D.sigmoid_focal_loss,
         [rs.randn(30, 4).astype(f), rs.randint(0, 5, (30, 1)),
          np.array([5])], {}, (0,)),
        ('matrix_nms', D.matrix_nms,
         [np.stack([bx(40, lo=0.2)] * 2), rs.rand(2, 3, 40).astype(f)],
         dict(score_threshold=0.1, post_threshold=0.05, nms_top_k=30,
              keep_top_k=20), ()),
        ('polygon_box_transform', D.polygon_box_transform,
         [rs.randn(2, 8, 5, 6).astype(f)], {}, ()),
        ('distribute_fpn_proposals', D.distribute_fpn_proposals,
         [bx(40, 600.)], dict(min_level=2, max_level=5, refer_level=4,
                              refer_scale=224), ()),
        ('collect_fpn_proposals',
         lambda a, b, s, t: D.collect_fpn_proposals([a, b], [s, t], 2, 3,
                                                    20),
         [bx(15, 90.), bx(12, 90.), rs.rand(15, 1).astype(f),
          rs.rand(12, 1).astype(f)], {}, ()),
        ('box_decoder_and_assign', D.box_decoder_and_assign,
         [bx(20, 50.), np.tile(np.asarray(SSD_VARIANCE, f), (20, 1)),
          rs.randn(20, 12).astype(f), rs.rand(20, 3).astype(f)],
         dict(box_clip=4.135), ()),
        ('roi_pool', lambda x, r, n: D.roi_pool(x, r, 3, 3, 0.7,
                                                 rois_num=n),
         [rs.randn(2, 6, 10, 12).astype(f), bx(7, 14.), np.array([4, 3])],
         {}, ()),
        ('psroi_pool', lambda x, r, n: D.psroi_pool(x, r, 2, 0.7, 3, 3,
                                                     rois_num=n),
         [rs.randn(2, 2 * 9, 10, 12).astype(f), bx(7, 14.),
          np.array([4, 3])], {}, ()),
        ('prroi_pool', D.prroi_pool,
         [rs.randn(2, 6, 10, 12).astype(f), bx(7, 14.)],
         dict(spatial_scale=0.7, pooled_height=3, pooled_width=3), ()),
        ('roi_perspective_transform', D.roi_perspective_transform,
         [rs.randn(1, 4, 10, 12).astype(f),
          np.array([[1, 1, 9, 2, 10, 8, 2, 7]], f)],
         dict(transformed_height=5, transformed_width=6), ()),
        ('deformable_conv',
         lambda x, o, m: D.deformable_conv(
             x, o, m, 8, 3, padding=1, deformable_groups=2,
             param_attr=ParamAttr(initializer=Assign(dw)),
             bias_attr=ParamAttr(initializer=Assign(db))),
         [rs.randn(2, 6, 9, 10).astype(f),
          (1.5 * rs.randn(2, 36, 9, 10)).astype(f),
          rs.rand(2, 18, 9, 10).astype(f)], {}, (0, 1, 2)),
        ('deformable_roi_pooling', D.deformable_roi_pooling,
         [rs.randn(1, 4, 10, 12).astype(f), bx(5, 10.),
          (0.5 * rs.randn(5, 2, 3, 3)).astype(f)],
         dict(pooled_height=3, pooled_width=3, sample_per_part=2), ()),
    ]
    if not full:
        return cases
    # the YOLOv3 head: (8, 255, 19 / 38 / 76, ...) at 608 x 608
    ygt = np.zeros((YOLO_BATCH, YOLO_MAX_GT, 4), f)
    ylab = np.zeros((YOLO_BATCH, YOLO_MAX_GT), np.int64)
    for b in range(YOLO_BATCH):
        n = rs.randint(5, YOLO_MAX_GT)
        wh = 0.02 + 0.5 * rs.rand(n, 2)
        ygt[b, :n] = np.concatenate([wh / 2 + rs.rand(n, 2) * (1 - wh),
                                     wh], 1)
        ylab[b, :n] = rs.randint(0, YOLO_CLASSES, n)
    size = np.tile(np.array([[YOLO_IMAGE, YOLO_IMAGE]], np.int64),
                   (YOLO_BATCH, 1))
    for mask, stride in YOLO_LEVELS:
        side = YOLO_IMAGE // stride
        x = rs.randn(YOLO_BATCH, 3 * (5 + YOLO_CLASSES), side,
                     side).astype(f)
        anchors = [YOLO_ANCHORS[2 * m + i] for m in mask for i in (0, 1)]
        cases.append((f'yolo_box {side}x{side}', O.yolo_box, [x, size],
                      dict(anchors=anchors, class_num=YOLO_CLASSES,
                           conf_thresh=0.01, downsample_ratio=stride), ()))
        cases.append((f'yolov3_loss {side}x{side}', D.yolov3_loss,
                      [x, ygt, ylab],
                      dict(anchors=YOLO_ANCHORS, anchor_mask=mask,
                           class_num=YOLO_CLASSES, ignore_thresh=0.7,
                           downsample_ratio=stride), (0,)))
    # Faster R-CNN's RPN: 50 x 68 cells, 15 anchors each, two images
    feat = np.zeros((1, 1) + RPN_MAP)
    an, av = (t.numpy() for t in O.anchor_generator(
        feat, RPN_SIZES, RPN_RATIOS, stride=(16., 16.), device='cpu'))
    A = an.shape[2]
    h, w = RPN_MAP
    info = np.array([[800, 1088, 1.0], [800, 1088, 1.0]], f)
    cases.append(('generate_proposals (candidates)',
                  lambda *a: D._proposal_candidates(*a, 6000, 0.1),
                  [rs.randn(2, A, h, w).astype(f),
                   (0.2 * rs.randn(2, 4 * A, h, w)).astype(f), info, an, av],
                  {}, ()))
    gtr = bx(20, 800., 0.05)
    gtr[-4:] = 0.0
    cases.append(('rpn_target_assign', D.rpn_target_assign,
                  [rs.randn(an.size // 4, 4).astype(f),
                   rs.randn(an.size // 4, 1).astype(f), an.reshape(-1, 4),
                   av.reshape(-1, 4), gtr], {}, ()))
    cases.append(('retinanet_target_assign', D.retinanet_target_assign,
                  [rs.randn(an.size // 4, 4).astype(f),
                   rs.randn(an.size // 4, 1).astype(f), an.reshape(-1, 4),
                   av.reshape(-1, 4), gtr, rs.randint(1, 81, (20, 1))],
                  {}, ()))
    rois = np.concatenate([bx(ROI_COUNT // 2, 1000.), bx(ROI_COUNT // 2,
                                                         1000.)])
    cases.append(('roi_align 7x7', lambda x, r, n: O.roi_align(
        x, r, 7, 7, 1 / 16., rois_num=n),
        [rs.randn(2, ROI_CHANNELS, h, w).astype(f), rois,
         np.array([ROI_COUNT // 2] * 2)], {}, (0,)))
    return cases


def _nms_exact(name, fn, inputs, rows, near):
    """An NMS on the card against the same NMS on the CPU fed the card's
    own inputs: every output equal (the IoUs are the same elementwise
    operations on the same bits). ``near``: its candidate pairs within
    ``NEAR_THRESHOLD`` of the threshold (``_nms_near``)."""
    got = fn(*inputs)
    want = fn(*[t.cpu() for t in inputs])
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"{name}: output {i} differs between the "
                                 f"card and the CPU on the same inputs")
    rows[name] = {'equal': True, 'near_threshold_pairs': near}


def phase_detection_parity(seed):
    """Every function of ``vision/ops.py`` and ``vision/detection_train.py``
    on the card against the same function on the CPU, on the same inputs
    (``_detection_cases``: small sizes, plus the YOLOv3 head at 608 x 608
    for ``yolo_box`` / ``yolov3_loss``, the RPN at a 50 x 68 stride-16 map
    with 15 anchors a cell for the proposal candidates and the assigners,
    and ``roi_align`` with 7 x 7 bins on a 1024-channel map of that size).
    fp64: every output within ``TOL`` of its largest entry (integer
    outputs equal), and the gradients of ``ssd_loss``, ``yolov3_loss``,
    ``roi_align`` and ``deformable_conv`` (and ``sigmoid_focal_loss``)
    within ``TOL``; fp32: the outputs within ``MODEL_TOL`` (the fp32
    gradients printed). The NMS forms are held exactly by feeding the CPU
    the card's own inputs: ``nms``, ``multiclass_nms``, ``matrix_nms``,
    ``detection_output`` after the card's decode and softmax,
    ``generate_proposals`` after the card's candidates,
    ``locality_aware_nms`` after its merge, ``retinanet_detection_output``
    after its decode; the pairs whose IoU lies within ``NEAR_THRESHOLD`` of
    the threshold are counted. The priors and anchors (host numpy) are
    equal on both devices; ``multi_box_head`` and the host samplers run on
    the card. -> None."""
    from paddle_tpu_torch.vision import detection_train as D
    from paddle_tpu_torch.vision import ops as O
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    rows = {'fp64': {}, 'fp32': {}, 'fp64_grads': {}, 'fp32_grads': {},
            'nms': {}}
    with tf32_off():
        for dtype, tol, key in ((torch.float64, TOL, 'fp64'),
                                (torch.float32, MODEL_TOL, 'fp32')):
            for name, fn, arrays, kw, grads in _detection_cases(seed, dtype,
                                                                True):
                got, want, ggot, gwant = _on_both(fn, arrays, dtype, dev,
                                                  grads, **kw)
                _held(name, got, want, tol, rows[key])
                if grads:
                    errs = [rel_err(g, w) for g, w in zip(ggot, gwant)]
                    rows[f'{key}_grads'][name] = max(errs)
                    if dtype == torch.float64:
                        check(f'{name} gradients, GPU vs CPU', max(errs), TOL)
        # the NMS forms, exact on the card's own inputs
        rs = np.random.RandomState(seed + 51)
        f32 = dict(dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 52)
        boxes = torch.rand((4, SSD_PRIORS, 2), generator=gen, **f32) * 0.7
        boxes = torch.cat([boxes, boxes + 0.05 + 0.25 * torch.rand(
            (4, SSD_PRIORS, 2), generator=gen, **f32)], -1)
        scores = torch.rand((4, SSD_CLASSES, SSD_PRIORS), generator=gen,
                            **f32)
        bg = torch.arange(SSD_CLASSES, device=dev)[None, :, None] == 0
        fg_scores = torch.where(bg, -math.inf, scores)
        _nms_exact('nms', lambda b, s: O.nms(b, s, 0.45, 400, 0.01),
                   [boxes[0], scores[0, 1]], rows['nms'],
                   _nms_near(boxes[0], scores[0, 1], 0.45, 400, 0.01))
        _nms_exact('multiclass_nms', lambda b, s: O.multiclass_nms(
            b, s, return_index=True, **SSD_DETECT), [boxes, scores],
            rows['nms'], _nms_near(boxes[:, None], fg_scores, 0.45, 400,
                                   0.01))
        _nms_exact('multiclass_nms nms_eta=0.9', lambda b, s:
                   O.multiclass_nms(b, s, score_threshold=0.01,
                                    nms_top_k=100, keep_top_k=100,
                                    nms_threshold=0.7, nms_eta=0.9),
                   [boxes[:, :300], scores[:, :4, :300]], rows['nms'], None)
        _nms_exact('matrix_nms', lambda b, s: D.matrix_nms(
            b, s, 0.01, nms_top_k=400, keep_top_k=200), [boxes, scores],
            rows['nms'], None)
        loc = torch.randn((4, SSD_PRIORS, 4), generator=gen, **f32) * 0.5
        logits = torch.randn((4, SSD_PRIORS, SSD_CLASSES), generator=gen,
                             **f32)
        prior = boxes[0]
        pvar = torch.tensor(SSD_VARIANCE, **f32).expand(SSD_PRIORS, 4)
        decoded = O.box_coder(prior, pvar, loc,
                              code_type='decode_center_size')
        probs = torch.softmax(logits, -1).transpose(1, 2)
        want = O.box_coder(prior.cpu(), pvar.cpu(), loc.cpu(),
                           code_type='decode_center_size')
        check('detection_output decode, GPU vs CPU',
              rel_err(decoded.cpu(), want), MODEL_TOL)
        check('detection_output softmax, GPU vs CPU',
              rel_err(probs.cpu(), torch.softmax(logits.cpu(),
                                                 -1).transpose(1, 2)),
              MODEL_TOL)
        _nms_exact('detection_output', lambda b, s: O.multiclass_nms(
            b, s, return_index=True, **SSD_DETECT), [decoded, probs],
            rows['nms'], _nms_near(decoded[:, None],
                                   torch.where(bg, -math.inf, probs),
                                   0.45, 400, 0.01))
        full = D.detection_output(loc, logits, prior, pvar,
                                  return_index=True, **SSD_DETECT)
        nms_only = O.multiclass_nms(decoded, probs, return_index=True,
                                    **SSD_DETECT)
        if not all(torch.equal(a, b) for a, b in zip(full, nms_only)):
            raise AssertionError("detection_output is not its decode, "
                                 "softmax and multiclass_nms")
        feat = np.zeros((1, 1) + RPN_MAP)
        an, av = O.anchor_generator(feat, RPN_SIZES, RPN_RATIOS,
                                    stride=(16., 16.), device=dev)
        A = an.shape[2]
        tb, ts = D._proposal_candidates(
            torch.randn((2, A) + RPN_MAP, generator=gen, **f32),
            0.2 * torch.randn((2, 4 * A) + RPN_MAP, generator=gen, **f32),
            torch.tensor([[800., 1088., 1.]] * 2, **f32), an, av, 6000, 0.1)
        _nms_exact('generate_proposals', lambda b, s: D._proposal_nms(
            b, s, 1000, 0.7, 1.0), [tb, ts], rows['nms'],
            _nms_near(tb, ts, 0.7, 6000, normalized=False))
        merged = D._locality_merge(boxes, scores, 0.45, 0.3)
        check('locality_aware_nms merge, GPU vs CPU',
              rel_err(merged.cpu(), D._locality_merge(
                  boxes.cpu(), scores.cpu(), 0.45, 0.3)), MODEL_TOL)
        _nms_exact('locality_aware_nms', lambda b, s: O.multiclass_nms(
            b, s, score_threshold=0.3, nms_top_k=400, keep_top_k=200,
            nms_threshold=0.45, background_label=-1), [merged, scores],
            rows['nms'], _nms_near(merged[:, None], scores, 0.45, 400, 0.3))
        levels = [boxes[0, :1000] * 600, boxes[0, 1000:] * 600]
        deltas = [0.3 * loc[:, :1000], 0.3 * loc[:, 1000:]]
        dec = torch.cat([O.box_coder(a, [1.0] * 4, d,
                                     code_type='decode_center_size')
                         for a, d in zip(levels, deltas)], 1)
        sc = scores[:, :4]
        retina = dict(score_threshold=0.05, nms_top_k=1000, keep_top_k=100,
                      nms_threshold=0.3, background_label=-1)
        _nms_exact('retinanet_detection_output', lambda b, s:
                   O.multiclass_nms(b, s, **retina), [dec, sc], rows['nms'],
                   _nms_near(dec[:, None], sc, 0.3, 1000, 0.05))
        full = D.retinanet_detection_output(
            deltas, [sc[..., :1000].transpose(1, 2),
                     sc[..., 1000:].transpose(1, 2)], levels, None,
            nms_top_k=1000)
        nms_only = O.multiclass_nms(dec, sc, **retina)
        if not all(torch.equal(a, b) for a, b in zip(full, nms_only)):
            raise AssertionError("retinanet_detection_output is not its "
                                 "decode and multiclass_nms")
        # host-side generators and samplers, and multi_box_head
        img = np.zeros((1, 3, SSD_IMAGE, SSD_IMAGE))
        for name, call in (
                ('prior_box', lambda d: O.prior_box(
                    np.zeros((1, 1, 19, 19)), img, [60.], None, [2.],
                    flip=True, device=d)),
                ('density_prior_box', lambda d: O.density_prior_box(
                    np.zeros((1, 1, 19, 19)), img, [4, 2], [30., 60.],
                    [1.], device=d)),
                ('anchor_generator', lambda d: O.anchor_generator(
                    feat, RPN_SIZES, RPN_RATIOS, stride=(16., 16.),
                    device=d))):
            for g, w in zip(call(dev), call('cpu')):
                if g.device.type != 'cuda' or not torch.equal(g.cpu(), w):
                    raise AssertionError(f"{name}: the card's differs")
        rois = torch.tensor(rs.rand(30, 4) * 50, **f32).sort(-1).values
        rois = rois[:, [0, 1, 3, 2]]
        out = D.generate_proposal_labels(
            rois, np.array([[3], [1]]), None,
            np.array([[5., 5., 30., 30.], [20., 25., 45., 48.]], np.float32),
            np.array([50., 50., 1.]), batch_size_per_im=16,
            class_nums=4, use_random=True, rng=np.random.RandomState(seed))
        masks = D.generate_mask_labels(
            None, np.array([[3], [1]]), None,
            np.array([[[5, 5], [30, 6], [28, 30]]] * 2, np.float32), out[0],
            out[1], num_classes=4, resolution=7)
        if not all(t.device.type == 'cuda' for t in (*out, *masks)):
            raise AssertionError("the host samplers' tensors are not on "
                                 "the card")
        heads = D.multi_box_head(
            [torch.randn((2, 32, 10, 10), generator=gen, **f32),
             torch.randn((2, 64, 5, 5), generator=gen, **f32)],
            torch.zeros((2, 3, 160, 160), **f32), 160, 5, [[2.], [2., 3.]],
            min_sizes=[30., 60.], max_sizes=[[], 90.],
            generator=torch.Generator(device=dev).manual_seed(seed))
        if heads[0].shape != (2, 10 * 10 * 3 + 5 * 5 * 6, 4) or \
                not torch.isfinite(heads[1]).all():
            raise AssertionError(f"multi_box_head: {heads[0].shape}")
    torch.cuda.synchronize()
    emit({'phase': 'detection_parity', 'tolerance_fp64': TOL,
          'tolerance_fp32': MODEL_TOL, 'near_threshold': NEAR_THRESHOLD,
          'errors': rows, 'seconds': time.perf_counter() - t0})


def _ssd_pre_nms(model, x):
    """The eval SSD's decoded boxes (B, P, 4) and class probabilities
    (B, C, P): what ``detection_output`` hands its NMS."""
    from paddle_tpu_torch.vision.ops import box_coder
    with torch.inference_mode():
        loc, conf = model(x)
        boxes = box_coder(model.priors, model.prior_vars, loc,
                          code_type='decode_center_size')
        return boxes, torch.softmax(conf, -1).transpose(1, 2)


def _ssd_detect_syncs(model, x):
    """``detection_output`` alone on one batch at ``nms_top_k`` 400 and 100
    -> ({top_k: host syncs}, their sites, its device ms at 400 (CUDA
    events, a median of 5))."""
    from paddle_tpu_torch.vision import detection_output
    with torch.inference_mode():
        loc, conf = model(x)
        syncs, sites = {}, []
        for k in (400, 100):
            kw = dict(SSD_DETECT, nms_top_k=k)
            detection_output(loc, conf, model.priors, model.prior_vars, **kw)
            torch.cuda.synchronize()
            _, n, where = _count_syncs(lambda: detection_output(
                loc, conf, model.priors, model.prior_vars, **kw))
            syncs[k] = n - (_SYNC_NOTICE in ' '.join(where))
            sites += [w for w in where if _SYNC_NOTICE not in w]
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            detection_output(loc, conf, model.priors, model.prior_vars,
                             **SSD_DETECT)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
    return syncs, sorted(set(sites)), float(np.median(ms))


def phase_serve_ssd(seed, card):
    """``ServingEngine.register(layer=SSDDetector(SSDMobileNet()))`` (the
    engine puts it in eval mode) at full
    width (3 x 300 x 300, 21 classes, ``SSD_PRIORS`` priors), fp32, in
    ``RESNET_WAVES`` (buckets 1-16); a request's response is (out (200, 6),
    count). Gates: every response ok with those shapes; for the first
    ``SSD_CHECKED`` requests the pre-NMS boxes and scores within
    ``MODEL_TOL`` of the same model's on the CPU, and the served
    detections equal to ``multiclass_nms`` run on the CPU on the card's
    pre-NMS tensors; ``detection_output``'s host syncs at most
    ``DETECT_SYNC_BUDGET``, the same at ``nms_top_k`` 400 and 100; the
    seven kernels' launch counters zero.
    Printed: requests/s, p50/p99 batch ms per bucket, ``detection_output``'s
    own device ms at bucket 16 and its host syncs, peak memory; then one
    profiled bucket-16 batch. -> the path's launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.vision.ops import multiclass_nms
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 53)
    t0 = time.perf_counter()
    model = SSDMobileNet(device=dev, generator=gen).eval()
    if model.priors.shape[0] != SSD_PRIORS:
        raise AssertionError(f"SSD priors: {model.priors.shape[0]}")
    eng = ServingEngine(queue_capacity=64, device=dev)
    ep = eng.register('ssd', layer=SSDDetector(model), example={
        'x': np.zeros((3, SSD_IMAGE, SSD_IMAGE), np.float32)})
    warm = eng.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rs = np.random.RandomState(seed + 54)
    reqs = [{'x': rs.randn(3, SSD_IMAGE, SSD_IMAGE).astype(np.float32)}
            for _ in range(sum(RESNET_WAVES))]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()              # the main path starts here
    (served, batch_ms, serve_s), syncs, sync_sites = _count_syncs(
        lambda: _waves(eng, ep, reqs, RESNET_WAVES))
    counts = kernels.launch_counts()           # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    _zero_counts(counts, 'serve_ssd')
    found = []
    for i, resp in enumerate(served):
        if not resp.ok:
            raise AssertionError(f"ssd request {i}: {resp.status}")
        out, n = (np.asarray(o) for o in resp.outputs)
        if out.shape != (SSD_DETECT['keep_top_k'], 6) or n.shape != () \
                or not np.isfinite(out).all():
            raise AssertionError(f"ssd request {i}: {out.shape}, {n}")
        found.append(int(n))
    # the checked requests were served one a batch (bucket 1): each is
    # recomputed alone, so the convolutions run at the served shapes
    cpu = copy.deepcopy(model).to('cpu').eval()
    bg = torch.arange(SSD_CLASSES, device=dev)[None, :, None] == 0
    pre = {'boxes': 0.0, 'scores': 0.0}
    near = 0
    for i in range(SSD_CHECKED):
        x = torch.from_numpy(reqs[i]['x'][None])
        boxes, probs = _ssd_pre_nms(model, x.to(dev))
        cboxes, cprobs = _ssd_pre_nms(cpu, x)
        pre['boxes'] = max(pre['boxes'], rel_err(boxes.cpu(), cboxes))
        pre['scores'] = max(pre['scores'], rel_err(probs.cpu(), cprobs))
        want, want_n = multiclass_nms(boxes.cpu(), probs.cpu(), **SSD_DETECT)
        out, n = (torch.from_numpy(np.asarray(o))
                  for o in served[i].outputs)
        if not (torch.equal(out, want[0]) and int(n) == int(want_n[0])):
            raise AssertionError(f"ssd request {i}: the served detections "
                                 f"differ from the CPU's NMS on the card's "
                                 f"pre-NMS tensors")
        near += _nms_near(boxes[:, None], torch.where(bg, -math.inf, probs),
                          SSD_DETECT['nms_threshold'],
                          SSD_DETECT['nms_top_k'],
                          SSD_DETECT['score_threshold'])
    for key, err in pre.items():
        check(f'ssd pre-NMS {key}, GPU vs CPU', err, MODEL_TOL)
    big = torch.from_numpy(np.stack([r['x'] for r in reqs[:16]])).to(dev)
    det_syncs, det_sites, det_ms = _ssd_detect_syncs(model, big)
    if det_syncs[400] != det_syncs[100] or \
            det_syncs[400] > DETECT_SYNC_BUDGET:
        raise AssertionError(f"detection_output's host syncs: {det_syncs} "
                             f"(budget {DETECT_SYNC_BUDGET}, the same at "
                             f"every nms_top_k): {det_sites}")
    lat = {str(bk): {'batches': len(v), 'p50_ms': float(np.percentile(v, 50)),
                     'p99_ms': float(np.percentile(v, 99))}
           for bk, v in sorted(batch_ms.items())}
    emit({'phase': 'serve_ssd', 'model': 'ssd_mobilenet_v1_voc',
          'image': [3, SSD_IMAGE, SSD_IMAGE], 'classes': SSD_CLASSES,
          'priors': int(model.priors.shape[0]), 'detect': SSD_DETECT,
          'dtype': 'float32', 'cudnn_tf32': torch.backends.cudnn.allow_tf32,
          'card': card, 'setup_s': setup_s,
          'warmup_buckets': warm['ssd'], 'requests': len(served),
          'requests_per_s': len(served) / serve_s,
          'batch_latency_ms': lat, 'peak_gb': peak / 1e9,
          'detections_per_image': {'min': min(found), 'max': max(found),
                                   'mean': float(np.mean(found))},
          'detection_output_ms_bucket16': det_ms,
          'detection_output_host_syncs': det_syncs,
          'detection_output_sync_sites': det_sites,
          'launches': counts, 'host_syncs_waves': syncs,
          'host_sync_sites': sync_sites, 'pre_nms_rel_err': pre,
          'near_threshold_pairs': near})

    def one_batch():
        futs = [ep.submit(r) for r in reqs[:16]]
        eng.run_until_idle()
        for f in futs:
            f.result(timeout=600)
    phase_profile('serve_ssd', one_batch, {}, bucket=16)
    return counts


def _ssd_batch(seed, batch, dev, dtype=torch.float32):
    """Images made on the card from a seeded generator and
    ``ssd_ground_truth`` targets -> (images, boxes, labels) on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn((batch, 3, SSD_IMAGE, SSD_IMAGE), generator=gen,
                         device=dev, dtype=dtype)
    boxes, labels = ssd_ground_truth(np.random.RandomState(seed), batch)
    return (images, torch.from_numpy(boxes).to(dev, dtype),
            torch.from_numpy(labels).to(dev))


def _ssd_train_pass(model, batch):
    """One train-mode forward and backward -> (loss, d loss / d loc,
    d loss / d conf, {parameter: gradient}, {buffer: value}), detached."""
    from paddle_tpu_torch.vision import ssd_loss
    images, gt_box, gt_label = batch
    model.train()
    model.zero_grad(set_to_none=True)
    loc, conf = model(images)
    loc.retain_grad()
    conf.retain_grad()
    loss = ssd_loss(loc, conf, gt_box, gt_label, model.priors,
                    model.prior_vars, **SSD_LOSS).sum()
    loss.backward()
    return (loss.detach(), loc.grad.detach(), conf.grad.detach(),
            {n: p.grad.detach() for n, p in model.named_parameters()},
            {n: b.detach().clone() for n, b in model.named_buffers()
             if n.endswith(('_mean', '_variance'))})


def _ssd_state(state):
    """The step's parameters, optimizer slots and buffers by name."""
    out = {f'params.{k}': v for k, v in state['params'].items()}
    for k, st in state['opt'].items():
        items = st.items() if isinstance(st, dict) else [('', st)]
        out.update({f'opt.{k}.{s}': t for s, t in items
                    if isinstance(t, torch.Tensor)})
    out.update({f'buffers.{k}': v for k, v in state['buffers'].items()})
    return out


def phase_train_ssd(seed, card):
    """The SSD in train mode through ``engine.build_train_step(loss_fn=,
    params=, buffers=)`` (``ssd_loss_fn``; BatchNorm's statistics in
    ``state['buffers']``), batch ``TRAIN_SSD_BATCH`` x 3 x 300 x 300, fp32,
    TF32 off, the published optimizer ``RMSProp(learning_rate=0.001)``
    with ``L2Decay(5e-5)``, ``nan_guard=True``; ``TRAIN_SSD_WARMUP`` +
    ``TRAIN_SSD_STEPS`` steps on a fixed batch (CUDA events around each
    timed one). Gates: finite losses, the last below the first; the
    running statistics moved; a batch with a NaN leaves the parameters,
    RMSProp's slots and the buffers bitwise as they were; the seven
    kernels' launch counters zero. Printed: step ms (median), images/s,
    peak GB, host syncs a step; one profiled step. Then one train pass at
    ``SSD_PARITY_BATCH`` x 3 x 300 x 300 in fp64 on the card against the
    CPU: the loss, the location and confidence gradients, every parameter
    gradient and the BatchNorm statistics within ``TOL``. -> the path's
    launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.engine import build_train_step
    from paddle_tpu_torch.engine.builder import persistent_buffers
    from paddle_tpu_torch.nn.regularizer import L2Decay
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 55)
    t0 = time.perf_counter()
    model = SSDMobileNet(device=dev, generator=gen).train()
    batch = _ssd_batch(seed + 56, TRAIN_SSD_BATCH, dev)
    params = dict(model.named_parameters())
    step = build_train_step(
        ssd_loss_fn(model), topt.RMSProp(learning_rate=0.001,
                                         weight_decay=L2Decay(5e-5)),
        params=params, buffers=persistent_buffers(model), nan_guard=True,
        device=dev)
    state = step.init_state()
    stats0 = {n: v.clone() for n, v in state['buffers'].items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = []
    for _ in range(TRAIN_SSD_WARMUP):
        state, out = step(state, batch)
        losses.append(out.loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_SSD_STEPS)]

    def timed():
        for start, end in events:
            start.record()
            _, res = step(state, batch)
            end.record()
            losses.append(res.loss)
    kernels.reset_launch_counts()              # the main path starts here
    _, syncs, sync_sites = _count_syncs(timed)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()           # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    _zero_counts(counts, 'train_ssd')
    ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_ssd: losses {losses}")
    moved = sum(not torch.equal(stats0[n], v)
                for n, v in state['buffers'].items())
    if moved != len(stats0) or not all(
            torch.isfinite(v).all() for v in state['buffers'].values()):
        raise AssertionError(f"train_ssd: {moved} of {len(stats0)} running "
                             f"statistics moved (or not finite)")
    before = {k: v.clone() for k, v in _ssd_state(state).items()}
    bad = batch[0].clone()
    bad[0, 0, 0, 0] = float('nan')
    state, res = step(state, (bad,) + batch[1:])
    after = _ssd_state(state)
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    if np.isfinite(float(res.loss)) or changed:
        raise AssertionError(f"train_ssd: the poisoned step changed "
                             f"{changed[:8]} (loss {float(res.loss)})")
    if step.sync(state)['guard']['skipped'] != 1:
        raise AssertionError("train_ssd: the guard did not count the skip")
    med = float(np.median(ms))
    emit({'phase': 'train_ssd', 'model': 'ssd_mobilenet_v1_voc',
          'batch': TRAIN_SSD_BATCH, 'image': SSD_IMAGE, 'dtype': 'float32',
          'cudnn_tf32': torch.backends.cudnn.allow_tf32,
          'optimizer': 'RMSProp(0.001), L2Decay(5e-5)', 'card': card,
          'setup_s': setup_s, 'step_ms': ms, 'step_ms_median': med,
          'images_per_s': TRAIN_SSD_BATCH / (med / 1e3),
          'peak_gb': peak / 1e9, 'losses': losses, 'launches': counts,
          'host_syncs_per_step': syncs / TRAIN_SSD_STEPS,
          'host_sync_sites': sync_sites, 'running_stats_moved': moved,
          'poisoned_step_skipped': True, 'state_tensors': len(before)})
    phase_profile('train_ssd', lambda: step(state, batch), {})
    del step, state
    # the fp64 train pass, GPU against CPU, on one set of weights
    with tf32_off():
        cpu = SSDMobileNet(device='cpu',
                           generator=torch.Generator().manual_seed(seed + 57))
        cpu = cpu.double()
        gpu = copy.deepcopy(cpu).to(dev)
        small = _ssd_batch(seed + 58, SSD_PARITY_BATCH, 'cpu', torch.float64)
        want = _ssd_train_pass(cpu, small)
        got = _ssd_train_pass(gpu, tuple(t.to(dev) for t in small))
        got = [g.cpu() if isinstance(g, torch.Tensor) else
               {n: t.cpu() for n, t in g.items()} for g in got]
        errs = {'loss': rel_err(got[0], want[0]),
                'loc_grad': rel_err(got[1], want[1]),
                'conf_grad': rel_err(got[2], want[2]),
                'running_stats': max(rel_err(got[4][n], want[4][n])
                                     for n in want[4])}
        for key, err in errs.items():
            check(f'ssd fp64 train {key}, GPU vs CPU', err, TOL)
        worst, worst_of, mean = _compare_grads('ssd fp64 train', got[3],
                                               want[3], TOL)
    emit({'phase': 'train_ssd_parity', 'batch': SSD_PARITY_BATCH,
          'dtype': 'float64', 'tolerance': TOL, 'errors': errs,
          'gradients_worst': worst, 'gradients_worst_of': worst_of,
          'gradients_mean': mean, 'seconds': time.perf_counter() - t0})
    return counts


# ---------------------------------------------------------------------------
# ERNIE fine-tuned and the Transformer seq2seq decoded with beam search
# ---------------------------------------------------------------------------

# the kernels 1-3 held at lengths that are no multiple of the 64-row tile
RAGGED_LENGTHS = (77, 200, 333)
RAGGED_SHAPE = (4, 16, 64)             # batch, heads, head dim
ERNIE_PARITY_BATCH = 2
ERNIE_PARITY_LEN = 333
ERNIE_MAX_PREDICTIONS = 20             # the knowledge mask's static width
# ERNIE 2.0 large-en: bert_large's widths with 4 sentence types
ERNIE_TYPES = 4
ERNIE_CLASSES = 3                      # a sentence-pair task (NLI)
ERNIE_BATCH = 16
ERNIE_LENGTHS = (128, 333, 512, 77)    # the padded lengths, batch by batch
ERNIE_WARMUP = 2
ERNIE_STEPS = 8
ERNIE_LR = 2e-5
# per step of ERNIE-large fine-tuning at p = 0.1: the encoder's attention
# and epilogues, the embeddings' LayerNorm (no MLM head)
FINETUNE_LAUNCHES = {**TRAIN_LAUNCHES, 'layer_norm_fwd': 1}
FINETUNE_ROUTES = {**TRAIN_ROUTES, 'ln_rows_warp_kernel': 1}
S2S_VOCAB = 10000                      # WMT16's default dictionary sizes
S2S_LAYERS = 6
S2S_BATCH = 32
S2S_SHAPES = ((64, 64), (80, 64))      # (source, target) lengths, in turn
S2S_WARMUP = 2
S2S_STEPS = 6
S2S_SOURCES = 16
S2S_SOURCE_LEN = 64
S2S_BEAM = 4
S2S_MAX_LEN = 64
S2S_PARITY_LAYERS = 2                  # encoder and decoder layers each
S2S_PARITY_BATCH = 8
NEAR_TIE = 1e-4                        # selected beam scores this close
# the errors of the ragged cases each attention kernel answers for
RAGGED_ERRS = {'flash_attention_fwd': ('o', 'o_rel', 'lse'),
               'flash_attention_dq': ('dq',),
               'flash_attention_dkv': ('dk', 'dv')}


def _ragged_attention(seed):
    """The forward, dQ and dK/dV kernels against their plain versions at
    ``RAGGED_LENGTHS`` (a tail tile in every direction), fp32 and bf16,
    with BERT's key bias and at p = 0 and 0.1 -> the cases. fp32: o within
    ``TOL``, the gradients ``GRAD_TOL`` relative; bf16: o ``BF16_TOL``
    relative, lse ``STAT_TOL``, the gradients ``BF16_TOL``."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 71)
    b, h, d = RAGGED_SHAPE
    cases = []
    for dtype in (torch.float32, BF16):
        for length in RAGGED_LENGTHS:
            q, k, v, do = (torch.randn(b, h, length, d, device=dev,
                                       generator=gen).to(dtype)
                           for _ in range(4))
            bias, keys = _key_bias(b, length, dev, gen)
            for p in (0.0, 0.1):
                e = _attention_case(fa, q, k, v, do, False, bias, p,
                                    0x5EED + seed, 7)
                what = f"ragged flash {str(dtype)[6:]} L={length} p={p}"
                if dtype == torch.float32:
                    check(f'{what}: o', e['o'], TOL)
                    tol = GRAD_TOL
                else:
                    check(f'{what}: o over its max', e['o_rel'], BF16_TOL)
                    check(f'{what}: lse', e['lse'], STAT_TOL)
                    tol = BF16_TOL
                for g in ('dq', 'dk', 'dv'):
                    check(f'{what}: {g}', e[g], tol)
                cases.append({'dtype': str(dtype)[6:], 'length': length,
                              'tiles': -(-length // 64), 'p': p,
                              'unmasked_keys': keys, **e})
    return cases


def _knowledge_masked(seed, batch, length, vocab):
    """One ``ernie_mask_batch`` batch: random wordpieces grouped into
    words (two or three pieces now and then), each row padded after a
    length drawn in [length / 2, length], two phrase spans a row -> (the
    feeds, (masked labels, NSP labels)) as numpy."""
    from paddle_tpu_torch.text.ernie import ernie_mask_batch
    rs = np.random.RandomState(seed)
    ids = rs.randint(1000, vocab, (batch, length)).astype(np.int64)
    words = np.cumsum(rs.rand(batch, length) < 0.7, axis=1)
    real = rs.randint(length // 2, length + 1, batch)
    spans = []
    for i, n in enumerate(real):
        ids[i, n:], words[i, n:] = 0, -1
        spans.append([(3, 6), (int(words[i, n // 2]),
                               int(words[i, n // 2]) + 2)])
    ids[:, 0] = 101                                      # [CLS]
    masked, pos, labels = ernie_mask_batch(
        ids, words, vocab, max_predictions=ERNIE_MAX_PREDICTIONS,
        phrase_spans=spans, seed=seed)
    feeds = {'input_ids': masked,
             'token_type_ids': rs.randint(0, ERNIE_TYPES, (batch, length)),
             'attention_mask': (words >= 0).astype(np.int64),
             'masked_positions': pos}
    return feeds, (labels, rs.randint(0, 2, (batch, 1)).astype(np.int64))


def phase_ernie_parity(seed):
    """``ErnieForPretraining`` at ERNIE-large's widths, 2 layers, fp32,
    p = 0, TF32 off, on one knowledge-masked batch (``ernie_mask_batch``:
    ``ERNIE_PARITY_BATCH`` x ``ERNIE_PARITY_LEN``, ragged padding masks,
    phrase spans): the loss within ``TOL`` and every gradient within
    ``GRAD_TOL`` (over its tensor's max), GPU against CPU on the same
    weights; then ``_ragged_attention``."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.text.bert import bert_large
    from paddle_tpu_torch.text.ernie import ErnieForPretraining
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    cfg = bert_large(type_vocab_size=ERNIE_TYPES, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    cfg.num_hidden_layers = 2
    x, y = _knowledge_masked(seed + 72, ERNIE_PARITY_BATCH, ERNIE_PARITY_LEN,
                             cfg.vocab_size)
    with tf32_off():
        gen = torch.Generator(device=dev).manual_seed(seed + 73)
        model = ErnieForPretraining(cfg, device=dev, generator=gen).train()
        kernels.reset_launch_counts()
        loss, grads = _loss_and_grads(model, x, y, dev)
        counts = kernels.launch_counts()
        cpu = copy.deepcopy(model).to('cpu')
        ref_loss, ref_grads = _loss_and_grads(cpu, x, y, 'cpu')
    del model, cpu
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    check('ernie parity: loss, GPU vs CPU', loss_err, TOL)
    worst, worst_of, mean = _compare_grads('ernie parity', grads, ref_grads)
    if counts != PARITY_LAUNCHES | {'dropout_grad': 0}:
        raise AssertionError(f"ernie parity: launches {counts}")
    cases = _ragged_attention(seed)
    torch.cuda.empty_cache()
    emit({'phase': 'ernie_parity', 'layers': 2, 'hidden': cfg.hidden_size,
          'type_vocab_size': ERNIE_TYPES,
          'batch': [ERNIE_PARITY_BATCH, ERNIE_PARITY_LEN],
          'real_tokens': x['attention_mask'].sum(1).tolist(),
          'masked_predictions': int((y[0] >= 0).sum()),
          'tolerance': {'loss': TOL, 'gradients': GRAD_TOL},
          'loss': loss, 'reference_loss': ref_loss, 'loss_rel_err': loss_err,
          'gradients_worst': worst, 'gradients_worst_of': worst_of,
          'gradients_mean': mean, 'gradients': len(grads),
          'launches': counts, 'ragged_attention': cases,
          'seconds': time.perf_counter() - t0})
    return cases


class ErnieClassifier(torch.nn.Module):
    """ERNIE's sentence-pair classifier: the pooled output, dropout 0.1
    (the model's ``DropoutState``), then ``Linear(hidden, classes)``."""

    def __init__(self, cfg, classes, *, device, generator):
        super().__init__()
        from paddle_tpu_torch.nn import Dropout, Linear
        from paddle_tpu_torch.text.ernie import ErnieModel
        self.ernie = ErnieModel(cfg, device=device, generator=generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob,
                               dropout_state=self.ernie.dropout_state)
        self.classifier = Linear(cfg.hidden_size, classes, device=device,
                                 generator=generator)

    @property
    def dropout_state(self):
        return self.ernie.dropout_state

    def forward(self, input_ids, token_type_ids, attention_mask):
        _, pooled = self.ernie(input_ids, token_type_ids,
                               attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))


def _finetune_set(seed, vocab, lengths):
    """Batches of ``ERNIE_BATCH`` sentence pairs, batch j padded to
    ``lengths[j]``: [CLS] A [SEP] B [SEP], sentence types 0 and 1, each
    row's real length drawn in [L / 2, L] with its padding mask, the
    labels balanced within a batch; half of a row's real tokens are one
    id that its label picks, so that the loss can fall in a few steps.
    -> an ``io.Dataset`` of ({'input_ids', 'token_type_ids',
    'attention_mask'}, (label,)) in batch order."""
    from paddle_tpu_torch import io
    rs = np.random.RandomState(seed)
    rows = []
    for L in lengths:
        for label in rs.permutation(np.arange(ERNIE_BATCH) % ERNIE_CLASSES):
            n = rs.randint(L // 2, L + 1)
            ids = rs.randint(1000, vocab, L)
            ids[rs.rand(L) < 0.5] = 1000 + label
            a = rs.randint(2, n - 2)
            ids[0], ids[a], ids[n - 1], ids[n:] = 101, 102, 102, 0
            types = np.zeros(L, np.int64)
            types[a + 1:n] = 1
            rows.append(({'input_ids': ids.astype(np.int64),
                          'token_type_ids': types,
                          'attention_mask': (np.arange(L) < n).astype(
                              np.int64)},
                         (np.int64(label),)))

    class Pairs(io.Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i]
    return Pairs()


def phase_finetune_ernie(seed, card):
    """ERNIE-large fine-tuned through ``hapi.Model.fit``, the dygraph path:
    ``ErnieClassifier`` on ``ErnieModel(bert_large(type_vocab_size=4))``
    (24 layers, hidden 1024, dropout 0.1), fp32 (TF32 off), AdamW(2e-5,
    weight decay 0.01, none on LayerNorm and biases) under a linear
    warm-up, the gradient clipped to a global norm of 1.0; one epoch of
    ``_finetune_set`` (batch 16, dynamic shapes: the padded length cycles
    128, 333, 512, 77), the first ``ERNIE_WARMUP`` batches a warm-up.
    Gates: every step launches ``FINETUNE_LAUNCHES`` exactly (kernels 1,
    2, 3, 4, 6 and 7 at every length); finite losses; the loss of a
    held-out batch (eval mode, outside the counted path) lower after the
    fit than before it; at most one host sync a step (the loop's loss
    fetch). Printed: step ms by length, samples/s, peak memory, the
    device's idle share in one profiled step (at 512). -> the path's
    launch counts."""
    from paddle_tpu_torch import Model, io, kernels
    from paddle_tpu_torch.hapi.callbacks import Callback, LRScheduler
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW, lr
    from paddle_tpu_torch.text.bert import bert_large
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    cfg = bert_large(type_vocab_size=ERNIE_TYPES)
    gen = torch.Generator(device=dev).manual_seed(seed + 74)
    net = ErnieClassifier(cfg, ERNIE_CLASSES, device=dev, generator=gen)
    sched = lr.LinearWarmup(ERNIE_LR, ERNIE_WARMUP, 0.0, ERNIE_LR)
    opt = AdamW(learning_rate=sched, weight_decay=0.01,
                apply_decay_param_fun=lambda n: not _no_decay(n),
                grad_clip=ClipGradByGlobalNorm(1.0),
                parameters=net.named_parameters())

    def loss(logits, label):
        return F.cross_entropy(logits, label.reshape(-1))
    model = Model(net, device=dev).prepare(opt, loss)
    steps = ERNIE_WARMUP + ERNIE_STEPS
    lengths = [ERNIE_LENGTHS[j % len(ERNIE_LENGTHS)] for j in range(steps)]
    loader = io.DataLoader(_finetune_set(seed + 75, cfg.vocab_size, lengths),
                           batch_size=ERNIE_BATCH, shuffle=False, device=dev)
    # a held-out batch, scored in eval mode before and after the fit
    held_out = next(iter(io.DataLoader(
        _finetune_set(seed + 76, cfg.vocab_size, ERNIE_LENGTHS[:1]),
        batch_size=ERNIE_BATCH, device=dev)))

    class Launches(Callback):
        """Each batch's own launches (the counters read, never reset)."""

        def __init__(self):
            super().__init__()
            self.rows = []

        def on_train_batch_begin(self, step, logs=None):
            self.before = kernels.launch_counts()

        def on_train_batch_end(self, step, logs=None):
            now = kernels.launch_counts()
            self.rows.append({k: now[k] - self.before[k] for k in now})
    clock, launches = _step_clock(), Launches()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with tf32_off():
        before = model.eval_batch(*held_out)[0][0]
        kernels.reset_launch_counts()          # the main path: the fit
        t1 = time.perf_counter()
        _, n_sync, where = _count_syncs(lambda: model.fit(
            loader, epochs=1, shuffle=False, verbose=0,
            callbacks=[clock, LRScheduler(), launches]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = kernels.launch_counts()       # ... read right after it
        after = model.eval_batch(*held_out)[0][0]
    n_sync -= _SYNC_NOTICE in ' '.join(where)
    peak = torch.cuda.max_memory_allocated()
    bad = [(lengths[j], c) for j, c in enumerate(launches.rows)
           if c != FINETUNE_LAUNCHES]
    if len(launches.rows) != steps or bad:
        raise AssertionError(f"finetune_ernie: {len(launches.rows)} steps, "
                             f"launches off at {bad[:2]}")
    losses = [float(r[3]['loss']) for r in clock.rows]
    if not all(np.isfinite(losses)) or not after < before:
        raise AssertionError(f"finetune_ernie: held-out loss {before} -> "
                             f"{after}, losses {losses}")
    if n_sync > steps:
        raise AssertionError(f"finetune_ernie: {n_sync} host syncs in "
                             f"{steps} steps: {where[:4]}")
    ends = [r[2] for r in clock.rows]
    ms = [1e3 * (b - a) for a, b in zip(ends, ends[1:])][ERNIE_WARMUP - 1:]
    timed = lengths[ERNIE_WARMUP:]
    by_length = {L: [m for m, n in zip(ms, timed) if n == L]
                 for L in ERNIE_LENGTHS}
    tokens = ERNIE_BATCH * sum(timed)
    row = {'phase': 'finetune_ernie', 'model': 'ERNIE 2.0 large-en widths '
           '(bert_large, type_vocab_size 4), sentence-pair classifier',
           'entry': 'hapi.Model.fit (eager)', 'card': card,
           'layers': cfg.num_hidden_layers,
           'batch': ERNIE_BATCH, 'lengths': lengths, 'dropout': 0.1,
           'dtype': 'float32 (TF32 off)',
           'optimizer': f'AdamW({ERNIE_LR}, weight_decay=0.01, no decay on '
                        f'LayerNorm and biases), LinearWarmup({ERNIE_WARMUP}'
                        f' steps), ClipGradByGlobalNorm(1.0)',
           'setup_s': setup_s, 'fit_wall_s': wall,
           'step_ms_by_length': {str(L): v for L, v in by_length.items()},
           'step_ms_median_by_length': {str(L): float(np.median(v))
                                        for L, v in by_length.items()},
           'samples_per_s': ERNIE_BATCH * len(ms) / (sum(ms) / 1e3),
           'tokens_per_s': tokens / (sum(ms) / 1e3),
           'peak_gb': peak / 1e9, 'own_peak_gb': (peak - held) / 1e9,
           'losses': losses, 'held_out_loss': [before, after],
           'host_syncs': n_sync,
           'host_syncs_per_step': n_sync / steps, 'sync_sites': where[:4],
           'launches_per_step': FINETUNE_LAUNCHES, 'launches': counts,
           'seconds': time.perf_counter() - t0}
    emit(row)
    longest = max(ERNIE_LENGTHS)
    batch = next(b for j, b in enumerate(loader) if lengths[j] == longest)
    with tf32_off():
        prof = phase_profile(f'finetune_ernie train_batch (L = {longest})',
                             lambda: model.train_batch(*batch),
                             FINETUNE_ROUTES, top_n=12,
                             batch=[ERNIE_BATCH, longest])
    emit({'phase': 'finetune_ernie_profile', 'wall_ms': prof['wall_ms'],
          'device_busy_ms': prof['device_busy_ms'],
          'device_idle_share': prof['device_idle_share']})
    del model, net, opt, batch, loader
    torch.cuda.empty_cache()
    return counts


def _s2s_launches(src_len, trg_len, layers=S2S_LAYERS):
    """One train step's launches at p = 0.1: the encoder's attention (and
    the cross-attention when the lengths match) on kernels 1-3, its fused
    epilogues (6, and 7 backward), the decoder's LayerNorms (4)."""
    attn = layers * (2 if src_len == trg_len else 1)
    return {'flash_attention_fwd': attn, 'flash_attention_dq': attn,
            'flash_attention_dkv': attn, 'add_layer_norm_fwd': 2 * layers,
            'dropout_grad': 2 * layers, 'layer_norm_fwd': 3 * layers,
            'rms_norm_fwd': 0}


def _translate_launches(steps, layers=S2S_LAYERS):
    """One ``translate`` call's launches over ``steps`` decoding steps: the
    encoder's self-attention (kernel 1) and epilogues (6), the first
    step's self-attention (one query against the one key cached: kernel
    1), each step's decoder LayerNorms (4)."""
    return {'flash_attention_fwd': 2 * layers, 'flash_attention_dq': 0,
            'flash_attention_dkv': 0, 'add_layer_norm_fwd': 2 * layers,
            'dropout_grad': 0, 'layer_norm_fwd': 3 * layers * steps,
            'rms_norm_fwd': 0}


@contextlib.contextmanager
def _traced_beams(tops=False):
    """``text.seq2seq``'s beam search with each step's host time (taken
    after the loop's host read, so every earlier step has finished on the
    device) and outputs (the selected scores, ids and parents) kept; with
    ``tops``, also each step's best ``beam + 1`` candidate scores (the
    first one left out of the beams too), taken from the scores the
    search's own top-W selects from."""
    from paddle_tpu_torch.text import seq2seq
    base = seq2seq.BeamSearchDecoder
    trace = {'marks': [], 'outputs': [], 'tops': []}
    seq2seq.BeamSearchDecoder = _traced_decoder(base, trace, tops)
    try:
        yield trace
    finally:
        seq2seq.BeamSearchDecoder = base


def _traced_decoder(base, trace, tops):
    """``base`` (a beam search decoder class) keeping each step's host
    time and outputs in ``trace`` (and with ``tops`` each step's best
    ``beam + 1`` candidate scores): ``_traced_beams``'s class."""
    class Traced(base):
        def step(self, t, inputs, states, **kw):
            trace['marks'].append(time.perf_counter())
            out = super().step(t, inputs, states, **kw)
            trace['outputs'].append(out[0])
            return out

        def _candidate_log_probs(self, logits, beam_state):
            lp = super()._candidate_log_probs(logits, beam_state)
            if tops:
                trace['tops'].append(torch.topk(
                    lp.reshape(lp.shape[0], -1), self.beam_size + 1).values)
            return lp
    return Traced


def _near_ties(tops):
    """-> per source row, the first step at which two of its best ``beam +
    1`` candidates lie within ``NEAR_TIE`` (None when none do): there a
    different summation order may pick other beams."""
    first = [None] * tops[0].shape[0]
    for t, top in enumerate(tops):
        gaps = top[:, :-1] - top[:, 1:]
        for b in torch.nonzero(gaps.min(dim=1).values < NEAR_TIE
                               ).flatten().tolist():
            if first[b] is None:
                first[b] = t
    return first


def _beams_held(what, gpu, cpu, steps):
    """Two traced searches (``_traced_decoder`` with ``tops``), the card's
    and the CPU's: every row's selected (score, id, parent) equal step by
    step (scores within ``TOL`` of their max) up to its first near-tie
    (two of its best ``beam + 1`` candidates within ``NEAR_TIE``, on either
    side) -> (each row's first near-tie step or None, the rows with none,
    the scores' worst error)."""
    ties = [min((t for t in (a, b) if t is not None), default=None)
            for a, b in zip(_near_ties(gpu['tops']), _near_ties(cpu['tops']))]
    score_err, held_rows = 0.0, []
    for b, tie in enumerate(ties):
        upto = steps if tie is None else tie
        if len(cpu['outputs']) < upto:
            raise AssertionError(f"{what}: the CPU's search stopped before "
                                 f"step {upto} (row {b})")
        for t in range(upto):
            g = gpu['outputs'][t]
            w = cpu['outputs'][t]
            for key in ('predicted_ids', 'parent_ids'):
                if not torch.equal(g[key][b].cpu(), w[key][b]):
                    raise AssertionError(
                        f"{what}: row {b} step {t} {key} differ from the "
                        f"CPU's before any near-tie")
            score_err = max(score_err, rel_err(g['scores'][b].cpu(),
                                               w['scores'][b]))
        if tie is None:
            held_rows.append(b)
    check(f'{what}: step scores, GPU vs CPU', score_err, TOL)
    return ties, held_rows, score_err


def _s2s_loss_and_grads(model, batch, device):
    """One teacher-forced forward and backward of the target tokens'
    cross-entropy -> (loss, {name: fp32 gradient on the host}), with the
    model's dropout state rewound to offset 0."""
    from paddle_tpu_torch.nn import functional as F
    model.dropout_state.offset = 0
    params = dict(model.named_parameters())
    src, trg_in, trg_out = (torch.from_numpy(a).to(device) for a in batch)
    logits = model(src, trg_in)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           trg_out.reshape(-1))
    grads = torch.autograd.grad(loss, list(params.values()))
    return (float(loss.detach()),
            {n: g.detach().float().cpu() for n, g in zip(params, grads)})


def _width_512_norms(seed):
    """Kernels 4, 6 and 7 against their plain versions at Transformer-base's
    width, fp32, at the rows the seq2seq's paths give them: the train
    step's (``S2S_BATCH`` x 64 tokens) with the saved statistics (y, mean,
    rstd; y, yin, mean, rstd) and add+LayerNorm at p = 0 and 0.1, the
    mask gradient at p = 0.1; ``translate``'s encoder rows (``S2S_SOURCES``
    x ``S2S_SOURCE_LEN``, p = 0, no statistics) and a decoding step's
    (``S2S_SOURCES`` x ``S2S_BEAM`` rows); the LayerNorm at the text zoo
    Transformer's rows (``_text_transformer``): its pass's (``TT_BATCH`` x
    ``TT_LEN``, with the statistics), its beam search's encoder (the same
    rows, without) and decoding step (``TT_BATCH`` x ``TT_BEAM``,
    without). Each within ``TOL``; the train
    shapes also timed, beside their library yardsticks (the rows of the
    kernels phases' own: ``torch.native_layer_norm`` with its statistics;
    ``x + res``, then ``native_layer_norm``; the multiply by a stored mask)
    and a device copy of as many bytes -> {kernel: [case, ...]}."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import fused_dropout_norm as fdn
    from paddle_tpu_torch.kernels import fused_norm, philox
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 78)
    P, SEED, E = 0.1, 0x5EED + seed, 512
    train_rows = S2S_BATCH * 64
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)
    w, b = 1.0 + 0.1 * randn(E), 0.1 * randn(E)
    out = {'layer_norm_fwd': [], 'add_layer_norm_fwd': [], 'dropout_grad': []}

    def hold(name, what, fn, timed, work, library=None):
        got = fn()
        with kernels.plain_versions():
            want = fn()
            plain = time_ms(fn, flush) if timed else None
        torch.cuda.synchronize()
        err = max(max_err(a, c) for a, c in zip(got, want) if a is not None)
        check(f'{name} {what}', err, TOL)
        case = {'case': what, 'max_abs_err': err}
        if timed:
            case.update({'ms': time_ms(fn, flush), 'plain_ms': plain,
                         'library': library[0],
                         'library_ms': time_ms(library[1], flush),
                         'copy_ms': copy_ms(work['bytes'], flush), **work})
        out[name].append(case)

    for rows, stats, timed in ((train_rows, True, True),
                               (S2S_SOURCES * S2S_BEAM, False, False),
                               (TT_BATCH * TT_LEN, True, False),
                               (TT_BATCH * TT_LEN, False, False),
                               (TT_BATCH * TT_BEAM, False, False)):
        x = randn(rows, E)
        hold('layer_norm_fwd', f'({rows}, {E}) stats={stats}',
             lambda x=x, st=stats: fused_norm._forward(x, w, b, 1e-5, st),
             timed, bound(8.0 * rows * E, 4.0 * (2 * rows * E + 2 * E
                                                 + 2 * rows)),
             ('torch.native_layer_norm (y, mean, rstd)',
              lambda x=x: torch.native_layer_norm(x, (E,), w, b, 1e-5)))
    for rows, p, saved, timed in ((train_rows, 0.0, True, True),
                                  (train_rows, P, True, True),
                                  (S2S_SOURCES * S2S_SOURCE_LEN, 0.0, False,
                                   False)):
        x, res = randn(rows, E), randn(rows, E)
        hold('add_layer_norm_fwd', f'({rows}, {E}) p={p} saved={saved}',
             lambda x=x, res=res, p=p, sv=saved: fdn._forward(
                 x, res, w, b, p, 1e-5, SEED, 5, sv), timed,
             bound(9.0 * rows * E, 4.0 * (4 * rows * E + 2 * E + 2 * rows)),
             (ADD_LN_LIBRARY, lambda x=x, res=res: torch.native_layer_norm(
                 x + res, (E,), w, b, 1e-5)))
    g = randn(train_rows, E)
    stored = philox.keep_scale(g.shape, P, SEED, 5, dev)
    hold('dropout_grad', f'({train_rows}, {E}) p={P}',
         lambda: (fdn.dropout_grad(g, P, SEED, 5),), True,
         bound(1.0 * train_rows * E, 4.0 * 2 * train_rows * E),
         ('multiply by a stored (N, D) fp32 mask', lambda: g * stored))
    del flush
    return out


def phase_seq2seq_parity(seed):
    """``Seq2SeqTransformer`` at Transformer-base's widths (d_model 512, 8
    heads, FFN 2048, vocabularies 10000), ``S2S_PARITY_LAYERS`` +
    ``S2S_PARITY_LAYERS`` layers, p = 0, TF32 off, on one batch of
    ``S2S_PARITY_BATCH`` sources and targets of 64 tokens (the
    cross-attention on the flash kernel): the card's fp32 teacher-forced
    loss within ``TOL`` and every gradient within ``GRAD_TOL`` (over its
    tensor's max) of the CPU's in fp64 on the same weights, with the train
    step's launches at p = 0. The CPU's fp32 pass is printed beside it,
    not held: on this model the plain attention's fp32 backward (the CPU's
    path) lies 3.4e-3 from fp64 on the encoder's last FFN, the kernels
    2e-5. Then ``_width_512_norms`` -> its cases."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.text import Seq2SeqTransformer
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed + 79)
    src = rs.randint(2, S2S_VOCAB, (S2S_PARITY_BATCH, 64))
    trg = rs.randint(2, S2S_VOCAB, (S2S_PARITY_BATCH, 65))
    trg[:, 0] = 0                                           # bos
    batch = (src, trg[:, :-1], trg[:, 1:])
    with tf32_off():
        gen = torch.Generator(device=dev).manual_seed(seed + 80)
        model = Seq2SeqTransformer(
            S2S_VOCAB, S2S_VOCAB, num_encoder_layers=S2S_PARITY_LAYERS,
            num_decoder_layers=S2S_PARITY_LAYERS, dropout=0.0, device=dev,
            generator=gen).train()
        kernels.reset_launch_counts()
        loss, grads = _s2s_loss_and_grads(model, batch, dev)
        counts = kernels.launch_counts()
        cpu = copy.deepcopy(model).to('cpu')
        cpu_loss, cpu_grads = _s2s_loss_and_grads(cpu, batch, 'cpu')
        ref_loss, ref_grads = _s2s_loss_and_grads(cpu.double(), batch,
                                                  'cpu')
    del model, cpu
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    check('seq2seq parity: loss, GPU vs CPU fp64', loss_err, TOL)
    worst, worst_of, mean = _compare_grads('seq2seq parity (GPU vs CPU '
                                           'fp64)', grads, ref_grads)
    cpu32 = {'loss_rel_err': abs(cpu_loss - ref_loss) / abs(ref_loss)}
    for what, errs in (('cpu_fp32', _grad_errs(cpu_grads, ref_grads)),
                       ('gpu_vs_cpu_fp32', _grad_errs(grads, cpu_grads))):
        name = max(errs, key=errs.get)
        cpu32[f'{what}_gradients_worst'] = [name, errs[name]]
    want = _s2s_launches(64, 64, S2S_PARITY_LAYERS) | {'dropout_grad': 0}
    if counts != want:
        raise AssertionError(f"seq2seq parity: launches {counts}, expected "
                             f"{want}")
    norms = _width_512_norms(seed)
    torch.cuda.empty_cache()
    emit({'phase': 'seq2seq_parity',
          'layers': [S2S_PARITY_LAYERS, S2S_PARITY_LAYERS], 'd_model': 512,
          'batch': [S2S_PARITY_BATCH, 64, 64],
          'against': 'the CPU in fp64, same weights',
          'tolerance': {'loss': TOL, 'gradients': GRAD_TOL},
          'loss': loss, 'reference_loss': ref_loss, 'loss_rel_err': loss_err,
          'gradients_worst': worst, 'gradients_worst_of': worst_of,
          'gradients_mean': mean, 'gradients': len(grads),
          'cpu_fp32_not_held': cpu32,
          'launches': counts, 'width_512': norms,
          'seconds': time.perf_counter() - t0})
    return norms


def phase_seq2seq(seed, card):
    """``Seq2SeqTransformer`` at Transformer-base (d_model 512, 8 heads, 6
    + 6 layers, FFN 2048, dropout 0.1, 256 positions; vocabularies 10000
    and 10000, ``text.datasets.WMT16``'s defaults), fp32 (TF32 off).

    Train: ``engine.build_train_step`` with AdamW(beta2 0.98, eps 1e-9) on
    ``NoamDecay(512, 4000)``, cross-entropy over the target tokens, batch
    32, ``S2S_WARMUP + S2S_STEPS`` steps alternating (source, target) =
    (64, 64) (the cross-attention on the flash kernel) and (80, 64)
    (composed); every step's launches exactly ``_s2s_launches``, every
    loss finite; ms a step and tokens/s; one profiled step.

    Translate: ``translate`` of ``S2S_SOURCES`` sources of 64 ids, beam 4,
    ``max_len`` 64 (the main path: kernels 1, 4 and 6), exact launches;
    first-token ms, ms a decode step (p50), tokens/s, host reads a step,
    peak memory; one profiled call. Then the same search on the CPU on the
    same weights: every row's selected (score, id, parent) equal step by
    step (scores within ``TOL`` of their max) up to its first near-tie
    (two of its best ``beam + 1`` candidates within ``NEAR_TIE``, on
    either side), and on the rows with none the best beam's ids equal and
    the final log-probabilities within ``TOL``; the near-tie rows counted.
    -> (the train path's launches, the translate path's)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.engine import build_train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW, lr
    from paddle_tpu_torch.text import Seq2SeqTransformer
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 76)
    model = Seq2SeqTransformer(S2S_VOCAB, S2S_VOCAB, device=dev,
                               generator=gen).train()
    sched = lr.NoamDecay(d_model=512, warmup_steps=4000)
    opt = AdamW(learning_rate=sched, beta2=0.98, epsilon=1e-9)

    def loss(logits, labels):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
    step = build_train_step(net=model, loss=loss, optimizer=opt, device=dev)
    state = step.init_state()
    rs = np.random.RandomState(seed + 77)
    batches = []
    for src_len, trg_len in S2S_SHAPES:
        src = rs.randint(2, S2S_VOCAB, (S2S_BATCH, src_len))
        trg = rs.randint(2, S2S_VOCAB, (S2S_BATCH, trg_len + 1))
        trg[:, 0] = 0                                       # bos
        batches.append(tuple(torch.from_numpy(a).to(dev) for a in
                             (src, trg[:, :-1], trg[:, 1:])))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, ms, totals = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    with tf32_off():
        for i in range(S2S_WARMUP + S2S_STEPS):
            src, trg_in, trg_out = batches[i % len(batches)]
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            kernels.reset_launch_counts()      # the main path: one step
            start.record()
            state, res = step(state, ((src, trg_in), (trg_out,)))
            end.record()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()   # ... read right after it
            want = _s2s_launches(src.shape[1], trg_in.shape[1])
            if counts != want:
                raise AssertionError(f"seq2seq train step {i}: launches "
                                     f"{counts}, expected {want}")
            for k, n in counts.items():
                totals[k] = totals.get(k, 0) + n
            sched.step()
            losses.append(float(res.loss))
            if i >= S2S_WARMUP:
                ms.append(start.elapsed_time(end))
        train_peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            raise AssertionError(f"seq2seq train: losses {losses}")
        by_shape = {f'{s}x{t}': [m for i, m in enumerate(ms)
                                 if S2S_SHAPES[(i + S2S_WARMUP) % 2] == (s, t)]
                    for s, t in S2S_SHAPES}
        emit({'phase': 'seq2seq_train', 'model': 'Transformer-base '
              '(Seq2SeqTransformer defaults)', 'card': card,
              'layers': [S2S_LAYERS, S2S_LAYERS], 'vocab': S2S_VOCAB,
              'batch': S2S_BATCH, 'shapes': S2S_SHAPES, 'dropout': 0.1,
              'dtype': 'float32 (TF32 off)',
              'optimizer': 'AdamW(beta2=0.98, epsilon=1e-9) on '
                           'NoamDecay(d_model=512, warmup_steps=4000)',
              'setup_s': setup_s, 'step_ms': ms,
              'step_ms_median_by_shape': {k: float(np.median(v))
                                          for k, v in by_shape.items()},
              'target_tokens_per_s': S2S_BATCH * 64 * len(ms) /
              (sum(ms) / 1e3), 'peak_gb': train_peak / 1e9,
              'losses': losses, 'launches': totals,
              'launches_per_step': {f'{s}x{t}': _s2s_launches(s, t)
                                    for s, t in S2S_SHAPES}})
        src, trg_in, trg_out = batches[0]
        prof = phase_profile('seq2seq train step (64 x 64)',
                             lambda: step(state, ((src, trg_in),
                                                  (trg_out,))), {},
                             batch=[S2S_BATCH, 64])
        emit({'phase': 'seq2seq_train_profile', 'wall_ms': prof['wall_ms'],
              'device_busy_ms': prof['device_busy_ms'],
              'device_idle_share': prof['device_idle_share']})
        del step, state, batches, opt
        torch.cuda.empty_cache()

        model.eval()
        sources = torch.from_numpy(rs.randint(
            2, S2S_VOCAB, (S2S_SOURCES, S2S_SOURCE_LEN))).to(dev)
        model.translate(sources[:2], beam_size=S2S_BEAM, max_len=4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with _traced_beams() as trace:
            kernels.reset_launch_counts()      # the main path: translate
            t1 = time.perf_counter()
            ids, n_sync, where = _count_syncs(lambda: model.translate(
                sources, beam_size=S2S_BEAM, max_len=S2S_MAX_LEN))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            decoded = kernels.launch_counts()  # ... read right after it
        peak = torch.cuda.max_memory_allocated()
        n_sync -= _SYNC_NOTICE in ' '.join(where)
        steps = len(trace['outputs'])
        want = _translate_launches(steps)
        if decoded != want:
            raise AssertionError(f"seq2seq translate: launches {decoded}, "
                                 f"expected {want}")
        if tuple(ids.shape) != (S2S_SOURCES, S2S_MAX_LEN, S2S_BEAM) or \
                ids.min() < 0 or ids.max() >= S2S_VOCAB:
            raise AssertionError(f"seq2seq translate: ids {ids.shape}")
        marks = trace['marks'] + [t2]
        step_ms = [1e3 * (b - a) for a, b in zip(marks[1:], marks[2:])]
        # the same search again, for the final states and the candidates'
        # scores, and on the CPU
        with _traced_beams(tops=True) as gpu:
            got, got_states = model.beam_decode(sources, 0, 1, S2S_BEAM,
                                                S2S_MAX_LEN)
        if not torch.equal(got, ids):
            raise AssertionError("seq2seq translate: a second call differs")
        t3 = time.perf_counter()
        cpu = copy.deepcopy(model).to('cpu')
        with _traced_beams(tops=True) as cpu_trace:
            want_ids, want_states = cpu.beam_decode(
                sources.cpu(), 0, 1, S2S_BEAM, S2S_MAX_LEN)
        cpu_s = time.perf_counter() - t3
    del cpu
    ties, held_rows, score_err = _beams_held('seq2seq translate', gpu,
                                             cpu_trace, steps)
    rows = torch.tensor(held_rows, dtype=torch.long)
    if not torch.equal(ids.cpu()[rows, :, 0], want_ids[rows, :, 0]):
        raise AssertionError("seq2seq translate: the best beam's ids differ "
                             "from the CPU's on a row without a near-tie")
    lp_err = rel_err(got_states['log_probs'].cpu()[rows],
                     want_states['log_probs'][rows])
    check('seq2seq translate: final log-probabilities, GPU vs CPU', lp_err,
          TOL)
    total_s = t2 - t1
    emit({'phase': 'seq2seq_translate', 'card': card,
          'sources': [S2S_SOURCES, S2S_SOURCE_LEN], 'beam': S2S_BEAM,
          'max_len': S2S_MAX_LEN, 'steps_run': steps,
          'first_token_ms': 1e3 * (trace['marks'][1] - t1)
          if steps > 1 else None,
          'decode_step_ms_p50': float(np.median(step_ms)) if step_ms
          else None, 'decode_step_ms_p99': float(np.percentile(step_ms, 99))
          if step_ms else None,
          'translate_ms': 1e3 * total_s,
          'tokens_per_s': S2S_SOURCES * steps / total_s,
          'beam_tokens_per_s': S2S_SOURCES * S2S_BEAM * steps / total_s,
          'host_reads': n_sync, 'host_reads_per_step': n_sync / steps,
          'sync_sites': where[:4], 'peak_gb': peak / 1e9,
          'own_peak_gb': (peak - held) / 1e9, 'launches': decoded,
          'parity': {'against': 'the CPU, same weights, fp32',
                     'near_tie': NEAR_TIE,
                     'near_tie_rows': sum(t is not None for t in ties),
                     'first_near_tie_steps': ties, 'rows_held_whole':
                     len(held_rows), 'step_scores_rel_err': score_err,
                     'final_log_probs_rel_err': lp_err,
                     'cpu_search_s': cpu_s},
          'seconds': time.perf_counter() - t0})
    prof = phase_profile('seq2seq translate', lambda: model.translate(
        sources, beam_size=S2S_BEAM, max_len=S2S_MAX_LEN), {},
        sources=[S2S_SOURCES, S2S_SOURCE_LEN])
    emit({'phase': 'seq2seq_translate_profile', 'wall_ms': prof['wall_ms'],
          'device_busy_ms': prof['device_busy_ms'],
          'device_idle_share': prof['device_idle_share']})
    del model
    torch.cuda.empty_cache()
    return totals, decoded


# the recurrent slice. rnn_parity's sizes; the text zoo's Transformer at
# Transformer-base widths (Paddle's hapi ``transformer`` example builds on
# these layers); PTB large (Zaremba et al. 2014, Paddle's ptb_lm 'large');
# LAC (the reference's SequenceTagging defaults, LAC's published
# dictionaries: ~20,940 words, 57 IOB tags of 28 chunk types)
RNN_I = RNN_H = 256
RNN_B, RNN_T = 8, 40
CRF_SHAPE = (300, 64, 57)                 # batch, steps, tags
TT_LAYERS, TT_HEADS, TT_DK, TT_DMODEL, TT_DINNER = 2, 8, 64, 512, 2048
TT_BATCH, TT_LEN, TT_VOCAB, TT_BEAM, TT_STEPS = 8, 64, 10000, 4, 16
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS, PTB_DROPOUT = 10000, 1500, 2, 0.65
PTB_BATCH, PTB_BPTT, PTB_WARMUP, PTB_STEPS = 20, 35, 2, 20
PTB_CYCLE, PTB_REPEATS = 50, 700          # a corpus of 50 ids, 700 times
LAC_VOCAB, LAC_TAGS, LAC_CHUNK_TYPES = 20940, 57, 28
LAC_BATCH, LAC_LEN, LAC_WARMUP, LAC_STEPS = 300, 64, 2, 10
# one length bucket, the padding train_lac trained at: the tagger's reverse
# GRU runs from the padding (its encoder is given no lengths, as the
# reference's), so its tags depend on how far a request is padded
LAC_BATCH_BUCKETS, LAC_LENGTH_BUCKETS = (1, 4, 16, 64), (LAC_LEN,)
LAC_WAVES = (1, 4, 16, 64, 100, 100, 100)
# host syncs of one served batch: the copies of its two feeds (pageable,
# blocking) and the fetch of its paths; the tagger itself reads nothing
LAC_SYNC_BUDGET = 3
# a Viterbi path of the card that differs from the CPU's on the same fp32
# emissions: accepted (and counted) only where the two paths' fp64 scores
# lie this close, relative to the score
VITERBI_NEAR_TIE = 1e-5
# the LayerNorm launches of the text zoo's Transformer: each 'n' command,
# 2 an encoder layer and 1 after the encoder, 3 a decoder layer and 1 after
TT_ENC_NORMS = 2 * TT_LAYERS + 1
TT_DEC_NORMS = 3 * TT_LAYERS + 1


def _leaves(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [y for part in x for y in _leaves(part)]
    return [x]


def _only_norms(counts, n, what):
    """The counts of a text-zoo Transformer path: ``n`` LayerNorm launches,
    no other kernel."""
    want = {k: (n if k == 'layer_norm_fwd' else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def _projected_pass(model, arrays, run, device, dtype, seed=0):
    """``run(model, *inputs)`` -> output tensors, the float arrays of
    ``arrays`` as tensors of ``dtype`` on ``device`` that need a gradient
    (the others passed as they are); the loss each output times a fixed
    random projection, summed -> (loss, the outputs as fp64 CPU tensors,
    {parameter: fp64 gradient}, [input gradients])."""
    inputs = [torch.tensor(a, dtype=dtype, device=device, requires_grad=True)
              if isinstance(a, np.ndarray) and a.dtype.kind == 'f' else a
              for a in arrays]
    outs = _leaves(run(model, *inputs))
    rs = np.random.RandomState(seed + 88)
    loss = sum((o * torch.tensor(rs.uniform(-1, 1, tuple(o.shape)),
                                 dtype=o.dtype, device=device)).sum()
               for o in outs)
    params = dict(model.named_parameters())
    xs = [t for t in inputs if isinstance(t, torch.Tensor)
          and t.requires_grad]
    grads = torch.autograd.grad(loss, list(params.values()) + xs,
                                allow_unused=True)
    host = [torch.zeros(()) if g is None else g.detach().double().cpu()
            for g in grads]
    return (float(loss.detach()), [o.detach().double().cpu() for o in outs],
            dict(zip(params, host[:len(params)])), host[len(params):])


def _held_pass(what, got, want, extra_grads=True):
    """``_projected_pass`` results against the reference's: the loss within
    ``TOL`` relative, every output within ``TOL`` of max(its largest entry,
    1), every gradient within ``GRAD_TOL`` (``_compare_grads``) -> the
    errors."""
    loss_err = abs(got[0] - want[0]) / max(abs(want[0]), 1.0)
    check(f'{what}: loss', loss_err, TOL)
    out_err = max(max_err(g, w) / max(float(w.abs().max()), 1.0)
                  for g, w in zip(got[1], want[1]))
    check(f'{what}: outputs', out_err, TOL)
    grads, ref = dict(got[2]), dict(want[2])
    if extra_grads:
        for i, (g, w) in enumerate(zip(got[3], want[3])):
            grads[f'input{i}'], ref[f'input{i}'] = g, w
    worst, worst_of, _ = _compare_grads(what, grads, ref)
    return {'loss_rel_err': loss_err, 'outputs_err': out_err,
            'gradients_worst': [worst_of, worst]}


def _three_ways(what, make, arrays, run, seed):
    """One model built by ``make(device, generator)`` on the card, its
    copy on the CPU: the card's default route (cuDNN's RNN for standard
    cells) in fp32 against the CPU's per-step route in fp64, and the card's
    per-step route against its default one, each under ``_held_pass``; the
    CPU's fp32 pass printed beside them -> the row, with the calls of each
    route on the card."""
    from paddle_tpu_torch.nn.functional import rnn as frnn
    dev = torch.device('cuda', 0)
    model = make(dev, torch.Generator(device=dev).manual_seed(seed))
    frnn.reset_route_counts()
    card = _projected_pass(model, arrays, run, dev, torch.float32)
    routes = frnn.route_counts()
    with frnn.rnn_route('per_step'):
        per_step = _projected_pass(model, arrays, run, dev, torch.float32)
    cpu = copy.deepcopy(model).to('cpu')
    cpu32 = _projected_pass(cpu, arrays, run, 'cpu', torch.float32)
    ref = _projected_pass(cpu.double(), arrays, run, 'cpu', torch.float64)
    row = {'case': what, 'card_routes': routes,
           'card_vs_cpu_fp64': _held_pass(f'{what} (card vs CPU fp64)',
                                          card, ref),
           'per_step_vs_card': _held_pass(f'{what} (per-step vs cuDNN on '
                                          'the card)', per_step, card),
           'cpu_fp32_vs_fp64_not_held': {
               'loss_rel_err': abs(cpu32[0] - ref[0]) / max(abs(ref[0]), 1),
               'gradients_worst': max(_grad_errs(cpu32[2], ref[2]).values())}}
    return row


# (name, class, kwargs, time_major, initial states, lengths): each mode
# forward and bidirectional, batch-major and time-major, with and without
# initial states and lengths, 2 layers each
RNN_PARITY_CASES = (
    ('SimpleRNN tanh', 'SimpleRNN', {}, False, False, False),
    ('SimpleRNN tanh bidirect', 'SimpleRNN', {'direction': 'bidirect'}, True,
     True, True),
    ('SimpleRNN relu', 'SimpleRNN', {'activation': 'relu'}, True, True,
     False),
    ('SimpleRNN relu bidirect', 'SimpleRNN',
     {'activation': 'relu', 'direction': 'bidirect'}, False, False, True),
    ('LSTM', 'LSTM', {}, True, True, True),
    ('LSTM bidirect', 'LSTM', {'direction': 'bidirect'}, False, True, True),
    ('GRU', 'GRU', {}, False, False, True),
    ('GRU bidirect', 'GRU', {'direction': 'bidirect'}, True, False, False),
)


def _rnn_lengths(rs):
    """One row at T, one at 1, the rest in [1, T]."""
    lens = rs.randint(1, RNN_T + 1, RNN_B)
    lens[0], lens[1] = RNN_T, 1
    return lens


def _rnn_layer_cases(seed):
    from paddle_tpu_torch import nn
    rows = []
    for i, (what, cls, kw, tm, init, lens) in enumerate(RNN_PARITY_CASES):
        rs = np.random.RandomState(seed + 93 + i)
        d = 2 if kw.get('direction') == 'bidirect' else 1
        x = rs.randn(*((RNN_T, RNN_B, RNN_I) if tm else
                       (RNN_B, RNN_T, RNN_I)))
        states = [rs.randn(2 * d, RNN_B, RNN_H)
                  for _ in range((2 if cls == 'LSTM' else 1) if init else 0)]
        lengths = _rnn_lengths(rs) if lens else None

        def run(model, x, *st):
            init = None if not st else (st if len(st) == 2 else st[0])
            return model(x, init, lengths)
        rows.append(_three_ways(
            what, lambda dev, gen, cls=cls, kw=kw, tm=tm: getattr(nn, cls)(
                RNN_I, RNN_H, 2, time_major=tm, device=dev, generator=gen,
                **kw), [x] + states, run, seed + 94 + i))
    return rows


def _text_rnn_cases(seed):
    """The text zoo's recurrent layers with lengths: ``text.LSTM``
    reversed, ``text.BidirectionalGRU`` both ways of merging, and
    ``text.RNN`` over a ``StackedLSTMCell`` with ``forget_bias``."""
    from paddle_tpu_torch import text
    kw = dict(num_layers=2)
    makes = {
        'text.LSTM reverse': lambda d, g: text.LSTM(
            RNN_I, RNN_H, is_reverse=True, device=d, generator=g, **kw),
        'text.BidirectionalGRU stacked': lambda d, g: text.BidirectionalGRU(
            RNN_I, RNN_H, device=d, generator=g, **kw),
        'text.BidirectionalGRU merge_each_layer': lambda d, g:
        text.BidirectionalGRU(RNN_I, RNN_H, merge_each_layer=True, device=d,
                              generator=g, **kw),
        'text.RNN(StackedLSTMCell forget_bias=1.0)': lambda d, g: text.RNN(
            text.StackedLSTMCell(RNN_I, RNN_H, forget_bias=1.0, device=d,
                                 generator=g, **kw)),
    }
    rows = []
    for i, (what, make) in enumerate(makes.items()):
        rs = np.random.RandomState(seed + 103 + i)
        x = rs.randn(RNN_B, RNN_T, RNN_I)
        lengths = _rnn_lengths(rs)
        rows.append(_three_ways(what, make, [x],
                                lambda m, x: m(x, None, lengths),
                                seed + 107 + i))
    return rows


def _path_scores(emission, transition, path, lens):
    """Each row's score of ``path`` under the CRF, in fp64."""
    e, w = emission.double(), transition.double()
    rows = torch.arange(e.shape[0])
    mask = torch.arange(e.shape[1])[None] < lens[:, None]
    emit = (e.gather(2, path[..., None])[..., 0] * mask).sum(1)
    trans = (w[2:][path[:, :-1], path[:, 1:]] * mask[:, 1:]).sum(1)
    last = path[rows, (lens - 1).clamp(min=0)]
    return w[0][path[:, 0]] + emit + trans + w[1][last]


def _viterbi_held(what, emission, transition, lens, got):
    """``got`` (the card's paths) against ``F.crf_decoding`` on the CPU on
    the same fp32 emissions: equal, except rows whose two paths' fp64
    scores lie within ``VITERBI_NEAR_TIE`` of each other -> the counted
    near-tie rows."""
    from paddle_tpu_torch.nn import functional as F
    em, tr = emission.detach().cpu(), transition.detach().cpu()
    lens = torch.as_tensor(lens).cpu()
    want = F.crf_decoding(em, tr, length=lens)
    got = got.cpu()
    differ = torch.nonzero((got != want).any(1)).flatten()
    if len(differ):
        a = _path_scores(em[differ], tr, got[differ], lens[differ])
        b = _path_scores(em[differ], tr, want[differ], lens[differ])
        gap = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
        check(f'{what}: Viterbi paths that differ from the CPU\'s beyond a '
              f'near-tie', gap, VITERBI_NEAR_TIE)
    return int(len(differ))


def _crf_cases(seed):
    """``F.linear_chain_crf`` at ``CRF_SHAPE``, lengths in [1, T]: the NLL
    and its gradients to the emissions and the transition, the card fp32
    against the CPU fp64; ``F.crf_decoding`` on the card's emissions
    against the CPU's on the same tensors."""
    from paddle_tpu_torch.nn import functional as F
    dev = torch.device('cuda', 0)
    B, T, D = CRF_SHAPE
    rs = np.random.RandomState(seed + 111)
    arrays = [rs.randn(B, T, D), 0.5 * rs.randn(D + 2, D)]
    label = rs.randint(0, D, (B, T))
    lens = rs.randint(1, T + 1, B)

    def run(model, e, w):
        return F.linear_chain_crf(e, torch.as_tensor(label, device=e.device),
                                  w, length=lens)
    card = _projected_pass(torch.nn.Module(), arrays, run, dev,
                           torch.float32)
    ref = _projected_pass(torch.nn.Module(), arrays, run, 'cpu',
                          torch.float64)
    nll = _held_pass('linear_chain_crf (card vs CPU fp64)', card, ref)
    em = torch.tensor(arrays[0], dtype=torch.float32, device=dev)
    tr = torch.tensor(arrays[1], dtype=torch.float32, device=dev)
    paths = F.crf_decoding(em, tr, length=torch.as_tensor(lens, device=dev))
    ties = _viterbi_held('crf_decoding', em, tr, lens, paths)
    return {'shape': list(CRF_SHAPE), 'nll': nll,
            'viterbi_near_tie_rows': ties}


def _skipgram_case(seed):
    from paddle_tpu_torch import text
    rs = np.random.RandomState(seed + 113)
    ids = [rs.randint(0, PTB_VOCAB, 256), rs.randint(0, PTB_VOCAB, 256),
           rs.randint(0, PTB_VOCAB, (256, 5))]

    def run(model, *unused):
        return model(*(torch.as_tensor(a, device=model.in_embed.weight.device)
                       for a in ids))
    return _three_ways('SkipGram (vocab 10000, dim 128, 5 negatives)',
                       lambda d, g: text.SkipGram(PTB_VOCAB, 128, device=d,
                                                  generator=g),
                       [], run, seed + 114)


class _TextTransformer(torch.nn.Module):
    """The text zoo's ``TransformerEncoder`` and ``TransformerDecoder`` at
    Transformer-base widths (p = 0), target embeddings, a position table
    and the output projection: the model ``rnn_parity`` trains one pass of
    and beam-searches."""

    def __init__(self, *, device, generator):
        super().__init__()
        from paddle_tpu_torch import nn, text
        args = (TT_LAYERS, TT_HEADS, TT_DK, TT_DK, TT_DMODEL, TT_DINNER,
                0.0, 0.0, 0.0)
        kw = dict(device=device, generator=generator)
        self.encoder = text.TransformerEncoder(*args, **kw)
        self.decoder = text.TransformerDecoder(*args, **kw)
        self.word = nn.Embedding(TT_VOCAB, TT_DMODEL, **kw)
        self.pos = nn.Embedding(256, TT_DMODEL, **kw)
        self.out = nn.Linear(TT_DMODEL, TT_VOCAB, **kw)

    def embed(self, ids, pos):
        return self.word(ids) + self.pos(pos)

    def forward(self, src, trg_ids, src_bias):
        memory = self.encoder(src, src_bias)
        pos = torch.arange(trg_ids.shape[1], device=src.device)[None]
        causal = torch.triu(torch.full((trg_ids.shape[1],) * 2, -1e9,
                                       dtype=src.dtype, device=src.device), 1)
        out = self.decoder(self.embed(trg_ids, pos), memory, causal, src_bias)
        return torch.log_softmax(self.out(out), -1)

    def beam_search(self, src, src_bias, trace):
        from paddle_tpu_torch import text
        cell = text.TransformerCell(self.decoder, self.embed, self.out)
        search = _traced_decoder(text.TransformerBeamSearchDecoder, trace,
                                 True)(cell, 0, 1, TT_BEAM, 2)
        memory = self.encoder(src, src_bias)
        tile = search.tile_beam_merge_with_batch
        static = [{k: tile(v, TT_BEAM) for k, v in c.items()}
                  for c in self.decoder.prepare_static_cache(memory)]
        return text.DynamicDecode(search, max_step_num=TT_STEPS,
                                  is_test=True)(
            inits=self.decoder.prepare_incremental_cache(memory),
            enc_output=tile(memory, TT_BEAM), static_caches=static,
            trg_src_attn_bias=tile(src_bias, TT_BEAM))


def _text_transformer(seed):
    """``_TextTransformer`` on ``TT_BATCH`` sources of ``TT_LEN`` (random
    embeddings, rows padded through a key bias) and targets of ``TT_LEN``
    ids: one forward and backward of the target tokens' log-likelihood
    projected, the card fp32 against the CPU fp64 (the LayerNorm kernel
    launched once for each 'n' command of the forward, exactly); then the
    beam search (beam ``TT_BEAM``, ``TT_STEPS`` steps) on the card against
    the same search on the CPU up to each row's first near-tie (with its
    launches) -> (the row, the path's launches)."""
    from paddle_tpu_torch import kernels
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 115)
    model = _TextTransformer(device=dev, generator=gen).train()
    rs = np.random.RandomState(seed + 116)
    src = rs.randn(TT_BATCH, TT_LEN, TT_DMODEL)
    bias = np.zeros((TT_BATCH, 1, 1, TT_LEN))
    for b in range(TT_BATCH):
        bias[b, ..., rs.randint(TT_LEN // 2, TT_LEN + 1):] = -1e9
    trg = rs.randint(2, TT_VOCAB, (TT_BATCH, TT_LEN))

    def run(m, x, bias_):
        return m(x, torch.as_tensor(trg, device=x.device), bias_.detach())
    with tf32_off():
        kernels.reset_launch_counts()          # the main path: one pass
        card = _projected_pass(model, [src, bias], run, dev, torch.float32)
        counts = kernels.launch_counts()       # ... read right after it
        _only_norms(counts, TT_ENC_NORMS + TT_DEC_NORMS,
                    'text_transformer forward and backward')
        ref = _projected_pass(copy.deepcopy(model).to('cpu').double(),
                              [src, bias], run, 'cpu', torch.float64)
        held = _held_pass('text zoo Transformer (card vs CPU fp64)', card,
                          ref, extra_grads=False)
        model.eval()
        x = torch.tensor(src, dtype=torch.float32, device=dev)
        xb = torch.tensor(bias, dtype=torch.float32, device=dev)
        gpu = {'marks': [], 'outputs': [], 'tops': []}
        kernels.reset_launch_counts()          # the main path: the search
        ids, states = model.beam_search(x, xb, gpu)
        decoded = kernels.launch_counts()      # ... read right after it
        steps = len(gpu['outputs'])
        _only_norms(decoded, TT_ENC_NORMS + TT_DEC_NORMS * steps,
                    'text_transformer beam search')
        cpu = {'marks': [], 'outputs': [], 'tops': []}
        want_ids, want_states = copy.deepcopy(model).to('cpu').beam_search(
            x.cpu(), xb.cpu(), cpu)
    ties, held_rows, score_err = _beams_held('text zoo beam search', gpu,
                                             cpu, steps)
    rows = torch.tensor(held_rows, dtype=torch.long)
    if not torch.equal(ids.cpu()[rows], want_ids[rows]):
        raise AssertionError("text zoo beam search: the beams differ from "
                             "the CPU's on a row without a near-tie")
    lp_err = rel_err(states['log_probs'].cpu()[rows],
                     want_states['log_probs'][rows])
    check('text zoo beam search: final log-probabilities', lp_err, TOL)
    total = {k: counts[k] + decoded[k] for k in counts}
    return {'widths': {'layers': [TT_LAYERS, TT_LAYERS], 'n_head': TT_HEADS,
                       'd_key': TT_DK, 'd_model': TT_DMODEL,
                       'd_inner_hid': TT_DINNER, 'vocab': TT_VOCAB},
            'batch': [TT_BATCH, TT_LEN], 'pass': held,
            'pass_launches': counts, 'beam': TT_BEAM, 'steps_run': steps,
            'search_launches': decoded,
            'near_tie_rows': sum(t is not None for t in ties),
            'first_near_tie_steps': ties, 'step_scores_rel_err': score_err,
            'final_log_probs_rel_err': lp_err}, total


def phase_rnn_parity(seed):
    """The recurrent slice on the card against the CPU, fp32 with TF32 off
    against the port's CPU path in fp64 on the same weights (the CPU's
    fp32 distance printed, not held): ``nn.SimpleRNN`` (tanh, relu),
    ``nn.LSTM`` and ``nn.GRU`` (``RNN_PARITY_CASES``) and the text zoo's
    recurrent layers (``_text_rnn_cases``) at I = H = ``RNN_H``, batch
    ``RNN_B``, ``RNN_T`` steps: outputs and final states within ``TOL``,
    every gradient within ``GRAD_TOL``, for cuDNN's route against the CPU
    and the card's per-step route against cuDNN's; ``F.linear_chain_crf``
    and ``F.crf_decoding`` (``_crf_cases``); ``SkipGram`` with given
    negatives; the text zoo's Transformer (``_text_transformer``) ->
    the ``text_transformer`` path's launches."""
    t0 = time.perf_counter()
    with tf32_off():
        layers = _rnn_layer_cases(seed)
        text_rnn = _text_rnn_cases(seed)
        crf = _crf_cases(seed)
        skipgram = _skipgram_case(seed)
    transformer, counts = _text_transformer(seed)
    emit({'phase': 'rnn_parity', 'size': {'input': RNN_I, 'hidden': RNN_H,
                                          'batch': RNN_B, 'steps': RNN_T},
          'against': 'the port on the CPU in fp64, same weights',
          'tolerance': {'outputs': TOL, 'gradients': GRAD_TOL,
                        'viterbi_near_tie': VITERBI_NEAR_TIE},
          'layers': layers, 'text_layers': text_rnn, 'crf': crf,
          'skipgram': skipgram, 'text_transformer': transformer,
          'seconds': time.perf_counter() - t0})
    torch.cuda.empty_cache()
    return counts


def _ptb_corpus(seed):
    """``PTB_REPEATS`` copies of one sequence of ``PTB_CYCLE`` ids drawn
    from ``seed``, cut into ``PTB_BATCH`` rows as ptb_lm batches its
    corpus -> the (inputs, targets) of each truncated step, on the card."""
    dev = torch.device('cuda', 0)
    rs = np.random.RandomState(seed)
    data = np.tile(rs.randint(0, PTB_VOCAB, PTB_CYCLE), PTB_REPEATS)
    data = torch.from_numpy(data.reshape(PTB_BATCH, -1)).to(dev)
    return [(data[:, i * PTB_BPTT:(i + 1) * PTB_BPTT],
             data[:, i * PTB_BPTT + 1:(i + 1) * PTB_BPTT + 1])
            for i in range(PTB_WARMUP + PTB_STEPS)]


def _lstm_routes(model, seed):
    """One forward and backward of the model's LSTM on a PTB step's
    shapes (train mode, p = 0 between layers) on cuDNN's route and on the
    per-step route: both timed, and the per-step one held to cuDNN's
    within ``TOL`` / ``GRAD_TOL``; and cuDNN's with the four tensors of
    each layer copied into one flat buffer (``torch._cudnn_rnn_flatten_
    weight``, as ``torch.nn.LSTM`` keeps them) against the port's separate
    parameters, which cuDNN compacts on every call."""
    from paddle_tpu_torch.nn.functional import rnn as frnn
    dev = torch.device('cuda', 0)
    lstm = copy.deepcopy(model.lstm).train()
    lstm.dropout = 0.0
    rs = np.random.RandomState(seed + 121)
    x = torch.tensor(rs.randn(PTB_BATCH, PTB_BPTT, PTB_HIDDEN),
                     dtype=torch.float32, device=dev, requires_grad=True)

    def once():
        out, (h, c) = lstm(x)
        loss = out.square().sum() + h.sum() + c.sum()
        return [out, h, c] + list(torch.autograd.grad(
            loss, [x] + list(lstm.parameters())))

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5
    cudnn = once()
    cudnn_ms = timed(once)
    with frnn.rnn_route('per_step'):
        per_step = once()
        per_step_ms = timed(once)
    out_err = max(max_err(a, b) for a, b in zip(per_step[:3], cudnn[:3]))
    check('PTB LSTM: per-step vs cuDNN outputs', out_err, TOL)
    grad_err = max(rel_err(a, b) for a, b in zip(per_step[3:], cudnn[3:]))
    check('PTB LSTM: per-step vs cuDNN gradients', grad_err, GRAD_TOL)
    # the same layers, each on one flat buffer: what cuDNN's copy costs
    flat = []
    with torch.no_grad():
        for layer in lstm._all_layers:
            ws = [t.detach().clone().requires_grad_()
                  for t in layer.cell._params()]
            torch._cudnn_rnn_flatten_weight(ws, 4, PTB_HIDDEN, 2, PTB_HIDDEN,
                                            0, 1, True, False)
            flat.append(ws)
    zeros = torch.zeros(1, PTB_BATCH, PTB_HIDDEN, device=dev)

    def flat_once():
        out, ends = x, []
        for ws in flat:
            out, h, c = torch._VF.lstm(out, (zeros, zeros), ws, True, 1,
                                       0.0, True, False, True)
            ends += [h, c]
        loss = out.square().sum() + sum(e.sum() for e in ends)
        return torch.autograd.grad(loss, [x] + [w for ws in flat
                                                for w in ws])
    flat_ms = timed(flat_once)
    return {'shape': [PTB_BATCH, PTB_BPTT, PTB_HIDDEN], 'layers': PTB_LAYERS,
            'cudnn_ms': cudnn_ms, 'per_step_ms': per_step_ms,
            'cudnn_flat_weights_ms': flat_ms,
            'per_step_vs_cudnn': {'outputs': out_err,
                                  'gradients_worst': grad_err}}


def phase_train_ptb_lm(seed, card):
    """``text.LSTMLanguageModel`` at PTB large (Zaremba et al. 2014, Paddle's
    ptb_lm 'large'): vocab ``PTB_VOCAB``, hidden ``PTB_HIDDEN``,
    ``PTB_LAYERS`` layers, dropout ``PTB_DROPOUT``, untied, fp32 (TF32 off),
    trained by ptb_lm's eager loop: batch ``PTB_BATCH`` x ``PTB_BPTT``
    steps of truncated backpropagation through time, the state carried
    across steps and detached, the loss ptb_lm's (the mean over the batch
    summed over the steps), SGD at 1.0 with ``ClipGradByGlobalNorm(10.0)``;
    ``PTB_WARMUP`` + ``PTB_STEPS`` steps on ``_ptb_corpus``. Gates: every
    loss finite, the mean of the last five below the first step's, none of
    the seven kernels, two cuDNN RNN calls a step (one a layer). Printed:
    step ms (median), words/s, peak memory, launches and host syncs a step,
    the perplexity at the first and last step, one profiled step, and
    ``_lstm_routes`` -> the path's launch counts."""
    from paddle_tpu_torch import kernels, text
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.functional import rnn as frnn
    from paddle_tpu_torch.optimizer import SGD
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 118)
    model = text.LSTMLanguageModel(PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS,
                                   PTB_DROPOUT, device=dev,
                                   generator=gen).train()
    opt = SGD(learning_rate=1.0, parameters=model.parameters(),
              grad_clip=ClipGradByGlobalNorm(10.0))
    batches = _ptb_corpus(seed + 119)
    n_params = sum(p.numel() for p in model.parameters())
    state = [None]

    def step(x, y):
        logits, st = model(x, state[0])
        loss = model.loss(logits, y) * PTB_BPTT
        loss.backward()
        opt.step()
        opt.clear_grad()
        state[0] = tuple(s.detach() for s in st)
        return loss
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, ms, syncs = [], [], []
    with tf32_off():
        kernels.reset_launch_counts()          # the main path: the steps
        frnn.reset_route_counts()
        for i, (x, y) in enumerate(batches):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            loss, n, _ = _count_syncs(lambda: float(step(x, y)))
            end.record()
            torch.cuda.synchronize()
            losses.append(loss / PTB_BPTT)
            syncs.append(n)
            if i >= PTB_WARMUP:
                ms.append(start.elapsed_time(end))
        counts = kernels.launch_counts()       # ... read right after it
        routes = frnn.route_counts()
    peak = torch.cuda.max_memory_allocated()
    _zero_counts(counts, 'train_ptb_lm')
    n_steps = PTB_WARMUP + PTB_STEPS
    if routes['torch_rnn'] != PTB_LAYERS * n_steps or routes['per_step']:
        raise AssertionError(f"train_ptb_lm: RNN routes {routes}")
    if not (all(np.isfinite(losses)) and
            np.mean(losses[-5:]) < losses[0]):
        raise AssertionError(f"train_ptb_lm: losses {losses}")
    x, y = batches[0]
    with tf32_off():
        prof = phase_profile('train_ptb_lm step', lambda: step(x, y), {},
                             batch=[PTB_BATCH, PTB_BPTT])
        lstm = _lstm_routes(model, seed)
    emit({'phase': 'train_ptb_lm', 'model': 'LSTMLanguageModel, PTB large '
          '(Zaremba et al. 2014; ptb_lm large)', 'card': card,
          'entry': "the eager loop of ptb_lm (model, loss.backward, "
                   "SGD.step with the clip)",
          'vocab': PTB_VOCAB, 'hidden': PTB_HIDDEN, 'layers': PTB_LAYERS,
          'dropout': PTB_DROPOUT, 'parameters': n_params,
          'batch': [PTB_BATCH, PTB_BPTT], 'dtype': 'float32 (TF32 off)',
          'optimizer': 'SGD(1.0), ClipGradByGlobalNorm(10.0)',
          'setup_s': setup_s, 'step_ms': ms,
          'step_ms_median': float(np.median(ms)),
          'words_per_s': PTB_BATCH * PTB_BPTT / (float(np.median(ms)) / 1e3),
          'peak_gb': peak / 1e9, 'losses': losses,
          'perplexity_first_last': [math.exp(losses[0]),
                                    math.exp(losses[-1])],
          'host_syncs_per_step': syncs, 'host_syncs_counted': 'the step '
          'and the read of its loss', 'launches': counts,
          'rnn_routes': routes,
          'profile': {k: prof[k] for k in ('wall_ms', 'device_busy_ms',
                                           'device_idle_share',
                                           'device_events')},
          'lstm_routes': lstm, 'seconds': time.perf_counter() - t0})
    del model, opt, batches
    torch.cuda.empty_cache()
    return counts


def _lac_set(seed, n):
    """``n`` sentences of lengths in [4, ``LAC_LEN``] padded to it, words
    in [1, ``LAC_VOCAB``), each tag a function of its word (learnable) in the
    IOB scheme of ``LAC_CHUNK_TYPES`` types (tag 2t: B of type t, 2t + 1:
    I, ``LAC_TAGS`` - 1: O) -> (words, lengths, tags) numpy."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(4, LAC_LEN + 1, n)
    words = rs.randint(1, LAC_VOCAB, (n, LAC_LEN))
    tags = words % LAC_TAGS
    pad = np.arange(LAC_LEN)[None] >= lens[:, None]
    words[pad], tags[pad] = 0, 0
    return words.astype(np.int64), lens.astype(np.int64), \
        tags.astype(np.int64)


class _LacTrainNet(torch.nn.Module):
    """``SequenceTagging`` as LAC trains it under ``Model.fit``: forward
    (words, lengths, tags) -> (decoded paths, CRF costs), the paths first
    for the chunk metric, the costs for the loss."""

    def __init__(self, tagger):
        super().__init__()
        self.tagger = tagger

    def forward(self, word, lengths, target):
        cost, decoded = self.tagger(word, lengths, target)
        return decoded, cost


def phase_train_lac(seed, card):
    """LAC's BiGRU-CRF tagger (``text.SequenceTagging``: word embedding
    128, two BiGRUs of 128, 57 tags; vocab ``LAC_VOCAB``; the embedding
    and CRF learning rates at the reference's defaults) trained through
    ``hapi.Model.fit``, eager, fp32 (TF32 off): batch ``LAC_BATCH``
    sentences padded to ``LAC_LEN``, Adam(1e-3), the loss the CRF cost's
    mean, the metric the port's ``ChunkEvaluator`` on ``metric.chunk_eval``
    (IOB, ``LAC_CHUNK_TYPES`` types); ``LAC_WARMUP`` + ``LAC_STEPS`` steps.
    Gates: finite losses, a held-out batch's CRF cost a token (eval mode,
    outside the counted path) lower after the fit than before, none of the
    seven kernels. Printed: step ms, sentences/s and tokens/s, peak
    memory, host syncs a step, the F1 at the end, one profiled step ->
    (the path's launch counts, the trained tagger)."""
    from paddle_tpu_torch import Model, io, kernels, metric, text
    from paddle_tpu_torch.optimizer import Adam
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 123)
    tagger = text.SequenceTagging(LAC_VOCAB, LAC_TAGS, device=dev,
                                  generator=gen)
    net = _LacTrainNet(tagger)

    class Chunks(metric.ChunkEvaluator):
        """The chunk counts of ``metric.chunk_eval`` (IOB); each update
        returns the F1 so far."""

        def compute(self, decoded, target, lengths):
            return metric.chunk_eval(decoded, target, 'IOB',
                                     LAC_CHUNK_TYPES,
                                     seq_length=lengths)[3:]

        def update(self, *counts):
            super().update(*counts)
            return self.accumulate()[2]
    steps = LAC_WARMUP + LAC_STEPS
    words, lens, tags = _lac_set(seed + 124, LAC_BATCH * steps)
    rows = [((words[i], lens[i], tags[i]), (tags[i], lens[i]))
            for i in range(len(words))]

    class Sentences(io.Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i]
    opt = Adam(learning_rate=1e-3, parameters=net.parameters())
    model = Model(net, device=dev).prepare(
        opt, lambda decoded, cost, *labels: cost.mean(), Chunks())
    loader = io.DataLoader(Sentences(), batch_size=LAC_BATCH, shuffle=False,
                           device=dev)
    # a held-out batch, its mean cost a token in eval mode before and after
    w, n, t = (torch.from_numpy(a).to(dev) for a in
               _lac_set(seed + 126, LAC_BATCH))

    def held_out():
        return model.eval_batch([w, n, t], [t, n])[0][0] / float(n.float(
        ).mean())
    clock = _step_clock()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with tf32_off():
        before = held_out()
        kernels.reset_launch_counts()          # the main path: the fit
        t1 = time.perf_counter()
        _, n_sync, where = _count_syncs(lambda: model.fit(
            loader, epochs=1, shuffle=False, verbose=0, callbacks=[clock]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = kernels.launch_counts()       # ... read right after it
        after = held_out()
    n_sync -= _SYNC_NOTICE in ' '.join(where)
    peak = torch.cuda.max_memory_allocated()
    _zero_counts(counts, 'train_lac')
    losses = [float(r[3]['loss']) for r in clock.rows]
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            not after < before:
        raise AssertionError(f"train_lac: held-out cost a token {before} -> "
                             f"{after}, losses {losses}")
    ends = [r[2] for r in clock.rows]
    ms = [1e3 * (b - a) for a, b in zip(ends, ends[1:])][LAC_WARMUP - 1:]
    tokens = int(lens[LAC_BATCH * LAC_WARMUP:].sum())
    batch = next(iter(loader))
    with tf32_off():
        prof = phase_profile('train_lac train_batch',
                             lambda: model.train_batch(*batch), {},
                             batch=[LAC_BATCH, LAC_LEN])
    emit({'phase': 'train_lac', 'model': 'SequenceTagging (LAC BiGRU-CRF: '
          'embedding 128, 2 BiGRUs of 128, 57 IOB tags)', 'card': card,
          'entry': 'hapi.Model.fit (eager)', 'vocab': LAC_VOCAB,
          'batch': [LAC_BATCH, LAC_LEN], 'dtype': 'float32 (TF32 off)',
          'optimizer': 'Adam(1e-3); embedding and CRF learning rates 0.1',
          'setup_s': setup_s, 'fit_wall_s': wall, 'step_ms': ms,
          'step_ms_median': float(np.median(ms)),
          'sentences_per_s': LAC_BATCH * len(ms) / (sum(ms) / 1e3),
          'tokens_per_s': tokens / (sum(ms) / 1e3),
          'peak_gb': peak / 1e9, 'losses': losses,
          'held_out_cost_per_token': [before, after],
          'chunk_f1': clock.rows[-1][3].get('chunk'),
          'host_syncs': n_sync, 'host_syncs_per_step': n_sync / steps,
          'sync_sites': where[:4], 'launches': counts,
          'profile': {k: prof[k] for k in ('wall_ms', 'device_busy_ms',
                                           'device_idle_share',
                                           'device_events')},
          'seconds': time.perf_counter() - t0})
    del model, net, opt, loader, batch
    torch.cuda.empty_cache()
    return counts, tagger


def _alone_held(eng, ep, tagger, reqs, served):
    """Each request of ``reqs`` served again on its own (batch bucket 1, the
    same length bucket): its tags equal to ``served``'s, the ones it got
    inside its batch, except rows whose two paths' fp64 scores under the
    lone run's emissions lie within ``VITERBI_NEAR_TIE`` -> {'requests',
    'near_tie_rows'}."""
    seen = []
    hook = tagger.fc.register_forward_hook(
        lambda m, a, out: seen.append(out.detach().cpu()))
    try:
        with tf32_off():
            alone = []
            for r in reqs:
                fut = ep.submit(r)
                eng.run_until_idle()
                alone.append(fut.result(timeout=600))
    finally:
        hook.remove()
    trans = tagger.linear_chain_crf.transition.detach().cpu()
    ties = 0
    for i, (r, one, resp) in enumerate(zip(reqs, alone, served)):
        if not one.ok:
            raise AssertionError(f"serve_lac request {i} alone: {one.status}")
        a = torch.as_tensor(np.asarray(one.outputs))[None]
        b = torch.as_tensor(np.asarray(resp.outputs))[None]
        if torch.equal(a, b):
            continue
        n = torch.as_tensor([int(r['lengths'])])
        sa, sb = (_path_scores(seen[i][:1], trans, p, n) for p in (a, b))
        gap = float((sa - sb).abs() / sb.abs().clamp(min=1.0))
        check(f'serve_lac request {i}: tags alone vs in its batch beyond a '
              f'near-tie', gap, VITERBI_NEAR_TIE)
        ties += 1
    return {'requests': len(reqs), 'near_tie_rows': ties}


def phase_serve_lac(seed, card, tagger):
    """The trained tagger served: ``ServingEngine.register(layer=tagger,
    bucket_spec=BucketSpec(LAC_BATCH_BUCKETS, LAC_LENGTH_BUCKETS))``, each
    request a query-length sentence (its words unpadded, 4 to ``LAC_LEN``
    words, 13 on average, and its length), in ``LAC_WAVES``. Gates: every response
    ok, its tags over its length in [0, ``LAC_TAGS``) and zeros past it;
    each batch's paths equal to ``F.crf_decoding`` on the CPU on that
    batch's own emissions (taken on the card by a hook), near-tie rows
    counted; each request served again alone (batch bucket 1, the same
    padding) with the tags it got in its batch (``_alone_held``); at most
    ``LAC_SYNC_BUDGET`` host syncs a batch; none of the seven kernels.
    Printed: requests/s, p50/p99 batch ms per (batch, length) bucket, peak
    memory, one profiled batch of 64 -> the path's launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import (BucketSpec, ServingEngine,
                                          select_bucket)
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    tagger = tagger.eval()
    eng = ServingEngine(queue_capacity=256, device=dev)
    ep = eng.register('lac', layer=tagger, example={
        'word': np.zeros(LAC_LEN, np.int64), 'lengths': np.int64(LAC_LEN)},
        bucket_spec=BucketSpec(LAC_BATCH_BUCKETS, LAC_LENGTH_BUCKETS))
    warm = eng.warmup()
    # query-length sentences: 3 + a geometric number of words (mean 10),
    # at most LAC_LEN
    rs = np.random.RandomState(seed + 125)
    lens = np.minimum(3 + rs.geometric(0.1, sum(LAC_WAVES)), LAC_LEN)
    reqs = [{'word': rs.randint(1, LAC_VOCAB, n).astype(np.int64),
             'lengths': np.int64(n)} for n in lens]
    seen = []
    hooks = [tagger.fc.register_forward_hook(
        lambda m, a, out: seen.append(out.detach().clone()))]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with tf32_off():
        kernels.reset_launch_counts()          # the main path: the waves
        served, n_sync, where = [], 0, []
        t1 = time.perf_counter()
        at = 0
        for n in LAC_WAVES:
            futs = [ep.submit(r) for r in reqs[at:at + n]]
            at += n
            _, k, w = _count_syncs(eng.run_until_idle)
            n_sync, where = n_sync + k, where + w
            served += [f.result(timeout=600) for f in futs]
        serve_s = time.perf_counter() - t1
        counts = kernels.launch_counts()       # ... read right after it
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated()
    n_sync -= _SYNC_NOTICE in ' '.join(where)
    _zero_counts(counts, 'serve_lac')
    batches = len(seen)
    if n_sync > LAC_SYNC_BUDGET * batches:
        raise AssertionError(f"serve_lac: {n_sync} host syncs in {batches} "
                             f"batches: {sorted(set(where))[:4]}")
    # the batches in order: the responses that share one 'run' make one
    groups, by_bucket = [], {}
    for i, resp in enumerate(served):
        if not resp.ok:
            raise AssertionError(f"serve_lac request {i}: {resp.status}")
        if groups and groups[-1][0] == resp.breakdown['run']:
            groups[-1][1].append(i)
        else:
            groups.append((resp.breakdown['run'], [i]))
    if len(groups) != batches:
        raise AssertionError(f"serve_lac: {len(groups)} batches in the "
                             f"responses, {batches} through the tagger")
    near_ties = 0
    trans = tagger.linear_chain_crf.transition
    for (run_ms, idx), emission in zip(groups, seen):
        paths = torch.stack([torch.as_tensor(np.asarray(served[i].outputs))
                             for i in idx])
        L = paths.shape[1]
        for j, i in enumerate(idx):
            p = paths[j]
            if int(p[lens[i]:].abs().sum()) or int(p.max()) >= LAC_TAGS:
                raise AssertionError(f"serve_lac request {i}: tags {p}")
        rows = emission[:len(idx)]
        near_ties += _viterbi_held('serve_lac', rows, trans,
                                   lens[idx], paths)
        key = f'{select_bucket(len(idx), LAC_BATCH_BUCKETS)}x{L}'
        by_bucket.setdefault(key, []).append(run_ms)
    lat = {k: {'batches': len(v), 'p50_ms': float(np.percentile(v, 50)),
               'p99_ms': float(np.percentile(v, 99))}
           for k, v in sorted(by_bucket.items())}
    alone = _alone_held(eng, ep, tagger, reqs, served)

    def one_batch():
        futs = [ep.submit(r) for r in reqs[-64:]]
        eng.run_until_idle()
        for f in futs:
            f.result(timeout=600)
    with tf32_off():
        prof = phase_profile('serve_lac batch of 64', one_batch, {},
                             bucket=64)
    emit({'phase': 'serve_lac', 'model': 'SequenceTagging (LAC), trained by '
          'train_lac', 'card': card, 'dtype': 'float32 (TF32 off)',
          'buckets': {'batch': LAC_BATCH_BUCKETS,
                      'length': LAC_LENGTH_BUCKETS},
          'setup_s': setup_s, 'warmup_buckets': warm['lac'],
          'requests': len(served), 'waves': LAC_WAVES,
          'requests_per_s': len(served) / serve_s,
          'batch_latency_ms': lat, 'batches': batches, 'peak_gb': peak / 1e9,
          'host_syncs': n_sync, 'host_syncs_per_batch': n_sync / batches,
          'host_sync_budget_per_batch': LAC_SYNC_BUDGET,
          'sync_sites': sorted(set(where))[:4],
          'viterbi_near_tie_rows': near_ties, 'alone': alone,
          'launches': counts,
          'profile': {k: prof[k] for k in ('wall_ms', 'device_busy_ms',
                                           'device_idle_share',
                                           'device_events')},
          'seconds': time.perf_counter() - t0})
    torch.cuda.empty_cache()
    return counts


SOURCES = {
    'flash_attention_fwd': ('paddle_tpu_torch/kernels/csrc/flash_attention.cu',
                            'paddle_tpu/kernels/flash_attention.py:95'),
    'flash_attention_dq': (
        'paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu',
        'paddle_tpu/kernels/flash_attention.py:208'),
    'flash_attention_dkv': (
        'paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu',
        'paddle_tpu/kernels/flash_attention.py:265'),
    'dropout_grad': (
        'paddle_tpu_torch/kernels/csrc/fused_dropout_norm.cu',
        'paddle_tpu/kernels/fused_dropout_norm.py:74'),
    'layer_norm_fwd': ('paddle_tpu_torch/kernels/csrc/fused_norm.cu',
                       'paddle_tpu/kernels/fused_norm.py:26'),
    'rms_norm_fwd': ('paddle_tpu_torch/kernels/csrc/fused_norm.cu',
                     'paddle_tpu/kernels/fused_norm.py:43'),
    'add_layer_norm_fwd': (
        'paddle_tpu_torch/kernels/csrc/fused_dropout_norm.cu',
        'paddle_tpu/kernels/fused_dropout_norm.py:41'),
}


def _kernel_phases(r):
    """The kernel phases 3-5 and 18, which share one flush buffer -> their
    rows at fp32, bf16 and fp16 (RMSNorm's among them), ``nn.RMSNorm``'s
    path counts and GPT's rows."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                        device='cuda')       # 256 MB, five times the L2
    rows = phase_kernels(r.seed, flush)
    rows16 = phase_kernels_16(r.seed, flush)
    rowsh = phase_kernels_16(r.seed, flush, FP16)
    phase_mask_probe(r.seed)
    rms_rows, rms_path = phase_rms(r.seed, flush)
    for table, dtype in ((rows, 'fp32'), (rows16, 'bf16'), (rowsh, 'fp16')):
        table['rms_norm_fwd'] = rms_rows[dtype]
    return rows, rows16, rowsh, rms_path, phase_kernels_gpt(r.seed, flush)


# The phases in the order the whole run takes them: (name, the results of
# earlier phases it reads, the results it gives, run). ``run(r)`` returns
# its results in that order (one result bare); ``r`` holds the seed, the
# card and every result given so far. A result that later phases read is
# dropped after the last of them ran; the others stay for the kernels line.
PHASES = (
    ('kernels', (), ('rows', 'rows16', 'rowsh', 'rms_path', 'gpt_rows'),
     _kernel_phases),
    ('parity', (), (), lambda r: phase_parity(r.seed)),
    ('serve', (), ('served', 'serve'), lambda r: phase_serve(r.seed, r.card)),
    ('serve_tenants', ('serve',), ('served_tenants',),
     lambda r: phase_serve_tenants(r.seed, r.card, r.serve)),
    ('serve_fleet', ('serve',), ('served_fleet',),
     lambda r: phase_serve_fleet(r.seed, r.card, r.serve)),
    ('train_parity', (), (), lambda r: phase_train_parity(r.seed)),
    # the step's callable, and with it its model and state, goes
    ('train', (), ('trained', 'train_ms'),
     lambda r: phase_train(r.seed, r.card)[::2]),
    ('train_parity_bf16', (), (), lambda r: phase_train_parity_bf16(r.seed)),
    ('train_bf16', (), ('trained16',),
     lambda r: phase_train(r.seed, r.card, 'bf16')[0]),
    ('train_parity_flat', (), (), lambda r: phase_train_parity_flat(r.seed)),
    ('train_bf16_flat', (), ('trained_flat',),
     lambda r: phase_train(r.seed, r.card, 'bf16_flat')[0]),
    ('train_parity_fp16', (), (), lambda r: phase_train_parity_fp16(r.seed)),
    ('train_fp16_amp', (), ('trained_amp', 'amp_again'),
     lambda r: phase_train(r.seed, r.card, 'fp16_amp')[:2]),
    ('train_parity_fit', (), (), lambda r: phase_train_parity_fit(r.seed)),
    ('train_fit', (), ('trained_fit', 'fit_row'),
     lambda r: phase_train_fit(r.seed, r.card)),
    ('remat_memory', (), (), lambda r: phase_remat_memory(r.seed, r.card)),
    ('generate', (), ('generated',), lambda r: phase_generate(r.seed, r.card)),
    ('serve_generative', (), ('served_gen',),
     lambda r: phase_serve_generative(r.seed, r.card)),
    ('hapi_parity', (), (), lambda r: phase_hapi_parity(r.seed)),
    ('hapi_fit', ('train_ms',), ('hapi',),
     lambda r: phase_hapi_fit(r.seed, r.card, r.train_ms['median'])),
    ('routes', ('amp_again',), (), lambda r: phase_routes(r.seed,
                                                         r.amp_again)),
    # last: after it, a torch.profiler session loses its first device
    # events (PERF.md, section 7), and every profile phase counts them
    ('train_resume', (), ('resumed',),
     lambda r: phase_train_resume(r.seed, r.card)),
    # no profile follows: the training side's telemetry runs after it
    ('train_telemetry', (), ('telemetry',),
     lambda r: phase_train_telemetry(r.seed, r.card)),
    # data parallelism: no profiler session here either (see above)
    ('collectives', (), (), lambda r: phase_collectives(r.card)),
    ('train_sharded', ('fit_row',), ('sharded',),
     lambda r: phase_train_sharded(r.seed, r.card, r.fit_row)[0]),
    ('dp_two_ranks', (), ('dp_ranks',),
     lambda r: phase_dp_two_ranks(r.seed, r.card)[0]),
    # model parallelism: two gloo ranks a phase, no profiler session
    ('tp_two_ranks', (), ('tp_ranks',),
     lambda r: phase_tp_two_ranks(r.seed, r.card)[0]),
    ('ring_two_ranks', (), ('ring_ranks',),
     lambda r: phase_ring_two_ranks(r.seed, r.card)[0]),
    ('pipeline_two_ranks', (), ('pipe_ranks',),
     lambda r: phase_pipeline_two_ranks(r.seed, r.card)[0]),
    # vision: the convolutional nn and ResNet-50, none of the seven kernels
    ('vision_parity', (), (), lambda r: phase_vision_parity(r.seed)),
    ('serve_resnet', (), ('serve_resnet',),
     lambda r: phase_serve_resnet(r.seed, r.card)),
    ('train_resnet', (), ('train_resnet',),
     lambda r: phase_train_resnet(r.seed, r.card)),
    ('hapi_fit_resnet', (), ('hapi_resnet',),
     lambda r: phase_hapi_fit_resnet(r.seed, r.card)),
    # detection: vision.ops and detection_train, the SSD served and trained
    ('detection_parity', (), (), lambda r: phase_detection_parity(r.seed)),
    ('serve_ssd', (), ('serve_ssd',),
     lambda r: phase_serve_ssd(r.seed, r.card)),
    ('train_ssd', (), ('train_ssd',),
     lambda r: phase_train_ssd(r.seed, r.card)),
    # text: ERNIE fine-tuned, the Transformer seq2seq trained and decoded
    ('ernie_parity', (), ('ragged',), lambda r: phase_ernie_parity(r.seed)),
    ('finetune_ernie', (), ('finetuned',),
     lambda r: phase_finetune_ernie(r.seed, r.card)),
    ('seq2seq_parity', (), ('width_512',),
     lambda r: phase_seq2seq_parity(r.seed)),
    ('seq2seq', (), ('s2s_trained', 's2s_decoded'),
     lambda r: phase_seq2seq(r.seed, r.card)),
    # the recurrent slice: the RNNs, the CRF and the text zoo against the
    # CPU, PTB-large trained, LAC trained and served
    ('rnn_parity', (), ('text_transformer',),
     lambda r: phase_rnn_parity(r.seed)),
    ('train_ptb_lm', (), ('ptb_lm',),
     lambda r: phase_train_ptb_lm(r.seed, r.card)),
    ('train_lac', (), ('lac_trained', 'lac_tagger'),
     lambda r: phase_train_lac(r.seed, r.card)),
    ('serve_lac', ('lac_tagger',), ('lac_served',),
     lambda r: phase_serve_lac(r.seed, r.card, r.lac_tagger)),
)


def selected_phases(arg):
    """``--phases a,b`` -> the phases to run, in ``PHASES``' order: those
    named and those whose results they read; every phase without the flag.
    Raises ``SystemExit`` on an unknown name."""
    if arg is None:
        return PHASES
    names = {n.strip() for n in arg.split(',') if n.strip()}
    unknown = sorted(names - {p[0] for p in PHASES})
    if unknown or not names:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; the phases "
                         f"are {', '.join(p[0] for p in PHASES)}")
    giver = {key: p[0] for p in PHASES for key in p[2]}
    for name, reads, _, _ in reversed(PHASES):   # readers after givers
        if name in names:
            names.update(giver[key] for key in reads)
    return tuple(p for p in PHASES if p[0] in names)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument(
        '--phases', default=None,
        help='comma-separated phases to run (with those whose results they '
             'read), for a partial run: it prints no kernels line and no ok '
             'line; without it every phase runs')
    args = parser.parse_args()
    run = selected_phases(args.phases)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run "
              "here", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    r = types.SimpleNamespace(seed=args.seed, card=phase_card())
    phase_build()
    for i, (name, reads, gives, fn) in enumerate(run):
        out = fn(r)
        for key, value in zip(gives, out if len(gives) > 1 else (out,)):
            setattr(r, key, value)
        later = {key for p in run[i + 1:] for key in p[1]}
        for key in set(reads) - later:
            delattr(r, key)
        torch.cuda.empty_cache()
    if len(run) != len(PHASES):
        # a partial run: its phases' lines only
        emit({'phases_run': [p[0] for p in run], 'whole_run': False})
        return 0
    # launches: each main path's counts, zeroed just before the path and
    # read just after (serving: 21 batches; serve_tenants: the tenants
    # engine's pumped and threaded batches; serve_fleet: every replica's
    # batches from the chaos waves to the autoscaler's shrink, and the
    # warmups of the relaunched and the grown replica; each training run:
    # 20 steps;
    # train_fit: 2 fit calls, 40 steps; train_resume: the resumed
    # full-width fit, 6 steps; nn.RMSNorm: 18 forwards and their
    # backward; generate: 5 calls of GPT's generate; serve_generative: the
    # engine's four generative runs, which launch none; hapi_fit: two
    # Model.fit calls, 24 steps, and 12 eval-mode forwards; train_telemetry:
    # its telemetry-on runs, two engine.fit calls and two with a checkpoint,
    # 20 steps each, and a Model.fit of 6 steps; train_sharded: the FSDP
    # fit, 20 steps; dp_two_ranks: both ranks' AdamW steps, 3 each;
    # tp_two_ranks: both ranks' AdamW steps; ring_two_ranks: both ranks'
    # logits and loss forward and backward; pipeline_two_ranks: both
    # stages' forward and backward; serve_resnet, train_resnet and
    # hapi_fit_resnet: ResNet-50's waves, steps and fit, and serve_ssd and
    # train_ssd: the SSD's waves and timed steps, which launch
    # none; finetune_ernie: ERNIE-large's fit, 10 steps at four lengths;
    # seq2seq_train: 8 Transformer-base steps; seq2seq_translate: one
    # translate call; text_transformer: the text zoo's Transformer, one
    # forward and backward and one beam search; train_ptb_lm: 22 steps;
    # train_lac: the fit, 12 steps; serve_lac: the waves, which launch
    # none); the top-level numbers are bf16's, the dtype of the
    # reference's training recipe, ``gpt`` holds the fp32 cases at
    # generate's shapes and ``ragged`` the attention kernels' cases at
    # RAGGED_LENGTHS (ernie_parity), ``width_512`` the norm kernels' cases
    # at the seq2seq's rows (seq2seq_parity)
    paths = {'serve': r.served, 'serve_tenants': r.served_tenants,
             'serve_fleet': r.served_fleet,
             'train_fp32': r.trained,
             'train_bf16': r.trained16, 'train_bf16_flat': r.trained_flat,
             'train_fp16_amp': r.trained_amp, 'train_fit': r.trained_fit,
             'train_resume': r.resumed, 'nn.RMSNorm': r.rms_path,
             'generate': r.generated, 'serve_generative': r.served_gen,
             'hapi_fit': r.hapi, 'train_telemetry': r.telemetry,
             'train_sharded': r.sharded, 'dp_two_ranks': r.dp_ranks,
             'tp_two_ranks': r.tp_ranks, 'ring_two_ranks': r.ring_ranks,
             'pipeline_two_ranks': r.pipe_ranks,
             'serve_resnet': r.serve_resnet,
             'train_resnet': r.train_resnet,
             'hapi_fit_resnet': r.hapi_resnet,
             'serve_ssd': r.serve_ssd, 'train_ssd': r.train_ssd,
             'finetune_ernie': r.finetuned, 'seq2seq_train': r.s2s_trained,
             'seq2seq_translate': r.s2s_decoded,
             'text_transformer': r.text_transformer,
             'train_ptb_lm': r.ptb_lm, 'train_lac': r.lac_trained,
             'serve_lac': r.lac_served}
    keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms', 'share_of_bound', 'achieved_tflops',
            'achieved_tb_per_s')
    rows, rows16, rowsh = r.rows, r.rows16, r.rowsh
    for row in (*rows.values(), *rows16.values(), *rowsh.values()):
        row.update(closeness(row))
    emit({'kernels': [
        {'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
         'replaces': SOURCES[name][1],
         'launches': sum(c[name] for c in paths.values()),
         'launches_by_path': {p: c[name] for p, c in paths.items()},
         **{k: rows16[name][k] for k in keys},
         'fp32': {k: rows[name][k] for k in keys},
         'bf16': {k: rows16[name][k] for k in keys},
         'fp16': {k: rowsh[name][k] for k in keys},
         **({'gpt': {case: {k: row[k] for k in keys}
                     for case, row in r.gpt_rows[name].items()}}
            if name in r.gpt_rows else {}),
         **({'ragged': [{k: c[k] for k in ('dtype', 'length', 'p', err)}
                        for c in r.ragged for err in RAGGED_ERRS[name]]}
            if name in RAGGED_ERRS else {}),
         **({'width_512': r.width_512[name]} if name in r.width_512
            else {})}
        for name in SOURCES]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
